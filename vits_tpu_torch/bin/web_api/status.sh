#!/bin/sh
# Report each service of the port's serving stack as running or stopped, by its pidfile in run/.
cd "$(dirname "$0")"
RUN=run
for name in socket_server http_server sat_api; do
  if [ -f "$RUN/$name.pid" ] && kill -0 "$(cat "$RUN/$name.pid")" 2>/dev/null; then
    echo "$name: running (pid $(cat "$RUN/$name.pid"))"
  else
    echo "$name: stopped"
  fi
done

#!/bin/sh
# Stop the port's serving stack by the exact PIDs in run/ (no pattern matching).
cd "$(dirname "$0")"
RUN=run
for name in sat_api http_server socket_server; do
  if [ -f "$RUN/$name.pid" ]; then
    PID=$(cat "$RUN/$name.pid")
    kill "$PID" 2>/dev/null
    rm -f "$RUN/$name.pid"
    echo "stopped $name ($PID)"
  fi
done

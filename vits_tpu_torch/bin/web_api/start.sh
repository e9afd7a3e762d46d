#!/bin/sh
# Start the port's serving stack: the socket server, the HTTP gateway and
# the SAT API (vits_tpu_torch.serve.*), each under nohup with a pidfile and
# a log in this directory's run/. Arguments go to the socket server, e.g.
#   sh start.sh --checkpoint ../../../checkpoint --quantize
# The servers run on the card (--device cuda, their default).
cd "$(dirname "$0")"
ROOT=$(cd ../../.. && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
RUN=run; mkdir -p "$RUN"
if [ ! -f "$RUN/socket_server.pid" ] || ! kill -0 "$(cat "$RUN/socket_server.pid" 2>/dev/null)" 2>/dev/null; then
  nohup python3 -m vits_tpu_torch.serve.socket_server "$@" >> "$RUN/socket_server.log" 2>&1 &
  echo $! > "$RUN/socket_server.pid"
fi
if [ ! -f "$RUN/http_server.pid" ] || ! kill -0 "$(cat "$RUN/http_server.pid" 2>/dev/null)" 2>/dev/null; then
  nohup python3 -m vits_tpu_torch.serve.http_server >> "$RUN/http_server.log" 2>&1 &
  echo $! > "$RUN/http_server.pid"
fi
if [ ! -f "$RUN/sat_api.pid" ] || ! kill -0 "$(cat "$RUN/sat_api.pid" 2>/dev/null)" 2>/dev/null; then
  nohup python3 -m vits_tpu_torch.serve.sat_api >> "$RUN/sat_api.log" 2>&1 &
  echo $! > "$RUN/sat_api.pid"
fi
sh ./tlog.sh
echo "started."

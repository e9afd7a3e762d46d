#!/bin/sh
# Self-heal loop: re-run start.sh every 60 s (it starts only what is not running).
cd "$(dirname "$0")"
while true; do
  sh ./start.sh "$@" >/dev/null 2>&1
  sleep 60
done

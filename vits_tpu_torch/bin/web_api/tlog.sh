#!/bin/sh
# Truncate the serving stack's logs in run/ past 10 MB.
cd "$(dirname "$0")"
MAX=10485760 # 10 MB
for f in run/*.log; do
  [ -f "$f" ] || continue
  size=$(wc -c < "$f")
  if [ "$size" -gt "$MAX" ]; then
    : > "$f"
    echo "truncated $f"
  fi
done

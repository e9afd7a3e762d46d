#!/bin/sh
# Kaldi-style option parser: turns --key value pairs into shell variables
# key=value.
# Usage: source this file after defining defaults; remaining args stay in "$@".
while true; do
  case "${1:-}" in
    --*)
      name=$(echo "$1" | sed s/^--// | sed s/-/_/g)
      eval '[ -z "${'"$name"'+xxx}" ]' && echo "$0: invalid option $1" >&2 && exit 1
      eval "$name=\"\$2\""
      shift 2 ;;
    *) break ;;
  esac
done
true

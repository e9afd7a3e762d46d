#!/bin/sh
# Speaker-adaptive training (vits_tpu_torch.sat.run_adapt): data preparation,
# scp building, the adapt-mode finetune from <satdir>/pretrain, the greedy-soup
# export, spkid.map and the emotion banks, on the card.
#   sh adapt.sh [--satdir DIR] [--outdir DIR] [--device cuda|cpu]
# --satdir defaults to the repo's sat/ (data/<spkid>/, configs/adapt.json,
# pretrain/), --outdir to <satdir>/../checkpoint.
HERE=$(cd "$(dirname "$0")" && pwd)
ROOT=$(cd "$HERE/../../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
satdir=$ROOT/sat
outdir=
device=cuda
while [ $# -gt 0 ]; do
  case "$1" in
    --satdir) satdir="$2"; shift 2 ;;
    --outdir) outdir="$2"; shift 2 ;;
    --device) device="$2"; shift 2 ;;
    *) echo "unknown option $1"; exit 1 ;;
  esac
done
cd "$satdir" || exit 1
exec python3 - "${outdir:-../checkpoint}" "$device" <<'PY'
import sys
from vits_tpu_torch.sat import run_adapt
run_adapt(".", sys.argv[1], device=sys.argv[2])
PY

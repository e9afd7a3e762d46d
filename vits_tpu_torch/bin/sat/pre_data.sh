#!/bin/sh
# Per-speaker data preparation (vits_tpu_torch.sat.prepare_speaker_data):
# trim, emotion extraction and clustering, text to vectors; prints the scp lines.
#   sh pre_data.sh <spk_dir> <work_dir> <spkid> [config] [device]
# config defaults to the repo's sat/configs/adapt.json, device to cuda.
HERE=$(cd "$(dirname "$0")" && pwd)
ROOT=$(cd "$HERE/../../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
spk_dir=$1; work_dir=$2; spkid=$3; config=${4:-$ROOT/sat/configs/adapt.json}; device=${5:-cuda}
exec python3 - "$spk_dir" "$work_dir" "$spkid" "$config" "$device" <<'PY'
import sys
from vits_tpu_torch.config import get_hparams_from_file
from vits_tpu_torch.sat import prepare_speaker_data
spk_dir, work_dir, spkid, config, device = sys.argv[1:6]
hps = get_hparams_from_file(config)
lines = prepare_speaker_data(spk_dir, work_dir, spkid, hps, device=device)
print("\n".join(lines))
PY

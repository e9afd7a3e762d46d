#!/bin/sh
# Tool checks: the python environment imports the port (vits_tpu_torch) and
# torch sees a CUDA device.
ROOT=$(cd "$(dirname "$0")/../../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
python3 -c "import vits_tpu_torch" 2>/dev/null || { echo "vits_tpu_torch not importable"; exit 1; }
python3 -c "import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)" || \
  { echo "torch sees no CUDA device"; exit 1; }

#!/usr/bin/env bash
# Clip-feature extraction of the PyTorch port (the counterpart of
# tools/misc/dist_clip_feature_extraction.sh, which runs the same program on
# every TPU host):
#
#   tools/misc/dist_clip_feature_extraction_torch.sh CONFIG OUT [clip_feature_extraction_torch.py options]
#
# runs tools/misc/clip_feature_extraction_torch.py, one process on the card
# (--device cpu for the CPU). PYTHON names the interpreter (default python3).
set -euo pipefail
CONFIG=$1
OUT=$2
shift 2
exec "${PYTHON:-python3}" "$(dirname "$0")/clip_feature_extraction_torch.py" "$CONFIG" "$OUT" "$@"

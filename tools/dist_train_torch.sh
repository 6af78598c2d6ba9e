#!/usr/bin/env bash
# Data-parallel training of the PyTorch port, one process a card
# (the counterpart of the reference's tools/dist_train.sh):
#
#   tools/dist_train_torch.sh GPUS CONFIG [train_torch.py options]
#
# runs torchrun (python -m torch.distributed.run) over tools/train_torch.py
# with --launcher pytorch; PORT sets the rendezvous port (default 29500).
# data.videos_per_gpu is a rank's batch: the global batch is GPUS times it.
set -euo pipefail
GPUS=$1
CONFIG=$2
shift 2
exec "${PYTHON:-python3}" -m torch.distributed.run --nproc_per_node="$GPUS" \
    --master_port="${PORT:-29500}" "$(dirname "$0")/train_torch.py" "$CONFIG" \
    --launcher pytorch "$@"

#!/usr/bin/env bash
# Data-parallel evaluation of the PyTorch port, one process a card
# (the counterpart of the reference's tools/dist_test.sh):
#
#   tools/dist_test_torch.sh GPUS CONFIG [test_torch.py options]
#
# runs torchrun (python -m torch.distributed.run) over tools/test_torch.py
# with --launcher pytorch; PORT sets the rendezvous port (default 29500).
# Each rank scores its shard of the split; rank 0 prints the metrics.
set -euo pipefail
GPUS=$1
CONFIG=$2
shift 2
exec "${PYTHON:-python3}" -m torch.distributed.run --nproc_per_node="$GPUS" \
    --master_port="${PORT:-29500}" "$(dirname "$0")/test_torch.py" "$CONFIG" \
    --launcher pytorch "$@"

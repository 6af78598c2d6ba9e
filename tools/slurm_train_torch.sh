#!/usr/bin/env bash
# SLURM training of the PyTorch port (the counterpart of the reference's
# tools/slurm_train.sh):
#
#   tools/slurm_train_torch.sh PARTITION JOB_NAME CONFIG [train_torch.py options]
#
# runs GPUS tasks (default 8), GPUS_PER_NODE a node (default 8), one a card.
# Each task takes torchrun's environment from SLURM's (RANK = SLURM_PROCID,
# WORLD_SIZE = SLURM_NTASKS, LOCAL_RANK = SLURM_LOCALID, LOCAL_WORLD_SIZE =
# the tasks of its node, MASTER_ADDR = the job's first node, MASTER_PORT =
# PORT, default 29500) and runs tools/train_torch.py with --launcher pytorch,
# which joins the process group (parallel/distributed.py::init_distributed).
# PYTHON names the interpreter (default python3); SRUN_ARGS adds srun options.
set -euo pipefail
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
shift 3
GPUS=${GPUS:-8}
GPUS_PER_NODE=${GPUS_PER_NODE:-$(( GPUS < 8 ? GPUS : 8 ))}
SRUN_ARGS=${SRUN_ARGS:-}
export TOOL="$(dirname "$0")/train_torch.py" PORT=${PORT:-29500} PYTHON=${PYTHON:-python3}

srun -p "$PARTITION" \
     --job-name="$JOB_NAME" \
     --gres=gpu:"$GPUS_PER_NODE" \
     --ntasks="$GPUS" \
     --ntasks-per-node="$GPUS_PER_NODE" \
     --kill-on-bad-exit=1 \
     $SRUN_ARGS \
     bash -c 'export RANK=$SLURM_PROCID WORLD_SIZE=$SLURM_NTASKS LOCAL_RANK=$SLURM_LOCALID
              export LOCAL_WORLD_SIZE=${SLURM_NTASKS_PER_NODE%%(*} MASTER_PORT=$PORT
              export MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)
              exec "$PYTHON" "$TOOL" "$@" --launcher pytorch' \
     slurm_train_torch "$CONFIG" "$@"

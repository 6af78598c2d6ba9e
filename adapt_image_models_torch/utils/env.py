"""The environment of a run (parity: ``adapt_image_models_tpu/utils/
env.py:14``; the reference's ``mmaction/utils/collect_env.py``)."""

from __future__ import annotations

import platform
import subprocess
import sys

import numpy as np
import torch

from adapt_image_models_torch.parallel.distributed import get_dist_info


def card_line() -> str:
    """``name, power.limit`` of each card, as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"


def collect_env() -> str:
    """Python, numpy, torch, CUDA and NCCL versions, the cards (name and
    power limit) and this process's rank and world size."""
    rank, world = get_dist_info()
    lines = [f"python: {sys.version.split()[0]}",
             f"platform: {platform.platform()}",
             f"numpy: {np.__version__}",
             f"torch: {torch.__version__}",
             f"CUDA: {torch.version.cuda}"]
    if torch.cuda.is_available():
        nccl = torch.cuda.nccl.version() if torch.distributed.is_nccl_available() else None
        lines += [f"NCCL: {'.'.join(map(str, nccl)) if nccl else 'not available'}",
                  f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}",
                  f"cards (name, power limit): {card_line()}"]
    else:
        lines.append("devices: no CUDA device")
    lines.append(f"rank / world: {rank} / {world}")
    return "\n".join(lines)

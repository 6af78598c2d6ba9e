"""Data parallelism over ``torch.distributed`` (parity:
``adapt_image_models_tpu/parallel/mesh.py:23-36, 75-99``; the reference's
``tools/dist_train.sh``).

One process a card, launched by ``torchrun`` (``tools/dist_train_torch.sh``,
``tools/dist_test_torch.sh``). The JAX package's ``data`` mesh axis becomes
the ranks of the process group: each rank runs the model, and its
hand-written kernels, on its own shard of the global batch, and the train
step averages loss, gradients and metrics across ranks (JAX ``pmean``,
``core/train_state.py:210-232``). Without a process group every helper
here returns at once and calls no collective.

Backends: ``nccl`` on the card, ``gloo`` on the CPU, unless ``backend=``
says otherwise; no backend is ever swapped for another. The helpers use
only all_reduce, broadcast and all_gather, which this PyTorch's gloo runs
on CUDA tensors itself, so the helpers pass CUDA tensors to gloo as they
are and stage nothing; the blend's neighbour row travels by all_gather, as
gloo's send and recv take CPU tensors only.

BatchNorm under a group (``all_reduce_sum``): the JAX package's CNN train
step is a ``jax.jit`` over a data-sharded batch (``apis/train.py:243-253``),
so XLA:SPMD computes each BatchNorm's mean and variance over the global
batch. The port's ``models.layers.BatchNormFlax`` all-reduces its (Σx, Σx²,
count) in the forward and the gradient of those sums in the backward: one
all_reduce of 2C + 1 floats per BatchNorm layer per pass (53 layers in
ResNet-50, so 53 in a forward and 53 more in its backward). Evaluation
reads the running statistics and calls no collective.

Not ported: the hybrid multi-slice mesh (``mesh.py:39-72``; ``torchrun
--nnodes`` runs this code across hosts, untested here) and the
tensor-parallel rules (``parallel/sharding_rules.py``).
"""

from __future__ import annotations

import os
from typing import Iterable, List, Tuple

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_distributed() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    return get_dist_info()[0] == 0


def _rank_device(kind: str, local_rank: int) -> torch.device:
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"data parallelism runs on 'cuda' or 'cpu', not {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but torch.cuda.is_available() is False")
    # ranks beyond the host's cards share them (gloo only, checked below)
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(backend: str | None = None, device="cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    and return this rank's device: ``cuda:<LOCAL_RANK>`` for a ``device``
    of type cuda (made the current device), ``cpu`` for the CPU.

    ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on the CPU; nccl
    on the CPU, and nccl with more ranks on a host than it has cards (NCCL
    runs no two ranks on one device), raise ``ValueError``. Under a group
    on the card, local rank 0 builds the kernel library
    (``ops._kernels.build_library``) before the other ranks may load it.
    Called again, it returns this rank's device and joins nothing."""
    kind = torch.device(device).type
    if is_distributed():
        if dist.get_backend() == "nccl" and kind != "cuda":
            raise ValueError(f"the process group runs nccl, which needs CUDA devices, "
                             f"not {kind!r}")
        return _rank_device(kind, int(os.environ.get("LOCAL_RANK", 0)))
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise ValueError(f"launcher 'pytorch' needs torchrun's environment; {missing} "
                         "unset: start with torchrun --nproc_per_node=N "
                         "(tools/dist_train_torch.sh)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and kind != "cuda":
        raise ValueError(f"the nccl backend needs CUDA devices, not {kind!r}: use gloo "
                         "on the CPU")
    rank_device = _rank_device(kind, local_rank)
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(f"nccl cannot run {local_world} ranks on {cards} CUDA "
                             "device(s): NCCL runs no two ranks on one device. Start "
                             "one rank a card, or pick the gloo backend")
    if rank_device.type == "cuda":
        torch.cuda.set_device(rank_device)
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    if rank_device.type == "cuda":
        from adapt_image_models_torch.ops import _kernels
        if local_rank == 0:
            _kernels.build_library()
        barrier()
    return rank_device


def barrier() -> None:
    if is_distributed():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _copy_into(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    """Scatter the flat buffer back into ``tensors``, in their order."""
    offset = 0
    for t in tensors:
        t.detach().copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Average ``tensors`` across ranks, in place, with one all_reduce over a
    flat buffer of all of them (in their widest float type, at least fp32),
    and return them. Each rank's copy is then the mean of every rank's."""
    tensors = list(tensors)
    if not is_distributed() or not tensors:
        return tensors
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat)
    _copy_into(tensors, flat.div_(dist.get_world_size()))
    return tensors


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks of a tensor, whose gradient is the sum over ranks
    of the gradients: every rank's loss reads the global sum, so each
    rank's share of it carries every rank's cotangent."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``t`` over ranks (one all_reduce forward, one
    backward); ``t`` itself without a group."""
    if not is_distributed():
        return t
    return _AllReduceSum.apply(t)


def broadcast_module_(model: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Give every rank rank ``src``'s parameters and buffers: one broadcast a
    dtype, over a flat buffer of that dtype's tensors."""
    if not is_distributed():
        return model
    by_dtype = {}
    for t in list(model.parameters()) + list(model.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src)
        _copy_into(tensors, flat)
    return model


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along dim 0 in rank
    order; ``t`` itself without a group."""
    if not is_distributed():
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts)


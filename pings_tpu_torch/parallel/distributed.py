"""Multi-process runtime initialisation and the collectives of the sharded
paths.

Counterpart of ``pings_tpu/parallel/distributed.py``. The JAX package
wires the hosts of a pod slice into one runtime with
``jax.distributed.initialize``; here each process drives one device and
joins a ``torch.distributed`` process group. The three values come from
the arguments or the environment:

    PINGS_COORDINATOR=host0:8476 PINGS_NUM_PROCESSES=4 PINGS_PROCESS_ID=0 ...

and, where none of those is set, from torchrun's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (which take the place of
JAX's autodetection on a TPU pod).

The collectives are autograd functions written for a loss that every rank
computes whole (``parallel.mesh``): ``all_gather_rows`` concatenates the
ranks' row blocks and its backward keeps the rank's own rows;
``shard_rows`` is its dual (the rank's rows forward, the ranks' gradients
all-gathered backward); ``sum_gradient`` is the identity whose backward
sums the gradient over the ranks, where a replicated input feeds sharded
work. ``torch.distributed.nn``'s all-gather reduce-scatters in its
backward instead, which here would count each gradient once per rank.
Only all-gather and all-reduce are used: gloo has no reduce-scatter for
CUDA tensors, and several ranks sharing one card must use gloo (NCCL
refuses two ranks on one GPU).
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from pings_tpu_torch import resolve_device


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> bool:
    """Join the multi-process runtime (idempotent).

    Returns True if a process group of more than one rank is up, False
    when running single-process (no coordinator configured). ``backend``
    defaults to "nccl" on cuda and "gloo" on cpu; a cuda rank is set to
    card ``LOCAL_RANK`` (else ``process_id``) modulo the cards present.
    ``device="cuda"`` without a card raises, as ``resolve_device`` does."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "PINGS_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("PINGS_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("PINGS_PROCESS_ID")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
        if num_processes is None:
            num_processes = _env_int("WORLD_SIZE")
        if process_id is None:
            process_id = _env_int("RANK")
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the number of processes and "
                         "this process's id")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        local = process_id if local is None else local
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def runtime_info() -> dict:
    """Process/device topology summary for logs and scaling reports: the
    six keys of the JAX package's, read from torch. One process drives
    one device, so the global device count is the world size; ``backend``
    is the process group's ("nccl", "gloo") or "none"."""
    up = dist.is_initialized()
    cuda = torch.cuda.is_available()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_device_count": torch.cuda.device_count() if cuda else 1,
        "global_device_count": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else "none",
        "device_kind": torch.cuda.get_device_name() if cuda else "cpu",
    }


# ---------------------------------------------------------------------------
# Collectives. ``mesh`` is a ``parallel.mesh.Mesh``: its ``group`` is None
# for a mesh of one process without a process group, and each function is
# then the identity.
# ---------------------------------------------------------------------------

def _gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' row blocks of ``x``, concatenated in rank order (no
    gradient). gloo has no bool: bools travel as uint8."""
    if x.dtype == torch.bool:
        return _gather(x.to(torch.uint8), mesh).bool()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.mesh.rank * ctx.rows
        return g[r0:r0 + ctx.rows], None


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        n = x.shape[0] // mesh.size
        return x[mesh.rank * n:(mesh.rank + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh), None


class _SumGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g, None


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """(n, ...) on each rank -> (size n, ...) on every rank, rank order.
    Backward: the rank's own rows of the gradient."""
    if mesh.group is None:
        return x
    if not (x.requires_grad and torch.is_grad_enabled()):
        return _gather(x, mesh)
    return _GatherRows.apply(x, mesh)


def shard_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's contiguous block of x.shape[0] / size rows. Backward: the
    ranks' gradients of their blocks, all-gathered, so that every rank
    holds the gradient of the whole ``x``."""
    if mesh.group is None:
        return x
    if not (x.requires_grad and torch.is_grad_enabled()):
        n = x.shape[0] // mesh.size
        return x[mesh.rank * n:(mesh.rank + 1) * n]
    return _ShardRows.apply(x, mesh)


def sum_gradient(x: torch.Tensor, mesh) -> torch.Tensor:
    """The identity; its backward all-reduces (sums) the gradient over the
    ranks: for a replicated input of work that each rank does on its own
    shard."""
    if mesh.group is None or not (x.requires_grad
                                  and torch.is_grad_enabled()):
        return x
    return _SumGradient.apply(x, mesh)


def all_reduce_mean(tensors: Iterable[torch.Tensor], mesh) -> None:
    """Average each tensor over the ranks, in place, with one all-reduce
    of one flat buffer (the data-parallel step's gradient pmean)."""
    tensors = list(tensors)
    if mesh.group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()

"""Row gathers from the map's feature tables, with a hand-written gradient.

``gather_rows(tables, idx)`` returns ``t[idx]`` for each table, through
PyTorch's own indexing. Its gradient sums the cotangent rows of equal
indices into each table's row (``row_scatter``): on CUDA tensors by the
kernel of ``csrc/row_scatter.cu``, which sorts ``idx`` once for all the
tables and reduces the runs of equal rows in fixed chunks, so its time does
not depend on how often a row repeats (the map sends every invalid
neighbour and every padded window row to the one dump row); on CPU tensors
by the plain version, ``row_scatter_ref`` (``index_add_`` into zeros, which
sums in the order of the entries, as PyTorch's own gradient of ``t[idx]``
does there). Any other device raises.

No TPU kernel is replaced: the JAX package leaves this gradient to XLA's
scatter-add. ``LAUNCHES`` counts the kernel's launches (a call with no
entries launches nothing) and ``PLAIN_RUNS`` the plain version's runs;
``scatters()`` is their sum, which the frame loop reports per frame.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from pings_tpu_torch.ops import _build

CHUNK = 256      # sorted entries of a chunk-pass block (csrc/row_scatter.cu)

LAUNCHES = 0     # row_scatter kernel launches (CUDA tensors)
PLAIN_RUNS = 0   # row_scatter_ref runs (CPU tensors)

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGS = [_VP] * 8 + [_CI] * 5 + [_VP]


def scatters() -> int:
    """Backward scatters so far, on any device."""
    return LAUNCHES + PLAIN_RUNS


def gather_rows(tables: Sequence[torch.Tensor], idx: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """``tuple(t[idx] for t in tables)`` for one or two 2-D tables of one
    row count and an int64 or int32 ``idx`` of any shape (the JAX
    package's window rows arrive as int32), whose gradient is
    ``row_scatter``'s. Where no gradient can be asked for (grad mode off,
    or no table requires one) it is the plain indexing."""
    tables = tuple(tables)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return _GatherRows.apply(idx, *tables)
    return tuple(t[idx] for t in tables)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, *tables):
        if idx.dtype not in (torch.int64, torch.int32):
            raise ValueError(f"idx must be int64 or int32, got {idx.dtype}")
        rows = {t.shape[0] for t in tables}
        if len(tables) > 2 or len(rows) != 1 \
                or any(t.dim() != 2 for t in tables):
            raise ValueError(
                "gather_rows takes one or two 2-D tables of one row count, "
                f"got {[tuple(t.shape) for t in tables]}")
        # t[idx] wraps a negative row round where the backward would
        # write before the gradient: refused here, without a host read (on
        # the card a failed check ends the process at its next sync)
        if idx.numel():
            torch._assert_async(idx.min() >= 0,
                                "gather_rows: negative row index")
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(idx)
        ctx.rows = rows.pop()
        return tuple(t[idx] for t in tables)

    @staticmethod
    def backward(ctx, *grads):
        (idx,) = ctx.saved_tensors
        want = [g if need else None
                for g, need in zip(grads, ctx.needs_input_grad[1:])]
        return (None, *row_scatter(idx, want, ctx.rows))


def row_scatter(idx: torch.Tensor, grads: Sequence[Optional[torch.Tensor]],
                rows: int) -> List[Optional[torch.Tensor]]:
    """The gradient of ``t[idx]`` for each of one or two cotangents in
    ``grads`` (shape ``idx.shape + (f,)``; None gives None): a dense
    (rows, f) table whose row r sums the cotangent rows of the entries
    with ``idx == r``. CUDA tensors launch the kernel, CPU tensors take
    ``row_scatter_ref``; any other device raises."""
    live = [i for i, g in enumerate(grads) if g is not None]
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    if not live:
        return out
    dev = idx.device
    if dev.type == "cpu":
        global PLAIN_RUNS
        done = row_scatter_ref(idx, [grads[i] for i in live], rows)
        PLAIN_RUNS += 1
    elif dev.type == "cuda":
        done = _scatter_cuda(idx, [grads[i] for i in live], rows)
    else:
        raise ValueError(f"row_scatter runs on cuda or cpu tensors, got "
                         f"{dev}")
    for i, d in zip(live, done):
        out[i] = d
    return out


def row_scatter_ref(idx: torch.Tensor, grads: Sequence[torch.Tensor],
                    rows: int) -> List[torch.Tensor]:
    """The plain version: ``index_add_`` of the cotangent rows into zeros,
    entry by entry in the gather's order."""
    flat = idx.reshape(-1)
    out = []
    for g in grads:
        f = g.shape[-1]
        d = torch.zeros((rows, f), dtype=g.dtype, device=g.device)
        out.append(d.index_add_(0, flat, g.reshape(-1, f)))
    return out


def _scatter_cuda(idx: torch.Tensor, grads: Sequence[torch.Tensor],
                  rows: int) -> List[torch.Tensor]:
    global LAUNCHES
    dev = idx.device
    E = idx.numel()
    if rows >= 2 ** 31 or E >= 2 ** 31 - CHUNK:
        raise ValueError(f"row_scatter takes under 2^31 rows and entries, "
                         f"got {rows} rows, {E} entries")
    if len(grads) > 2:
        raise ValueError(f"row_scatter takes one or two tables, got "
                         f"{len(grads)}")
    gs = []
    for g in grads:
        if g.device != dev or g.dtype != torch.float32 \
                or g.shape[:-1] != idx.shape:
            raise ValueError(
                "row_scatter: each cotangent must be float32 of shape "
                f"{tuple(idx.shape)} + (f,) on {dev}, got {g.dtype} "
                f"{tuple(g.shape)} on {g.device}")
        gs.append(g.reshape(E, g.shape[-1]).contiguous())
    fs = [g.shape[1] for g in gs]
    outs = [torch.zeros((rows, f), dtype=torch.float32, device=dev)
            for f in fs]
    if E == 0:
        return outs
    keys, perm = torch.sort(idx.reshape(-1).to(torch.int32), stable=True)
    launch(keys, perm, gs, outs, rows)
    LAUNCHES += 1
    return outs


def launch(keys: torch.Tensor, perm: torch.Tensor,
           gs: Sequence[torch.Tensor], outs: Sequence[torch.Tensor],
           rows: int) -> None:
    """One launch of the kernel on checked inputs: ``keys`` (E,) int32
    sorted rows and ``perm`` (E,) int64 their entries' positions (as
    ``torch.sort(..., stable=True)`` gives them), one or two cotangents
    ``gs`` (E, f) and zero-filled gradients ``outs`` (rows, f), contiguous
    float32 on one card. Adds into ``outs``' touched rows; counts
    nothing."""
    E = keys.shape[0]
    fs = [g.shape[1] for g in gs]
    carry = torch.empty((2, -(-E // CHUNK), sum(fs)), dtype=torch.float32,
                        device=keys.device)
    ptrs = [x.data_ptr() for x in (*gs, *outs, carry)]
    vec4 = all(f % 4 == 0 for f in fs) and all(p % 16 == 0 for p in ptrs)
    two = len(gs) == 2
    p = lambda x: ctypes.c_void_p(x.data_ptr() if x is not None else None)
    rc = _lib().row_scatter(
        p(keys), p(perm), p(gs[0]), p(gs[1] if two else None), p(outs[0]),
        p(outs[1] if two else None), p(carry[0]), p(carry[1]), _CI(E),
        _CI(rows), _CI(fs[0]), _CI(fs[1] if two else 0), _CI(int(vec4)),
        ctypes.c_void_p(torch.cuda.current_stream(keys.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"row_scatter launch failed: CUDA error {rc}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("row_scatter")
    if not getattr(lib, "_typed", False):
        lib.row_scatter.argtypes = _ARGS
        lib.row_scatter.restype = ctypes.c_int
        lib._typed = True
    return lib

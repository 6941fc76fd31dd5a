"""The blend kernels alone: their time on the reference's tile tables and
their share of the least time those tables need.

The time is the method of the repository's ``chip_smoke.kernel_times``:
CUDA events around 20 launches that wait behind a spin kernel, so the
host has queued them all before the first starts; the median of 5 rounds
after a warm-up round. The tables are built by the reference's own
binning from the program's state after the window, so the kernels are
timed on inputs the program did not prepare.
"""

from __future__ import annotations

import statistics

from perfbench.harness import counts


def _timed(torch, fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e6))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / 1e3 / n


def kernel_time(torch, fn, n: int = 20, rounds: int = 5) -> float:
    """Seconds per launch of ``fn`` on the card."""
    _timed(torch, fn, n)
    return statistics.median(_timed(torch, fn, n) for _ in range(rounds))


def roofline(torch, kind: str, mode: str, attr, tbl, counts_, hits: int,
             n_ids: int, width: int, height: int, tile: int, seed: int):
    """The ``kind`` ("fwd" or "bwd") blend kernel of the program on this
    table: (share in %, seconds, least seconds, bound)."""
    from pings_tpu_torch.ops import raster_blend as rb
    from pings_tpu_torch.ops.rasterize import TileBins

    ntx = (width + tile - 1) // tile
    nty = (height + tile - 1) // tile
    kmax = tbl.shape[1]
    k = torch.arange(kmax, device=tbl.device)
    mask = k[None, :] < counts_[:, None]
    bins = TileBins(gauss_tbl=tbl.to(torch.int32).contiguous(), mask=mask,
                    counts=counts_.to(torch.int32).contiguous(),
                    n_overflow=torch.zeros((), dtype=torch.int32,
                                           device=tbl.device))
    attr = attr.detach().contiguous()
    if kind == "fwd":
        fn = lambda: rb.blend_fwd(attr, bins, ntx, nty, tile, mode)
    else:
        gen = torch.Generator(device=attr.device).manual_seed(seed)
        T, P = tbl.shape[0], tile * tile
        out, trans, _ = rb.blend_fwd(attr, bins, ntx, nty, tile, mode)
        g_out = torch.randn((T, 8, P), device=attr.device, generator=gen)
        g_trans = torch.randn((T, 1, P), device=attr.device, generator=gen)
        rho = (g_out * out).sum(dim=1, keepdim=True)
        fn = lambda: rb.blend_bwd(attr, bins, g_out, g_trans, rho, trans,
                                  ntx, nty, tile, mode)
    sec = kernel_time(torch, fn)
    least, bound = counts.least_time(kind, mode, hits, tbl.shape[0],
                                     int(counts_.sum()), n_ids, tile * tile)
    return 100.0 * least / sec, sec, least, bound

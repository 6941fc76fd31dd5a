"""The parts of the redesigned blend kernels that run without a card.

- ``raster_blend.warp_culled`` (the plain version of ``slot_outside`` in
  ``csrc/blend_common.cuh``, by which a warp skips a slot) and, as a
  second and looser statement of the same bound, ``slot_extent`` below
  (the rectangle that holds a slot's pixels) never exclude a pixel where
  ``slot_alpha`` gives alpha > 0: random and near-degenerate
  conics, conics that are not positive definite, non-finite rows, means
  far outside the image, sub-pixel Gaussians on a pixel centre, opacities
  around 1/255, Gaussians whose cutoff ends exactly on a warp rectangle's
  edge, and whole tile tables with the kernels' layout of 8 x 4 pixels per
  warp. Exact: the cull is a statement about which alphas are zero.
- The transposing butterfly by which a warp of the backward kernel sums
  its 16 column terms, emulated lane by lane with the kernel's index
  arithmetic: lane c (and c + 16) ends with column c's sum (float64 sums
  of integers, exact).
- The contribution kernel's batched sum, by the same emulation: the slots
  of a chunk that had a hit go through the 8-column butterfly 8 at a time,
  and every slot's sum ends at that slot's entry of the warp's partials.
- Wherever a warp skips a slot, the plain version's blend weight
  alpha * T is exactly 0 on the warp's 32 pixels: the contribution kernel
  loses nothing to the cull.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from pings_tpu_torch.ops import raster_blend as rb
from pings_tpu_torch.ops.rasterize import TileBins
from test_torch_raster_blend import random_table

W, H = 64, 48       # the image of the pixel grids below
GEOM = {"surfel": (6, 7, 8, 9, 10, 11), "3dgs": (8, 9, 10, 11, 12, 13)}


def slot_extent(rows: torch.Tensor, mode: str) -> torch.Tensor:
    """(..., 16) attribute rows -> (..., 4) rectangle (x0, x1, y0, y1) of
    pixel centres outside which the slot's alpha is 0 for certain.

    alpha > 0 needs q < 9 and opa exp(-q/2) >= 1/255, that is
    q <= qc = min(9, 2 ln(255 opa) + slack), and on q <= qc the offsets
    from the centre obey |dx| <= sqrt(qc C / det), |dy| <= sqrt(qc A / det)
    with det = A C - B^2. The half-widths are widened by the margins of
    ``raster_blend.warp_culled``. A conic that is not positive definite
    with det >= ``DET_MIN`` A C (or holds a non-finite entry) gets an
    infinite rectangle; an opacity under 1/255 an empty one (x0 = +inf,
    x1 = -inf)."""
    mx, my, ca, cb, cc, op = GEOM[mode]
    A, B, C, opa = rows[..., ca], rows[..., cb], rows[..., cc], rows[..., op]
    inf = torch.full_like(A, float("inf"))
    ac = A * C
    det = ac - B * B
    ok = (A > 0) & (ac > 0) & (ac < inf) & (det >= rb.DET_MIN * ac)
    qc = 2.0 * torch.log(opa * 255.0) + rb.EXT_LOG_SLACK
    qc = torch.where(qc < rb.CUTOFF_Q, qc, torch.full_like(qc, rb.CUTOFF_Q))
    k = qc / det
    rx = rb.EXT_SCALE * torch.sqrt(k * C) + rb.EXT_PIXELS
    ry = rb.EXT_SCALE * torch.sqrt(k * A) + rb.EXT_PIXELS
    empty = ok & (qc < 0)
    rx = torch.where(empty, -inf, torch.where(ok, rx, inf))
    ry = torch.where(empty, -inf, torch.where(ok, ry, inf))
    return torch.stack([rows[..., mx] - rx, rows[..., mx] + rx,
                        rows[..., my] - ry, rows[..., my] + ry], dim=-1)


def _rows(mode, mu, conic, opa, rng):
    """(n, 16) float32 rows with the given geometry; the plane depth of a
    surfel row passes its gate at every pixel of the image."""
    n = len(opa)
    a = np.zeros((n, 16), np.float32)
    mx, my, ca, cb, cc, op = GEOM[mode]
    a[:, :6] = rng.uniform(-1, 1, (n, 6))
    a[:, mx], a[:, my] = mu[:, 0], mu[:, 1]
    a[:, ca], a[:, cb], a[:, cc] = conic[:, 0], conic[:, 1], conic[:, 2]
    a[:, op] = opa
    if mode == "surfel":
        a[:, 14] = 0.3
    return a


def _grid():
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return (torch.from_numpy(xs.reshape(-1).astype(np.float32)) + 0.5,
            torch.from_numpy(ys.reshape(-1).astype(np.float32)) + 0.5)


def _blocks():
    """The image cut into warp blocks of 8 x 4 pixels: the rectangle of
    each block's pixel centres (x0, x1, y0, y1), four (blocks,) tensors,
    and for each pixel of ``_grid`` its block."""
    nbx = W // rb.WARP_W
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    owner = (ys // rb.WARP_H * nbx + xs // rb.WARP_W).reshape(-1)
    b = np.arange(nbx * (H // rb.WARP_H))
    x0 = torch.from_numpy(((b % nbx) * rb.WARP_W + 0.5).astype(np.float32))
    y0 = torch.from_numpy(((b // nbx) * rb.WARP_H + 0.5).astype(np.float32))
    return (x0, x0 + (rb.WARP_W - 1), y0, y0 + (rb.WARP_H - 1)), owner


def _culled_pixels(rows, mode):
    """(n, pixels): the pixel's warp block skips the row."""
    rect, owner = _blocks()
    r = torch.from_numpy(rows)[:, None]                        # (n, 1, 16)
    return rb.warp_culled(r, mode, *(v[None] for v in rect))[:, owner]


def _alpha(rows, px, py, mode):
    """(n, pixels) alpha of every row at every pixel."""
    r = torch.from_numpy(rows)
    alpha, _ = rb.slot_alpha(lambda c: r[:, c:c + 1], px[None], py[None],
                             mode)
    return alpha


def _cases(rng, n=300):
    """name -> (mu, conic, opa) with n slots each."""
    inside = rng.uniform([0, 0], [W, H], (n, 2))
    sig = rng.uniform(0.3, 12.0, n)
    iso = np.stack([1 / sig ** 2, np.zeros(n), 1 / sig ** 2], -1)
    cases = {}
    # random: anisotropic, rotated
    s1, s2 = rng.uniform(0.3, 15.0, n), rng.uniform(0.3, 15.0, n)
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    A = c * c / s1 ** 2 + s * s / s2 ** 2
    B = c * s * (1 / s1 ** 2 - 1 / s2 ** 2)
    C = s * s / s1 ** 2 + c * c / s2 ** 2
    cases["random"] = (inside, np.stack([A, B, C], -1),
                       rng.uniform(0.01, 1.0, n))
    # near-degenerate: B^2 within 1e-2 .. 1e-7 of A C, either sign of det
    a_, c_ = rng.uniform(1e-3, 1.0, n), rng.uniform(1e-3, 1.0, n)
    eps = 10.0 ** rng.uniform(-7, -2, n) * rng.choice([-1, 1], n)
    b_ = np.sqrt(a_ * c_ * np.clip(1 - eps, 0, None)) * rng.choice([-1, 1], n)
    cases["near_degenerate"] = (inside, np.stack([a_, b_, c_], -1),
                                rng.uniform(0.3, 1.0, n))
    # not positive definite: det <= 0, negative or zero diagonal
    conic = rng.uniform(-0.2, 0.2, (n, 3))
    conic[: n // 3, 1] = 1.0                      # |B| dominates
    conic[n // 3: n // 2, 2] = 0.0                # C = 0
    cases["not_positive_definite"] = (inside, conic,
                                      rng.uniform(0.3, 1.0, n))
    # non-finite entries in the conic, the centre or the opacity
    mu, con, opa = inside.copy(), iso.copy(), rng.uniform(0.3, 1.0, n)
    bad = rng.choice([np.nan, np.inf, -np.inf], n)
    where = rng.integers(0, 6, n)
    for i in range(n):
        if where[i] < 3:
            con[i, where[i]] = bad[i]
        elif where[i] < 5:
            mu[i, where[i] - 3] = bad[i]
        else:
            opa[i] = bad[i]
    cases["non_finite"] = (mu, con, opa)
    # means far outside the image, wide enough to reach into it or not
    far = inside + rng.choice([-1, 1], (n, 2)) * rng.uniform(50, 5e3, (n, 2))
    wide = 10.0 ** rng.uniform(0, 3.5, n)
    cases["far_outside"] = (far, np.stack([1 / wide ** 2, np.zeros(n),
                                           1 / wide ** 2], -1),
                            rng.uniform(0.3, 1.0, n))
    # sub-pixel Gaussians exactly on a pixel centre
    centre = np.floor(inside) + 0.5
    tiny = 10.0 ** rng.uniform(-3, -0.5, n)
    cases["subpixel_on_centre"] = (centre, np.stack(
        [1 / tiny ** 2, np.zeros(n), 1 / tiny ** 2], -1),
        rng.uniform(0.3, 1.0, n))
    # opacities around the 1/255 floor (on a centre, q = 0: alpha = opa)
    cases["opacity_floor"] = (centre, iso, (1 / 255) * rng.uniform(
        0.98, 1.05, n))
    return cases


@pytest.mark.parametrize("mode", ["surfel", "3dgs"])
@pytest.mark.parametrize("case", [
    "random", "near_degenerate", "not_positive_definite", "non_finite",
    "far_outside", "subpixel_on_centre", "opacity_floor"])
def test_extent_contains_every_active_pixel(rng, mode, case):
    mu, conic, opa = _cases(rng)[case]
    rows = _rows(mode, mu, conic, opa, rng)
    px, py = _grid()
    active = _alpha(rows, px, py, mode) > 0
    rect = slot_extent(torch.from_numpy(rows), mode)
    inside = ((px[None] >= rect[:, 0:1]) & (px[None] <= rect[:, 1:2])
              & (py[None] >= rect[:, 2:3]) & (py[None] <= rect[:, 3:4]))
    assert not bool((active & ~inside).any())
    culled = _culled_pixels(rows, mode)
    assert not bool((active & culled).any())
    # the warp test is at least as tight as the rectangle: a block wholly
    # outside it is skipped (the two share their margins)
    assert not bool((~inside & ~culled).all(dim=1).any()) or case in (
        "not_positive_definite", "non_finite", "near_degenerate")
    if case in ("random", "subpixel_on_centre"):
        assert bool(active.any())
        assert bool(culled.any())
    if case == "subpixel_on_centre":
        # the pixel the Gaussian sits on is active and inside
        assert bool((active & inside).any(dim=1).all())
    if case in ("not_positive_definite", "non_finite"):
        # no finite rectangle comes from a conic that is not positive
        # definite or not finite
        c32 = conic.astype(np.float32)
        bad = ~(np.isfinite(c32).all(1) & (c32[:, 0] > 0)
                & (c32[:, 0] * c32[:, 2] - c32[:, 1] ** 2 > 0))
        assert bad.sum() > len(bad) // 3
        assert not np.isfinite(rect.numpy()[bad]).any()


def _warp_rects(ntx, tile, T):
    """The kernels' pixel layout: per tile and warp the rectangle of its
    8 x 4 pixel centres, (T, NW, 4), and per tile and pixel (row-major
    in the tile) the warp that owns it, (P,)."""
    wpr = tile // rb.WARP_W
    nw = tile * tile // 32
    warp = np.arange(nw)
    bx, by = (warp % wpr) * rb.WARP_W, (warp // wpr) * rb.WARP_H
    t = np.arange(T)
    x0 = ((t % ntx) * tile)[:, None] + bx[None] + 0.5
    y0 = ((t // ntx) * tile)[:, None] + by[None] + 0.5
    rects = np.stack([x0, x0 + rb.WARP_W - 1, y0, y0 + rb.WARP_H - 1], -1)
    lane = np.arange(tile * tile)
    owner = (lane // tile // rb.WARP_H) * wpr + (lane % tile) // rb.WARP_W
    return torch.from_numpy(rects.astype(np.float32)), owner


@pytest.mark.parametrize("mode", ["surfel", "3dgs"])
@pytest.mark.parametrize("tile", [16, 8])
def test_warp_cull_keeps_every_active_slot_pixel(rng, mode, tile):
    """On a whole tile table: wherever a warp would skip a slot, every
    pixel of that warp has alpha = 0 there; and the cull does skip."""
    T, kmax = 12, 48
    a, tbl, _, ntx = random_table(rng, mode, T, kmax)
    a[:, GEOM[mode][0]:GEOM[mode][0] + 2] *= tile / 16
    a[::7, GEOM[mode][2]] = a[::7, GEOM[mode][4]] = 1e-3      # wide ones
    n = a.shape[0]
    rows = torch.from_numpy(a)[np.minimum(tbl, n - 1)]        # (T, K, 16)
    px, py = rb.tile_pixels(T, ntx, tile, "cpu")              # (T, P)
    alpha, _ = rb.slot_alpha(lambda c: rows[:, :, c:c + 1], px[:, None],
                             py[:, None], mode)               # (T, K, P)
    rects, owner = _warp_rects(ntx, tile, T)                  # (T, NW, 4)
    w = rects[:, None]                                        # (T, 1, NW, 4)
    culled = rb.warp_culled(rows[:, :, None], mode, w[..., 0], w[..., 1],
                            w[..., 2], w[..., 3])             # (T, K, NW)
    # the warp rectangle really spans its pixels
    for k, lo, hi in ((px, 0, 1), (py, 2, 3)):
        assert bool((k >= rects[:, owner, lo]).all())
        assert bool((k <= rects[:, owner, hi]).all())
    culled_px = culled[:, :, owner]                           # (T, K, P)
    assert not bool(((alpha > 0) & culled_px).any())
    assert 0.2 < float(culled.float().mean()) < 1.0
    # a warp that is not skipped is not always hit: the cull is a rectangle
    assert bool((alpha > 0).any())


def _iso_row(mode, mx, my, sigma, opa=1.0):
    return _rows(mode, np.array([[mx, my]]),
                 np.array([[1 / sigma ** 2, 0.0, 1 / sigma ** 2]]),
                 np.array([opa]), np.random.default_rng(0))


@pytest.mark.parametrize("mode", ["surfel", "3dgs"])
def test_cutoff_ending_on_a_warp_edge(mode):
    """A round Gaussian left of a warp whose first column of pixel centres
    is at distance d. Where its cutoff 3 sigma ends exactly on that column
    (one ulp either side) the warp is not skipped; the skip begins where
    the cutoff, widened by the margins, stays short of the column:
    1.01 * 3 sigma + 1 < d."""
    wx0, wx1, wy0, wy1 = 16.5, 23.5, 8.5, 11.5
    d = 6.0
    mx, my = wx0 - d, 10.5
    px = torch.tensor([wx0])
    py = torch.tensor([my])
    for sigma in np.nextafter(np.float32(d / 3), np.float32([0, 10])):
        row = _iso_row(mode, mx, my, float(sigma))
        assert not bool(rb.warp_culled(torch.from_numpy(row), mode, wx0, wx1,
                                       wy0, wy1))
    # just inside the cutoff the edge pixel is active
    assert bool(_alpha(_iso_row(mode, mx, my, d / 3 * 1.001), px, py,
                       mode)[0, 0] > 0)
    edge = (d - rb.EXT_PIXELS) / (3 * rb.EXT_SCALE)
    for sigma, want in ((edge * 0.9999, True), (edge * 1.0001, False)):
        row = torch.from_numpy(_iso_row(mode, mx, my, sigma))
        assert bool(rb.warp_culled(row, mode, wx0, wx1, wy0, wy1)) is want
    # the same from the corner: the distance is along the diagonal
    mx, my = wx0 - d, wy0 - d
    edge = (np.hypot(d, d) - np.hypot(1, 1) * rb.EXT_PIXELS) / (
        3 * rb.EXT_SCALE)
    for sigma, want in ((edge * 0.9999, True), (edge * 1.0001, False)):
        row = torch.from_numpy(_iso_row(mode, mx, my, sigma))
        assert bool(rb.warp_culled(row, mode, wx0, wx1, wy0, wy1)) is want
    # a conic with a NaN is never skipped; an opacity below the floor is
    row = _iso_row(mode, -50.0, -50.0, float("nan"))
    assert not bool(rb.warp_culled(torch.from_numpy(row), mode, wx0, wx1,
                                   wy0, wy1))
    row = _iso_row(mode, 20.0, 10.0, 4.0, opa=1e-3)
    assert bool(rb.warp_culled(torch.from_numpy(row), mode, wx0, wx1, wy0,
                               wy1))
    assert bool((slot_extent(torch.from_numpy(row), mode)[0, [0, 2]]
                 == float("inf")).all())


finite = dict(allow_nan=False, allow_infinity=False, width=32)


@settings(max_examples=300, deadline=None, database=None)
@given(a=st.floats(2.0 ** -20, 1e4, **finite),
       c=st.floats(2.0 ** -20, 1e4, **finite),
       corr=st.floats(-1.0, 1.0, **finite),
       opa=st.floats(0.0, 1.5, **finite),
       mx=st.floats(-40.0, 100.0, **finite),
       my=st.floats(-40.0, 100.0, **finite),
       mode=st.sampled_from(["surfel", "3dgs"]))
def test_extent_contains_every_active_pixel_hypothesis(a, c, corr, opa, mx,
                                                       my, mode):
    b = corr * np.sqrt(a * c)
    rows = _rows(mode, np.array([[mx, my]]), np.array([[a, b, c]]),
                 np.array([opa]), np.random.default_rng(0))
    px, py = _grid()
    active = _alpha(rows, px, py, mode)[0] > 0
    x0, x1, y0, y1 = slot_extent(torch.from_numpy(rows), mode)[0]
    inside = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
    assert not bool((active & ~inside).any())
    assert not bool((active & _culled_pixels(rows, mode)[0]).any())


def _butterfly(v):
    """The kernels' ``warp_transpose_sum`` on (32 lanes, N columns), N = 8
    or 16: returns what each lane ends with. Index arithmetic only: a
    shuffle with ``lane ^ bit`` is a gather."""
    v = v.copy()
    lanes = np.arange(32)
    n_col = v.shape[1]
    half = n_col // 2
    while half >= 1:
        up = (lanes & half) != 0
        new = v.copy()
        for i in range(half):
            send = np.where(up, v[:, i], v[:, i + half])
            keep = np.where(up, v[:, i + half], v[:, i])
            new[:, i] = keep + send[lanes ^ half]
        v = new
        half //= 2
    x = v[:, 0]
    bit = n_col
    while bit < 32:
        x = x + x[lanes ^ bit]
        bit *= 2
    return x


@pytest.mark.parametrize("live", [14, 15, 16])
def test_butterfly_leaves_column_c_on_lane_c(rng, live):
    v = np.zeros((32, 16))
    v[:, :live] = rng.integers(-1000, 1000, (32, live))
    got = _butterfly(v)
    want = v.sum(axis=0)
    np.testing.assert_array_equal(got[:16], want)
    np.testing.assert_array_equal(got[16:], want)
    assert (got[live:16] == 0).all()


CONTRIB_BATCH = 8    # BATCH of csrc/blend_contrib.cu


def _batched_partials(w, hit):
    """The contribution kernel's plan for one warp and one chunk: ``w``
    (32 lanes, 32 slots) weights, ``hit`` the slots with a hit in some
    lane, one bit each. The slots are taken in order, ``CONTRIB_BATCH`` at
    a time, one butterfly column each; slot j's column is its rank among
    the batch's slots, column r's sum lies on lane r, lane j fetches it
    and stores it at entry j of the partials. Returns (partials with NaN
    where nothing was written, mask of the entries written, the padding
    columns' sums of every batch)."""
    part = np.full(32, np.nan)
    hits, padding, left = 0, [], hit
    while left:
        v = np.zeros((32, CONTRIB_BATCH))
        batch = 0
        for i in range(CONTRIB_BATCH):
            if not left:
                break
            j = (left & -left).bit_length() - 1
            left &= left - 1
            v[:, i] = w[:, j]
            batch |= 1 << j
        mine = _butterfly(v)
        n_used = bin(batch).count("1")
        padding += [mine[lane] for lane in range(32)
                    if lane % CONTRIB_BATCH >= n_used]
        for lane in range(32):
            r = bin(batch & ((1 << lane) - 1)).count("1")
            fetched = mine[r]
            if (batch >> lane) & 1:
                part[lane] = fetched
        hits |= batch
    return part, hits, np.array(padding)


@pytest.mark.parametrize("n_hit", [0, 1, 15, 16, 17, 32])
def test_contrib_batched_sum_lands_on_its_slot(rng, n_hit):
    slots = np.sort(rng.choice(32, n_hit, replace=False))
    hit = sum(1 << int(j) for j in slots)
    w = np.zeros((32, 32))
    w[:, slots] = rng.integers(1, 1000, (32, n_hit))
    part, hits, padding = _batched_partials(w, hit)
    assert hits == hit
    written = ~np.isnan(part)
    np.testing.assert_array_equal(np.flatnonzero(written), slots)
    np.testing.assert_array_equal(part[written], w.sum(axis=0)[slots])
    assert (padding == 0).all()
    # batches needed: 8 slots a butterfly
    assert len(padding) == 32 * (-n_hit % CONTRIB_BATCH) // CONTRIB_BATCH


@pytest.mark.parametrize("mode", ["surfel", "3dgs"])
def test_culled_warp_slots_carry_no_blend_weight(rng, mode):
    """alpha * T of the plain scan, slot by slot with the running T, is
    exactly 0 on all 32 pixels of a warp's 8 x 4 block wherever
    ``warp_culled`` lets that warp skip the slot; and the per-slot sums
    without those pixels are the plain version's contributions."""
    T, kmax, tile = 12, 48, 16
    a, tbl, counts, ntx = random_table(rng, mode, T, kmax)
    a[::7, GEOM[mode][2]] = a[::7, GEOM[mode][4]] = 1e-3      # wide ones
    n = a.shape[0]
    at = torch.from_numpy(a)
    idx = torch.from_numpy(np.minimum(tbl, n - 1)).long()
    rows = at[idx]                                            # (T, K, 16)
    px, py = rb.tile_pixels(T, ntx, tile, "cpu")
    alpha, _ = rb.slot_alpha(lambda c: rows[:, :, c:c + 1], px[:, None],
                             py[:, None], mode)               # (T, K, P)
    on = torch.arange(kmax)[None] < torch.from_numpy(counts)[:, None]
    alpha = torch.where(on[:, :, None], alpha, torch.zeros(()))
    trans = torch.ones(T, tile * tile)
    w = []
    for k in range(kmax):
        w.append(alpha[:, k] * trans)
        trans = trans * (1.0 - alpha[:, k])
    w = torch.stack(w, dim=1)                                 # (T, K, P)
    rects, owner = _warp_rects(ntx, tile, T)
    r = rects[:, None]
    culled = rb.warp_culled(rows[:, :, None], mode, r[..., 0], r[..., 1],
                            r[..., 2], r[..., 3])[:, :, owner]
    assert bool(culled.any()) and bool((w > 0).any())
    assert bool((w[culled] == 0).all())
    kept = torch.where(culled, torch.zeros(()), w).sum(dim=2)
    want = torch.zeros(n).index_add_(0, idx.reshape(-1), kept.reshape(-1))
    bins = TileBins(torch.from_numpy(tbl), on, torch.from_numpy(counts),
                    torch.zeros((), dtype=torch.int32))
    got = rb.blend_contrib(at, bins, ntx, T // ntx, tile, mode, 256)
    # two sums of the same 256 float32 weights per slot: 1e-5 relative
    # allows for another order of summation
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

"""The feature tables' row gather (``ops.row_gather.gather_rows``) on the
CPU, where its gradient is the plain version (``index_add_`` into zeros):
the forward equals ``t[idx]`` and the gradients equal autograd's through
``t[idx]`` bit for bit, for 1-D and (N, K) indices, a run of 100,000
entries at the last row, one table without a gradient and an empty index;
a gradient with respect to the query points alone forms no table
gradient; ``eval_neighbors`` through it equals the plain gathers. The
kernel itself runs only on the card (``chip_smoke.row_scatter_check``)."""

import numpy as np
import pytest
import torch

from pings_tpu_torch.models import neural_points as npm
from pings_tpu_torch.ops import row_gather as rg

ROWS = 1000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(seed, widths=(8, 8), grad=(True, True)):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(ROWS, f, generator=g).requires_grad_(r)
            for f, r in zip(widths, grad)]


def _indices(kind, seed):
    g = torch.Generator().manual_seed(seed)
    if kind == "1d":
        return torch.randint(0, ROWS, (5000,), generator=g)
    if kind == "nk":
        idx = torch.randint(0, ROWS, (700, 6), generator=g)
        idx[torch.rand(700, 6, generator=g) < 0.5] = ROWS - 1
        return idx
    if kind == "long_run":
        idx = torch.full((100_000,), ROWS - 1, dtype=torch.long)
        idx[::7] = torch.randint(0, ROWS, (idx[::7].numel(),), generator=g)
        return idx
    return torch.zeros((0, 6), dtype=torch.long)


def _grads(outs, tables, seed):
    """Gradients of a weighted sum of ``outs`` with respect to the tables
    that require one (None for the others)."""
    g = torch.Generator().manual_seed(seed)
    loss = sum(torch.sum(o * torch.randn(o.shape, generator=g))
               for o in outs)
    for t in tables:
        t.grad = None
    loss.backward()
    return [t.grad for t in tables]


@pytest.mark.parametrize("kind", ["1d", "nk", "long_run", "empty",
                                  "int32"])
def test_forward_and_gradient_equal_indexing(kind):
    idx = _indices(kind, 1) if kind != "int32" \
        else _indices("nk", 1).to(torch.int32)
    tables = _tables(2)
    plain = _grads([t[idx] for t in tables], tables, 3)
    n0 = rg.scatters()
    outs = rg.gather_rows(tables, idx)
    for o, t in zip(outs, tables):
        assert torch.equal(o, t[idx])
    got = _grads(outs, tables, 3)
    assert rg.scatters() == n0 + 1          # one scatter for both tables
    for a, b in zip(got, plain):
        assert a.shape == (ROWS, 8)
        assert torch.equal(a, b)


def test_one_table_without_a_gradient():
    idx = _indices("nk", 4)
    tables = _tables(5, widths=(8, 4), grad=(False, True))
    plain = _grads([t[idx] for t in tables], tables, 6)
    got = _grads(rg.gather_rows(tables, idx), tables, 6)
    assert got[0] is None and plain[0] is None
    assert torch.equal(got[1], plain[1])


def test_unused_output_gives_no_gradient():
    idx = _indices("1d", 7)
    tables = _tables(8)
    geo, _ = rg.gather_rows(tables, idx)
    geo.sum().backward()
    assert torch.equal(tables[0].grad,
                       torch.bincount(idx, minlength=ROWS)[:, None]
                       .expand(ROWS, 8).float())
    assert tables[1].grad is None


def test_no_grad_is_plain_indexing():
    idx = _indices("nk", 9)
    tables = _tables(10)
    n0 = rg.scatters()
    with torch.no_grad():
        outs = rg.gather_rows(tables, idx)
    assert all(not o.requires_grad for o in outs)
    assert all(torch.equal(o, t[idx]) for o, t in zip(outs, tables))
    assert rg.scatters() == n0


def test_refuses_other_devices_and_index_types():
    idx = torch.zeros(4, dtype=torch.long, device="meta")
    g = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rg.row_scatter(idx, [g], ROWS)
    tables = _tables(11)
    with pytest.raises(ValueError, match="int64 or int32"):
        rg.gather_rows(tables, torch.zeros(3, dtype=torch.int16))
    with pytest.raises(ValueError, match="one or two"):
        rg.gather_rows(tables * 2, torch.zeros(3, dtype=torch.long))
    assert rg.LAUNCHES == 0


def test_refuses_a_negative_row():
    """t[idx] would wrap -1 round to the last row; the backward would
    write before the gradient."""
    idx = _indices("nk", 12)
    idx[3, 2] = -1
    n0 = rg.scatters()
    with pytest.raises(RuntimeError, match="negative row index"):
        rg.gather_rows(_tables(12), idx)
    assert rg.scatters() == n0


def _small_map(seed):
    """A map of 600 random points with random features that require a
    gradient; its capacity is 1,023, so the dump row is row 1,023."""
    rng = np.random.default_rng(seed)
    m = npm.init_map(_cfg(), device="cpu")
    pts = (rng.uniform(-1.5, 1.5, (600, 3))).astype(np.float32)
    npm.insert_points(m, torch.from_numpy(pts),
                      torch.from_numpy(rng.uniform(size=(600, 3))
                                       .astype(np.float32)),
                      torch.ones(600, dtype=torch.bool),
                      torch.tensor([1.0, 0, 0, 0]).repeat(600, 1),
                      0, torch.zeros(8), 1e9)
    with torch.no_grad():
        m.geo_feat.normal_(generator=torch.Generator().manual_seed(seed))
        m.color_feat.normal_(generator=torch.Generator().manual_seed(seed))
    m.geo_feat.requires_grad_(True)
    m.color_feat.requires_grad_(True)
    return m, rng


def _cfg():
    from pings_tpu_torch.config import Config

    return Config.load(overrides=dict(
        max_points=1023, buffer_size=1 << 12, voxel_size_m=0.2,
        feature_dim=8, color_feature_dim=8))


def _plain_eval(m, qpts, kidx, r, alpha):
    """``eval_neighbors``' features with the plain gathers ``t[kidx]``."""
    res, cap = m.resolution, m.capacity
    kinvalid = kidx >= cap
    diff = qpts[:, None, :] - m.positions[kidx]
    d2 = torch.sum(diff * diff, dim=-1)
    kinvalid = kinvalid | (d2 > ((r + alpha) * res) ** 2)
    kidx = torch.where(kinvalid, torch.full_like(kidx, cap), kidx)
    ki = kinvalid[..., None]
    zero = torch.zeros(())
    return (torch.where(ki, zero, m.geo_feat[kidx]),
            torch.where(ki, zero, m.color_feat[kidx]))


def test_eval_neighbors_gradient_equals_plain_gathers():
    m, rng = _small_map(12)
    q = torch.from_numpy(rng.uniform(-1.6, 1.6, (900, 3)).astype(np.float32))
    kidx = npm.query_neighbor_idx(m, q, 6, 1, 0.2)
    assert bool((kidx == m.capacity).any())     # invalid neighbours: dump
    r = npm.eval_neighbors(m, q, kidx, 1, 0.2)
    got = _grads([r.feat[..., :8], r.color_feat[..., :8]],
                 [m.geo_feat, m.color_feat], 0)
    want = _grads(_plain_eval(m, q, kidx, 1, 0.2),
                  [m.geo_feat, m.color_feat], 0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
        # the dump row is in the gradient, an exact zero
        assert a.shape[0] == m.capacity + 1
        assert torch.equal(a[-1], torch.zeros(8))


def test_point_gradient_forms_no_table_gradient():
    """The tracker's gradient (``field.sdf_grad_analytical``): with
    respect to the points alone, the tables requiring a gradient."""
    m, rng = _small_map(13)
    n0 = rg.scatters()
    p = torch.from_numpy(rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
                         ).requires_grad_(True)
    kidx = npm.query_neighbor_idx(m, p.detach(), 6, 1, 0.2)
    r = npm.eval_neighbors(m, p, kidx, 1, 0.2)
    assert r.feat.requires_grad
    (g,) = torch.autograd.grad((r.feat.sum(-1) * r.weights).sum(), p)
    assert torch.isfinite(g).all() and bool(g.abs().max() > 0)
    assert m.geo_feat.grad is None and m.color_feat.grad is None
    assert rg.scatters() == n0

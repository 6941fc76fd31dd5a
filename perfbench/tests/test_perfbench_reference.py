"""The plain reference against cases worked out by hand; it imports
nothing of the program to do so."""

import math

import numpy as np
import pytest
import torch

from perfbench.reference import field as rf
from perfbench.reference import mapping as rm
from perfbench.reference import render as rr
from perfbench.reference import train as rt


def _row(mx, my, a, b, c, opa, rgb, depth):
    """One 3DGS attribute row."""
    r = torch.zeros(16)
    r[0:3] = torch.tensor(rgb)
    r[3] = depth
    r[7] = 1.0
    r[8], r[9] = mx, my
    r[10], r[11], r[12] = a, b, c
    r[13] = opa
    return r


def test_two_gaussians_in_one_tile_blend_front_to_back():
    g0 = _row(3.5, 2.5, 0.5, 0.0, 0.5, 0.6, [1.0, 0.0, 0.0], 2.0)
    g1 = _row(4.0, 2.0, 0.1, 0.02, 0.2, 0.9, [0.0, 0.0, 1.0], 5.0)
    attr = torch.stack([g0, g1])
    tbl = torch.zeros((1, 8), dtype=torch.long)
    tbl[0, :2] = torch.tensor([0, 1])
    counts = torch.tensor([2])
    acc, trans, hits, contrib = rr.blend(attr, tbl, counts, ntx=1,
                                         tile=16, mode="3dgs")
    # pixel (3, 2): centre (3.5, 2.5)
    p = 2 * 16 + 3
    q0 = 0.0
    a0 = 0.6 * math.exp(-0.5 * q0)
    dx, dy = 3.5 - 4.0, 2.5 - 2.0
    q1 = 0.1 * dx * dx + 0.2 * dy * dy + 2 * 0.02 * dx * dy
    a1 = 0.9 * math.exp(-0.5 * q1)
    assert acc[0, 0, p].item() == pytest.approx(a0, rel=1e-6)
    assert acc[0, 2, p].item() == pytest.approx((1 - a0) * a1, rel=1e-6)
    assert acc[0, 3, p].item() == pytest.approx(a0 * 2 + (1 - a0) * a1 * 5,
                                                rel=1e-6)
    assert trans[0, p].item() == pytest.approx((1 - a0) * (1 - a1),
                                               rel=1e-6)
    # pixel (15, 15) is past the first splat's 3 sigma (q = 9 * 2 ...)
    far = 15 * 16 + 15
    q_far = 0.5 * (15.5 - 3.5) ** 2 + 0.5 * (15.5 - 2.5) ** 2
    assert q_far >= 9 and acc[0, 0, far].item() == 0.0
    assert hits.item() > 2
    # each Gaussian's contribution is its blend weights summed over the
    # tile: the first one's are its alphas, and with the second's the
    # sum is the tile's opacity
    assert contrib[0].item() == pytest.approx(
        acc[0, 7].sum().item() - contrib[1].item(), rel=1e-5)
    assert contrib[0].item() > a0 and contrib[1].item() > (1 - a0) * a1
    assert contrib.sum().item() == pytest.approx(acc[0, 7].sum().item(),
                                                 rel=1e-6)


def test_the_closer_gaussian_is_listed_first():
    m2d = torch.tensor([[8.0, 8.0], [8.0, 8.0], [40.0, 8.0]])
    depth = torch.tensor([5.0, 2.0, 1.0])
    radius = torch.tensor([3.0, 3.0, 3.0])
    ok = torch.tensor([True, True, True])
    tbl, counts = rr.bin_tiles(m2d, depth, radius, ok, 48, 16, 16, 8)
    assert counts.tolist() == [2, 0, 1]
    assert tbl[0, :2].tolist() == [1, 0]
    assert tbl[2, 0].item() == 2


def test_a_one_layer_and_a_two_layer_decoder():
    w = torch.tensor([[1.0, -2.0], [0.5, 3.0]])
    b = torch.tensor([0.25, -1.0])
    x = torch.tensor([[2.0, 1.0]])
    one = rr.mlp({"w": [w], "b": [b]}, x)
    assert one.tolist() == [[2.75, -2.0]]
    w2 = torch.tensor([[1.0], [1.0]])
    two = rr.mlp({"w": [w, w2], "b": [b, None]}, x)
    assert two.tolist() == [[2.75]]      # ReLU cuts the -2
    low = rr.mlp({"w": [w], "b": [b]}, x * (1 + 2 ** -12), low=True)
    assert low.dtype == torch.float32
    assert low.tolist() == [[2.75, -2.0]]   # TF32 drops the 2**-12


def test_tf32_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12)])
    assert rr.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                                   -1.0]


def test_local_mask_keeps_whole_bins_nearest_first():
    pos = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0], [3.0, 0, 0],
                        [50.0, 0, 0], [0.5, 0, 0]])
    valid = torch.tensor([True, True, True, False, True, True])
    m = rr.local_mask(pos, valid, torch.zeros(3), radius=10.0, max_local=3)
    # the invalid and the far point are out, the dump row (last) too
    assert m.tolist() == [True, True, False, False, False, False]


def test_adamw_first_step_moves_by_the_learning_rate():
    p = torch.tensor([1.0, -2.0])
    g = torch.tensor([0.5, -0.25])
    z = torch.zeros(2)
    after = rt.adamw(p, g, z, z, 0, lr=1e-3, eps=1e-15, wd=0.0)
    # float32 subtraction from parameters of order 1 keeps ~1e-4 of it
    np.testing.assert_allclose((after - p).numpy(), [-1e-3, 1e-3],
                               rtol=1e-4)


def test_ssim_of_an_image_with_itself_is_one():
    img = torch.rand(20, 24, 3, generator=torch.Generator().manual_seed(0))
    assert rt.ssim(img, img).item() == pytest.approx(1.0, abs=1e-6)
    assert rt.ssim(img, 1 - img).item() < 0.5


def test_tf32_rounding_passes_the_gradient():
    w = torch.tensor([[1.0 + 2 ** -12], [2.0]], requires_grad=True)
    x = torch.tensor([[3.0, 1.0]])
    rr.mlp({"w": [w], "b": [None]}, x, low=True).sum().backward()
    assert w.grad.tolist() == [[3.0], [1.0]]


def test_downsample_keeps_the_point_nearest_each_voxel_centre():
    pts = torch.tensor([[0.05, 0.05, 0.05], [0.02, 0.06, 0.04],
                        [0.09, 0.01, 0.01], [0.35, 0.05, 0.05],
                        [9.0, 9.0, 9.0]])
    mask = torch.tensor([True, True, True, True, False])
    keep = rm.downsample_mask(pts, mask, 0.1)
    # voxel (0,0,0): centre (0.05, 0.05, 0.05) is point 0 itself; voxel
    # (3,0,0) has point 3 alone; point 4 is masked out
    assert keep.tolist() == [True, False, False, True, False]


def test_insert_admits_new_voxels_once_and_refreshes_matches():
    cap, H, res = 8, 64, 1.0
    st = {"positions": torch.zeros((cap + 1, 3)),
          "ts_create": torch.zeros(cap + 1, dtype=torch.int32),
          "ts_update": torch.zeros(cap + 1, dtype=torch.int32),
          "valid_mask": torch.zeros(cap + 1, dtype=torch.bool),
          "hash_table": torch.full((H,), -1, dtype=torch.int32),
          "count": 0}
    travel = torch.zeros(10)
    pts = torch.tensor([[0.5, 0.5, 0.5], [0.6, 0.4, 0.5], [2.5, 0.5, 0.5]])
    out = rm.insert(st, pts, torch.ones(3, dtype=torch.bool), 1, travel,
                    100.0, res)
    # two voxels: the first point wins its voxel's slot, the second of
    # that voxel is dropped
    assert out["count"] == 2
    assert out["positions"][:2].tolist() == [[0.5, 0.5, 0.5],
                                             [2.5, 0.5, 0.5]]
    b = rm.voxel_hash(torch.tensor([[2, 0, 0]]), H)
    assert int(out["hash_table"][b]) == 1
    again = rm.insert(out, pts[:1] + 0.1, torch.ones(1, dtype=torch.bool),
                      3, travel, 100.0, res)
    assert again["count"] == 2 and int(again["ts_update"][0]) == 3
    assert int(again["ts_create"][0]) == 1


def test_the_local_window_cuts_whole_distance_bins_nearest_first():
    pos = torch.tensor([[1.0, 0, 0], [2.0, 0, 0], [2.1, 0, 0], [50.0, 0, 0],
                        [0.0, 0, 0]])
    valid = torch.tensor([True, True, True, True, True])
    ts = torch.zeros(5, dtype=torch.int32)
    travel = torch.zeros(4)
    loc, sur = rm.local_window(pos, valid, ts, ts, torch.zeros(3), 0,
                               travel, 10.0, 100.0, True, 2, 8)
    # points 1 and 2 share a bin (14 m / 128 a bin), which does not fit
    # beside point 0 under a cap of 2: the window keeps point 0 alone
    assert loc.tolist() == [True, False, False, False, False]
    assert sur.tolist() == [False, True, True, False, False]


def _one_layer_sdf(gain):
    # a decoder of one linear layer: the SDF of a neighbour is gain times
    # the first feature
    w = torch.zeros((11, 1))
    w[0, 0] = gain
    return {"w": [w], "b": [None]}


def test_neighbours_weights_and_a_one_layer_sdf():
    res = 1.0
    pos = torch.tensor([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [0.0, 0.0, 0.0]])
    H = 1 << 20      # no two cells of the stencil share a bucket
    table = torch.full((H,), -1, dtype=torch.int32)
    for i in range(2):
        c = torch.floor(pos[i:i + 1] / res).to(torch.int32)
        table[rm.voxel_hash(c, H)] = i
    feat = torch.zeros((3, 8))
    feat[0, 0], feat[1, 0] = 1.0, 3.0
    m = rf.MapState(pos, torch.tensor([True, True, False]), table, feat,
                    feat, res)
    q = torch.tensor([[0.75, 0.5, 0.5]])
    kidx = rf.neighbours(m, q, 6, 1, 0.2)
    # the hash takes |h|, so the cell (-1, 0, 0) reads the bucket of
    # (1, 0, 0): point 1 is listed twice, as the program lists it
    assert kidx[0].tolist() == [0, 1, 1, 2, 2, 2]
    f, w, v = rf.evaluate(m, q, kidx, 1, 0.2)
    # inverse squared distances 1/0.0625 and 1/0.5625 (+1e-6), normalised
    w0 = 1 / (0.0625 + 1e-6)
    w1 = 1 / (0.5625 + 1e-6)
    assert w[0, 0].item() == pytest.approx(w0 / (w0 + 2 * w1), rel=1e-5)
    assert bool(v[0])
    s = rf.sdf(_one_layer_sdf(0.5), f, w, 1.0)
    assert s.item() == pytest.approx(
        0.5 * (w0 * 1 + 2 * w1 * 3) / (w0 + 2 * w1), rel=1e-5)


def test_bce_of_a_prediction_equal_to_its_label():
    """BCE of logits x against targets sigmoid(x) is the entropy of
    sigmoid(x); the eikonal term of a unit gradient is 0."""
    import types
    cfg = types.SimpleNamespace(
        sigma_sigmoid_m=0.1, logistic_gaussian_ratio=10.0, num_nei_cells=1,
        search_alpha=0.2, voxel_size_m=1.0, num_grad_step_ratio=0.1,
        bs=8, gradient_decimation=1, query_nn_k=6, incidence_weight_on=False)
    res = 1.0
    pos = torch.tensor([[0.5, 0.5, 0.5], [0.0, 0.0, 0.0]])
    H = 1024
    table = torch.full((H,), -1, dtype=torch.int32)
    table[rm.voxel_hash(torch.zeros((1, 3), dtype=torch.int32), H)] = 0
    feat = torch.zeros((2, 8))
    m = rf.MapState(pos, torch.tensor([True, False]), table, feat, feat,
                    res)
    # the SDF decoder reads the offset's x (column 8) and the scale is 1:
    # the SDF is the distance in x from the neighbour, 0.2 m at the
    # points, with the gradient (1, 0, 0)
    w = torch.zeros((11, 1))
    w[8, 0] = 1.0
    dec = {"w": [w], "b": [torch.tensor([0.0])]}
    pts = torch.tensor([[0.7, 0.5, 0.5]] * 8)
    lab = torch.full((8,), 0.2)
    batch = (pts, lab, None, torch.ones(8), torch.ones(8, dtype=torch.bool))
    bce, eik = rf.batch_terms(m, dec, batch, cfg)
    p = 1 / (1 + math.exp(-2.0))
    assert bce.item() == pytest.approx(
        -(p * math.log(p) + (1 - p) * math.log(1 - p)), rel=1e-5)
    assert eik.item() == pytest.approx(0.0, abs=1e-8)

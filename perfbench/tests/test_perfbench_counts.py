"""The frozen counts of work and the least times on hand-built tables."""

import types

import pytest

from perfbench.harness import counts


def test_mlp_flops_counts_each_layer_once():
    assert counts.mlp_flops(16, 64, 1, 12) == 2 * (16 * 64 + 64 * 12)
    assert counts.mlp_flops(11, 64, 2, 1) == 2 * (11 * 64 + 64 * 64 + 64)


def test_blend_bytes_on_a_hand_built_table():
    # 3 tiles of 256 pixels, 10 listed slots, 4 distinct Gaussians
    fwd = counts.blend_bytes("fwd", 3, 10, 4, 256, surfel=True)
    assert fwd == 4 * 10 + 4 * 3 + 4 * 16 * 4 + 4 * 3 * 256 * (8 + 1 + 1)
    bwd = counts.blend_bytes("bwd", 3, 10, 4, 256, surfel=False)
    assert bwd == (4 * 10 + 4 * 3 + 4 * 16 * 4 + 4 * 3 * 256 * 11
                   + 4 * 16 * 4)


def test_least_time_names_its_bound():
    t, bound = counts.least_time("fwd", "surfel", hits=0, n_tiles=3,
                                 n_slots=10, n_ids=4, pixels_per_tile=256)
    assert bound == "bytes"
    assert t == pytest.approx(counts.blend_bytes(
        "fwd", 3, 10, 4, 256, True) / counts.PEAK_BYTES)
    t, bound = counts.least_time("bwd", "3dgs", hits=10 ** 9, n_tiles=3,
                                 n_slots=10, n_ids=4, pixels_per_tile=256)
    assert bound == "flops"
    assert t == pytest.approx(10 ** 9 * 78 / counts.PEAK_FLOPS)


def _cfg(**kw):
    base = dict(spawn_n_gaussian=4, feature_dim=8, color_feature_dim=8,
                gaussian_mlp_hidden_dim=64, gaussian_mlp_level=1,
                geo_mlp_hidden_dim=64, geo_mlp_level=1, dist_concat_on=True,
                view_concat_on=True, monochrome=False, query_nn_k=6,
                bs=4096, gradient_decimation=10, incidence_weight_on=False,
                gs_sdf_sample_count=256, max_local_points=65536,
                gs_type="gaussian_surfel", source_max_count=8192)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_iteration_counts_follow_the_configuration():
    cfg = _cfg()
    d = counts.decoder_flops(cfg)
    assert d["sdf"] == 2 * (11 * 64 + 64)
    gauss = 2 * (16 * 64 * 3 + 64 * (12 + 16 + 12)) + 2 * (17 * 64 + 64 * 4) \
        + 2 * (19 * 64 + 64 * 12)
    assert d["gauss"] == gauss
    rows = 6 * (4096 + 6 * 409 + 7 * 256)
    assert counts.gs_iteration_flops(cfg, 100) == pytest.approx(
        3.0 * (65536 * gauss + rows * d["sdf"]) + 100 * (37 + 87))
    inc = _cfg(incidence_weight_on=True)
    assert counts.gs_iteration_flops(inc, 0) > counts.gs_iteration_flops(
        cfg, 0)
    assert counts.view_flops(cfg, 10) == 65536 * gauss + 10 * 37
    assert counts.tracking_iteration_flops(cfg) == 3.0 * 8192 * 6 * d["sdf"]

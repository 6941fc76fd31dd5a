"""The benchmark's frozen counts of work, and the card's published peaks.

The counts depend on the configuration and on what the reference finds
in the cell's views, never on how the program does the work, so a later
implementation that does less work reads a higher share.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit:
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# FLOPs of one slot-pixel pair that the blend needs (alpha >= 1/255 while
# the transmittance is above 1e-4): the multiplies, adds, divisions and
# exponentials of the plain formulas (reference/render.py ``_slot`` and
# ``blend``; the backward of the port's suffix identity), comparisons not
# counted. Forward: offsets 2, quadratic form 9, alpha 3, weight 1,
# channels 2 x 8, transmittance 2 (3DGS 33); the surfel mode adds the
# plane depth 5 and its row (37). Backward: the forward's alpha again 14,
# phi 16, running sum 2, dL/dalpha 7, dq and dexp 4, channels 16, centre
# and conic 15, opacity 2, transmittance 2 (3DGS 78); surfel adds the
# plane-depth terms 9 (87).
FWD_FLOPS = {"3dgs": 33, "surfel": 37}
BWD_FLOPS = {"3dgs": 78, "surfel": 87}
NCH = 16       # float32 attribute columns per Gaussian
NOUT = 8       # blended rows per pixel
MODES = {"3d_gs": "3dgs", "gaussian_surfel": "surfel"}


def mlp_flops(in_dim: int, hidden: int, levels: int, out_dim: int) -> int:
    """Multiply-adds x 2 of one row through Linear -> ReLU -> ... ->
    Linear (biases and ReLUs not counted)."""
    dims = [in_dim] + [hidden] * max(levels, 1) + [out_dim]
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def decoder_flops(cfg) -> dict:
    """FLOPs per row of each decoder at the configuration's widths."""
    K = cfg.spawn_n_gaussian
    pf = cfg.feature_dim + cfg.color_feature_dim
    gh, gl = cfg.gaussian_mlp_hidden_dim, cfg.gaussian_mlp_level
    return {
        "sdf": mlp_flops(cfg.feature_dim + 3, cfg.geo_mlp_hidden_dim,
                         cfg.geo_mlp_level, 1),
        "gauss": (mlp_flops(pf, gh, gl, 3 * K) + mlp_flops(pf, gh, gl, 4 * K)
                  + mlp_flops(pf, gh, gl, 3 * K)
                  + mlp_flops(pf + (1 if cfg.dist_concat_on else 0), gh, gl,
                              K)
                  + mlp_flops(pf + (3 if cfg.view_concat_on else 0), gh, gl,
                              (1 if cfg.monochrome else 3) * K)),
    }


def gs_iteration_flops(cfg, hits: float) -> float:
    """One joint GS+SDF iteration: the Gaussian heads over the local
    window's rows, the SDF decoder over the replay batch's neighbours (and
    its six finite-difference probes where the eikonal or incidence terms
    take them) and over the sampled Gaussian centres, each forward and
    backward (x3), and the blend forward and backward over ``hits``
    needed slot-pixel pairs."""
    d = decoder_flops(cfg)
    k = cfg.query_nn_k
    eik_n = max(cfg.bs // max(cfg.gradient_decimation, 1), 8)
    probes = cfg.bs if cfg.incidence_weight_on else eik_n
    sdf_rows = k * (cfg.bs + 6 * probes + 7 * cfg.gs_sdf_sample_count)
    mode = MODES[cfg.gs_type]
    return (3.0 * (cfg.max_local_points * d["gauss"] + sdf_rows * d["sdf"])
            + hits * (FWD_FLOPS[mode] + BWD_FLOPS[mode]))


def tracking_iteration_flops(cfg) -> float:
    """One tracker iteration: the SDF decoder over the source points'
    neighbours with its analytic gradient (x3)."""
    return 3.0 * cfg.source_max_count * cfg.query_nn_k * \
        decoder_flops(cfg)["sdf"]


def view_flops(cfg, hits: float) -> float:
    """One served view: the Gaussian heads forward over the local window
    and the forward blend over ``hits`` needed pairs."""
    return (cfg.max_local_points * decoder_flops(cfg)["gauss"]
            + hits * FWD_FLOPS[MODES[cfg.gs_type]])


def blend_bytes(kind: str, n_tiles: int, n_slots: int, n_ids: int,
                pixels_per_tile: int, surfel: bool) -> int:
    """Bytes the blend must move at least: the table's ids and counts,
    each listed Gaussian's attribute row once, and the outputs once
    (forward: 8 rows, the transmittance and, in surfel mode, the median
    depth per pixel); the backward reads the 8 row cotangents, those of
    the transmittance, rho and the saved transmittance per pixel and
    writes one gradient row per listed Gaussian."""
    P = pixels_per_tile
    common = 4 * n_slots + 4 * n_tiles + 4 * NCH * n_ids
    if kind == "fwd":
        return common + 4 * n_tiles * P * (NOUT + 1 + (1 if surfel else 0))
    return common + 4 * n_tiles * P * (NOUT + 3) + 4 * NCH * n_ids


def least_time(kind: str, mode: str, hits: int, n_tiles: int, n_slots: int,
               n_ids: int, pixels_per_tile: int):
    """(seconds, bound) of the least time the card could take."""
    flops = hits * (FWD_FLOPS if kind == "fwd" else BWD_FLOPS)[mode]
    nbytes = blend_bytes(kind, n_tiles, n_slots, n_ids, pixels_per_tile,
                         mode == "surfel")
    tf, tb = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (tf, "flops") if tf >= tb else (tb, "bytes")

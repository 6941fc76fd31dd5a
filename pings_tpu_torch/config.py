"""Configuration system (a copy of ``pings_tpu/config.py``).

The port keeps its own copy because importing anything from ``pings_tpu``
runs that package's ``__init__``, which imports JAX. The two files must
read the same YAML into the same values: ``tests/test_torch_*`` load the
committed ``config_all.yaml`` files through both.

Same semantics as the JAX package: a flat typed attribute space, a
12-section YAML overlay where *presence of a section toggles the
subsystem* (``tracker:``, ``pgo:``, ``gs:``), overrides applied on top,
derived parameters computed last.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml


@dataclass
class Config:
    # ---------------- setting ----------------
    name: str = "dummy"
    run_name: str = ""
    output_root: str = "./experiments"
    pc_path: str = ""
    data_loader_name: str = "generic"
    data_loader_seq: str = ""
    begin_frame: int = 0
    end_frame: int = -1
    step_frame: int = 1
    seed: int = 42
    device: str = "tpu"
    silence: bool = False
    deskew: bool = False
    kitti_correction_on: bool = False
    correction_deg: float = 0.195
    # optional monocular depth prior (reference Metric3D path,
    # slam_dataset.py:333-480); provider resolves lazily and the system
    # degrades to LiDAR-only depth when its weights are unavailable
    mono_depth_on: bool = False
    mono_depth_provider: str = "dpt"

    # ---------------- process ----------------
    min_range: float = 2.5
    max_range: float = 60.0
    min_z: float = -10.0
    max_z: float = 60.0
    rand_downsample: bool = False
    vox_down_m: float = 0.08  # derived default: 0.05 * max_range / 60 style
    rand_down_r: float = 1.0
    dynamic_filter_on: bool = False
    dynamic_certainty_thre: float = 5.0
    dynamic_sdf_ratio_thre: float = 1.5
    # drop labeled moving objects from semantic supervision (reference
    # filter_moving_object, utils/config.py:78; consumed by the
    # SemanticKITTI label reduction in data/kitti.py)
    filter_moving_object: bool = True

    # ---------------- sampler ----------------
    surface_sample_range_m: float = 0.25
    surface_sample_n: int = 3
    free_sample_begin_ratio: float = 0.3
    free_sample_end_dist_m: float = 1.0
    free_front_n: int = 2
    free_behind_n: int = 1

    # ---------------- neuralpoints ----------------
    voxel_size_m: float = 0.3
    max_points: int = 1 << 20          # capacity of the global point buffer
    max_local_points: int = 1 << 17    # capacity of the local map view
    max_surrounding_points: int = 1 << 13  # capacity of the frozen
                                       # surrounding-annulus render background
    buffer_size: int = 1 << 22         # spatial hash table size
    feature_dim: int = 8
    color_feature_dim: int = 8
    feature_std: float = 0.0
    query_nn_k: int = 6
    num_nei_cells: int = 2             # stencil radius in voxels
                                       # (reference utils/config.py:96)
    search_alpha: float = 0.2
    use_mid_ts: bool = True
    local_map_travel_dist_ratio: float = 5.0
    local_map_radius: float = 65.0     # derived: ~1.05 * max_range
    sorrounding_map_radius: float = 91.0  # derived: 1.4 * local_map_radius
    max_prune_certainty: float = 2.0
    color_on: bool = True
    semantic_on: bool = False

    # ---------------- decoder ----------------
    mlp_bias_on: bool = True
    geo_mlp_hidden_dim: int = 64
    geo_mlp_level: int = 1
    color_mlp_hidden_dim: int = 64
    color_mlp_level: int = 1
    sem_mlp_hidden_dim: int = 64
    sem_mlp_level: int = 1
    gaussian_mlp_hidden_dim: int = 64
    gaussian_mlp_level: int = 1
    freeze_after_frame: int = 40
    sem_class_count: int = 20

    # ---------------- loss ----------------
    sigma_sigmoid_m: float = 0.1
    logistic_gaussian_ratio: float = 0.55
    proj_correction_on: bool = False
    loss_weight_on: bool = False
    dist_weight_scale: float = 0.8
    ekional_loss_on: bool = True
    weight_e: float = 0.5
    numerical_grad: bool = True
    gradient_decimation: int = 10
    # incidence-angle down-weighting of projective SDF labels
    # (losses.incidence_weights; the reference's data_sampler.py:157
    # TODO): weight = floor + (1-floor)*|cos(field grad, ray)|. Costs a
    # full-batch FD gradient per step (cheap with the shared neighbor
    # table). Default OFF after a two-sided experiment
    # (scripts/diag/sdf_bias_probe.py + a closed-loop run): with GT poses
    # it HALVES the ground zero-crossing bias (-14.8 -> -7.1 mm) and the
    # tracker bias ((-50,+14) -> (-19,+9) mm), but in the closed SLAM
    # loop the weights depend on the still-untrained field gradient, the
    # young map destabilizes (valid ratio 0.95 -> 0.58 within 10 frames)
    # and the run aborts — a field-independent incidence estimate (scan
    # normals) is the prerequisite for enabling it online
    # r5: the prerequisite is built — ops/scan_normals.py estimates
    # incidence from the raw scan (voxel-covariance PCA), independent of
    # the field, applied to surface-sample weights at sampling time.
    # incidence_source "scan" (default) uses it; "field" keeps the r4
    # field-gradient variant (sdf_mapper) for comparison.
    incidence_weight_on: bool = False
    incidence_weight_floor: float = 0.1
    incidence_source: str = "scan"
    incidence_normal_voxel_m: float = 0.6
    num_grad_step_ratio: float = 0.2
    consistency_loss_on: bool = False
    weight_c: float = 0.5
    weight_s: float = 1.0
    weight_i: float = 1.0

    # ---------------- continual (replay pool) ----------------
    pool_capacity: int = 1 << 22
    bs_new_sample: int = 2048
    new_certainty_thre: float = 1.0
    pool_filter_freq: int = 10
    window_radius: float = 60.0
    local_sample_buffer: int = 1 << 20

    # ---------------- tracker ----------------
    track_on: bool = True
    photometric_loss_on: bool = False
    photometric_loss_weight: float = 0.01
    source_vox_down_m: float = 0.6
    source_max_count: int = 8192
    reg_iter_n: int = 50
    reg_term_thre_deg: float = 0.01
    reg_term_thre_m: float = 0.0005
    reg_gm_k: float = 0.3
    reg_gm_grad_anomaly: float = 3.0
    reg_lm_lambda: float = 1e-4
    reg_min_grad_norm: float = 0.4
    reg_max_grad_norm: float = 2.5
    max_sdf_std_ratio: float = 1.0
    valid_ratio_thre: float = 0.15
    max_valid_final_sdf_residual_cm: float = 30.0
    max_valid_dist_residual_cm: float = 30.0
    eigenvalue_check: bool = True
    eigenvalue_ratio_thre: float = 0.005
    stop_frame_thre: int = 20
    lose_track_abort_n: int = 20

    # ---------------- pgo ----------------
    pgo_on: bool = False
    pgo_freq_frame: int = 30
    pgo_with_pose_prior: bool = False
    pgo_tran_std: float = 0.04
    pgo_rot_std: float = 0.01
    pgo_error_thre_frame: float = 0.5
    # cooldown: frames after a successful loop before detecting again
    # (reference pgo_freq, utils/config.py:355 + pings.py:564) — without
    # it a revisit segment fires a loop EVERY frame (27 in the first
    # completed circuit run), each re-optimizing the graph and re-posing
    # the map, and the repeated snapping made SLAM ATE 4x worse than
    # odometry-only
    pgo_freq_frame: int = 30
    use_reg_cov_mat: bool = False
    pgo_max_iter: int = 50
    # drift-scaled odometry covariances (see slam/pgo.py): per-edge std =
    # pgo_tran_std + pgo_drift_per_m * edge_translation (the reference's
    # 1 %/m drift estimate, utils/pgo.py:321-336, promoted from loop
    # gating into the factor weights)
    pgo_drift_per_m: float = 0.01
    pgo_drift_rot_deg_per_m: float = 0.05
    # informativeness (SNR) gate: only APPLY a verified loop when its
    # implied correction exceeds this multiple of the loop measurement
    # std — at 300 m scale the measured drift (~0.2-0.4 m, odometry ATE
    # 0.21 m) is the same order as scan-to-map registration noise, and
    # applying such a loop redistributes systematic SDF-bias drift into
    # a WORSE trajectory (r4: SLAM 1.99 m vs odometry 0.21 m; a
    # GT-perfect factor still lands at 0.40 m). Loops pay when drift is
    # random-walk dominated (km scale / noisy odometry) — exactly when
    # the correction clears this gate. Skipped loops are counted in
    # metrics (n_loops_uninformative). 0 disables the gate.
    pgo_min_loop_snr: float = 5.0
    # loop verification gates (r5): the 20260822_052655 run applied ONE
    # loop whose registration carried a multi-degree yaw error — the
    # fixed 20 deg rotation gate let it through and PGO smeared ~16 deg
    # across the chain (SLAM ATE 2.05 m vs odometry 0.13 m). (a) the
    # rotational correction must be explainable by rotational drift:
    # bound = max(floor, 3 * pgo_drift_rot_deg_per_m * travel-since-
    # loop); (b) the loop registration's weighted mean residual must be
    # comparable to the SAME frame's odometry registration residual — a
    # mis-locked match on self-similar geometry converges with a clearly
    # higher residual than a true revisit. 0 disables either gate.
    pgo_loop_rot_floor_deg: float = 2.0
    pgo_max_loop_res_ratio: float = 2.0

    # ---------------- validation-only odometry noise injection ---------
    # perturb each committed tracker relative pose with random-walk noise
    # (std per meter of edge motion): emulates the km-scale regime where
    # drift is random-walk dominated so loop-closure value can be
    # measured on the 280 m validation circuit (VERDICT r4 item 3a).
    odom_noise_std_per_m: float = 0.0
    odom_noise_rot_deg_per_m: float = 0.0
    odom_noise_seed: int = 0

    # ---------------- loop detection ----------------
    local_map_context: bool = True
    loop_with_feature: bool = False
    min_loop_travel_dist_ratio: float = 4.0
    local_map_context_latency: int = 5
    context_shape: List[int] = field(default_factory=lambda: [20, 60])
    context_num_candidates: int = 1
    context_cosdist_threshold: float = 0.25
    context_virtual_side_count: int = 5
    context_virtual_step_m: float = 2.0
    npmc_max_dist: float = 60.0
    max_loop_dist: float = 8.0
    voxel_down_before_context: bool = True

    # ---------------- optimizer ----------------
    mapping_iters: int = 15
    new_obs_ratio_based_iters: bool = True
    adaptive_iters: bool = True
    # new-observation-ratio thresholds for the adaptive iteration offset
    # (reference utils/config.py:218-220, mapper.py:499-512)
    new_sample_ratio_less: float = 0.02
    new_sample_ratio_more: float = 0.15
    new_sample_ratio_restart: float = 0.3
    lr: float = 0.01
    lr_mlp_base: float = 1e-3
    lr_exposure: float = 1e-3
    lr_cam_dr: float = 1e-4
    lr_cam_dt: float = 1e-4
    weight_decay: float = 0.0
    adam_eps: float = 1e-15
    bs: int = 16384
    infer_bs: int = 131072           # derived: 8 * bs

    # ---------------- gs (gaussian splatting) ----------------
    gs_on: bool = True
    gs_type: str = "gaussian_surfel"  # reference default (utils/config.py:225); "3d_gs" | "gaussian_surfel" | "2d_gs"
    spawn_n_gaussian: int = 8
    displacement_range_ratio: float = 1.0
    unit_scale_ratio: float = 0.5
    max_scale_ratio: float = 3.0
    dist_concat_on: bool = True
    view_concat_on: bool = True
    learn_color_residual: bool = True
    monochrome: bool = False
    gs_iters: int = 50
    init_iter_ratio: int = 20
    img_pool_size: int = 10
    long_term_pool_size: int = 40
    train_img_downrate: int = 1
    long_term_train_down: bool = False  # train long-term pool one pyramid
                                        # level coarser (ref config.py:254)
    gs_keyframe_interval: int = 1
    # hold out every Nth frame from GS keyframing entirely (0 = off): the
    # held-out views never enter the training camera pool, mirroring the
    # reference's train_view=False cameras (utils/mapper.py:669,
    # cameras.py:35) so inspect_map --eval-every N measures TRUE
    # novel-view quality (VERDICT r3: the round-3 "held-out" numbers were
    # train views)
    gs_eval_hold_out_every: int = 0
    sample_latest_prob: float = 0.3
    sample_short_term_prob: float = 0.4
    lambda_ssim: float = 0.2
    lambda_depth: float = 0.01
    inverse_depth_loss: bool = False
    lambda_normal_depth_consist: float = 0.01
    lambda_mono_normal: float = 0.0
    lambda_sky: float = 0.01
    lambda_opacity_ent: float = 0.01
    lambda_isotropic: float = 0.0
    lambda_area: float = 0.0
    lambda_distortion: float = 0.0
    gs_sdf_consistency_on: bool = True
    lambda_gs_sdf_consist: float = 0.1
    lambda_gs_sdf_normal_consist: float = 0.1
    gs_sdf_sample_count: int = 1024
    gs_invalid_check_on: bool = True
    gs_invalid_sdf_thre_ratio: float = 3.0
    exposure_correction_on: bool = False
    affine_exposure_correction: bool = False
    cam_pose_train_on: bool = False
    sky_on: bool = False
    min_alpha: float = 0.0
    bg_color: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    tile_size: int = 16
    # static per-tile capacity (Pallas). 128 is the benched + validated
    # value (bench.py, configs/*); res.n_overflow > 0 in the step metrics
    # means tiles saturated — raise to 256/512 for denser scenes
    max_gs_per_tile: int = 128
    # Pallas raster tuning: blend-dot precision ("fast" = single-pass
    # bf16, ~2^-8 relative blend error — below the CUDA reference's own
    # run-to-run nondeterminism; "high" = bf16-split ~f32), and tile-table
    # reuse across GS iterations (re-bin every N iters per keyframe, or
    # sooner when projected means drift beyond the pixel guard)
    raster_precision: str = "fast"
    raster_rebin_every: int = 8
    raster_rebin_drift_px: float = 4.0
    # GS-SDF consistency sample gating (reference utils/config.py:298,304;
    # consistency samples must be visible gaussians with alpha > min_alpha
    # AND blend contribution > gs_contribution_threshold,
    # utils/mapper.py:1355-1366)
    gs_contribution_threshold: float = 0.1
    gs_min_alpha: float = 0.05
    # edge-aware normal smoothness (reference lambda_normal_smooth,
    # utils/config.py:283; off by default like the reference)
    lambda_normal_smooth: float = 0.0
    max_render_gaussians: int = 1 << 18

    # ---------------- eval ----------------
    o3d_vis_on: bool = False
    eval_traj_on: bool = True
    save_map: bool = True
    save_mesh: bool = False
    save_merged_pc: bool = False
    mesh_freq_frame: int = 0
    mesh_min_nn: int = 8
    mc_res_m: float = 0.2
    # drop mesh connected components with fewer triangles (reference
    # min_cluster_vertices=500 gated by filter_isolated_mesh; 0 = off)
    min_cluster_vertices: int = 0
    # TSDF-fusion mesh of the camera depth maps at end of run (reference
    # tsdf_fusion_voxel_size, slam_dataset.py:995-1195)
    save_tsdf_mesh: bool = False
    tsdf_fusion_voxel_size: float = 0.2
    pad_voxel: int = 2
    skip_top_voxel: int = 0
    mc_mask_on: bool = True
    mesh_default_path: str = ""
    eval_gs_every_frame: int = 0
    gs_eval_cam_refine_on: bool = False
    gs_eval_cam_refine_iters: int = 50

    def __post_init__(self):
        self.run_path: str = ""

    # -- derived values (reference: utils/config.py:490-566, :773-777) ------
    def derive(self) -> "Config":
        self.infer_bs = 8 * self.bs
        self.local_map_radius = 1.05 * self.max_range
        self.sorrounding_map_radius = 1.4 * self.local_map_radius
        self.window_radius = max(self.max_range, self.window_radius)
        if self.vox_down_m <= 0:
            self.vox_down_m = self.max_range * 1e-3
        if self.source_vox_down_m <= 0:
            self.source_vox_down_m = 10.0 * self.vox_down_m
        # sampling/loss scales tied to the map resolution (reference
        # utils/config.py:500-553: surface range = 3*vox_down = 0.6*voxel,
        # sigma_sigmoid = vox_down = voxel/5, behind <= 2*surface range)
        if self.surface_sample_range_m <= 0:
            self.surface_sample_range_m = 0.6 * self.voxel_size_m
        if self.free_sample_end_dist_m <= 0:
            self.free_sample_end_dist_m = 2.0 * self.surface_sample_range_m
        if self.sigma_sigmoid_m <= 0:
            self.sigma_sigmoid_m = 0.2 * self.voxel_size_m
        return self

    # -- YAML overlay --------------------------------------------------------
    SECTIONS = (
        "setting", "process", "sampler", "neuralpoints", "decoder", "loss",
        "continual", "tracker", "pgo", "optimizer", "gs", "eval",
    )

    @classmethod
    def load(cls, path: str | Path | None = None,
             overrides: Optional[Dict[str, Any]] = None) -> "Config":
        cfg = cls()
        if path is not None:
            with open(path) as f:
                raw = yaml.safe_load(f) or {}
            known = {f.name for f in dataclasses.fields(cls)}
            for section, vals in raw.items():
                if not isinstance(vals, dict):
                    if section in known:
                        setattr(cfg, section, vals)
                    continue
                # presence of a section toggles the subsystem
                if section == "tracker":
                    cfg.track_on = True
                elif section == "pgo":
                    cfg.pgo_on = True
                elif section == "gs":
                    cfg.gs_on = True
                for k, v in vals.items():
                    if k in known:
                        setattr(cfg, k, v)
            if "tracker" not in raw:
                cfg.track_on = False
            if "pgo" not in raw:
                cfg.pgo_on = False
            if "gs" not in raw:
                cfg.gs_on = False
        if overrides:
            known = {f.name for f in dataclasses.fields(cls)}
            for k, v in overrides.items():
                if k not in known:
                    raise KeyError(f"unknown config key: {k}")
                setattr(cfg, k, v)
        return cfg.derive()

    def dump(self, path: str | Path) -> None:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        with open(path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=True)

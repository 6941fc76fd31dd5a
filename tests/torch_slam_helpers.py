"""Shared set-up of the port's SLAM-slice tests: the tiny configuration,
the JAX package's map and decoders carried into the port as numpy, and the
whole slice run in both packages side by side (``run_slice``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pings_tpu.config import Config as JConfig
from pings_tpu_torch.config import Config as TConfig
from pings_tpu_torch.models import decoder as tdec
from pings_tpu_torch.models import neural_points as tnpm

# tests/test_pipeline.py:12-29 shrunk: a 2^14-point map, a 2^16 hash, bs
# 1,024, hidden 16, 10 mapping iterations (x30 on frame 0)
TINY = dict(
    max_points=1 << 14, buffer_size=1 << 16, voxel_size_m=0.3,
    feature_dim=8, color_feature_dim=8, bs=1024,
    geo_mlp_hidden_dim=16, color_mlp_hidden_dim=16,
    gaussian_mlp_hidden_dim=16,
    pool_capacity=1 << 16, lr=0.02, lr_mlp_base=2e-3,
    surface_sample_range_m=-1.0, free_sample_end_dist_m=-1.0,
    sigma_sigmoid_m=-1.0,
    min_range=0.5, max_range=25.0, min_z=-5.0,
    vox_down_m=0.1, source_vox_down_m=0.4,
    mapping_iters=10, init_iter_ratio=30,
    max_local_points=4096, spawn_n_gaussian=4,
    gs_iters=10, gs_sdf_sample_count=128, max_gs_per_tile=256,
    mesh_min_nn=3, data_loader_name="synthetic",
    gs_on=False, track_on=True, pgo_on=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port while a module of these tests
    runs: the suite runs in several processes at once, and the port's
    default of one thread per core on top of JAX's own pool starves the
    other processes' timing tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    """(JAX config, port config) of the tiny configuration."""
    over = dict(TINY, **kw)
    return JConfig.load(overrides=over), TConfig.load(overrides=over)


def map_to_torch(m, device="cpu"):
    flat = {"map." + f.name: np.array(getattr(m, f.name))
            for f in dataclasses.fields(m)
            if f.name not in ("resolution", "buffer_size")}
    return tnpm.map_from_jax(flat, m.resolution, m.buffer_size, device)


def decoders_to_torch(decoders, device="cpu"):
    leaves = jax.tree_util.tree_flatten_with_path(decoders)[0]
    return tdec.decoders_from_jax(
        {"dec" + jax.tree_util.keystr(kp): np.asarray(x) for kp, x in leaves},
        device)


class JaxDraws:
    """The JAX package's random numbers for the port's ``SlamSystem.draws``
    hook: the same key flow as its ``SlamSystem`` (a key of seed + 1, split
    once per map update, once per SDF-only step and once per frame of the
    joint GS step) and the same draws as its ``sample_rays``,
    ``pool_insert`` and ``pool_batch``, so that both packages sample the
    same rays and batches."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.key = jax.random.PRNGKey(cfg.seed + 1)

    def _next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def map_update(self, n, pool):
        import jax.numpy as jnp
        import torch

        c = self.cfg
        k_s, k_p = jax.random.split(self._next())
        ks, kf, kb = jax.random.split(k_s, 3)
        rays = (jax.random.normal(ks, (n, c.surface_sample_n)),
                jax.random.uniform(kf, (n, c.free_front_n)),
                jax.random.uniform(kb, (n, c.free_behind_n)))
        n_s = n * (1 + c.surface_sample_n + c.free_front_n + c.free_behind_n)
        slots = jax.random.randint(k_p, (n_s,), 0,
                                   jnp.int32(max(int(pool.count), 1)))
        t = lambda a: torch.from_numpy(np.array(a))
        return tuple(t(a) for a in rays), t(slots)

    def sdf_batches(self, iters, pool):
        import jax.numpy as jnp
        import torch

        c = self.cfg
        bs_new = min(c.bs_new_sample, c.bs // 2)
        key = self._next()
        hi_h = jnp.int32(max(int(pool.count), 1))
        hi_f = jnp.int32(max(int(pool.new_count), 1))
        out = []
        for i in range(iters):
            k1, k2 = jax.random.split(jax.random.fold_in(key, i))
            out.append((torch.from_numpy(np.array(jax.random.randint(
                k1, (c.bs - bs_new,), 0, hi_h))),
                torch.from_numpy(np.array(jax.random.randint(
                    k2, (bs_new,), 0, hi_f)))))
        return out


    def gs_batches(self, iters, pool):
        """The joint step's SDF batches of one frame: a key split into one
        per iteration, each split again for the history and the fresh
        slots (``pool_batch`` inside the JAX package's step)."""
        import jax.numpy as jnp
        import torch

        c = self.cfg
        bs_new = min(c.bs_new_sample, c.bs // 2)
        keys = jax.random.split(self._next(), iters)
        hi_h = jnp.int32(max(int(pool.count), 1))
        hi_f = jnp.int32(max(int(pool.new_count), 1))
        out = []
        for k in keys:
            k1, k2 = jax.random.split(k)
            out.append((torch.from_numpy(np.array(jax.random.randint(
                k1, (c.bs - bs_new,), 0, hi_h))),
                torch.from_numpy(np.array(jax.random.randint(
                    k2, (bs_new,), 0, hi_f)))))
        return out


def run_slice(sequence="4:line", **kw):
    """Both packages' ``SlamSystem`` on the frames of ``sequence`` at the
    tiny configuration (``kw`` overrides it, ``seed`` among them), the port
    on the CPU from the JAX package's initial decoders and drawing its
    random numbers. Returns (per frame (JAX report, port report, JAX pose,
    port pose, JAX map count, port map count), (JAX, port) hash tables
    after frame 0, the dataset, the JAX system, the port's system)."""
    from pings_tpu.data.base import dataset_factory
    from pings_tpu.slam.pipeline import SlamSystem as JSlam
    from pings_tpu_torch.slam.pipeline import SlamSystem as TSlam

    jcfg, tcfg = configs(**kw)
    ds = dataset_factory("synthetic", "", sequence, jcfg)
    js = JSlam(jcfg)
    ts = TSlam(tcfg, device="cpu")
    ts.decoders = decoders_to_torch(js.decoders)
    ts.draws = JaxDraws(tcfg)
    out = []
    for i in range(len(ds)):
        f = ds[i]           # one draw of the scan noise for both
        jr, tr = js.process_frame(f), ts.process_frame(f)
        out.append((jr, tr, js.poses[-1].copy(), ts.poses[-1].copy(),
                    int(js.m.count), int(ts.m.count)))
        if i == 0:
            hashes = (np.asarray(js.m.hash_table),
                      ts.m.hash_table.numpy().copy())
    return out, hashes, ds, js, ts

"""pings_tpu_torch.mapping.campool vs pings_tpu.mapping.campool (CPU): the
same seed and the same sequence of keyframes give the same slots, the same
evictions and the same samples; the pyramid levels agree (1e-6)."""

import jax.numpy as jnp
import numpy as np
import torch

from pings_tpu.config import Config as JConfig
from pings_tpu.mapping.campool import CamPool as JCamPool
from pings_tpu.models import renderer as jrd
from pings_tpu_torch.config import Config as TConfig
from pings_tpu_torch.mapping.campool import CamPool as TCamPool
from pings_tpu_torch.models import renderer as trd

OVER = dict(img_pool_size=3, long_term_pool_size=4, seed=11)


def _cams(rng, h=12, w=20):
    rgb = rng.uniform(size=(h, w, 3)).astype(np.float32)
    depth = rng.uniform(1, 5, (h, w)).astype(np.float32)
    sky = (rng.uniform(size=(h, w)) < 0.3).astype(np.float32)
    K = np.array([[30.0, 0, 10.0], [0, 30.0, 6.0], [0, 0, 1]], np.float32)
    j = jrd.CamView(jnp.asarray(K), jnp.eye(4), jnp.asarray(rgb),
                    jnp.asarray(depth), jnp.asarray(sky), jnp.int32(0))
    t = trd.CamView(torch.from_numpy(K), torch.eye(4), torch.from_numpy(rgb),
                    torch.from_numpy(depth), torch.from_numpy(sky), 0)
    return j, t


def _state(p):
    return ([c.frame_id for c in p.short], [c.frame_id for c in p.long],
            [c.slot for c in p.short], [c.slot for c in p.long],
            sorted(p._free))


def test_same_seed_same_pool_history(rng):
    jp, tp = JCamPool(JConfig.load(overrides=OVER)), TCamPool(
        TConfig.load(overrides=OVER))
    assert jp.n_slots == tp.n_slots == 8
    jc, tc = _cams(rng)
    pos = rng.normal(size=(30, 3)) * 5
    for fid in range(30):
        sj = jp.add_keyframe(jc, pos[fid], fid)
        st = tp.add_keyframe(tc, pos[fid], fid)
        assert sj == st
        assert _state(jp) == _state(tp)
        if fid % 7 == 6:
            jp.prune_by_range(pos[fid], 6.0)
            tp.prune_by_range(pos[fid], 6.0)
            assert _state(jp) == _state(tp)
        for _ in range(5):
            a, b = jp.sample(), tp.sample()
            assert (a.frame_id, a.slot) == (b.frame_id, b.slot)
    assert len(tp.all_cams()) == len(jp.all_cams())
    assert TCamPool(TConfig.load(overrides=OVER)).sample() is None


def test_param_pools_and_pyramid(rng):
    tp = TCamPool(TConfig.load(overrides=OVER))
    jp = JCamPool(JConfig.load(overrides=OVER))
    te, td = tp.init_param_pools(device="cpu")
    je, jd = jp.init_param_pools()
    for a, b in zip(je, te):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    jc, tc = _cams(rng, 13, 22)
    jp.add_keyframe(jc, np.zeros(3), 0)
    tp.add_keyframe(tc, np.zeros(3), 0)
    for lv in (0, 1, 2):
        a, b = jp.short[0].level(lv), tp.short[0].level(lv)
        for f in ("K", "rgb", "depth", "sky"):
            np.testing.assert_allclose(getattr(b, f).numpy(),
                                       np.asarray(getattr(a, f)), atol=1e-6,
                                       err_msg=f"{f} level {lv}")
    assert tp.short[0].level(1) is tp.short[0].level(1)     # cached
    tp.short[0].set_cam(tc)
    assert not tp.short[0].pyr
    assert torch.equal(tc.K, torch.from_numpy(np.array(jc.K)))  # not edited

"""The port's scan normals (``ops/scan_normals.py``) against the JAX
package's (CPU): the hash keys exactly, the smallest eigenvectors of random
covariances, and on a kitti scan the incidence cosines: the same points
fall back to cos = 1, and elsewhere cos agrees within 1e-4, except in
voxels whose points lie on a line, where the normal is not determined
(the closed-form eigenvector's arccos, cos and determinant round
differently in the two packages, and there that decides the direction)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.ops import scan_normals as jsn
from pings_tpu_torch.data import synthetic as tsyn
from pings_tpu_torch.ops import scan_normals as tsn
from torch_slam_helpers import one_torch_thread  # noqa: F401


def test_keys_equal(rng):
    ijk = np.concatenate([
        rng.integers(-2 ** 31, 2 ** 31 - 1, (4000, 3)),
        rng.integers(-50, 50, (4000, 3)),
        np.array([[2 ** 31 - 1, -2 ** 31, 0], [-1, -1, -1],
                  [1666666, 1666666, 1666666]])]).astype(np.int32)
    for m in (1 << 17, 1 << 10):
        jh, jv = (np.asarray(a) for a in jsn._keys(jnp.asarray(ijk), m))
        th, tv = (a.numpy() for a in tsn._keys(torch.from_numpy(ijk), m))
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_array_equal(tv, jv.astype(np.int64))


def test_smallest_eigvec(rng):
    A = rng.normal(size=(500, 3, 3)).astype(np.float32)
    C = A @ A.transpose(0, 2, 1)
    C[:20] = np.eye(3, dtype=np.float32)          # isotropic: no normal
    C[20:40, 2] = C[20:40, :, 2] = 0.0            # a flat patch
    jn, jok = (np.asarray(a) for a in jsn._smallest_eigvec(jnp.asarray(C)))
    tn, tok = (a.numpy() for a in tsn._smallest_eigvec(torch.from_numpy(C)))
    np.testing.assert_array_equal(tok, jok)
    # the same axis (the sign of an eigenvector is free)
    dot = np.abs(np.sum(tn * jn, axis=-1))
    assert np.all(dot[jok] > 1 - 1e-4), dot[jok].min()
    ev, evec = np.linalg.eigh(C[jok].astype(np.float64))
    assert np.all(np.abs(np.sum(evec[:, :, 0] * tn[jok], -1)) > 0.999)


def _line_voxels(pts, mask, voxel=0.6, m=1 << 17, ratio=40.0):
    """Per point: whether its voxel's two smallest eigenvalues lie within
    p / ``ratio`` (p the eigenvalues' spread, sqrt(tr((C - q I)^2) / 6)),
    and the voxel's dominant axis (the largest eigenvalue's eigenvector).
    Such a voxel's points lie on a line (one scan ring crossing it): every
    direction perpendicular to the line is a smallest eigenvector to
    within float32 rounding, and the closed form's rounding, about
    (p / gap)^2 float32 roundings, picks one. Both packages form the
    covariance in float32 (E[p p^T] - E[p] E[p]^T, one rounding); here it
    is formed alike in numpy and decomposed in float64."""
    P = np.where(mask[:, None], pts, 1e6).astype(np.float32)
    ijk = np.floor(P / np.float32(voxel)).astype(np.int32)
    h = np.asarray(jsn._keys(jnp.asarray(ijk), m)[0])
    w = mask.astype(np.float32)
    cnt = np.zeros(m, np.float32)
    np.add.at(cnt, h, w)
    psum = np.zeros((m, 3), np.float32)
    np.add.at(psum, h, pts * w[:, None])
    msum = np.zeros((m, 3, 3), np.float32)
    np.add.at(msum, h, pts[:, :, None] * pts[:, None, :] * w[:, None, None])
    c = np.maximum(cnt, np.float32(1.0))
    mean = (psum / c[:, None]).astype(np.float64)
    cov = ((msum / c[:, None, None]).astype(np.float64)
           - mean[:, :, None] * mean[:, None, :]).astype(np.float32)
    C = cov[h].astype(np.float64)
    ev, evec = np.linalg.eigh(C)
    q = np.trace(C, axis1=1, axis2=2) / 3.0
    p = np.sqrt(np.sum((C - q[:, None, None] * np.eye(3)) ** 2,
                       axis=(1, 2)) / 6.0)
    return ev[:, 1] - ev[:, 0] <= p / ratio, evec[:, :, 2]


@pytest.mark.parametrize("frame", [5, 30, 100])
def test_scan_incidence_cos_kitti_scan(frame):
    """A kitti scan in the world frame: the same points fall back to
    cos = 1. Every other point's cos agrees within 1e-4 (measured at most
    1.9e-5), except the points of line voxels (``_line_voxels``; 2-33% of
    them on these scans): there both packages' normals are perpendicular
    to the line within 2e-4 (measured at most 9.9e-5 in either)."""
    T = tsyn.kitti_poses(120)[frame]
    pts = tsyn.kitti_scan(T, tsyn.circuit_world(), np.random.default_rng(0),
                          tsyn.kitti_lidar_dirs()[::2])
    pts_w = (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    n = len(pts_w)
    mask = np.ones(n, bool)
    mask[::7] = False
    origin = T[:3, 3].astype(np.float32)
    jc, jn = (np.asarray(a) for a in jsn.scan_incidence_cos(
        jnp.asarray(pts_w), jnp.asarray(mask), jnp.asarray(origin)))
    tc, tn = (a.numpy() for a in tsn.scan_incidence_cos(
        torch.from_numpy(pts_w), torch.from_numpy(mask),
        torch.from_numpy(origin)))
    fall_j, fall_t = jc == 1.0, tc == 1.0
    np.testing.assert_array_equal(fall_t, fall_j)
    ok = ~fall_j
    assert ok.mean() > 0.5
    line, axis = _line_voxels(pts_w, mask)
    line &= ok
    assert line.sum() < 0.4 * ok.sum()
    np.testing.assert_allclose(tc[ok & ~line], jc[ok & ~line], atol=1e-4)
    for nrm in (tn, jn):
        assert np.abs(np.sum(nrm[line] * axis[line], -1)).max() < 2e-4

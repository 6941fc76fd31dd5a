"""Mesh evaluation: chamfer distance, precision/recall/F-score.

Reference: eval/eval_mesh_utils.py:8-183 (eval_mesh/eval_pair: sampled
point clouds + NN distances -> accuracy, completeness, chamfer-L1,
precision/recall/F-score at a threshold, default 0.1 m). Uses the native
grid NN (pings_tpu_torch.native.nn_distances) instead of open3d KDTree.
A copy of ``pings_tpu/eval/mesh.py`` (``sample_mesh_points`` :18,
``eval_pair`` :35, ``eval_mesh`` :64).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from pings_tpu_torch.native import nn_distances


def sample_mesh_points(verts: np.ndarray, tris: np.ndarray, n: int,
                       rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Area-weighted surface sampling."""
    rng = rng or np.random.default_rng(0)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    p = areas / max(areas.sum(), 1e-12)
    idx = rng.choice(len(tris), size=n, p=p)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return (v0[idx] + u * (v1[idx] - v0[idx]) + v * (v2[idx] - v0[idx])
            ).astype(np.float32)


def eval_pair(
    pred_points: np.ndarray,
    gt_points: np.ndarray,
    threshold: float = 0.1,
    truncation_acc: float = 0.5,
) -> Dict[str, float]:
    """Chamfer/accuracy/completeness/F-score between sampled clouds."""
    cell = max(threshold, 0.05)
    d_pred_to_gt = nn_distances(pred_points, gt_points, cell=cell)
    d_gt_to_pred = nn_distances(gt_points, pred_points, cell=cell)
    # truncate unmatched distances (reference truncation, eval_mesh_utils)
    acc_d = np.minimum(d_pred_to_gt, truncation_acc)
    comp_d = np.minimum(d_gt_to_pred, truncation_acc)
    acc = float(acc_d.mean())
    comp = float(comp_d.mean())
    precision = float((d_pred_to_gt < threshold).mean())
    recall = float((d_gt_to_pred < threshold).mean())
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {
        "accuracy_m": acc,
        "completeness_m": comp,
        "chamfer_l1_m": 0.5 * (acc + comp),
        "precision": precision,
        "recall": recall,
        "fscore": f1,
    }


def eval_mesh(pred_verts, pred_tris, gt_points: np.ndarray,
              n_samples: int = 200000, threshold: float = 0.1,
              rng=None) -> Dict[str, float]:
    pred_pts = sample_mesh_points(pred_verts, pred_tris,
                                  min(n_samples, 4 * len(pred_tris) + 1000),
                                  rng)
    return eval_pair(pred_pts, gt_points.astype(np.float32), threshold)

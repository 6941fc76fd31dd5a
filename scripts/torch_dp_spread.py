#!/usr/bin/env python3
"""Where the data-parallel step's run-to-run gradient spread comes from,
on one GPU.

    python3 scripts/torch_dp_spread.py [--runs 4] [--out FILE]

Builds the kitti train cell of ``chip_smoke.py`` (the committed kitti map,
keyframes 112-121 ray-cast anew, the window around frame 121, surfel mode)
and runs ``parallel.mesh.make_dp_train_step`` over its 8 keyframes in one
process (a mesh of one, no process group), every time from the same
parameters:

- ``as is``: ``--runs`` times, as the port runs (CUDA kernels, torch's
  default algorithms);
- ``torch fixed``: twice with ``torch.use_deterministic_algorithms`` (the
  blend kernels still add with float atomics);
- ``all fixed``: twice with that and the backward and contribution kernels
  replaced by their plain versions on the CPU (every sum in a fixed order);
- ``4 cameras``: once over cameras 0-3 only: the gradient that rank 0 of
  two would step with if the all-reduce were left out.

Per gradient leaf, each against the first ``as is`` run (and the later
``as is`` runs against the second): the largest
difference over the leaf's largest entry (``max``), the relative L2
difference (``l2``), the median difference over the largest entry
(``median``) and the share of entries more than 1e-5 of the largest apart
(``off``); also for the planted faults ``2x`` (the gradient doubled: a sum
where the mean belongs, at two ranks) and ``4 cameras``. For the leaf with
the widest spread, its worst entry in every run; and the largest entry of
each column of the backward kernel's (N, 16) gradient over the 8 cameras.
Writes one JSON object to ``--out`` (default ``build/dp_spread.json``).
"""

import argparse
import json
import os
import sys
import time
import warnings
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

W, H = 640, 240


def leaf_names(params, gm):
    names = []
    for k in gm.gs_param_labels():
        n = sum(1 for _ in gm.param_leaves(params, k))
        names += [f"{k}.{i}" for i in range(n)]
    return names


def compare(torch, got, ref):
    """Per leaf: max, l2, median (over the leaf's largest |ref|) and the
    share of entries more than 1e-5 of the largest apart."""
    out = []
    for g, r in zip(got, ref):
        scale = float(r.abs().max())
        if scale == 0:
            out.append(None)
            continue
        d = (g - r).abs()
        out.append(dict(max=float(d.max()) / scale,
                        l2=float(torch.linalg.vector_norm(g - r))
                        / float(torch.linalg.vector_norm(r)),
                        median=float(d.median()) / scale,
                        off=float((d > 1e-5 * scale).float().mean())))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "build" / "dp_spread.json"))
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from pings_tpu_torch.mapping import gs_mapper as gm
    from pings_tpu_torch.mapping import pool as rp
    from pings_tpu_torch.models.renderer import CamView
    from pings_tpu_torch.models.spawn import local_indices
    from pings_tpu_torch.ops import _build
    from pings_tpu_torch.ops import raster_blend as rb
    from pings_tpu_torch.parallel.mesh import make_dp_train_step, make_mesh

    if not torch.cuda.is_available():
        print("torch_dp_spread: needs a CUDA device", file=sys.stderr)
        return 1
    card = cs.smi("name,power.limit")
    _build.build_all()
    fids = list(range(112, 122))
    frames, scan = cs.kitti_frames(fids + [122], fids[-1])
    frames = {f: frames[f] for f in fids}
    cfg, system = cs.train_setup(torch, cs.KITTI, frames, scan)
    for fid in fids:
        cs.run_train_gs(torch, system, frames, fid, 0)
    system._ensure_gs(W, H)
    opt, params = system._gs[0], system._gs[1]
    leaves = list(gm.param_leaves(params))
    names = leaf_names(params, gm)
    snap = [t.detach().clone() for t in leaves]
    pcs = sorted(system.campool.all_cams(), key=lambda c: c.frame_id)
    stack = lambda f: torch.stack([getattr(c.cam, f) for c in pcs])
    cams = CamView(stack("K"), stack("T_c_w"), stack("rgb"), stack("depth"),
                   stack("sky"), torch.tensor([c.frame_id for c in pcs]))
    slots = torch.tensor([c.slot for c in pcs], device="cuda")
    local_idx = local_indices(system.m.local_mask, system._local_size,
                              system.m.capacity)
    sdf_batch = rp.pool_batch(
        system.pool, torch.Generator(device="cuda").manual_seed(11),
        cfg.bs, min(cfg.bs_new_sample, cfg.bs // 2))
    freeze = max(frames) >= cfg.freeze_after_frame
    mesh = make_mesh(device="cuda")
    step = make_dp_train_step(cfg, opt, mesh, W, H)

    col_max = torch.zeros(rb.NCH, device="cuda")
    orig_bwd, orig_contrib = rb.blend_bwd, rb.blend_contrib

    def bwd_seen(*a, **k):
        d = orig_bwd(*a, **k)
        col_max.copy_(torch.maximum(col_max, d.abs().amax(0)))
        return d

    def on_cpu(fn):
        def call(*a, **k):
            cpu = lambda x: x.detach().cpu() if torch.is_tensor(x) else x
            a = [type(x)(*map(cpu, x)) if isinstance(x, tuple) else cpu(x)
                 for x in a]
            return fn(*a, **k).cuda()
        return call

    def run(cams_, slots_):
        cs.restore(leaves, snap)
        met = step(params, system.m, system.decoders, local_idx, cams_,
                   slots_, sdf_batch, freeze)
        torch.cuda.synchronize()
        return ([t.grad.detach().clone() for t in leaves],
                {k: float(v) for k, v in met._asdict().items()})

    res = {"card": card, "leaves": names, "runs": {}}
    grads = {}
    rb.blend_bwd = bwd_seen
    t0 = time.perf_counter()
    grads["as is"] = [run(cams, slots) for _ in range(args.runs)]
    rb.blend_bwd = orig_bwd
    res["as_is_s"] = time.perf_counter() - t0
    res["bwd_column_max"] = col_max.tolist()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        grads["torch fixed"] = [run(cams, slots) for _ in range(2)]
        rb.blend_bwd, rb.blend_contrib = (on_cpu(orig_bwd),
                                         on_cpu(orig_contrib))
        t0 = time.perf_counter()
        grads["all fixed"] = [run(cams, slots) for _ in range(2)]
        res["all_fixed_s"] = time.perf_counter() - t0
        rb.blend_bwd, rb.blend_contrib = orig_bwd, orig_contrib
        torch.use_deterministic_algorithms(False)
    res["nondeterministic_ops"] = sorted({str(w.message)[:160]
                                          for w in caught})
    half = [run(CamView(*(x[:4] for x in cams)), slots[:4])]

    ref, ref_met = grads["as is"][0]
    rows = {}
    for mode, runs in grads.items():
        for i, (g, met) in enumerate(runs):
            if mode == "as is" and i == 0:
                continue
            rows[f"{mode} {i}"] = (compare(torch, g, ref), met)
    for i, (g, met) in enumerate(grads["as is"][2:], 2):
        rows[f"as is {i} vs as is 1"] = (
            compare(torch, g, grads["as is"][1][0]), met)
    for mode in ("torch fixed", "all fixed"):
        a, b = grads[mode]
        res[f"{mode} bit-equal"] = all(torch.equal(x, y)
                                       for x, y in zip(a[0], b[0]))
    rows["fault 2x"] = (compare(torch, [2 * g for g in ref], ref), None)
    rows["fault 4 cameras"] = (compare(torch, half[0][0], ref), half[0][1])
    res["metrics_first"] = ref_met
    res["rows"] = {k: {"leaves": v, "metrics": m} for k, (v, m) in
                   rows.items()}

    spread = [max((v[i]["max"] for k, (v, _) in rows.items()
                   if k.startswith("as is") and v[i] is not None),
                  default=0.0) for i in range(len(leaves))]
    worst = int(np.argmax(spread))
    flat = [g[worst].reshape(-1) for runs in grads.values()
            for g, _ in runs]
    j = int((flat[0] - flat[1]).abs().argmax()) if len(flat) > 1 else 0
    res["worst_leaf"] = names[worst]
    res["worst_entry"] = {"index": j, "largest": float(
        ref[worst].abs().max()), "values": [
        f"{mode} {i}: {float(g[worst].reshape(-1)[j]):.9g}"
        for mode, runs in grads.items() for i, (g, _) in enumerate(runs)]}

    print(f"torch_dp_spread [{card}]: {len(pcs)} cameras, {len(leaves)} "
          f"leaves; as is {res['as_is_s'] / args.runs:.2f} s a step, all "
          f"fixed {res['all_fixed_s'] / 2:.2f} s")
    print("backward kernel's gradient, largest |entry| per column: "
          + " ".join(f"{c}:{v:.3g}" for c, v in enumerate(
              res["bwd_column_max"])))
    for mode in ("torch fixed", "all fixed"):
        print(f"{mode}: two runs bit-equal: {res[mode + ' bit-equal']}")
    print("nondeterministic ops left: "
          + ("; ".join(res["nondeterministic_ops"]) or "none"))
    for k, (v, met) in rows.items():
        print(f"{k}" + (f" (total {met['total']:.7f}, psnr "
                        f"{met['psnr']:.6f})" if met else "") + ":")
        for name, e in zip(names, v):
            if e is not None and (e["max"] > 1e-6 or k.startswith("fault")):
                print(f"  {name:16s} max {e['max']:.2e} l2 {e['l2']:.2e} "
                      f"median {e['median']:.2e} off {e['off']:.2e}")
    print(f"first run: total {ref_met['total']:.7f} psnr "
          f"{ref_met['psnr']:.6f}")
    print(f"widest spread: {res['worst_leaf']}, entry {j} (leaf's largest "
          f"{res['worst_entry']['largest']:.6g}): "
          + ", ".join(res["worst_entry"]["values"]))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

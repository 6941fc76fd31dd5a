"""The port's visualization (``pings_tpu_torch.vis``, ``make_vis_packet``,
the command line's ``--vis-every``) against the JAX package's, as
``tests/test_vis.py`` holds the JAX one (CPU):

- packets round-trip, and either package reads the other's ``.npz``;
- ``write_viewer``'s page equals the JAX package's except for the PNG
  thumbnails, which decode to the same RGB pixels;
- ``make_vis_packet`` on the JAX package's state after one frame, carried
  into the port (map, decoders, poses, keyframe): the arrays equal, the
  rendered images within 2 levels of 255 on 99.5% of the pixels and 16
  on the rest (the two blends round differently);
- ``_control_layers``: the same mesh (vertex count, vertices within
  1e-4 m) and SDF slice (the same valid cells, values within 1e-4 m);
- the live server's endpoints; the command line with ``--vis-every``,
  with ``vis_every`` and the layers set in ``control.json``, and with a
  stop through ``control.json``.
"""

import base64
import glob
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from pings_tpu.vis.packet import VisPacket as JPacket
from pings_tpu.vis.packet import downsample_points as j_down
from pings_tpu.vis.viewer import write_viewer as j_viewer
from pings_tpu_torch.data.imageio import read_png
from pings_tpu_torch.vis.packet import VisPacket, downsample_points, \
    load_packets
from pings_tpu_torch.vis.viewer import write_viewer
from torch_slam_helpers import configs, decoders_to_torch, map_to_torch
from torch_slam_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def make_packet(rng, fid=3, cls=VisPacket):
    """tests/test_vis.py's packet, with a depth image beside the rgb."""
    n = 500
    pkt = cls(frame_id=fid)
    pkt.neural_points = rng.random((n, 3)).astype(np.float32) * 10
    pkt.neural_colors = (rng.random((n, 3)) * 255).astype(np.uint8)
    pkt.scan_points = rng.random((200, 3)).astype(np.float32)
    pkt.traj_est = np.cumsum(rng.random((20, 3)), 0).astype(np.float32)
    pkt.traj_gt = pkt.traj_est + 0.1
    pkt.cam_poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    pkt.cam_intrinsics = np.tile([300.0, 300.0, 640, 480],
                                 (2, 1)).astype(np.float32)
    pkt.mesh_verts = rng.random((30, 3)).astype(np.float32)
    pkt.mesh_tris = rng.integers(0, 30, (40, 3)).astype(np.int32)
    pkt.sdf_slice = rng.normal(size=(16, 16)).astype(np.float32)
    pkt.sdf_slice_meta = np.array([0, 0, 1.0, 0.5], np.float32)
    pkt.images["render_rgb"] = (rng.random((24, 32, 3))
                                * 255).astype(np.uint8)
    pkt.images["render_depth"] = np.repeat(
        (rng.random((24, 32, 1)) * 255).astype(np.uint8), 3, -1)
    return pkt


def _same_packet(a, b):
    assert a.frame_id == b.frame_id
    for k, v in a.__dict__.items():
        if k in ("frame_id", "images"):
            continue
        w = getattr(b, k)
        assert (v is None) == (w is None), k
        if v is not None:
            np.testing.assert_array_equal(v, w, k)
            assert np.asarray(v).dtype == np.asarray(w).dtype, k
    assert sorted(a.images) == sorted(b.images)
    for k in a.images:
        np.testing.assert_array_equal(a.images[k], b.images[k], k)


def test_packets_round_trip_across_packages(rng, tmp_path):
    pkt = make_packet(rng)
    pkt.save(str(tmp_path / "t" / "frame_00003.npz"))
    back = VisPacket.load(str(tmp_path / "t" / "frame_00003.npz"))
    _same_packet(pkt, back)
    _same_packet(pkt, JPacket.load(str(tmp_path / "t" / "frame_00003.npz")))
    jpkt = make_packet(np.random.default_rng(5), fid=9, cls=JPacket)
    jpkt.save(str(tmp_path / "t" / "frame_00009.npz"))
    _same_packet(jpkt, VisPacket.load(str(tmp_path / "t" /
                                          "frame_00009.npz")))
    pkts = load_packets(str(tmp_path / "t"))
    assert [p.frame_id for p in pkts] == [3, 9]
    # a packet with only some layers keeps the others None
    VisPacket(frame_id=1).save(str(tmp_path / "e.npz"))
    e = VisPacket.load(str(tmp_path / "e.npz"))
    assert e.neural_points is None and e.images == {}
    pts = rng.random((1000, 3)).astype(np.float32)
    col = (rng.random((1000, 3)) * 255).astype(np.uint8)
    for m in (100, 999, 1000, 5000):
        a, b = downsample_points(pts, col, m), j_down(pts, col, m)
        assert len(a[0]) <= m
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _payloads(html):
    """(page with every PNG payload cut out, the payloads by frame and
    name)."""
    start = html.index("const PACKETS = ") + len("const PACKETS = ")
    end = html.index(";\nconst LAYERS")
    data = json.loads(html[start:end])
    imgs = {}
    for i, d in enumerate(data):
        for name, b64 in d["images"].items():
            imgs[i, name] = base64.b64decode(b64)
            d["images"][name] = ""
    return html[:start] + json.dumps(data) + html[end:], imgs


def test_write_viewer_matches_jax(rng, tmp_path):
    pkts = [make_packet(rng, fid=i) for i in (0, 5)]
    out = write_viewer(str(tmp_path / "t" / "viewer.html"), pkts)
    jout = j_viewer(str(tmp_path / "j" / "viewer.html"), pkts)
    html, jhtml = open(out).read(), open(jout).read()
    assert html.startswith("<!doctype html>") and len(html) > 10_000
    for key in ("neural", "scan", "traj_est", "traj_gt", "cams", "mesh",
                "sdf", "render_rgb", "render_depth"):
        assert key in html
    assert '"frame_id": 5' in html
    page, imgs = _payloads(html)
    jpage, jimgs = _payloads(jhtml)
    assert page == jpage
    assert sorted(imgs) == sorted(jimgs) and len(imgs) == 4
    for (i, name), png in imgs.items():
        p = tmp_path / f"t{i}{name}.png"
        p.write_bytes(png)
        q = tmp_path / f"j{i}{name}.png"
        q.write_bytes(jimgs[i, name])
        mine, theirs = read_png(str(p)), read_png(str(q))
        np.testing.assert_array_equal(mine, pkts[i].images[name])
        np.testing.assert_array_equal(mine, theirs[..., :3])
    with pytest.raises(ValueError):
        write_viewer(str(tmp_path / "none.html"), [])


@pytest.fixture(scope="module")
def carried():
    """The JAX package's SlamSystem after frame 0 of ``"2:line"`` (GS on
    with no iterations: the frame's camera becomes a keyframe), and the
    port's system with its map, decoders, poses and keyframe."""
    from pings_tpu.data.base import dataset_factory
    from pings_tpu.slam.pipeline import SlamSystem as JSlam
    from pings_tpu_torch.models.renderer import CamView
    from pings_tpu_torch.slam.pipeline import SlamSystem as TSlam

    jcfg, tcfg = configs(gs_on=True, gs_iters=0)
    ds = dataset_factory("synthetic", "", "2:line", jcfg)
    frame = ds[0]
    js = JSlam(jcfg)
    js.process_frame(frame)
    ts = TSlam(tcfg, device="cpu")
    ts.m = map_to_torch(js.m)
    ts.decoders = decoders_to_torch(js.decoders)
    ts.poses = [p.copy() for p in js.poses]
    ts.travel = list(js.travel)
    ts.frame_id = js.frame_id
    for pc in js.campool.all_cams():
        c = pc.cam
        t = lambda x: torch.from_numpy(np.array(x))
        ts.campool.add_keyframe(
            CamView(K=t(c.K), T_c_w=t(c.T_c_w), rgb=t(c.rgb),
                    depth=t(c.depth), sky=t(c.sky), frame_id=int(c.frame_id)),
            pc.position, pc.frame_id, T_c_l=pc.T_c_l)
    from pings_tpu.data.frame import preprocess_frame as jpre
    pre = jpre(frame, jcfg, np.eye(4), False)
    return jcfg, js, tcfg, ts, pre, ds.gt_poses()


def test_make_vis_packet_matches_jax(carried):
    jcfg, js, tcfg, ts, pre, gt = carried
    assert len(ts.campool.all_cams()) == 1
    jp = js.make_vis_packet(pre, gt_poses=gt, with_render=True)
    tp = ts.make_vis_packet(pre, gt_poses=gt, with_render=True)
    imgs = jp.images, tp.images
    jp.images, tp.images = {}, {}
    _same_packet(jp, tp)
    assert tp.neural_points.shape[0] == int(js.m.count) > 0
    assert tp.scan_points is not None and tp.cam_poses.shape == (1, 4, 4)
    assert sorted(imgs[1]) == sorted(imgs[0]) == [
        "render_depth", "render_rgb", "target_rgb"]
    for name in imgs[0]:
        a = imgs[0][name].astype(int)
        b = imgs[1][name].astype(int)
        assert a.shape == b.shape and b.dtype == np.int64
        d = np.abs(a - b)
        assert (d > 2).mean() <= 5e-3 and d.max() <= 16, (name, d.max())
    assert imgs[1]["render_rgb"].max() > 0


def test_control_layers_match_jax(carried):
    from pings_tpu.cli import _control_layers as j_layers
    from pings_tpu_torch.cli import _control_layers as t_layers

    jcfg, js, tcfg, ts, _, _ = carried
    st = {"mesh_on": True, "sdf_slice_on": True, "sdf_slice_height": 0.5}
    jp, tp = JPacket(frame_id=0), VisPacket(frame_id=0)
    j_layers(jp, st, js, jcfg)
    t_layers(tp, st, ts, tcfg)
    assert len(tp.mesh_verts) == len(jp.mesh_verts) > 0
    np.testing.assert_allclose(tp.mesh_verts, jp.mesh_verts, atol=1e-4)
    np.testing.assert_array_equal(tp.mesh_tris, jp.mesh_tris)
    np.testing.assert_array_equal(np.isnan(tp.sdf_slice),
                                  np.isnan(jp.sdf_slice))
    assert (~np.isnan(tp.sdf_slice)).any()
    np.testing.assert_allclose(tp.sdf_slice, jp.sdf_slice, atol=1e-4)
    np.testing.assert_array_equal(tp.sdf_slice_meta, jp.sdf_slice_meta)
    # no layer asked for, none made
    none = VisPacket(frame_id=0)
    t_layers(none, {}, ts, tcfg)
    assert none.mesh_verts is None and none.sdf_slice is None


def test_live_server_endpoints(rng, tmp_path):
    from http.server import ThreadingHTTPServer

    from pings_tpu_torch.vis.live import make_handler

    run_dir = str(tmp_path)
    # a packet written by the JAX package
    make_packet(rng, fid=7, cls=JPacket).save(
        os.path.join(run_dir, "vis", "frame_00007.npz"))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(run_dir))
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{port}"
    try:
        st = json.loads(urllib.request.urlopen(url + "/status",
                                               timeout=10).read())
        assert st == {"n_packets": 1, "latest": 7, "control": {}}
        for body in ({"pause": True}, {"sdf_slice_on": True}):
            req = urllib.request.Request(url + "/control",
                                         data=json.dumps(body).encode(),
                                         method="POST")
            urllib.request.urlopen(req, timeout=10).read()
        ctl = json.load(open(os.path.join(run_dir, "control.json")))
        assert ctl == {"pause": True, "sdf_slice_on": True}
        st = json.loads(urllib.request.urlopen(url + "/status",
                                               timeout=10).read())
        assert st["control"] == ctl
        html = urllib.request.urlopen(url + "/", timeout=30).read()
        assert b"ctrlpanel" in html and b"render_rgb" in html
        bad = urllib.request.Request(url + "/control", data=b"[1]",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(bad, timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()


def _writer(out, body, wait_s=60.0):
    """A thread that writes ``body`` into the run directory's
    control.json as soon as the directory appears."""
    def go():
        t_end = time.time() + wait_s
        while time.time() < t_end:
            dirs = glob.glob(os.path.join(out, "*"))
            if dirs:
                with open(os.path.join(dirs[0], "control.json"), "w") as f:
                    json.dump(body, f)
                return
            time.sleep(0.01)

    th = threading.Thread(target=go)
    th.start()
    return th


def test_cli_vis_every_and_control(tmp_path):
    """``--vis-every 2`` on 4 frames (GS off: no rendered images), then a
    run whose control.json asks for a packet every frame with the mesh and
    the slice, then a run stopped through control.json."""
    import yaml

    from pings_tpu_torch import cli

    # configs/run_synthetic.yaml with 3 mapping iterations a frame (x2 on
    # frame 0): the runs check the packets, not the map
    with open(os.path.join(ROOT, "configs", "run_synthetic.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["optimizer"].update(mapping_iters=3, init_iter_ratio=2, bs=512)
    cfg_file = str(tmp_path / "synth.yaml")
    with open(cfg_file, "w") as f:
        yaml.safe_dump(raw, f)
    base = [cfg_file, "--quiet", "--no-gs", "--device", "cpu"]
    out = str(tmp_path / "a")
    res = cli.main(base + ["--range", "0", "4", "1", "--vis-every", "2",
                           "--output", out])
    run_dir = glob.glob(os.path.join(out, "*"))[0]
    names = sorted(os.listdir(os.path.join(run_dir, "vis")))
    assert names == ["frame_00001.npz", "frame_00003.npz"]
    assert res["viewer"] == os.path.join(run_dir, "viewer.html")
    html = open(res["viewer"]).read()
    assert '"frame_id": 3' in html and "traj_est" in html
    pkt = JPacket.load(os.path.join(run_dir, "vis", names[-1]))
    assert pkt.neural_points is not None and len(pkt.traj_est) == 4

    out = str(tmp_path / "b")
    th = _writer(out, {"vis_every": 1, "mesh_on": True,
                       "sdf_slice_on": True})
    cli.main(base + ["--range", "0", "3", "1", "--output", out])
    th.join()
    run_dir = glob.glob(os.path.join(out, "*"))[0]
    pkts = load_packets(os.path.join(run_dir, "vis"))
    assert pkts and pkts[-1].frame_id == 2
    assert pkts[-1].mesh_verts is not None and pkts[-1].sdf_slice is not None
    assert os.path.exists(os.path.join(run_dir, "viewer.html"))

    out = str(tmp_path / "c")
    th = _writer(out, {"stop": True})
    res = cli.main(base + ["--range", "0", "8", "1", "--output", out])
    th.join()
    assert res["frames"] < 8 and "viewer" not in res
    run_dir = glob.glob(os.path.join(out, "*"))[0]
    assert os.path.exists(os.path.join(run_dir, "summary.json"))

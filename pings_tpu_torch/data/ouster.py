"""Ouster pcap loader — from-scratch, no vendor SDK.

The reference ``ouster.py`` (160 LoC) wraps the ouster-sdk: pcap packet
source + ``client.XYZLut`` built from the sensor's metadata json, yielding
per-scan point clouds with per-column normalized timestamps. That SDK is
not available here, so this module implements the same pipeline from the
*published* Ouster data formats:

- pcap container + ethernet/Linux-SLL/raw-IP + IPv4/UDP framing
  (payload extraction, lidar port filter);
- the LEGACY lidar packet layout (16 azimuth blocks per packet, each
  ``16B header | H x 12B channel blocks | 4B status``; e.g. the classic
  12608-byte OS1-64 packet) and the single-return
  ``RNG19_RFL8_SIG16_NIR16`` eUDP profile (32B packet header, columns of
  ``12B header | H x 12B channel blocks``);
- the beam-to-XYZ model from the metadata json
  (``beam_altitude_angles`` / ``beam_azimuth_angles`` /
  ``lidar_origin_to_beam_origin_mm`` / ``lidar_to_sensor_transform``):

      theta_enc = 2*pi*(1 - measurement_id / columns_per_frame)
      theta     = theta_enc + radians(beam_azimuth[row])
      phi       = radians(beam_altitude[row])
      x = (r - n) cos(theta) cos(phi) + n cos(theta_enc)
      y = (r - n) sin(theta) cos(phi) + n sin(theta_enc)
      z = (r - n) sin(phi)

  followed by the lidar-to-sensor transform (mm translation).

Columns are accumulated by ``frame_id`` into full scans; per-point
timestamps are the column phase in [0, 1) like the reference
(ouster.py:146). Zero ranges (no return) are dropped.

Validated by synthetic-pcap fixture round-trips (tests/test_dataloaders);
real-sensor conformance notes: dual-return profiles and the low-bandwidth
RNG15 profile are not implemented (load via rosbag/mcap instead).

A copy of ``pings_tpu/data/ouster.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from pings_tpu_torch.data.base import BaseDataset, register_loader

LIDAR_PORT_DEFAULT = 7502


# ---------------------------------------------------------------------------
# metadata json
# ---------------------------------------------------------------------------

def find_metadata_json(pcap_file: str) -> str:
    """Best-matching metadata json next to the pcap (longest common
    filename prefix — reference ouster.py:31-46)."""
    import glob

    dir_path, filename = os.path.split(pcap_file)
    dir_path = dir_path or "."
    cands = sorted(glob.glob(os.path.join(dir_path, "*.json")))
    if not cands:
        return ""
    pref = [len(os.path.commonprefix((filename, os.path.basename(p))))
            for p in cands]
    return cands[int(np.argmax(pref))]


def parse_metadata(path: str) -> dict:
    """Extract beam intrinsics + data format; tolerates both the flat and
    the nested ("beam_intrinsics"/"lidar_data_format"/"sensor_info")
    metadata layouts."""
    with open(path) as f:
        raw = json.load(f)

    def find(key, default=None):
        # search top level, then one level of nesting
        if key in raw:
            return raw[key]
        for v in raw.values():
            if isinstance(v, dict) and key in v:
                return v[key]
        return default

    alt_raw = find("beam_altitude_angles")
    az_raw = find("beam_azimuth_angles")
    if alt_raw is None or az_raw is None:
        raise ValueError(
            "ouster metadata json lacks beam_altitude_angles / "
            "beam_azimuth_angles — not a sensor info file")
    alt = np.asarray(alt_raw, np.float64)
    az = np.asarray(az_raw, np.float64)
    n_mm = float(find("lidar_origin_to_beam_origin_mm", 15.806))
    fmt = find("lidar_data_format") or {}
    w = int(fmt.get("columns_per_frame", 0) or 0)
    if not w:
        mode = find("lidar_mode", "1024x10")
        w = int(str(mode).split("x")[0])
    h = int(fmt.get("pixels_per_column", len(alt)))
    cols_per_packet = int(fmt.get("columns_per_packet", 16))
    profile = str(fmt.get("udp_profile_lidar", "LEGACY"))
    T_ls = find("lidar_to_sensor_transform")
    T = (np.asarray(T_ls, np.float64).reshape(4, 4)
         if T_ls is not None else np.diag([1.0, 1.0, 1.0, 1.0]))
    T = T.copy()
    T[:3, 3] /= 1000.0                       # mm -> m
    return dict(alt=alt, az=az, n_m=n_mm / 1000.0, w=w, h=h,
                cols_per_packet=cols_per_packet, profile=profile,
                T_lidar_sensor=T)


def xyz_lut(meta: dict) -> Tuple[np.ndarray, np.ndarray]:
    """Per (row, col) unit direction (H, W, 3) and encoder-origin offset
    (W, 3) implementing the beam model above (applied to range r as
    p = (r - n) * dir + off, then the lidar-to-sensor transform)."""
    h, w = meta["h"], meta["w"]
    theta_enc = 2.0 * np.pi * (1.0 - np.arange(w) / w)            # (W,)
    theta = theta_enc[None, :] + np.radians(meta["az"])[:, None]  # (H, W)
    phi = np.radians(meta["alt"])[:, None]                        # (H, 1)
    dirs = np.stack([np.cos(theta) * np.cos(phi),
                     np.sin(theta) * np.cos(phi),
                     np.broadcast_to(np.sin(phi), (h, w))], -1)
    n = meta["n_m"]
    off = np.stack([n * np.cos(theta_enc), n * np.sin(theta_enc),
                    np.zeros(w)], -1)
    return dirs.astype(np.float64), off.astype(np.float64)


# ---------------------------------------------------------------------------
# pcap + UDP framing
# ---------------------------------------------------------------------------

def pcap_udp_payloads(path: str,
                      port: Optional[int] = None) -> Iterator[bytes]:
    """UDP payloads from a pcap file (ethernet, Linux cooked (SLL) and
    raw-IPv4 link types; big- and little-endian headers, ns variants)."""
    with open(path, "rb") as f:
        gh = f.read(24)
        if len(gh) < 24:
            return
        magic = struct.unpack("<I", gh[:4])[0]
        if magic in (0xA1B2C3D4, 0xA1B23C4D):
            endian = "<"
        elif magic in (0xD4C3B2A1, 0x4D3CB2A1):
            endian = ">"
        else:
            raise ValueError(f"not a pcap file: {path}")
        linktype = struct.unpack(endian + "I", gh[20:24])[0]
        while True:
            rh = f.read(16)
            if len(rh) < 16:
                return
            _, _, incl, _ = struct.unpack(endian + "IIII", rh)
            data = f.read(incl)
            if len(data) < incl:
                return
            if linktype == 1:            # ethernet
                if len(data) < 14:
                    continue
                ethertype = struct.unpack(">H", data[12:14])[0]
                if ethertype == 0x8100 and len(data) >= 18:   # 802.1Q
                    ethertype = struct.unpack(">H", data[16:18])[0]
                    ip = data[18:]
                else:
                    ip = data[14:]
                if ethertype != 0x0800:
                    continue
            elif linktype == 113:        # Linux cooked capture
                if len(data) < 16:
                    continue
                if struct.unpack(">H", data[14:16])[0] != 0x0800:
                    continue
                ip = data[16:]
            elif linktype in (101, 12, 228):   # raw IP
                ip = data
            else:
                continue
            if len(ip) < 20 or (ip[0] >> 4) != 4 or ip[9] != 17:
                continue
            ihl = (ip[0] & 0xF) * 4
            udp = ip[ihl:]
            if len(udp) < 8:
                continue
            dport = struct.unpack(">H", udp[2:4])[0]
            if port is not None and dport != port:
                continue
            ulen = struct.unpack(">H", udp[4:6])[0]
            yield udp[8:ulen]


# ---------------------------------------------------------------------------
# lidar packet decoding
# ---------------------------------------------------------------------------

def _decode_legacy(payload: bytes, h: int, cols: int):
    """LEGACY azimuth blocks: (meas_ids (C,), ts (C,), ranges (C, H) in
    meters, valid (C,)); block = 16B hdr + 12B*h + 4B status."""
    block = 16 + 12 * h + 4
    if len(payload) < block * cols:
        cols = len(payload) // block
        if cols == 0:
            return None
    a = np.frombuffer(payload[:block * cols], np.uint8).reshape(cols, block)
    ts = a[:, 0:8].copy().view("<u8")[:, 0]
    mid = a[:, 8:10].copy().view("<u2")[:, 0].astype(np.int64)
    fid = a[:, 10:12].copy().view("<u2")[:, 0].astype(np.int64)
    ch = a[:, 16:16 + 12 * h].reshape(cols, h, 12)
    rng = (ch[:, :, 0:4].copy().view("<u4")[:, :, 0]
           & 0x000FFFFF).astype(np.float64) / 1000.0
    status = a[:, -4:].copy().view("<u4")[:, 0]
    valid = status != 0
    return mid, fid, ts, rng, valid


def _decode_rng19(payload: bytes, h: int, cols: int):
    """Single-return RNG19_RFL8_SIG16_NIR16 eUDP: 32B packet header,
    columns of 12B hdr + 12B*h channel blocks. The packet frame_id lives
    in the packet header (bytes 2:4)."""
    col = 12 + 12 * h
    need = 32 + col * cols
    if len(payload) < 32 + col:
        return None
    cols = min(cols, (len(payload) - 32) // col)
    fid_pkt = struct.unpack("<H", payload[2:4])[0]
    a = np.frombuffer(payload[32:32 + col * cols],
                      np.uint8).reshape(cols, col)
    ts = a[:, 0:8].copy().view("<u8")[:, 0]
    mid = a[:, 8:10].copy().view("<u2")[:, 0].astype(np.int64)
    status = a[:, 10:12].copy().view("<u2")[:, 0]
    ch = a[:, 12:].reshape(cols, h, 12)
    rng = (ch[:, :, 0:4].copy().view("<u4")[:, :, 0]
           & 0x0007FFFF).astype(np.float64) / 1000.0
    fid = np.full(cols, fid_pkt, np.int64)
    valid = (status & 0x1).astype(bool) | (status == 0xFFFF)
    return mid, fid, ts, rng, valid


@register_loader("ouster")
class OusterDataset(BaseDataset):
    """Sequential Ouster pcap reader (reference ouster.py semantics:
    sequential access, per-column timestamps in [0, 1))."""

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        pcap_file = data_path
        if os.path.isdir(data_path):
            import glob as _g

            pcaps = sorted(_g.glob(os.path.join(data_path, "*.pcap")))
            if not pcaps:
                raise FileNotFoundError(f"no .pcap under {data_path}")
            pcap_file = pcaps[0]
        self.pcap_file = pcap_file
        meta_path = (sequence if sequence and os.path.isfile(sequence)
                     else find_metadata_json(pcap_file))
        if not meta_path:
            raise FileNotFoundError(
                "no metadata json next to the pcap (sensor beam "
                "intrinsics are required)")
        self.meta = parse_metadata(meta_path)
        self.dirs, self.off = xyz_lut(self.meta)
        self.port = getattr(cfg, "ouster_lidar_port", None) \
            or LIDAR_PORT_DEFAULT
        self._frames = self._assemble()

    # -- scan assembly ------------------------------------------------------
    def _decode(self, payload: bytes):
        h = self.meta["h"]
        cols = self.meta["cols_per_packet"]
        if self.meta["profile"].upper().startswith("LEGACY"):
            return _decode_legacy(payload, h, cols)
        return _decode_rng19(payload, h, cols)

    def _assemble(self) -> List[dict]:
        """One pass over the pcap: group columns by frame_id into scans
        (range image (H, W) + per-column presence)."""
        w, h = self.meta["w"], self.meta["h"]
        frames: List[dict] = []
        cur_fid = None
        rng_img = None
        col_seen = None

        def flush():
            if cur_fid is None or not col_seen.any():
                return
            frames.append(dict(rng=rng_img.copy(), cols=col_seen.copy()))

        for payload in pcap_udp_payloads(self.pcap_file, self.port):
            dec = self._decode(payload)
            if dec is None:
                continue
            mid, fid, ts, rng, valid = dec
            for u in np.unique(fid):
                if cur_fid is None or u != cur_fid:
                    flush()
                    cur_fid = int(u)
                    rng_img = np.zeros((h, w), np.float64)
                    col_seen = np.zeros(w, bool)
                sel = (fid == u) & valid & (mid >= 0) & (mid < w)
                rng_img[:, mid[sel]] = rng[sel].T
                col_seen[mid[sel]] = True
        flush()
        return frames

    def __len__(self) -> int:
        return len(self._frames)

    def __getitem__(self, idx: int) -> dict:
        fr = self._frames[idx]
        rng_img = fr["rng"]
        w, h = self.meta["w"], self.meta["h"]
        sel = rng_img > 0
        pts = (rng_img[..., None] - self.meta["n_m"]) * self.dirs \
            + self.off[None, :, :]
        T = self.meta["T_lidar_sensor"]
        pts = pts @ T[:3, :3].T + T[:3, 3]
        ts = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :] / w,
                             (h, w))
        return {
            "points": pts[sel].astype(np.float32),
            "point_ts": ts[sel].astype(np.float32),
        }

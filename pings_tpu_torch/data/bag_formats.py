"""Pure-python parsers for robotics log formats: ROS1 .bag and MCAP.

TPU-native replacement for the reference's streaming loaders, which shell
out to the `rosbags` / `mcap` packages (reference
dataset/dataloaders/rosbag.py:1-137, mcap.py:1-164). Those libraries are
not in this image, and the formats are simple length-prefixed record
containers, so the readers are implemented from the public format specs:

- ROS1 bag 2.0 (http://wiki.ros.org/Bags/Format/2.0): records of
  (header-fields, data); chunks hold nested connection/message records,
  compressed with none/bz2 (bz2 via stdlib; lz4 only if importable).
- MCAP (https://mcap.dev/spec): opcode + length records; Schema/Channel/
  Message (+ Chunk with none/zstd/lz4 compression when the codec module
  is importable).

Message decoding supports sensor_msgs/PointCloud2 in ROS1 serialization
and in ROS2 CDR (little-endian), plus sensor_msgs/Image (rgb8/bgr8/mono8)
for camera topics.

A copy of ``pings_tpu/data/bag_formats.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# PointCloud2 field decoding (shared)
# ---------------------------------------------------------------------------

_PF_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4",
              7: "f4", 8: "f8"}


@dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int


def decode_pointcloud2(fields: List[PointField], point_step: int,
                       data: bytes, n_points: int) -> Dict[str, np.ndarray]:
    """Structured decode of a PointCloud2 payload -> dict of arrays with
    at least x/y/z; also intensity / ring / per-point time when present
    (reference utils/point_cloud2.py read_point_cloud semantics)."""
    names, formats, offsets = [], [], []
    for f in fields:
        if f.datatype not in _PF_DTYPES or f.count != 1:
            continue
        names.append(f.name)
        formats.append("<" + _PF_DTYPES[f.datatype])
        offsets.append(f.offset)
    dt = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                   "itemsize": point_step})
    arr = np.frombuffer(data[:n_points * point_step], dtype=dt)
    out: Dict[str, np.ndarray] = {}
    for key in ("x", "y", "z", "intensity", "ring"):
        if key in names:
            out[key] = np.asarray(arr[key], np.float32)
    for key in ("t", "time", "timestamp", "time_offset", "ts"):
        if key in names:
            ts = np.asarray(arr[key], np.float64)
            out["point_ts"] = ts
            break
    return out


def pointcloud_to_frame_points(pc: Dict[str, np.ndarray]) -> np.ndarray:
    pts = np.stack([pc["x"], pc["y"], pc["z"]], -1).astype(np.float32)
    ok = np.isfinite(pts).all(-1)
    return pts[ok]


# ---------------------------------------------------------------------------
# ROS1 serialization decoders
# ---------------------------------------------------------------------------

class _Cursor:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def u8(self):
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self):
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def u64(self):
        v = struct.unpack_from("<Q", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def raw(self, n):
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def string(self):
        return self.raw(self.u32())


def decode_ros1_pointcloud2(payload: bytes) -> Dict[str, np.ndarray]:
    c = _Cursor(payload)
    c.u32()                    # header.seq
    sec, nsec = c.u32(), c.u32()
    c.string()                 # frame_id
    height, width = c.u32(), c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string().decode()
        off, dtp, cnt = c.u32(), c.u8(), c.u32()
        fields.append(PointField(name, off, dtp, cnt))
    c.u8()                     # is_bigendian
    point_step = c.u32()
    c.u32()                    # row_step
    data = c.string()          # uint8[] with u32 length prefix
    out = decode_pointcloud2(fields, point_step, data, height * width)
    out["stamp"] = np.float64(sec + nsec * 1e-9)
    return out


def decode_ros1_image(payload: bytes) -> Tuple[np.ndarray, float]:
    c = _Cursor(payload)
    c.u32()
    sec, nsec = c.u32(), c.u32()
    c.string()
    height, width = c.u32(), c.u32()
    encoding = c.string().decode()
    c.u8()                     # is_bigendian
    step = c.u32()
    data = c.string()
    img = _image_from(encoding, data, height, width, step)
    return img, sec + nsec * 1e-9


def _image_from(encoding, data, height, width, step):
    ch = {"rgb8": 3, "bgr8": 3, "mono8": 1}.get(encoding)
    if ch is None:
        raise ValueError(f"unsupported image encoding: {encoding}")
    rows = np.frombuffer(data, np.uint8).reshape(height, step)
    img = rows[:, :width * ch].reshape(height, width, ch)
    if encoding == "bgr8":
        img = img[..., ::-1]
    elif ch == 1:
        img = np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------------------
# ROS2 CDR decoders (MCAP "cdr" message encoding)
# ---------------------------------------------------------------------------

class _CdrCursor:
    """Little-endian XCDR1 reader; alignment is relative to the start of
    the serialized body (after the 4-byte encapsulation header)."""

    def __init__(self, buf: bytes):
        assert buf[1] in (0x01, 0x03), "big-endian CDR not supported"
        self.buf = buf
        self.pos = 4

    def _align(self, n):
        rem = (self.pos - 4) % n
        if rem:
            self.pos += n - rem

    def u8(self):
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16(self):
        self._align(2)
        v = struct.unpack_from("<H", self.buf, self.pos)[0]
        self.pos += 2
        return v

    def u32(self):
        self._align(4)
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def i32(self):
        self._align(4)
        v = struct.unpack_from("<i", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def string(self) -> str:
        n = self.u32()          # length includes the null terminator
        v = self.buf[self.pos:self.pos + n - 1]
        self.pos += n
        return v.decode()

    def bytes_seq(self) -> bytes:
        n = self.u32()
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v


def decode_cdr_pointcloud2(payload: bytes) -> Dict[str, np.ndarray]:
    c = _CdrCursor(payload)
    sec, nsec = c.i32(), c.u32()
    c.string()                 # frame_id
    height, width = c.u32(), c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string()
        off = c.u32()
        dtp = c.u8()
        cnt = c.u32()
        fields.append(PointField(name, off, dtp, cnt))
    c.u8()                     # is_bigendian
    point_step = c.u32()
    c.u32()                    # row_step
    data = c.bytes_seq()
    out = decode_pointcloud2(fields, point_step, data, height * width)
    out["stamp"] = np.float64(sec + nsec * 1e-9)
    return out


# ---------------------------------------------------------------------------
# ROS1 bag reader
# ---------------------------------------------------------------------------

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_CHUNK = 0x05
_OP_CONN = 0x07


def _read_fields(buf: bytes, pos: int, end: int) -> Dict[str, bytes]:
    fields = {}
    while pos < end:
        flen = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        field = buf[pos:pos + flen]
        pos += flen
        k, _, v = field.partition(b"=")
        fields[k.decode()] = v
    return fields


def _read_header(buf: bytes, pos: int) -> Tuple[Dict[str, bytes], int]:
    hlen = struct.unpack_from("<I", buf, pos)[0]
    pos += 4
    end = pos + hlen
    return _read_fields(buf, pos, end), end


class Ros1Bag:
    """Sequential ROS1 bag 2.0 reader.

    iterate() yields (topic, msgtype, stamp_ns, payload) in file order.
    """

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        magic = b"#ROSBAG V2.0\n"
        if not self.buf.startswith(magic):
            raise ValueError(f"{path}: not a ROS1 v2.0 bag")
        self.start = len(magic)
        self.connections: Dict[int, Tuple[str, str]] = {}

    def _records(self, buf: bytes, pos: int, end: int):
        while pos < end:
            hdr, pos = _read_header(buf, pos)
            dlen = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            data = buf[pos:pos + dlen]
            pos += dlen
            yield hdr, data

    def _handle_conn(self, hdr, data):
        conn = struct.unpack("<I", hdr["conn"])[0]
        # connection record data = a bare header block of fields
        fields = _read_fields(data, 0, len(data))
        topic = fields.get("topic", hdr.get("topic", b"")).decode()
        mtype = fields.get("type", b"").decode()
        self.connections[conn] = (topic, mtype)

    def iterate(self) -> Iterator[Tuple[str, str, int, bytes]]:
        for hdr, data in self._records(self.buf, self.start,
                                       len(self.buf)):
            op = hdr["op"][0]
            if op == _OP_CONN:
                self._handle_conn(hdr, data)
            elif op == _OP_CHUNK:
                comp = hdr.get("compression", b"none").decode()
                if comp == "bz2":
                    data = bz2.decompress(data)
                elif comp == "lz4":
                    try:
                        import lz4.frame  # type: ignore
                        data = lz4.frame.decompress(data)
                    except ImportError as e:
                        raise ImportError(
                            "bag chunk is lz4-compressed; no lz4 module "
                            "available") from e
                elif comp != "none":
                    raise ValueError(f"unknown bag compression: {comp}")
                for chdr, cdata in self._records(data, 0, len(data)):
                    cop = chdr["op"][0]
                    if cop == _OP_CONN:
                        self._handle_conn(chdr, cdata)
                    elif cop == _OP_MSG:
                        yield self._msg(chdr, cdata)
            elif op == _OP_MSG:
                yield self._msg(hdr, data)

    def _msg(self, hdr, data):
        conn = struct.unpack("<I", hdr["conn"])[0]
        t = struct.unpack("<II", hdr["time"])
        topic, mtype = self.connections.get(conn, ("", ""))
        return topic, mtype, t[0] * 10**9 + t[1], data

    def topics(self) -> Dict[str, str]:
        if not self.connections:
            for _ in self.iterate():
                pass
        return {t: m for t, m in self.connections.values()}


# ---------------------------------------------------------------------------
# MCAP reader
# ---------------------------------------------------------------------------

_MCAP_MAGIC = b"\x89MCAP0\r\n"
_MC_SCHEMA = 0x03
_MC_CHANNEL = 0x04
_MC_MESSAGE = 0x05
_MC_CHUNK = 0x06


class McapFile:
    """Sequential MCAP reader: yields (topic, schema_name, encoding,
    log_time_ns, payload)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        if not self.buf.startswith(_MCAP_MAGIC):
            raise ValueError(f"{path}: not an MCAP file")
        self.schemas: Dict[int, Tuple[str, str]] = {}
        self.channels: Dict[int, Tuple[int, str, str]] = {}

    @staticmethod
    def _string(buf, pos):
        n = struct.unpack_from("<I", buf, pos)[0]
        return buf[pos + 4:pos + 4 + n].decode(), pos + 4 + n

    def _handle(self, op, payload):
        if op == _MC_SCHEMA:
            sid = struct.unpack_from("<H", payload, 0)[0]
            name, p = self._string(payload, 2)
            enc, p = self._string(payload, p)
            self.schemas[sid] = (name, enc)
        elif op == _MC_CHANNEL:
            cid, sid = struct.unpack_from("<HH", payload, 0)
            topic, p = self._string(payload, 4)
            menc, p = self._string(payload, p)
            self.channels[cid] = (sid, topic, menc)

    def _iter_records(self, buf, pos, end):
        while pos + 9 <= end:
            op = buf[pos]
            ln = struct.unpack_from("<Q", buf, pos + 1)[0]
            payload = buf[pos + 9:pos + 9 + ln]
            pos += 9 + ln
            yield op, payload

    def iterate(self) -> Iterator[Tuple[str, str, str, int, bytes]]:
        for op, payload in self._iter_records(
                self.buf, len(_MCAP_MAGIC), len(self.buf)):
            if op in (_MC_SCHEMA, _MC_CHANNEL):
                self._handle(op, payload)
            elif op == _MC_MESSAGE:
                yield self._message(payload)
            elif op == _MC_CHUNK:
                pos = 8 + 8 + 8 + 4
                comp, pos = self._string(payload, pos)
                rlen = struct.unpack_from("<Q", payload, pos)[0]
                records = payload[pos + 8:pos + 8 + rlen]
                if comp in ("", "none"):
                    pass
                elif comp == "zstd":
                    try:
                        import zstandard  # type: ignore
                        records = zstandard.ZstdDecompressor().decompress(
                            records)
                    except ImportError as e:
                        raise ImportError(
                            "mcap chunk is zstd-compressed; no zstandard "
                            "module available") from e
                elif comp == "lz4":
                    try:
                        import lz4.frame  # type: ignore
                        records = lz4.frame.decompress(records)
                    except ImportError as e:
                        raise ImportError(
                            "mcap chunk is lz4-compressed; no lz4 module "
                            "available") from e
                else:
                    raise ValueError(f"unknown mcap compression: {comp}")
                for cop, cpayload in self._iter_records(
                        records, 0, len(records)):
                    if cop in (_MC_SCHEMA, _MC_CHANNEL):
                        self._handle(cop, cpayload)
                    elif cop == _MC_MESSAGE:
                        yield self._message(cpayload)

    def _message(self, payload):
        cid = struct.unpack_from("<H", payload, 0)[0]
        log_time = struct.unpack_from("<Q", payload, 6)[0]
        data = payload[22:]
        sid, topic, menc = self.channels.get(cid, (0, "", ""))
        sname = self.schemas.get(sid, ("", ""))[0]
        return topic, sname, menc, log_time, data

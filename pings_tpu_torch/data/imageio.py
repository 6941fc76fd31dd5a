"""PNG reading and writing in numpy and ``zlib``, in place of ``cv2``.

The JAX package's kitti loader reads images with ``cv2.imread`` and its
data writer writes them with ``cv2.imwrite``; the port runs where OpenCV
is not installed. ``imread_rgb`` gives the array that
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` gives for an 8-bit
PNG (gray is repeated into three channels, alpha is dropped), and
``read_png`` the stored samples, as ``cv2.imread(path,
cv2.IMREAD_UNCHANGED)`` does but in RGB order. Non-interlaced PNGs of bit
depth 8 (gray, RGB, RGBA) and 16-bit gray are read, with all five row
filters; any other PNG raises ``ValueError``. ``write_png`` writes the
same kinds, with one chosen filter for every row (``encode_png`` gives
its bytes).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the kinds read and written here
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) raw bytes of the scanlines in ``data``."""
    if len(data) != h * (stride + 1):
        raise ValueError(f"PNG: {len(data)} bytes of image data, expected "
                         f"{h * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:       # Sub: a running sum per byte of a pixel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
                   % 256).astype(np.uint8).reshape(-1)
        elif ft == 2:       # Up
            cur = line + prior
        elif ft in (3, 4):  # Average, Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {ft} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """The samples of a PNG as stored: (H, W) uint8 or uint16 for gray,
    (H, W, 3) uint8 RGB, (H, W, 4) uint8 RGBA."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated {tag!r} chunk")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, comp, filt, interlace = hdr
    kind = (depth, ctype)
    if (comp, filt, interlace) != (0, 0, 0) or kind not in (
            (8, 0), (8, 2), (8, 6), (16, 0)):
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        return raw.view(">u2").astype(np.uint16).reshape(h, w)
    return raw.reshape(h, w, ch) if ch > 1 else raw.reshape(h, w)


def imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an 8-bit PNG, as
    ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` gives it."""
    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit PNG is not an 8-bit colour "
                         "image")
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def _filter_rows(raw: np.ndarray, bpp: int, ft: int) -> np.ndarray:
    """Filter ``raw`` (h, stride) uint8 scanlines with filter type ``ft``
    (computed from the unfiltered bytes, so all rows at once)."""
    x = raw.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    if ft == 0:
        pred = np.zeros_like(x)
    elif ft == 1:
        pred = left
    elif ft == 2:
        pred = up
    elif ft == 3:
        pred = (left + up) >> 1
    elif ft == 4:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"unknown PNG filter type {ft}")
    return ((x - pred) % 256).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 0,
              level: int = 6) -> None:
    """Write (H, W) uint8/uint16 gray, (H, W, 3) uint8 RGB or (H, W, 4)
    uint8 RGBA as a PNG, every row with ``filter_type`` (0-4)."""
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type, level))


def encode_png(img: np.ndarray, filter_type: int = 0,
               level: int = 6) -> bytes:
    """The bytes of the PNG that ``write_png`` writes."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    kinds = {(np.uint8, 1): (8, 0), (np.uint8, 3): (8, 2),
             (np.uint8, 4): (8, 6), (np.uint16, 1): (16, 0)}
    key = (img.dtype.type, ch)
    if key not in kinds:
        raise ValueError(f"cannot write a PNG of dtype {img.dtype} with "
                         f"{ch} channels")
    depth, ctype = kinds[key]
    if depth == 16:
        raw = img.astype(">u2").view(np.uint8).reshape(h, w * 2)
    else:
        raw = np.ascontiguousarray(img).reshape(h, w * ch)
    bpp = ch * depth // 8
    rows = _filter_rows(raw, bpp, filter_type)
    data = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows],
                          axis=1).tobytes()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(data, level))
            + chunk(b"IEND", b""))

"""A minimal PNG codec on ``zlib`` and numpy, for the images the sensors
read and write: 8-bit gray, RGB and RGBA, and 16-bit gray (TUM depth).

Reading undoes all five row filters (None, Sub, Up, Average, Paeth) of
non-interlaced images; writing uses filter 0 on every row. Palettes,
interlacing, other bit depths and gray + alpha raise ``ValueError``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels; 3 (palette) and 4 (gray + alpha) are not read
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + length


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstruct one scanline of bytes from its filtered bytes."""
    if ftype == 0:
        return row
    if ftype == 2:  # Up
        return row + prev
    if ftype == 1:  # Sub: a running sum per byte lane, mod 256
        lanes = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    if ftype not in (3, 4):
        raise ValueError(f"PNG: unknown row filter {ftype}")
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:  # Average
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0  # Paeth
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str | os.PathLike) -> np.ndarray:
    """Decode a PNG -> (H, W) or (H, W, C) uint8, or (H, W) uint16 for
    16-bit gray."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} is not supported")
    channels = _CHANNELS[ctype]
    if depth != 8 and not (depth == 16 and channels == 1):
        raise ValueError(f"{path}: bit depth {depth} with colour type {ctype} "
                         "is not supported")
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    if depth == 16:
        return out.view(">u2").reshape(height, width).astype(np.uint16)
    return out.reshape(height, width) if channels == 1 else out.reshape(height, width, channels)


def write_png(path: str | os.PathLike, image: np.ndarray) -> None:
    """Encode (H, W) uint8 / uint16 gray or (H, W, 3 | 4) uint8 colour."""
    img = np.asarray(image)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, body = 16, 0, img.astype(">u2")
    elif img.dtype == np.uint8 and (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        depth, body = 8, img
        ctype = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
    else:
        raise ValueError(f"cannot write a {img.dtype} image of shape {img.shape} as PNG")
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(body).view(np.uint8).reshape(height, -1)
    filtered = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(filtered.tobytes())))
        f.write(chunk(b"IEND", b""))

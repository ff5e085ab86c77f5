"""PNG reader and writer on the standard library (zlib + struct).

Covers what the pipeline reads and writes: 8-bit, non-interlaced
grayscale, gray+alpha, RGB and RGBA images, with any of the five
scanline filters (PNG specification, ISO/IEC 15948:2004 section 9).
Palette, 16-bit and interlaced files raise ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _paeth(a, b, c):
    """Paeth predictor (spec 9.4), elementwise on int arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Reconstruct one scanline (uint8) from its filtered bytes."""
    if ftype == 0:
        return line
    if ftype == 2:
        return (line.astype(np.int32) + prev).astype(np.uint8)
    if ftype == 1:
        # Sub: a running sum per channel, modulo 256
        px = line.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) % 256).astype(np.uint8).ravel()
    if ftype not in (3, 4):
        raise ValueError(f"unknown PNG filter type {ftype}")
    # Average and Paeth depend on the reconstructed left neighbour
    out = bytearray(len(line))
    up = prev.tolist()
    for i, x in enumerate(line.tolist()):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """PNG file -> uint8 array: (h, w) for grayscale, else (h, w, c)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace}); need 8-bit, non-interlaced "
            "gray, gray+alpha, RGB or RGBA")
    ch = _CHANNELS[color]
    stride = width * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, "
                         f"expected {height * (stride + 1)}")
    rows = raw.reshape(height, stride + 1)
    img = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        prev = img[r] = _unfilter_row(int(rows[r, 0]), rows[r, 1:], prev, ch)
    img = img.reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img


def _filter_rows(img: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """Apply one filter type to every scanline of (h, stride) uint8."""
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[ftype]
    return ((x - pred) % 256).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> str:
    """uint8 (h, w) or (h, w, c), c in 1..4 -> PNG file, every scanline
    encoded with ``filter_type`` (0-4)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png needs uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png: unsupported shape {img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"unknown PNG filter type {filter_type}")
    height, width, ch = img.shape
    rows = _filter_rows(img.reshape(height, width * ch), filter_type, ch)
    raw = np.concatenate(
        [np.full((height, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    header = struct.pack(">IIBBBBB", width, height, 8, _COLOR_TYPE[ch],
                         0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))
    return path

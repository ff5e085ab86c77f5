"""Standard-library PNG codec (utils/png.py) and the image loader on it."""

import struct
import zlib

import numpy as np
import pytest

from stabilized_navier_stokes_flow_fenicsx.mesh.image import load_image
from stabilized_navier_stokes_flow_fenicsx.utils.png import (
    read_png, write_png)


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_roundtrip(tmp_path, channels, filter_type):
    """gray, gray+alpha, RGB and RGBA through every scanline filter."""
    rng = np.random.default_rng(10 * channels + filter_type)
    img = rng.integers(0, 256, (23, 37, channels), dtype=np.uint8)
    if channels == 1:
        img = img[..., 0]
    path = write_png(str(tmp_path / "a.png"), img, filter_type)
    got = read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def test_png_reads_hand_filtered_rows(tmp_path):
    """A 3x3 gray PNG whose rows use Sub, Paeth and Average filters,
    filtered by hand (PNG spec section 9)."""
    want = np.array([[10, 20, 30], [15, 25, 5], [0, 255, 128]], np.uint8)
    raw = bytes([1, 10, 10, 10,          # Sub: x - left
                 4, 5, 5, 231,           # Paeth: predictors 10, 20, 30
                 3, 249, 243, 254])      # Average: (left + up) // 2
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", 3, 3, 8, 0, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    path = tmp_path / "hand.png"
    path.write_bytes(png)
    np.testing.assert_array_equal(read_png(str(path)), want)


def test_png_rejects_unsupported(tmp_path):
    """Palette images raise instead of decoding wrongly."""
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 3, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(b"\x00\x00"))
           + _chunk(b"IEND", b""))
    path = tmp_path / "pal.png"
    path.write_bytes(png)
    with pytest.raises(ValueError, match="unsupported"):
        read_png(str(path))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_load_image_channel_semantics(tmp_path, channels):
    """Gray scaled to [0, 1]; gray+alpha and RGBA blended over white;
    RGB through BT.709 luma (reference image2inlet.py:42-56)."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (9, 11, channels), dtype=np.uint8)
    x = img.astype(np.float64) / 255.0
    if channels == 1:
        img, want = img[..., 0], x[..., 0]
    elif channels == 2:
        want = x[..., 0] * x[..., 1] + (1.0 - x[..., 1])
    else:
        rgb = x[..., :3]
        if channels == 4:
            rgb = rgb * x[..., 3:4] + (1.0 - x[..., 3:4])
        want = rgb @ np.array([0.2125, 0.7154, 0.0721])
    got = load_image(write_png(str(tmp_path / "c.png"), img))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

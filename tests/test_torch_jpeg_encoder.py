"""The port's baseline JPEG encoder (native/jpeg_encoder.cpp through
data/jpeg.encode_jpeg) against Pillow, on the CPU.

The viewer streams its frames as Pillow's `Image.save(format="JPEG",
quality=85)` bytes (the JAX server's `_to_jpeg`); the card's machine has
no Pillow, so the port writes them itself. Held here: equal bytes to
Pillow at quality 85 on random images (every 8x8 block coded with large
coefficients), smooth and rendered-looking ones, sizes that are not
multiples of 8 or 16 (the replicated edges, the dummy blocks past a
component's right and bottom edges), 1x1, 1-channel input (repeated to 3
channels first, as the JAX server does), and 1920x1080; other qualities
too. The port's decoder reads each file back to Pillow's pixels.
"""

import io

import numpy as np
import pytest
from PIL import Image

from nerfstudio_thermal_torch.data.jpeg import decode_jpeg_bytes, encode_jpeg
from nerfstudio_thermal_torch.viewer.server import to_jpeg

SIZES = [(1, 1), (8, 8), (16, 16), (7, 9), (9, 17), (17, 9), (143, 257), (33, 31), (64, 48), (100, 200)]


def pillow_jpeg(img: np.ndarray, quality: int = 85) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def smooth(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.hypot(yy - h / 2, xx - w / 3) / max(h, w)
    img = np.stack([0.5 + 0.5 * np.sin(6 * r), xx / max(w - 1, 1), 1.0 - yy / max(h - 1, 1)], -1)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def rendered(h, w, seed=0):
    """A sphere on a dark background with noise, as a render looks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.hypot((yy - h / 2) / (h / 2.5), (xx - w / 2) / (w / 2.5))
    shade = np.clip(1.0 - d, 0, 1)[..., None] * np.array([0.9, 0.6, 0.3], np.float32)
    img = shade + rng.normal(0, 0.02, (h, w, 3)).astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def check(img: np.ndarray, quality: int = 85) -> bytes:
    got = encode_jpeg(img, quality=quality)
    rgb = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else np.repeat(img, 3, -1) if img.shape[-1] == 1 else img
    want = pillow_jpeg(rgb, quality)
    assert got == want, f"{img.shape} quality {quality}: {len(got)} bytes, Pillow {len(want)}"
    decoded = decode_jpeg_bytes(got)
    np.testing.assert_array_equal(decoded, np.asarray(Image.open(io.BytesIO(want)).convert("RGB")))
    return got


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("kind", ["random", "smooth", "rendered"])
def test_encoder_writes_pillows_bytes(hw, kind):
    h, w = hw
    if kind == "random":
        img = np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    else:
        img = smooth(h, w) if kind == "smooth" else rendered(h, w)
    check(img)


@pytest.mark.parametrize("shape", [(143, 257), (143, 257, 1), (31, 33, 1)])
def test_one_channel_is_repeated_to_rgb(shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    check(img)


def test_1080p_frame():
    check(rendered(1080, 1920, seed=2))
    check(np.random.default_rng(3).integers(0, 256, (1080, 1920, 3), dtype=np.uint8))


@pytest.mark.parametrize("quality", [10, 50, 75, 95, 100])
def test_other_qualities(quality):
    check(rendered(72, 130, seed=quality), quality)


def test_viewer_frame_conversion():
    """to_jpeg: [0, 1] floats truncated to uint8 and clipped, as the JAX
    server's _to_jpeg converts them; a 1-channel frame repeated to 3."""
    rng = np.random.default_rng(4)
    img = rng.uniform(-0.1, 1.1, (40, 56, 3)).astype(np.float32)
    assert to_jpeg(img) == pillow_jpeg((np.clip(img, 0, 1) * 255).astype(np.uint8))
    grey = rng.uniform(0, 1, (40, 56, 1)).astype(np.float32)
    assert to_jpeg(grey) == pillow_jpeg(np.repeat((grey * 255).astype(np.uint8), 3, -1))


def test_encoder_rejects_what_it_cannot_encode():
    with pytest.raises(TypeError):
        encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((0, 4, 3), np.uint8))

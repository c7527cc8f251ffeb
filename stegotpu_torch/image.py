"""Secret-image codec: image file <-> grayscale pixels <-> bit array.

A copy of ``stegotpu/image.py`` with Pillow imported where it is used, so
that the pipeline imports without it.

The secret image is always embedded as 8-bit grayscale, row-major, one byte
per pixel, MSB-first (reference: helpers.py:5-82 via PIL ``convert('L')`` and
``format(px, '08b')``). Decode stays host-side (PIL); the bit packing is
vectorized numpy instead of the reference's per-pixel string loop.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from stegotpu_torch.bitstream import BitArray


def load_image_gray(path: str | Path) -> np.ndarray:
    """Image file -> uint8 grayscale array (H, W) via PIL 'L' conversion."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("L"), dtype=np.uint8)


def image_to_bits(path: str | Path) -> tuple[int, int, BitArray]:
    """Image file -> (width, height, bit array) (reference: helpers.py:5-42)."""
    pixels = load_image_gray(path)
    height, width = pixels.shape
    return width, height, np.unpackbits(pixels.reshape(-1))


def pixels_to_bytes(pixels: np.ndarray) -> bytes:
    """uint8 grayscale (H, W) -> row-major bytes."""
    return np.ascontiguousarray(pixels, dtype=np.uint8).tobytes()


def bytes_to_pixels(data: bytes, width: int, height: int) -> np.ndarray:
    """Row-major bytes -> uint8 grayscale (H, W) (reference: helpers.py:44-82)."""
    expected = width * height
    if len(data) != expected:
        raise ValueError(
            f"pixel byte length {len(data)} != expected {expected} for {width}x{height}"
        )
    return np.frombuffer(data, dtype=np.uint8).reshape(height, width)


def save_image_gray(pixels: np.ndarray, path: str | Path) -> None:
    """uint8 grayscale (H, W) -> image file (PNG etc.) via PIL mode 'L'."""
    from PIL import Image

    Image.fromarray(np.asarray(pixels, dtype=np.uint8), mode="L").save(path)

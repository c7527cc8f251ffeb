"""Deterministic test/demo fixtures: dummy cover videos and secret images.

A copy of ``stegotpu/fixtures.py`` (tests/test_torch_host.py holds the two
equal) with ``cv2`` imported only where a video is written: the port
cannot import ``stegotpu``, whose package ``__init__`` pulls in JAX. The
exactness harness (ops/exactness.py) makes its 'compressed' covers here.

The reference auto-generates missing inputs (reference:
config_and_setup.py:219-238 — 32x32 light-gray secret + 640x480 24fps 5s
random-noise mp4; evaluation.py:93-142 — 64x64 patterned secret + 320x240
30-frame moving-square video). Same designs here, but with seeded RNG so
fixtures are reproducible.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from stegotpu_torch.image import save_image_gray


def make_secret_image(
    path: str | Path, width: int = 32, height: int = 32, kind: str = "gray", seed: int = 0
) -> None:
    """Write a grayscale secret image fixture.

    kind='gray': flat light-gray (reference: config_and_setup.py:225);
    kind='pattern': black with white/gray squares (reference: evaluation.py:101-104);
    kind='noise': seeded random pixels (worst-case payload).
    """
    if kind == "gray":
        img = np.full((height, width), 211, np.uint8)  # PIL 'lightgray'
    elif kind == "pattern":
        img = np.zeros((height, width), np.uint8)
        img[height // 6 : height // 3, width // 6 : width // 3] = 200
        img[height // 2 : -height // 8, width // 2 : -width // 8] = 150
    elif kind == "noise":
        img = np.random.default_rng(seed).integers(0, 256, (height, width), dtype=np.uint8)
    else:
        raise ValueError(f"unknown secret kind '{kind}'")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    save_image_gray(img, path)


def make_cover_video(
    path: str | Path,
    width: int = 320,
    height: int = 240,
    frames: int = 30,
    fps: float = 30.0,
    kind: str = "moving",
    seed: int = 0,
    codec: str = "mp4v",
) -> None:
    """Write a small cover video fixture.

    kind='moving': static color areas + a moving square (reference:
    evaluation.py:119-137); kind='noise': seeded random frames (reference:
    config_and_setup.py:233).
    """
    import cv2

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*codec), fps, (width, height))
    if not out.isOpened():
        raise IOError(f"cannot open VideoWriter for '{path}'")
    rng = np.random.default_rng(seed)
    # NOTE: mid-range luma base, not black — QIM embedding in saturated
    # (0 or 255) blocks clips the IDCT output and destroys the embedded
    # parity, an inherent limitation of the reference algorithm as well
    # (see tests/test_kernel_golden.py::test_clipping_data_loss_matches_oracle).
    base = np.full((height, width, 3), 110, np.uint8)
    base[height // 4 : 3 * height // 4, width // 4 : 3 * width // 4, 0] = 150
    base[5 * height // 12 : 7 * height // 12, 7 * width // 16 : 9 * width // 16, 1] = 180
    base[height // 12 : height // 3, width // 16 : width // 4, 2] = 190
    for i in range(frames):
        if kind == "noise":
            frame = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        else:
            frame = base.copy()
            pos = (i * 8) % max(1, height - 20)
            frame[pos : pos + 20, pos : pos + 20] = 180
        out.write(frame)
    out.release()

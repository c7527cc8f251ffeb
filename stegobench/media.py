"""The file traffic's inputs, made from a seed: cover videos and secrets.

A cover is a synthetic scene that compresses like video, not flat and not
uniform noise: a smooth background moving in each color channel, textured
shapes (stripes and checkers) moving across it, and low-amplitude seeded
noise, clipped to video range 16..235 in every channel (so luma is too).
The seed moves phases, positions and the noise; every seed has the same
number, sizes and speeds of shapes, so the codecs see the same kind of work
whatever the seed. Covers are written as mp4v, the reference project's
dummy-cover codec, with OpenCV, and read back with OpenCV.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

SHAPES = 6
SHAPE_HW = (120, 160)   # at 1280x720, scaled with the frame
SPEED = 6.0             # pixels a frame, at 1280 wide
NOISE = 3               # +- levels


class Scene:
    def __init__(self, h: int, w: int, rng: np.random.Generator):
        self.h, self.w = h, w
        self.rng = rng
        s = w / 1280.0
        self.phase = rng.uniform(0, 2 * math.pi, (3, 2))
        self.sh = max(2, int(SHAPE_HW[0] * s)), max(2, int(SHAPE_HW[1] * s))
        self.pos = rng.uniform(0, 1, (SHAPES, 2)) * (h, w)
        ang = rng.uniform(0, 2 * math.pi, SHAPES)
        self.vel = np.stack([np.sin(ang), np.cos(ang)], 1) * SPEED * s
        self.color = rng.integers(60, 200, (SHAPES, 3))
        self.period = np.array([8, 12, 16, 24, 32, 48])[:SHAPES] * s
        self.yy = np.arange(h, dtype=np.float32)[:, None]
        self.xx = np.arange(w, dtype=np.float32)[None, :]

    def frame(self, t: int) -> np.ndarray:
        h, w = self.h, self.w
        img = np.empty((3, h, w), np.float32)   # planes, then interleaved
        for c in range(3):
            sx = np.sin(2 * math.pi * (self.xx / w * 1.3 + t / 96
                                       + self.phase[c, 0]))
            sy = np.cos(2 * math.pi * (self.yy / h * 0.9 - t / 160
                                       + self.phase[c, 1]))
            np.multiply((45 * sy).astype(np.float32), sx.astype(np.float32),
                        out=img[c])
        img += 125
        sh, sw = self.sh
        yy = np.arange(sh, dtype=np.float32)[:, None]
        xx = np.arange(sw, dtype=np.float32)[None, :]
        for k in range(SHAPES):
            y0, x0 = (self.pos[k] + t * self.vel[k]) % (h, w)
            y0, x0 = int(y0) % max(1, h - sh), int(x0) % max(1, w - sw)
            p = self.period[k]
            if k % 2:
                tex = np.sign(np.sin(2 * math.pi * (xx + yy) / p))
            else:
                tex = np.sign(np.sin(2 * math.pi * xx / p)
                              * np.sin(2 * math.pi * yy / p))
            img[:, y0:y0 + sh, x0:x0 + sw] = (self.color[k][:, None, None]
                                              + 30 * tex[None])
        noise = np.frombuffer(self.rng.bytes(3 * h * w), np.uint8)
        img += (noise % (2 * NOISE + 1)).reshape(3, h, w)
        img -= NOISE
        np.clip(img, 16, 235, out=img)
        import cv2

        return cv2.merge(list(img.astype(np.uint8)))


def write_cover(path: Path, h: int, w: int, frames: int, fps: float,
                rng: np.random.Generator, codec: str = "mp4v") -> None:
    import cv2

    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*codec), fps,
                          (w, h))
    if not out.isOpened():
        raise IOError(f"cannot open a {codec} writer for {path}")
    scene = Scene(h, w, rng)
    try:
        for t in range(frames):
            out.write(scene.frame(t))
    finally:
        out.release()


def read_frames(path: Path) -> np.ndarray:
    """Every frame of a video as (N, H, W, 3) uint8 BGR."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    try:
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames in {path}")
    return np.stack(frames)


def write_frames(path: Path, frames: np.ndarray, fps: float,
                 codec: str = "FFV1") -> None:
    """(N, H, W, 3) uint8 BGR frames to a video file."""
    import cv2

    n, h, w, _ = frames.shape
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*codec), fps,
                          (w, h))
    if not out.isOpened():
        raise IOError(f"cannot open a {codec} writer for {path}")
    try:
        for f in frames:
            out.write(np.ascontiguousarray(f))
    finally:
        out.release()


def secret(size: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, 256, (size, size), dtype=np.uint8)


def write_png(path: Path, pixels: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(pixels, mode="L").save(path)


def read_png(path: Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("L"), np.uint8)

"""Color conversion matching OpenCV's fixed-point BT.601 BGR->gray exactly.

Counterpart of ``stegotpu/ops/color.py``, with the same integer arithmetic
(15-bit fixed point, bit-exact against cv2):

    gray = (R*9798 + G*19235 + B*3735 + 2^14) >> 15

The three coefficients sum to 2^15, so a GRAY2BGR-replicated frame converts
back to exactly the same gray values — the property the stego round trip
relies on (reference: embed_process.py:126).
"""

from __future__ import annotations

import numpy as np
import torch

_R, _G, _B = 9798, 19235, 3735  # cv2 fixed-point BT.601 weights, sum = 1 << 15
_HALF = 1 << 14
_SHIFT = 15


def bgr_to_gray_np(frames_bgr: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) uint8 BGR -> (..., H, W) uint8 gray, cv2-bit-exact."""
    f = frames_bgr.astype(np.int32)
    acc = f[..., 0] * _B + f[..., 1] * _G + f[..., 2] * _R + _HALF
    return (acc >> _SHIFT).astype(np.uint8)


def bgr_to_gray(frames_bgr: torch.Tensor) -> torch.Tensor:
    """Tensor variant of bgr_to_gray_np (same integer arithmetic)."""
    f = frames_bgr.to(torch.int32)
    acc = f[..., 0] * _B + f[..., 1] * _G + f[..., 2] * _R + _HALF
    return (acc >> _SHIFT).to(torch.uint8)

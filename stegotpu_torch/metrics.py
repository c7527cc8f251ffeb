"""Host-side quality metrics the pipeline needs (``psnr_np`` of
``stegotpu/metrics.py``). The device metrics are not ported yet."""

from __future__ import annotations

import numpy as np


def psnr_np(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB for 8-bit content; inf when identical."""
    d = a.astype(np.float64) - b.astype(np.float64)
    m = float(np.mean(d * d))
    if m == 0:
        return float("inf")
    return 10.0 * float(np.log10(255.0 * 255.0 / m))

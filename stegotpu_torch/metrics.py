"""Quality metrics: PSNR, SSIM and BER, on the device and on the host.

Counterpart of ``stegotpu/metrics.py``. The device half (``mse``,
``psnr``, ``ber``, ``psnr_batch``, ``ssim``, ``ssim_batch``) runs on the
tensors' own device, so a batch of frames is reduced there and only the
per-frame scalars reach the host. The host half (``psnr_np``, ``ssim_np``,
``ber_np``) is numpy/scipy for one-shot comparisons.

The reference's bugs are fixed as in the JAX package: differences are
taken in float (no uint8 wraparound), and SSIM uses the standard
data_range=255 with the 11x11 Gaussian window (sigma 1.5, K1=0.01,
K2=0.03, valid padding).

The Gaussian filter is the same separable shift-and-add as the JAX
package's (11 taps per pass, ``_gauss_filter_batch``), not
``F.conv2d``: on the card a convolution goes through cuDNN, whose
``allow_tf32`` is True by default, and that would put SSIM in TF32.
"""

from __future__ import annotations

import numpy as np
import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.to(torch.float32) - b.to(torch.float32)
    return (d * d).mean()


def _psnr_of_mse(m: torch.Tensor) -> torch.Tensor:
    return torch.where(m == 0, torch.full_like(m, float("inf")),
                       10.0 * torch.log10(255.0 * 255.0 / m))


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PSNR in dB for 8-bit content; inf when identical."""
    return _psnr_of_mse(mse(a, b))


def ber(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """Bit error rate between two equal-length 0/1 tensors."""
    return (bits_a != bits_b).to(torch.float32).mean()


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = _gaussian_1d(size, sigma)
    return np.outer(g, g).astype(np.float32)


def _gauss_filter_batch(x: torch.Tensor) -> torch.Tensor:
    """Separable 11x11 Gaussian, valid padding, over (N, H, W) stacks: a
    horizontal then a vertical pass, each a shift-and-add of 11 slices in
    f32 (stegotpu/metrics.py:50-63)."""
    g = _gaussian_1d()
    h, w = x.shape[-2], x.shape[-1]
    y = sum(float(g[k]) * x[:, :, k : k + w - 10] for k in range(11))
    return sum(float(g[k]) * y[:, k : k + h - 10, :] for k in range(11))


def ssim(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM over an (H, W) image pair, standard Wang et al. parameters."""
    return ssim_batch(a[None], b[None], data_range)[0]


def psnr_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-frame PSNR over (B, H, W) stacks; inf where identical."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return _psnr_of_mse((d * d).mean(dim=(-2, -1)))


def ssim_batch(a: torch.Tensor, b: torch.Tensor,
               data_range: float = 255.0) -> torch.Tensor:
    """Per-frame SSIM over (B, H, W) stacks; the five moment maps go
    through one batched separable filter."""
    if a.shape[-1] < 11 or a.shape[-2] < 11:
        # the 11x11 valid-padded window needs >= 11 px per axis
        raise ValueError(
            f"SSIM needs frames >= 11px per side, got {a.shape[-2]}x"
            f"{a.shape[-1]} (win_size exceeds image)")
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    bsz = a.shape[0]
    f = _gauss_filter_batch(torch.cat([a, b, a * a, b * b, a * b], dim=0))
    mu_a, mu_b = f[:bsz], f[bsz : 2 * bsz]
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = f[2 * bsz : 3 * bsz] - mu_a2
    var_b = f[3 * bsz : 4 * bsz] - mu_b2
    cov = f[4 * bsz :] - mu_ab
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2.0 * mu_ab + c1) * (2.0 * cov + c2)
    den = (mu_a2 + mu_b2 + c1) * (var_a + var_b + c2)
    return (num / den).mean(dim=(-2, -1))


# Host-side implementations: numpy/scipy, for one-shot comparisons.

def psnr_np(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB for 8-bit content; inf when identical."""
    d = a.astype(np.float64) - b.astype(np.float64)
    m = float(np.mean(d * d))
    if m == 0:
        return float("inf")
    return 10.0 * float(np.log10(255.0 * 255.0 / m))


def ssim_np(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    from scipy.ndimage import correlate

    if a.shape[-1] < 11 or a.shape[-2] < 11:
        raise ValueError(
            f"SSIM needs frames >= 11px per side, got {a.shape[-2]}x"
            f"{a.shape[-1]} (win_size exceeds image)")
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    win = _gaussian_kernel().astype(np.float64)

    def filt(x):
        return correlate(x, win, mode="constant")[5:-5, 5:-5]

    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a**2
    var_b = filt(b * b) - mu_b**2
    cov = filt(a * b) - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


def ber_np(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(a != b))

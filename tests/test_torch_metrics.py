"""The port's quality metrics (stegotpu_torch.metrics) against the JAX
package's (stegotpu.metrics), on the CPU.

Inputs are made with numpy from a seed and handed to both. Tolerance:
rtol 1e-5 for every float32 result (the two frameworks sum in another
order; f32 carries about 7 digits), exact for the Gaussian window, for inf
and for the host metrics, which are the same numpy/scipy code. On the card
tests/test_torch_cuda.py holds psnr_batch/ssim_batch against psnr_np/
ssim_np.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stegotpu import metrics as jm
from stegotpu_torch import metrics as tm

RTOL = 1e-5


def _pair(seed, shape=(3, 40, 56), noise=6):
    """A cover and a stego-like copy of it off by a few levels, clipped."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    d = rng.integers(-noise, noise + 1, shape)
    return a, np.clip(a.astype(int) + d, 0, 255).astype(np.uint8)


def test_gaussian_window_equal():
    np.testing.assert_array_equal(tm._gaussian_1d(), jm._gaussian_1d())
    np.testing.assert_array_equal(tm._gaussian_kernel(), jm._gaussian_kernel())
    np.testing.assert_array_equal(tm._gaussian_1d(7, 1.0), jm._gaussian_1d(7, 1.0))


def test_gauss_filter_matches_jax():
    x = np.random.default_rng(1).uniform(0, 255, (4, 23, 31)).astype(np.float32)
    got = tm._gauss_filter_batch(torch.from_numpy(x)).numpy()
    want = np.asarray(jm._gauss_filter_batch(jnp.asarray(x)))
    assert got.shape == want.shape == (4, 13, 21)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_device_metrics_match_jax(seed):
    a, b = _pair(seed)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("mse", "psnr", "ber"):
        got = getattr(tm, name)(ta, tb)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(getattr(jm, name)(ja, jb)),
                                   rtol=RTOL)
    for name in ("psnr_batch", "ssim_batch"):
        got = getattr(tm, name)(ta, tb)
        assert got.shape == (a.shape[0],) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(jm, name)(ja, jb)),
                                   rtol=RTOL)
    np.testing.assert_allclose(float(tm.ssim(ta[0], tb[0])),
                               float(jm.ssim(ja[0], jb[0])), rtol=RTOL)
    np.testing.assert_allclose(
        float(tm.ssim(ta[0], tb[0], data_range=100.0)),
        float(jm.ssim(ja[0], jb[0], data_range=100.0)), rtol=RTOL)


def test_host_metrics_match_jax():
    a, b = _pair(4, (37, 45))
    assert tm.psnr_np(a, b) == jm.psnr_np(a, b)
    assert tm.ssim_np(a, b) == jm.ssim_np(a, b)
    assert tm.ber_np(a > 128, b > 128) == jm.ber_np(a > 128, b > 128)
    # the device SSIM of one pair agrees with the float64 host SSIM
    np.testing.assert_allclose(
        float(tm.ssim(torch.from_numpy(a), torch.from_numpy(b))),
        tm.ssim_np(a, b), rtol=RTOL)


def test_identical_frames_and_no_uint8_wraparound():
    a, _ = _pair(5)
    ta = torch.from_numpy(a)
    assert float(tm.psnr(ta, ta)) == float("inf") == tm.psnr_np(a, a)
    assert torch.isinf(tm.psnr_batch(ta, ta)).all()
    assert torch.equal(tm.ssim_batch(ta, ta), torch.ones(a.shape[0]))
    assert float(tm.mse(ta, ta)) == 0.0 and float(tm.ber(ta, ta)) == 0.0
    # one frame identical, one not: inf only where identical
    b = a.copy()
    b[1, 0, 0] ^= 1
    got = tm.psnr_batch(ta, torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(np.isinf(got), [True, False, True])
    # 0 vs 255: the difference is 255, not a wrapped 1
    black = torch.zeros((1, 16, 16), dtype=torch.uint8)
    white = torch.full((1, 16, 16), 255, dtype=torch.uint8)
    assert float(tm.mse(black, white)) == 255.0 ** 2
    assert float(tm.psnr(black, white)) == 0.0
    assert float(tm.mse(white, black)) == float(jm.mse(jnp.asarray(white.numpy()),
                                                      jnp.asarray(black.numpy())))


@pytest.mark.parametrize("shape", [(2, 10, 32), (2, 32, 10), (2, 5, 5)])
def test_ssim_refuses_frames_under_11_px(shape):
    a = np.zeros(shape, np.uint8)
    for fn in (tm.ssim_batch, lambda x, y: tm.ssim(x[0], y[0])):
        with pytest.raises(ValueError, match="11px"):
            fn(torch.from_numpy(a), torch.from_numpy(a))
    with pytest.raises(ValueError, match="11px"):
        jm.ssim_batch(jnp.asarray(a), jnp.asarray(a))
    for ssim_np in (tm.ssim_np, jm.ssim_np):
        with pytest.raises(ValueError, match="11px"):
            ssim_np(a[0], a[0])
    ok = np.zeros((1, 11, 11), np.uint8)  # the smallest frame that works
    assert tm.ssim_batch(torch.from_numpy(ok), torch.from_numpy(ok)).shape == (1,)

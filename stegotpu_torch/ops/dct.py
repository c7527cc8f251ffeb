"""DCT-II basis matrices for the 8x8 block transform, and block reshapes.

Counterpart of ``stegotpu/ops/dct.py``: the matrices are built by the same
float64 formula and cast once, so they are bit-equal to the JAX package's
(tests/test_torch_host.py). ``blockify``/``unblockify`` work on tensors.

- separable form: ``Y = M @ X @ M.T`` with the orthonormal DCT-II matrix M
  (the CUDA kernels, csrc/qim_stripe.cu);
- Kronecker form: flatten each 8x8 block row-major to a 64-vector and
  apply ``K = M (x) M`` once; the flat coefficient order is the
  reference's row-major ``flatten()`` (config_and_setup.py:136).

The inverse transform matrix is K.T (K is orthonormal).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stegotpu_torch.config import BLOCK


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int = BLOCK, dtype=np.float32) -> np.ndarray:
    """Orthonormal DCT-II matrix: M[k, j] = s(k) * cos(pi*(2j+1)*k / (2n)).

    s(0) = sqrt(1/n), s(k>0) = sqrt(2/n). Matches
    ``scipy.fftpack.dct(x, norm='ortho')`` applied along an axis.
    """
    k = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    mat = np.cos(np.pi * (2.0 * j + 1.0) * k / (2.0 * n))
    mat *= np.sqrt(2.0 / n)
    mat[0, :] *= np.sqrt(0.5)
    out = mat.astype(dtype)
    out.setflags(write=False)  # lru_cache shares this array process-wide
    return out


@functools.lru_cache(maxsize=None)
def kron_dct_matrix(n: int = BLOCK, dtype=np.float32) -> np.ndarray:
    """K = M (x) M, the (n^2, n^2) one-shot 2-D DCT operator on flattened
    blocks, computed in float64 and cast once."""
    m = dct_matrix(n, np.float64)
    out = np.kron(m, m).astype(dtype)
    out.setflags(write=False)  # lru_cache shares this array process-wide
    return out


def kron_dct_tensor(device, dtype=torch.float32) -> torch.Tensor:
    """kron_dct_matrix() as a float32 (or float64) tensor on `device`."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return torch.tensor(kron_dct_matrix(BLOCK, np_dtype), device=device)


def blockify(frames: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """(..., H, W) -> (..., H//b * W//b, b*b) flattened blocks, row-major
    (row of blocks outer, column inner; config_and_setup.py:129-136)."""
    *lead, h, w = frames.shape
    bh, bw = h // block, w // block
    x = frames.reshape(*lead, bh, block, bw, block)
    x = x.transpose(-3, -2)  # (..., bh, bw, block, block)
    return x.reshape(*lead, bh * bw, block * block)


def unblockify(blocks: torch.Tensor, height: int, width: int,
               block: int = BLOCK) -> torch.Tensor:
    """Inverse of blockify: (..., nb, b*b) -> (..., H, W)."""
    *lead, _, _ = blocks.shape
    bh, bw = height // block, width // block
    x = blocks.reshape(*lead, bh, bw, block, block)
    x = x.transpose(-3, -2)  # (..., bh, block, bw, block)
    return x.reshape(*lead, height, width)

"""Independent scalar-loop oracle of the reference QIM/DCT semantics.

A copy of ``tests/reference_model.py`` (tests/test_torch_tools.py holds
the two equal), inside the package so that its tools reach into no test
directory.

This is NOT a copy of the reference code: it is a from-scratch numpy/scipy
implementation of the behavior documented in SURVEY.md §2.4 (reference:
config_and_setup.py:106-174), written to be the slow-but-trusted golden model
that the TPU kernels are validated against. It uses scipy.fftpack like the
reference does, so any float-level divergence between scipy's FFT-based DCT
and the matmul DCT shows up in the comparison.
"""

from __future__ import annotations

import numpy as np
from scipy.fftpack import dct as _dct, idct as _idct

BLOCK = 8


def _dct2(block: np.ndarray) -> np.ndarray:
    return _dct(_dct(block, axis=0, norm="ortho"), axis=1, norm="ortho")


def _idct2(block: np.ndarray) -> np.ndarray:
    return _idct(_idct(block, axis=0, norm="ortho"), axis=1, norm="ortho")


def embed_frame_oracle(
    gray_u8: np.ndarray, payload_bits: str, delta: int, num_ac: int
) -> tuple[np.ndarray, int]:
    """Embed a payload-bit prefix into one grayscale frame, scalar loop.

    Returns (stego uint8 frame, number of bits embedded). Semantics per
    SURVEY.md §2.4: row-major blocks, flat AC indices 1..N, round-half-even
    quantizer, directional parity move, unconditional lattice snap, stop
    mid-block at payload end, untouched blocks pass through, clip + truncating
    uint8 cast.
    """
    h, w = gray_u8.shape
    x = np.float32(gray_u8)
    out = x.copy()
    max_bits = len(payload_bits)
    pos = 0
    n = min(num_ac, BLOCK * BLOCK - 1)
    for r in range(0, h, BLOCK):
        if pos >= max_bits:
            break
        for c in range(0, w, BLOCK):
            if pos >= max_bits:
                break
            coeffs = _dct2(x[r : r + BLOCK, c : c + BLOCK]).flatten()
            modified = coeffs.copy()
            for j in range(n):
                if pos >= max_bits:
                    break
                idx = j + 1
                if delta <= 0:
                    continue
                bit = int(payload_bits[pos])
                q = int(round(coeffs[idx] / delta))
                if q % 2 != bit:
                    q = q + 1 if bit == 1 else q - 1
                modified[idx] = float(q * delta)
                pos += 1
            out[r : r + BLOCK, c : c + BLOCK] = _idct2(modified.reshape(BLOCK, BLOCK))
    return np.uint8(np.clip(out, 0, 255)), pos


def extract_frame_oracle(gray_u8: np.ndarray, delta: int, num_ac: int) -> str:
    """Extract the full QIM capacity of one grayscale frame, scalar loop."""
    h, w = gray_u8.shape
    x = np.float32(gray_u8)
    n = min(num_ac, BLOCK * BLOCK - 1)
    bits: list[str] = []
    for r in range(0, h, BLOCK):
        for c in range(0, w, BLOCK):
            coeffs = _dct2(x[r : r + BLOCK, c : c + BLOCK]).flatten()
            for j in range(n):
                if delta <= 0:
                    bits.append("0")
                    continue
                q = int(round(coeffs[j + 1] / delta))
                bits.append(str(q % 2))
    return "".join(bits)

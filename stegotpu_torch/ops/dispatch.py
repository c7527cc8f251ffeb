"""Kernel variant dispatch: select the embed/extract implementation.

Counterpart of ``stegotpu/ops/dispatch.py``, keeping its ``kernel`` names:

- 'pallas' and 'auto' — ops/stripe_kernel.py: the hand-written CUDA stripe
  kernels. Which version runs follows the device of the frames tensor:
  the CUDA kernel on a CUDA tensor, its plain PyTorch version on a CPU
  tensor (the wrapper decides; there is no fallback).
- 'xla' — ops/qim.py: the f32 Kronecker-matmul oracle.

``precision`` ('wire' or 'fast') is accepted for interchangeability with
the JAX package; the port computes IEEE f32 (the wire arithmetic) under
both.
"""

from __future__ import annotations

from stegotpu_torch.ops import qim, stripe_kernel


def _use_stripe_kernel(kernel: str, h: int, w: int) -> bool:
    return (kernel in ("auto", "pallas") and h % 8 == 0 and w % 8 == 0
            and h > 0 and w > 0)


def embed_fn(kernel: str, h: int, w: int, precision: str = "wire"):
    if _use_stripe_kernel(kernel, h, w):
        return stripe_kernel.embed_frames
    return qim.embed_frames


def extract_fn(kernel: str, h: int, w: int, precision: str = "wire"):
    if _use_stripe_kernel(kernel, h, w):
        return stripe_kernel.extract_frames
    return qim.extract_frames


def extract_packed_fn(kernel: str, h: int, w: int, precision: str = "wire"):
    """Packed-compact-rows extract for the streaming pipeline's fast path,
    or None when the oracle is in use (it has no packed layout). Pair with
    stripe_kernel.packed_rows_to_bits_host."""
    if not _use_stripe_kernel(kernel, h, w):
        return None
    return stripe_kernel.extract_frames_packed

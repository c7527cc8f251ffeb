"""Batched DCT/QIM embed & extract by Kronecker matmul — the port's oracle.

Counterpart of the JAX package's XLA kernel (``stegotpu/ops/qim.py:48-162``),
selected by ``kernel='xla'``, and of its round trip and quality metrics
(``embed_and_extract_frames``, ``roundtrip_metrics``,
``embed_extract_evaluate``, :165-234). It transforms every coefficient of every
block in f32 (``torch.matmul`` at full float32: the port never enables
TF32) and keeps the semantics listed at stegotpu/ops/qim.py:9-25:

- "AC coefficients" are flat row-major indices 1..N of the 8x8 block
  (NOT zigzag) (config_and_setup.py:138-140);
- embed quantizer: q = round(c/delta), round half to even
  (``torch.round``); if the parity (floor-mod, ``torch.remainder`` — not
  ``torch.fmod``) mismatches the payload bit, move q by +1 for bit 1 and
  -1 for bit 0; the coefficient is always rewritten to q*delta (lattice
  snap, config_and_setup.py:146-156);
- bits are consumed row-major, N per block; embedding stops mid-block at
  the payload end; blocks never entered pass through untouched, while
  partially used blocks are still inverse-transformed
  (config_and_setup.py:129-132,141,166-169);
- output pixels: clip to [0,255] then truncating uint8 cast
  (config_and_setup.py:171);
- extract reads round(c/delta) mod 2 for every AC slot of every block.

Frames are (B, H, W) uint8 tensors; scalars are Python numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from stegotpu_torch.config import BLOCK
from stegotpu_torch.metrics import psnr
from stegotpu_torch.ops import stripe_kernel
from stegotpu_torch.ops.dct import blockify, kron_dct_tensor, unblockify
from stegotpu_torch.utils.profiling import annotate


def qim_embed_coeffs(ac: torch.Tensor, bits: torch.Tensor,
                     valid: torch.Tensor, delta: float) -> torch.Tensor:
    """Directional-parity QIM on a tensor of AC coefficients.

    ac: float32 coefficients; bits: 0/1 same shape; valid: bool mask of
    slots actually carrying payload. Invalid slots keep their value.
    """
    q = torch.round(ac / delta)  # round-half-to-even, matches python round()
    parity = torch.remainder(q, 2.0)
    bits_f = bits.to(torch.float32)
    adjust = torch.where(parity != bits_f,
                         torch.where(bits_f == 1.0, 1.0, -1.0), 0.0)
    snapped = (q + adjust) * delta
    return torch.where(valid, snapped, ac)


def embed_frames(frames: torch.Tensor, payload_bits: torch.Tensor,
                 total_bits: int, delta: float, num_ac: int,
                 bit_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Embed payload bits into a batch of frames.

    frames: (B, H, W) uint8; payload_bits: (B, C) uint8 0/1 with
    C = (H/8)*(W/8)*num_ac; frame i consumes global bit indices
    [bit_offset + i*C, bit_offset + (i+1)*C) and total_bits (global) marks
    the payload end. Returns (stego uint8 (B, H, W), bits embedded per
    frame int32 (B,)).
    """
    b, h, w = frames.shape
    nb = (h // BLOCK) * (w // BLOCK)
    cap = nb * num_ac
    delta = float(np.float32(delta))
    dev = frames.device

    xb = blockify(frames.to(torch.float32))  # (B, nb, 64)
    with annotate("stegotpu_torch.host_wait"):  # a pageable copy
        k = kron_dct_tensor(dev)
    y = xb @ k.T
    rem = (total_bits - bit_offset
           - torch.arange(b, dtype=torch.int64, device=dev)[:, None] * cap
           - torch.arange(nb, dtype=torch.int64, device=dev)[None, :] * num_ac
           )[..., None]                                  # (B, nb, 1)
    valid = torch.arange(num_ac, device=dev) < rem        # (B, nb, N)
    bits = payload_bits.reshape(b, nb, num_ac)
    ac_new = qim_embed_coeffs(y[..., 1 : 1 + num_ac], bits, valid, delta)
    y_new = torch.cat([y[..., :1], ac_new, y[..., 1 + num_ac :]], dim=-1)
    x_out = y_new @ k

    # blocks never entered pass through with NO transform round trip
    x_final = torch.where(rem > 0, x_out, xb)
    stego = unblockify(x_final, h, w).clamp(0.0, 255.0)
    stego_u8 = stego.to(torch.int32).to(torch.uint8)     # truncating cast
    first = total_bits - bit_offset - torch.arange(
        b, dtype=torch.int64, device=dev) * cap
    return stego_u8, first.clamp(0, cap).to(torch.int32)


def extract_frames(frames: torch.Tensor, delta: float,
                   num_ac: int) -> torch.Tensor:
    """Extract the full QIM capacity of every frame: (B, C) uint8 bits.
    delta <= 0 reads all-zero bits (config_and_setup.py:143-145)."""
    b = frames.shape[0]
    delta = float(np.float32(delta))
    xb = blockify(frames.to(torch.float32))
    with annotate("stegotpu_torch.host_wait"):  # a pageable copy
        k = kron_dct_tensor(frames.device)
    ac = (xb @ k.T)[..., 1 : 1 + num_ac]
    if not delta > 0:
        return torch.zeros((b, ac[0].numel()), dtype=torch.uint8,
                           device=frames.device)
    bits = torch.remainder(torch.round(ac / delta), 2.0).to(torch.uint8)
    return bits.reshape(b, -1)


def embed_and_extract_frames(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The oracle's round trip, embed then re-extract from the stego:
    (stego, bits per frame, extracted (B, C)) on the frames' device
    (stegotpu/ops/qim.py:216-234)."""
    stego, bits_per_frame = embed_frames(frames, payload_bits, total_bits,
                                         delta, num_ac)
    return stego, bits_per_frame, extract_frames(stego, delta, num_ac)


def roundtrip_metrics(frames: torch.Tensor, stego: torch.Tensor,
                      extracted: torch.Tensor, payload_bits: torch.Tensor,
                      total_bits: int) -> dict[str, torch.Tensor]:
    """Quality metrics of an embed/extract round trip, as 0-dim tensors on
    the frames' device: {psnr_db, bit_errors, payload_bits}
    (stegotpu/ops/qim.py:165-189). Bit errors count payload-carrying slots
    only: slot i of frame f is valid iff i < total_bits - f*C (the
    remaining-bits threshold form).

    On the card one kernel computes them (ops/stripe_kernel.roundtrip_eval:
    an exact integer squared error, nothing that waits for the host); there
    all four tensors must be contiguous uint8 whose storage starts on a
    16-byte boundary (fresh allocations do), and anything else raises
    ValueError. On the CPU it is
    roundtrip_metrics_plain, which takes any dtype and layout. While a
    profiler records, the call is the span ``stegotpu_torch.eval``."""
    with annotate("stegotpu_torch.eval"):
        if frames.device.type == "cuda":
            return stripe_kernel.roundtrip_eval(frames, stego, extracted,
                                                payload_bits, total_bits)
        return roundtrip_metrics_plain(frames, stego, extracted, payload_bits,
                                       total_bits)


def roundtrip_metrics_plain(frames: torch.Tensor, stego: torch.Tensor,
                            extracted: torch.Tensor, payload_bits: torch.Tensor,
                            total_bits: int) -> dict[str, torch.Tensor]:
    """Plain PyTorch version of roundtrip_metrics, on any device: PSNR of
    the float32 mean squared error, the bit errors by a mask of valid
    slots."""
    b, cap = payload_bits.shape
    dev = payload_bits.device
    rem = int(total_bits) - torch.arange(b, dtype=torch.int64,
                                         device=dev)[:, None] * cap
    valid = torch.arange(cap, dtype=torch.int64, device=dev) < rem
    psnr_db = psnr(frames, stego)
    bit_errors = (valid & (extracted != payload_bits)).sum()
    n_bits = torch.full((), min(int(total_bits), b * cap), dtype=torch.int64,
                        device=dev)
    return {"psnr_db": psnr_db, "bit_errors": bit_errors,
            "payload_bits": n_bits}


def embed_extract_evaluate(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """The streaming-evaluation step: the oracle's round trip and its
    metrics, all on the frames' device — (stego, bits per frame, extracted,
    metrics) (stegotpu/ops/qim.py:192-213). Per-frame SSIM is
    metrics.ssim_batch, as in the JAX package."""
    stego, bits_per_frame, extracted = embed_and_extract_frames(
        frames, payload_bits, total_bits, delta, num_ac)
    metrics = roundtrip_metrics(frames, stego, extracted, payload_bits,
                                total_bits)
    return stego, bits_per_frame, extracted, metrics

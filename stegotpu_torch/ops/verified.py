"""Verified embed: closed-loop repair of clipping-induced bit errors.

Counterpart of ``stegotpu/ops/verified.py``. The QIM algorithm loses bits
when a block's IDCT output saturates at 0/255: the clip shifts
coefficients and can flip round(c/delta) parity (catastrophic on black or
white regions, such as a letterboxed film's bars). A single flipped bit
kills the AES-GCM tag; the reference has no defense.

After embedding, re-extract from the actual uint8 stego; for every 8x8
block containing a wrong bit, shift the block's DC coefficient so the
pre-clip pixel range fits inside [0, 255] (DC adds uniformly to all 64
pixels and is never extracted: flat index 0 is outside the payload slots),
re-synthesize, and iterate. The stego stays decodable by any standard QIM
extractor, the reference's included. Blocks whose pre-clip dynamic range
exceeds 255 are unfixable by a DC shift; they are counted in the returned
residual.

``embed_frames_verified`` is the repair loop in plain PyTorch (XLA in the
JAX package, not a Pallas kernel), over the whole batch. On the card
``embed_frames_verified_fast`` runs the whole verified embed as one CUDA
kernel, K3's repair variant (ops/stripe_kernel.embed_and_repair_frames):
each block is embedded, read back and, where it reads wrong, repaired by
the same rule in registers, so the host decides nothing and waits for
nothing. Elsewhere (the CPU, ``kernel='xla'``, delta <= 0) it runs K3
(ops/stripe_kernel.embed_and_check_frames) and takes the repair loop only
when K3 counted a wrong bit.

The repair, the loop or the kernel, runs inside the span
``stegotpu_torch.verified.repair``, and the wait for K3's count inside
``stegotpu_torch.host_wait`` (utils/profiling.annotate). ``REPAIRS``
counts on the host, with no device read: ``"checked"`` fast-path calls,
``"repaired"`` calls that took the repair loop, ``"rounds"`` repair
rounds run. The kernel counts on the device; ``repair_counts`` reads both.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from stegotpu_torch.config import BLOCK
from stegotpu_torch.ops import dispatch, stripe_kernel
from stegotpu_torch.ops.dct import blockify, kron_dct_tensor, unblockify
from stegotpu_torch.ops.qim import qim_embed_coeffs
from stegotpu_torch.utils.profiling import annotate

REPAIRS: collections.Counter[str] = collections.Counter()


def _require_full_f32_matmul() -> None:
    """The repair loop's matmuls are the f32 wire arithmetic (the JAX
    package pins Precision.HIGHEST): TF32 would move coefficients at the
    delta/2 margin, so refuse to run under it rather than ship flipped
    bits."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "verified embed needs full-precision float32 matmuls: unset "
            "torch.backends.cuda.matmul.allow_tf32 and keep "
            "torch.set_float32_matmul_precision('highest')")


def embed_frames_verified(
    frames: torch.Tensor,
    payload_bits: torch.Tensor,
    total_bits: int,
    delta: float,
    num_ac: int,
    repair_rounds: int = 3,  # = StegoConfig.repair_rounds default
    bit_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Embed with closed-loop repair.

    frames: (B, H, W) uint8; payload_bits: (B, C) uint8 0/1 on the same
    device. Returns (stego uint8, bits_per_frame int32 (B,),
    residual_errors int32 scalar tensor), all on the frames' device;
    residual_errors counts the payload slots still wrong after the final
    round (0 in practice except pathological saturated covers).
    """
    _require_full_f32_matmul()
    with annotate("stegotpu_torch.verified.repair"):
        return _repair(frames, payload_bits, total_bits, delta, num_ac,
                       repair_rounds, bit_offset)


def _repair(frames, payload_bits, total_bits, delta, num_ac, repair_rounds,
            bit_offset):
    b, h, w = frames.shape
    dev = frames.device
    nb = (h // BLOCK) * (w // BLOCK)
    cap = nb * num_ac
    delta = float(np.float32(delta))
    k = kron_dct_tensor(dev)

    rem = (int(total_bits) - int(bit_offset)
           - torch.arange(b, dtype=torch.int64, device=dev)[:, None] * cap
           - torch.arange(nb, dtype=torch.int64, device=dev)[None, :] * num_ac
           )[..., None]                                  # (B, nb, 1)
    valid = torch.arange(num_ac, device=dev) < rem
    bits_f = payload_bits.reshape(b, nb, num_ac).to(torch.float32)
    entered = rem > 0

    xb = blockify(frames.to(torch.float32))              # original blocks
    y0 = xb @ k.T
    # the ONE lattice implementation (qim.qim_embed_coeffs), as in the
    # JAX package: a local copy would desynchronize the verified embedder
    # from the standard one if the embed convention ever changed
    ac_snapped = qim_embed_coeffs(y0[..., 1 : 1 + num_ac], bits_f, valid,
                                  delta)

    def synthesize_float(dc_shift):
        """dc_shift: (B, nb) DC adjustment -> pre-clip float blocks."""
        dc = y0[..., :1] + dc_shift[..., None]
        y_new = torch.cat([dc, ac_snapped, y0[..., 1 + num_ac :]], dim=-1)
        return torch.where(entered, y_new @ k, xb)

    def finalize(x_float):
        stego = unblockify(x_float, h, w).clamp(0.0, 255.0)
        return stego.to(torch.int32).to(torch.uint8)     # truncating cast

    def recovered_bits(stego_u8):
        y = blockify(stego_u8.to(torch.float32)) @ k.T
        return torch.remainder(torch.round(y[..., 1 : 1 + num_ac] / delta),
                               2.0)

    dc_shift = torch.zeros((b, nb), dtype=torch.float32, device=dev)
    x_float = synthesize_float(dc_shift)
    stego = finalize(x_float)

    # Each pixel carries DC/8 (the orthonormal DC basis value is exactly
    # 1/8), so shifting DC by 8*d moves every pixel of the block by d.
    for _ in range(repair_rounds):
        REPAIRS["rounds"] += 1
        got = recovered_bits(stego)
        bad_block = (valid & (got != bits_f)).any(dim=-1)  # (B, nb)
        pixel_shift = stripe_kernel.shift_rule(x_float.amin(dim=-1),
                                               x_float.amax(dim=-1))
        dc_shift = dc_shift + torch.where(bad_block, 8.0 * pixel_shift, 0.0)
        x_float = synthesize_float(dc_shift)
        stego = finalize(x_float)

    residual = (valid & (recovered_bits(stego) != bits_f)).sum(
        dtype=torch.int32)
    first = int(total_bits) - int(bit_offset) - torch.arange(
        b, dtype=torch.int64, device=dev) * cap
    return stego, first.clamp(0, cap).to(torch.int32), residual


def embed_frames_verified_fast(
    frames: torch.Tensor,
    payload_bits: torch.Tensor,
    total_bits: int,
    delta: float,
    num_ac: int,
    repair_rounds: int = 3,  # = StegoConfig.repair_rounds default
    kernel: str = "auto",
    precision: str = "wire",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Verified embed on the fast path. On the card (stripe kernels,
    delta > 0) one launch of K3's repair variant embeds, reads back and
    repairs each block that reads wrong in registers; nothing waits for
    the device. Elsewhere K3 embeds, re-extracts the quantized stego in
    the same pass and counts wrong payload bits, and the repair decision
    is taken on the HOST from the summed count, as in the JAX package
    (``int()`` waits for the device once per batch): only when clipping
    actually flipped bits does the repair loop run. Kernels that are not
    stripe kernels (``kernel='xla'``) take the repair loop directly, by
    the same rule as the unverified dispatch.

    precision: accepted for interchangeability. The JAX package recounts
    the residual under 'fast' for its bf16 reader; the port's 'fast'
    reader runs the wire arithmetic, so there is nothing to recount.
    """
    REPAIRS["checked"] += 1
    _, h, w = frames.shape
    if not dispatch._use_stripe_kernel(kernel, h, w):
        REPAIRS["repaired"] += 1
        return embed_frames_verified(frames, payload_bits, total_bits, delta,
                                     num_ac, repair_rounds=repair_rounds)
    if frames.device.type == "cuda" and float(np.float32(delta)) > 0:
        with annotate("stegotpu_torch.verified.repair"):
            return stripe_kernel.embed_and_repair_frames(
                frames, payload_bits, total_bits, delta, num_ac,
                repair_rounds)
    stego, bpf, errors = stripe_kernel.embed_and_check_frames(
        frames, payload_bits, total_bits, delta, num_ac)
    with annotate("stegotpu_torch.host_wait"):
        clean = int(errors.sum()) == 0
    if clean:
        return stego, bpf, torch.zeros((), dtype=torch.int32,
                                       device=frames.device)
    REPAIRS["repaired"] += 1
    return embed_frames_verified(frames, payload_bits, total_bits, delta,
                                 num_ac, repair_rounds=repair_rounds)


# the names under which repair_counts gives stripe_kernel.repair_counter's
# counts, the repair variant's, beside REPAIRS'
VARIANT_COUNTS = ("blocks_wrong", "block_rounds", "residual_slots")


def repair_counts(device: torch.device | str) -> dict[str, int]:
    """What the verified embed counted, read on the host; a copy from the
    device that waits for it, for tests, chip_smoke.py and ``--timing``,
    never on the hot path. REPAIRS' host counts (``"checked"``,
    ``"repaired"``, ``"rounds"``: calls, calls that took the repair loop,
    the loop's rounds) and the repair variant's on `device` since the
    process started (stripe_kernel.repair_counter): ``"blocks_wrong"``
    blocks that read back wrong after the embed, ``"block_rounds"`` repair
    rounds summed over blocks, ``"residual_slots"`` valid slots still
    wrong after the last round."""
    return {**{k: REPAIRS[k] for k in ("checked", "repaired", "rounds")},
            **dict(zip(VARIANT_COUNTS,
                       stripe_kernel.repair_counter(device).tolist()))}

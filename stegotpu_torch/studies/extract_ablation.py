"""K9: the extract kernel K5 with stages removed, to see what each costs.

Counterpart of ``benchmarks/extract_ablation.py``, whose ``kern_*`` bodies
(:35-116, pallas_call :61, :92) become one CUDA kernel,
``qim_ablation_kernel<RN, V>`` in ``csrc/qim_study.cu``, with a variant per
body. Every variant writes K5's layout, (B, (H/stripe)*rows_pad, W) u8
with zero padding rows:

- ``full``: slot-row coefficients, then round(y/delta) mod 2 — K5 byte for
  byte (the same ``slot_bits`` of csrc/qim_common.cuh);
- ``no_qim``: the same coefficients through the truncating u8 cast, which
  wraps mod 256 through int32 (the JAX package's ``_f32_to_u8``);
- ``no_horiz``: the vertical 8-point DCT rows g < rn of each block at every
  pixel column, then the QIM bits;
- ``io_only``: u8(int32(pixel[jg*stripe + k, x] * delta)) for k < rows_pad;
- ``io_f4``: ``io_only`` with four frames per CTA (B % 4 == 0);
- ``full_notrunc``: ``full`` reading f32 frames.

The JAX script hands its kernels a single-pass bf16 horizontal matrix, so
its ``kern_full`` is not the wire K5; the port's ``full`` is (ROADMAP
queue 3). ``ablate`` launches the kernel on a CUDA tensor and runs
``ablate_plain`` only on a CPU tensor;
``stripe_kernel.LAUNCHES["stegotpu_qim_ablation:<variant>"]`` counts the
launches. ``python -m stegotpu_torch.studies.extract_ablation`` times each
variant on the card (defaults: the script's B=128 at 1080x1920).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stegotpu_torch.config import BLOCK
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.ops.dct import blockify, dct_matrix
from stegotpu_torch.studies import bounds, harness

VARIANTS = ("full", "no_qim", "no_horiz", "io_only", "io_f4", "full_notrunc")


def _wrap_u8(y: torch.Tensor) -> torch.Tensor:
    """The truncating u8 cast through int32: toward zero, then mod 256."""
    return y.to(torch.int32).to(torch.uint8)


def _lanes_to_rows(lanes: torch.Tensor, h: int, w: int, stripe: int
                   ) -> torch.Tensor:
    """(B, nb, rn, 8) u8 lanes per block -> K5's layout (B,
    (H/stripe)*rows_pad, W): lane v of slot row g of block (jg*stripe/8 + i,
    bx) at row jg*rows_pad + i*rn + g, column 8*bx + v; padding rows 0."""
    b, _, rn, _ = lanes.shape
    bh_s, bw = stripe // BLOCK, w // BLOCK
    rp = sk._rows_pad(stripe, rn)
    x = lanes.reshape(b, h // stripe, bh_s, bw, rn, BLOCK).permute(0, 1, 2, 4, 3, 5)
    out = torch.zeros((b, h // stripe, rp, w), dtype=torch.uint8,
                      device=lanes.device)
    out[:, :, : bh_s * rn] = x.reshape(b, h // stripe, bh_s * rn, w)
    return out.reshape(b, (h // stripe) * rp, w)


def ablate_plain(frames: torch.Tensor, delta: float, num_ac: int,
                 variant: str) -> torch.Tensor:
    """Plain PyTorch version of K9 `variant`, same arguments and layout."""
    b, h, w = frames.shape
    stripe = sk.pick_stripe(h)
    rn = sk.rows_per_block(num_ac)
    delta = float(np.float32(delta))
    if variant in ("full", "full_notrunc"):
        return sk.extract_frames_rows_plain(frames, delta, num_ac)
    if variant in ("io_only", "io_f4"):
        rp = sk._rows_pad(stripe, rn)
        x = frames.reshape(b, h // stripe, stripe, w)[:, :, :rp]
        return _wrap_u8(x.to(torch.float32) * delta).reshape(
            b, (h // stripe) * rp, w)
    m = torch.tensor(dct_matrix(BLOCK, np.float32), device=frames.device)
    xb = blockify(frames.to(torch.float32)).reshape(b, -1, BLOCK, BLOCK)
    t = m[:rn] @ xb                                   # (b, nb, rn, 8) vertical
    if variant == "no_horiz":
        return _lanes_to_rows(sk._extract_bits(t, delta), h, w, stripe)
    return _lanes_to_rows(_wrap_u8(t @ m.T), h, w, stripe)  # no_qim


def _check(frames: torch.Tensor, delta: float, variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown K9 variant {variant!r}; one of {VARIANTS}")
    want = torch.float32 if variant == "full_notrunc" else torch.uint8
    if frames.dtype != want or frames.dim() != 3:
        raise ValueError(f"K9 {variant} takes (B, H, W) {want} frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    b, h, w = frames.shape
    if h % BLOCK or w % BLOCK:
        raise ValueError(f"frame dims {h}x{w} must be multiples of {BLOCK}")
    if variant == "io_f4" and b % 4:
        raise ValueError(f"K9 io_f4 takes four frames per CTA: B={b} is not a "
                         "multiple of 4")
    if variant.startswith("io") and not abs(float(delta)) * 255 < 2 ** 31:
        raise ValueError(f"K9 {variant}: pixel*delta must fit int32 "
                         f"(delta {delta})")
    if frames.device.type == "cuda" and (
            not frames.is_contiguous() or frames.data_ptr() % 16):
        raise ValueError("CUDA frames must be contiguous and 16-byte aligned")


def ablate(frames: torch.Tensor, delta: float, num_ac: int,
           variant: str) -> torch.Tensor:
    """K9 `variant` of the extract on a batch of frames, on their device:
    (B, (H/stripe)*rows_pad, W) u8 in K5's layout. frames: (B, H, W) u8,
    f32 for full_notrunc."""
    _check(frames, delta, variant)
    if frames.device.type == "cpu":
        return ablate_plain(frames, delta, num_ac, variant)
    if frames.device.type != "cuda":
        raise ValueError(f"frames on unsupported device {frames.device}")
    b, h, w = frames.shape
    shape, stripe, rp = sk._packed_shape(b, h, w, num_ac, w)
    out = torch.empty(shape, dtype=torch.uint8, device=frames.device)
    if out.numel():
        dev = frames.device
        sk.launch("stegotpu_qim_ablation", frames.data_ptr(), out.data_ptr(),
                  sk._dct_on(dev).data_ptr(), dev.index,
                  VARIANTS.index(variant), b, h, w, num_ac, stripe, rp,
                  float(delta), sk._stream(dev), variant=variant)
    return out


def main(argv=None) -> int:
    ap = harness.parser("Time each K9 variant of the extract on the card.", 128)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    dev = harness.require_cuda("extract_ablation")
    if dev is None:
        return 2
    b, h, w, n = args.batch, args.height, args.width, harness.NUM_AC
    frames, _ = harness.inputs(dev, b, h, w)
    frames_f32 = None
    harness.header("extract_ablation", dev, args)
    for variant in args.variants.split(","):
        if variant == "full_notrunc":
            frames_f32 = frames.to(torch.float32)  # frames fed in f32
        x = frames_f32 if variant == "full_notrunc" else frames
        ms = harness.queued_ms(lambda: ablate(x, harness.DELTA, n, variant),
                               runs=args.iters)
        nbytes, _ = bounds.work(f"ablation_{variant}", b, h, w, n,
                                sk.pick_stripe(h))
        harness.emit({"variant": variant, "batch": b, "ms_per_batch": ms,
                      "ms_per_frame": ms / b, "fps": b / ms * 1e3,
                      "bytes_per_batch": nbytes,
                      "gbps": nbytes / ms / 1e6})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K11: the fused round trip K4 with two frames per thread as two
independent dependency chains.

Counterpart of ``benchmarks/dualchain_r5.py``: its ``_dual_kernel`` (:43,
pallas_call :91) becomes the CUDA kernel
``qim_roundtrip_dual_kernel<RN, Arith, MINB>`` in ``csrc/qim_study.cu``.
Each thread loads the same 8x8 block of frames 2z and 2z+1 and both
blocks' payload bits, then embeds, stores and re-extracts both with K4's
``embed_block`` and ``slot_bits`` in K4's Hopper spelling; nothing in one
chain waits on the other, so the compiler may interleave them for
instruction-level parallelism, at twice the live state of K4. Its stego,
bits per frame (written by the kernel) and packed bits are K4's byte for
byte. B must be even.

``dual_roundtrip_packed`` launches the kernel on a CUDA tensor and runs
``dual_roundtrip_packed_plain`` only on a CPU tensor;
``stripe_kernel.LAUNCHES["stegotpu_qim_roundtrip_dual"]``
counts the launches. ``python -m stegotpu_torch.studies.dualchain_r5``
checks K11 against K4 and times both on the card (defaults: the script's
B=512 at 1080x1920).
"""

from __future__ import annotations

import sys

import torch

from stegotpu_torch.config import BLOCK
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.studies import bounds, harness


def _check_even(frames: torch.Tensor) -> None:
    if frames.dim() == 3 and frames.shape[0] % 2:
        raise ValueError(f"K11 takes frames in pairs: B={frames.shape[0]} is "
                         "odd")


def dual_roundtrip_packed_plain(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K11: K4's plain version (the two chains are
    a schedule, not another function)."""
    _check_even(frames)
    return sk.embed_and_extract_frames_packed_plain(
        frames, payload_bits, total_bits, delta, num_ac)


def dual_roundtrip_packed(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11: K4's (stego, bits per frame, packed) with two frames per
    thread. B must be even."""
    b, h, w = sk._check_frames(frames)
    sk._check_payload(payload_bits, frames, num_ac)
    _check_even(frames)
    if frames.device.type == "cpu":
        return dual_roundtrip_packed_plain(frames, payload_bits, total_bits,
                                           delta, num_ac)
    shape, stripe, rp = sk._packed_shape(b, h, w, num_ac, w // BLOCK)
    stego = torch.empty_like(frames)
    packed = torch.empty(shape, dtype=torch.uint8, device=frames.device)
    if not stego.numel():  # no block, no bit
        return stego, torch.zeros(b, dtype=torch.int32,
                                  device=frames.device), packed
    bpf = torch.empty(b, dtype=torch.int32, device=frames.device)
    dev = frames.device
    sk.launch("stegotpu_qim_roundtrip_dual", frames.data_ptr(),
              payload_bits.data_ptr(), stego.data_ptr(), bpf.data_ptr(),
              packed.data_ptr(), dev.index, b, h, w, num_ac, int(total_bits),
              stripe, rp, float(delta), sk._stream(dev))
    return stego, bpf, packed


def dual_roundtrip(frames: torch.Tensor, payload_bits: torch.Tensor,
                   total_bits: int, delta: float, num_ac: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11, then the wire-order unpack: (stego, bits per frame, extracted
    (B, C) u8), the signature of the JAX script's dual_roundtrip."""
    _, h, w = sk._check_frames(frames)
    stego, bpf, packed = dual_roundtrip_packed(frames, payload_bits,
                                               total_bits, delta, num_ac)
    return stego, bpf, sk.packed_rows_to_bits(packed, h, w, num_ac,
                                              sk.pick_stripe(h))


def main(argv=None) -> int:
    ap = harness.parser("Check the two-chain fused round trip (K11) against "
                        "K4 and time both on the card.", 512)
    args = ap.parse_args(argv)
    dev = harness.require_cuda("dualchain_r5")
    if dev is None:
        return 2
    b, h, w = args.batch, args.height, args.width
    n, delta = harness.NUM_AC, harness.DELTA
    if b % 2:
        print("dualchain_r5: --batch must be even", file=sys.stderr)
        return 2
    frames, payload = harness.inputs(dev, b, h, w)
    total = b * payload.shape[1] - 13  # ends mid-block in the last frame
    harness.header("dualchain_r5", dev, args)
    ref = sk.embed_and_extract_frames_packed(frames, payload, total, delta, n)
    got = dual_roundtrip_packed(frames, payload, total, delta, n)
    same = all(torch.equal(a, c) for a, c in zip(ref, got))
    harness.emit({"check": "K11 (stego, bpf, packed) == K4", "ok": same})
    if not same:
        return 1
    del ref, got
    ms_default = harness.queued_ms(lambda: sk.embed_and_extract_frames_packed(
        frames, payload, total, delta, n), runs=args.iters)
    ms_dual = harness.queued_ms(lambda: dual_roundtrip_packed(
        frames, payload, total, delta, n), runs=args.iters)
    nbytes, _ = bounds.work("roundtrip_dual", b, h, w, n, sk.pick_stripe(h))
    harness.emit({"batch": b, "iters": args.iters,
                  "ms_default": ms_default, "ms_dualchain": ms_dual,
                  "fps_default": b / ms_default * 1e3,
                  "fps_dualchain": b / ms_dual * 1e3,
                  "gbps_dualchain": nbytes / ms_dual / 1e6,
                  "speedup": ms_default / ms_dual})
    return 0


if __name__ == "__main__":
    sys.exit(main())

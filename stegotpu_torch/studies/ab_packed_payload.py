"""K10: the embed K1 with its payload read bit-packed, 8 slots to a byte.

Counterpart of ``benchmarks/ab_packed_payload.py``: its
``_embed_kernel_packedin`` (:73, pallas_call :111) becomes the CUDA
kernel ``qim_embed_packedin_kernel<RN>`` in ``csrc/qim_study.cu``. The
payload comes in ``payload_to_rows_packed``'s layout (:53-61), which is
K2's packed compact rows: byte (f, jg*rp + i*rn + g, bx) = sum_s bit(8g+s)
<< s. The kernel reads the block's rn bytes, ignores the non-slot bits and
never reads the padding rows, and calls K1's ``embed_block``: its stego is
K1's byte for byte on the same bits. K1 reads the payload in wire order,
one u8 per bit; K10 reads an eighth of those bytes.

``embed_frames_packedin`` launches the kernel on a CUDA tensor and runs
``embed_frames_packedin_plain`` only on a CPU tensor;
``stripe_kernel.LAUNCHES["stegotpu_qim_embed_packedin"]``
counts the launches. ``python -m stegotpu_torch.studies.ab_packed_payload``
checks K10 against K1 and times both on the card (defaults: the script's
B=512 at 1080x1920).
"""

from __future__ import annotations

import sys

import torch

from stegotpu_torch.config import BLOCK
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.ops.stripe_kernel import payload_to_rows_packed
from stegotpu_torch.studies import bounds, harness


def _check_packed(packed: torch.Tensor, frames: torch.Tensor,
                  num_ac: int) -> tuple[int, int]:
    """Validate the packed payload against the frames; (stripe, rows_pad)."""
    b, h, w = frames.shape
    shape, stripe, rp = sk._packed_shape(b, h, w, num_ac, w // BLOCK)
    if (packed.dtype != torch.uint8 or tuple(packed.shape) != shape
            or packed.device != frames.device or not packed.is_contiguous()):
        raise ValueError(
            f"packed payload must be contiguous {shape} uint8 on "
            f"{frames.device}, got {tuple(packed.shape)} {packed.dtype} on "
            f"{packed.device}")
    return stripe, rp


def embed_frames_packedin_plain(frames: torch.Tensor, packed: torch.Tensor,
                                total_bits: int, delta: float, num_ac: int
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K10: unpack the slot bits to wire order,
    then K1's plain embed."""
    _, h, w = frames.shape
    bits = sk.packed_rows_to_bits(packed, h, w, num_ac, sk.pick_stripe(h))
    return sk.embed_frames_plain(frames, bits.contiguous(), total_bits, delta,
                                 num_ac)


def embed_frames_packedin(frames: torch.Tensor, packed: torch.Tensor,
                          total_bits: int, delta: float, num_ac: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K10: embed a bit-packed payload. frames: (B, H, W) u8; packed: (B,
    (H/stripe)*rows_pad, W/8) u8 from payload_to_rows_packed. Returns
    (stego (B, H, W) u8, bits per frame (B,) int32) on the frames' device.
    Global bit 0 is the payload's first bit (no bit offset)."""
    b, h, w = sk._check_frames(frames)
    stripe, rp = _check_packed(packed, frames, num_ac)
    if frames.device.type == "cpu":
        return embed_frames_packedin_plain(frames, packed, total_bits, delta,
                                           num_ac)
    cap = (h // BLOCK) * (w // BLOCK) * num_ac
    stego = torch.empty_like(frames)
    if stego.numel():
        dev = frames.device
        sk.launch("stegotpu_qim_embed_packedin", frames.data_ptr(),
                  packed.data_ptr(), stego.data_ptr(),
                  sk._dct_on(dev).data_ptr(), dev.index, b, h, w, num_ac,
                  int(total_bits), stripe, rp, float(delta), sk._stream(dev))
    return stego, sk._bits_per_frame(b, cap, int(total_bits), 0,
                                     frames.device)


def main(argv=None) -> int:
    ap = harness.parser("Check the bit-packed-payload embed (K10) against K1 "
                        "and time both on the card.", 512)
    args = ap.parse_args(argv)
    dev = harness.require_cuda("ab_packed_payload")
    if dev is None:
        return 2
    b, h, w = args.batch, args.height, args.width
    n, delta = harness.NUM_AC, harness.DELTA
    frames, payload = harness.inputs(dev, b, h, w)
    total = b * payload.shape[1]
    stripe = sk.pick_stripe(h)
    packed = payload_to_rows_packed(payload, h, w, n, stripe)
    harness.header("ab_packed_payload", dev, args)
    s_ref, bpf_ref = sk.embed_frames(frames, payload, total, delta, n)
    s_new, bpf_new = embed_frames_packedin(frames, packed, total, delta, n)
    same = torch.equal(s_ref, s_new) and torch.equal(bpf_ref, bpf_new)
    harness.emit({"check": "K10 stego == K1 stego", "ok": same})
    if not same:
        return 1
    del s_ref, s_new
    arms = {
        "embed_unpacked": ("embed", lambda: sk.embed_frames(
            frames, payload, total, delta, n)),
        "embed_packedin": ("embed_packedin", lambda: embed_frames_packedin(
            frames, packed, total, delta, n)),
        "pack_then_embed_packedin": (None, lambda: embed_frames_packedin(
            frames, payload_to_rows_packed(payload, h, w, n, stripe), total,
            delta, n)),
    }
    ms = {}
    for label, (kernel, fn) in arms.items():
        ms[label] = harness.queued_ms(fn, runs=args.iters)
        row = {"variant": label, "batch": b, "ms_per_batch": ms[label],
               "fps": b / ms[label] * 1e3}
        if kernel:
            nbytes, _ = bounds.work(kernel, b, h, w, n, stripe)
            row.update(bytes_per_batch=nbytes, gbps=nbytes / ms[label] / 1e6)
        harness.emit(row)
    harness.emit({"packed_over_unpacked":
                  ms["embed_packedin"] / ms["embed_unpacked"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())

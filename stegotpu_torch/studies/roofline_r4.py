"""K12: the floors under the fused round trip — the card's u8 copy rate and
K4's in/out set with no math — beside the embed and the round trip.

Counterpart of ``benchmarks/roofline_r4.py``. Its DMA-only variants
(``build_variant`` :53-149, pallas_call :91, :149) become the CUDA kernel
``copy_kernel<V>`` in ``csrc/qim_study.cu``:

- ``copy`` (:85-86): stego = frames, 16-byte loads and stores, the card's
  u8 streaming ceiling (``copy_frames``, plain version ``frames.clone()``);
- ``dmaspec`` (:79-81): K4's in/out set with no math. It reads the frames
  and the wire-order (B, C) payload, as the port's K4 does, and writes
  stego = frames and packed = the payload in K2's packed layout
  (``dmaspec``; plain version: a clone and ``payload_to_rows_packed``).

The study's ``embed`` and ``fused`` variants call the port's K1 and K4;
``fused_s216`` and ``fused_s360`` run K4 with that stripe passed
explicitly; ``fused_buf3`` and ``fused_buf4`` (K4 with Mosaic's pipeline
buffer count 3 and 4) run K13, the round trip through a ring of 3 and 4
tiles (studies/emitpipe_r4.py); the others run at ``pick_stripe`` of the
height. A variant whose stripe does not divide the height prints an error
row, and the study exits 1. The JAX variants ``fused_pp``, ``fused_arb``
and ``fused_cost`` set Mosaic compiler options; each is printed as a row
with ``"counterpart": null`` and the reason.
``stripe_kernel.LAUNCHES["stegotpu_copy:copy"]`` and
``LAUNCHES["stegotpu_copy:dmaspec"]`` count the launches.
``python -m stegotpu_torch.studies.roofline_r4`` times each variant on the
card (defaults: the script's B=128 at 1080x1920; at B=128 the working set
is some 580 MB, far beyond the 50 MB L2).
"""

from __future__ import annotations

import functools
import sys

import torch

from stegotpu_torch.config import BLOCK
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.ops.stripe_kernel import payload_to_rows_packed
from stegotpu_torch.studies import bounds, emitpipe_r4, harness

_COPY, _DMASPEC = 0, 1  # csrc/qim_study.cu CopyVariant

# (label, stripe, what it runs): stripe None is pick_stripe of the height;
# what it runs None: the JAX variant has no counterpart
GRID = [
    ("copy", None, "copy"),
    ("dmaspec", None, "dmaspec"),
    ("fused", None, "roundtrip_packed"),
    ("embed", None, "embed"),
    ("fused_pp", None, None),
    ("fused_cost", None, None),
    ("fused_arb", None, None),
    ("fused_s216", 216, "roundtrip_packed"),
    ("fused_s360", 360, "roundtrip_packed"),
    ("fused_buf3", None, "roundtrip_pipe_buf3"),
    ("fused_buf4", None, "roundtrip_pipe_buf4"),
]

NO_COUNTERPART = {
    "fused_pp": "Mosaic dimension_semantics ('parallel', 'parallel'): a CUDA "
                "grid's blocks run in no order, so there is no grid axis to "
                "mark",
    "fused_arb": "Mosaic dimension_semantics ('arbitrary', 'arbitrary'): a "
                 "CUDA grid's blocks run in no order, so there is no grid "
                 "axis to mark",
    "fused_cost": "pl.CostEstimate is a hint to XLA's scheduler around a "
                  "pallas_call; no CUDA launch reads one",
}


def copy_frames_plain(frames: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K12 copy."""
    return frames.clone()


def copy_frames(frames: torch.Tensor) -> torch.Tensor:
    """K12 copy: a new (B, H, W) u8 tensor equal to frames, on their
    device."""
    b, h, w = sk._check_frames(frames)
    if frames.device.type == "cpu":
        return copy_frames_plain(frames)
    if frames.data_ptr() % 16:
        raise ValueError("K12 copy moves 16-byte words: frames must be "
                         "16-byte aligned")
    stego = torch.empty_like(frames)
    if stego.numel():
        dev = frames.device
        sk.launch("stegotpu_copy", frames.data_ptr(), None, stego.data_ptr(),
                  None, dev.index, _COPY, b, h, w, 0, BLOCK, BLOCK,
                  sk._stream(dev), variant="copy")
    return stego


def dmaspec_plain(frames: torch.Tensor, payload_bits: torch.Tensor,
                  num_ac: int, stripe: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K12 dmaspec."""
    _, h, w = frames.shape
    return frames.clone(), payload_to_rows_packed(
        payload_bits, h, w, num_ac, sk._stripe_for(h, stripe))


def dmaspec(frames: torch.Tensor, payload_bits: torch.Tensor, num_ac: int,
            stripe: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K12 dmaspec: K4's inputs read and its outputs written, with no
    math. Returns (stego = frames, packed = payload_to_rows_packed of the
    payload), on the frames' device."""
    b, h, w = sk._check_frames(frames)
    sk._check_payload(payload_bits, frames, num_ac)
    shape, stripe, rp = sk._packed_shape(b, h, w, num_ac, w // BLOCK, stripe)
    if frames.device.type == "cpu":
        return dmaspec_plain(frames, payload_bits, num_ac, stripe)
    stego = torch.empty_like(frames)
    packed = torch.empty(shape, dtype=torch.uint8, device=frames.device)
    if stego.numel():
        dev = frames.device
        sk.launch("stegotpu_copy", frames.data_ptr(), payload_bits.data_ptr(),
                  stego.data_ptr(), packed.data_ptr(), dev.index, _DMASPEC,
                  b, h, w, num_ac, stripe, rp, sk._stream(dev),
                  variant="dmaspec")
    return stego, packed


def stripe_row(label: str, stripe: int | None, h: int) -> int | dict:
    """The stripe a variant runs at height h (`stripe`, or pick_stripe(h)
    when it is None), or, where it does not divide h, the variant's error
    row."""
    try:
        return sk._stripe_for(h, stripe)
    except ValueError as e:
        return {"variant": label, "stripe": stripe, "error": str(e)}


def variant_call(kernel: str, stripe: int, frames: torch.Tensor,
                 payload: torch.Tensor, delta: float, num_ac: int):
    """A no-argument callable running `kernel` (a GRID entry's third
    field) on the inputs, and its bytes per frame (bounds.work)."""
    b, h, w = frames.shape
    total = b * payload.shape[1]
    fn = {
        "copy": lambda: copy_frames(frames),
        "dmaspec": lambda: dmaspec(frames, payload, num_ac, stripe),
        "embed": lambda: sk.embed_frames(frames, payload, total, delta,
                                         num_ac),
        "roundtrip_packed": lambda: sk.embed_and_extract_frames_packed(
            frames, payload, total, delta, num_ac, stripe=stripe),
        **{f"roundtrip_pipe_buf{n}": functools.partial(
            emitpipe_r4.roundtrip_pipelined_packed, frames, payload, total,
            delta, num_ac, n, stripe) for n in emitpipe_r4.BUFS},
    }[kernel]
    nbytes, _ = bounds.work(kernel, b, h, w, num_ac, stripe)
    return fn, nbytes / b


def main(argv=None) -> int:
    ap = harness.parser("Time the copy and DMA-set floors beside the embed "
                        "and the fused round trip on the card.", 128)
    ap.add_argument("--variants", default=None, help="comma list; default all")
    args = ap.parse_args(argv)
    dev = harness.require_cuda("roofline_r4")
    if dev is None:
        return 2
    b, h, w, n = args.batch, args.height, args.width, harness.NUM_AC
    grid = GRID
    if args.variants:
        want = set(args.variants.split(","))
        grid = [g for g in GRID if g[0] in want]
    frames, payload = harness.inputs(dev, b, h, w)
    harness.header("roofline_r4", dev, args)
    ok = True
    for label, stripe, kernel in grid:
        if kernel is None:
            harness.emit({"variant": label, "counterpart": None,
                          "reason": NO_COUNTERPART[label]})
            continue
        stripe = stripe_row(label, stripe, h)
        if isinstance(stripe, dict):
            harness.emit(stripe)
            ok = False
            continue
        fn, bytes_per_frame = variant_call(kernel, stripe, frames, payload,
                                           harness.DELTA, n)
        ms = harness.queued_ms(fn, runs=args.iters)
        harness.emit({"variant": label, "stripe": stripe, "batch": b,
                      "ms_per_batch": ms, "ms_per_128": ms * 128 / b,
                      "fps": b / ms * 1e3,
                      "gbps": b * bytes_per_frame / ms / 1e6,
                      "bytes_per_frame": bytes_per_frame})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""The QIM/DCT stripe kernels: embed, extract, and their fused forms.

Counterpart of ``stegotpu/ops/pallas_kernel.py``. Six kernels, each a
hand-written CUDA C++ kernel for Hopper (csrc/qim_stripe.cu, built and
bound by ops/_build.py) with its plain PyTorch version beside it:

- K1 ``embed_frames`` replaces ``_embed_kernel`` (pallas_kernel.py:529);
  plain version ``embed_frames_plain``;
- K2 ``extract_frames_packed`` replaces ``_extract_kernel_packed``
  (pallas_kernel.py:577); plain version ``extract_frames_packed_plain``;
- K3 ``embed_and_check_frames`` replaces ``_embed_check_kernel``
  (pallas_kernel.py:906), the verified embed's fast path; plain version
  ``embed_and_check_frames_plain``;
- K4 ``embed_and_extract_frames_packed`` replaces
  ``_roundtrip_kernel_packed`` (pallas_kernel.py:804); plain version
  ``embed_and_extract_frames_packed_plain``;
- K5 ``extract_frames_rows`` replaces ``_extract_kernel``
  (pallas_kernel.py:545); plain version ``extract_frames_rows_plain``;
- K6 ``embed_and_extract_frames_rows`` replaces ``_roundtrip_kernel``
  (pallas_kernel.py:785), the unpacked fused round trip; plain version
  ``embed_and_extract_frames_rows_plain``.

A wrapper runs the plain version only because the tensor it was given lies
on the CPU; on a CUDA tensor it launches the kernel or raises — there is
no fallback. ``EMBED_LAUNCHES``, ``EXTRACT_LAUNCHES``, ``CHECK_LAUNCHES``,
``ROUNDTRIP_LAUNCHES``, ``EXTRACT_ROWS_LAUNCHES`` and
``ROUNDTRIP_ROWS_LAUNCHES`` count the kernel launches (and nothing else),
so a run can show that it went through them.

The plain versions compute the same sparse-delta form in f32: blockify,
``xb @ K^T`` on the slot columns of the Kronecker DCT matrix K, the QIM
delta on valid slots, then ``x + dy @ K[slots]``. Semantics are those of
``stegotpu/ops/qim.py:9-25``: row-major AC slots 1..num_ac,
round-half-even, directional parity, lattice snap, mid-block stop,
passthrough of blocks never entered, truncating u8 cast. The fused plain
versions are K1's and K2's plain versions run one after the other, so
they hold the same identities as the kernels: K3's, K4's and K6's stego
is K1's, K4's bits and K3's count are K2's reading of that stego, and
K6's rows are K5's.

K2 and K4 keep the TPU kernels' packed compact-rows output layout as their
interface, (B, (H/stripe)*rows_pad, W/8) u8: byte (f, jg*rp + i*rn + g, bx)
holds sum_s bit(8g+s) << s of block (jg*stripe/8 + i, bx), and the
sublane-pad rows are 0. K5 writes the same rows unpacked, (B,
(H/stripe)*rows_pad, W) u8 with bit s of that byte in lane 8*bx + s. So
``packed_rows_to_bits_host`` and the pipeline's ``_PackedBitBuf`` carry
over unchanged; the layout helpers below mirror pallas_kernel.py:75-134 and
:198-281 exactly. K6 writes K5's layout. K3, K4 and K6 have no bit offset:
global bit 0 is the payload's first bit, as in the TPU kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from stegotpu_torch.config import BLOCK
from stegotpu_torch.ops import _build
from stegotpu_torch.ops.dct import blockify, kron_dct_tensor, unblockify

EMBED_LAUNCHES = 0
EXTRACT_LAUNCHES = 0
CHECK_LAUNCHES = 0
ROUNDTRIP_LAUNCHES = 0
EXTRACT_ROWS_LAUNCHES = 0
ROUNDTRIP_ROWS_LAUNCHES = 0


# --- layout helpers (numpy/int, mirrors of pallas_kernel.py) -----------------

def rows_per_block(num_ac: int) -> int:
    """In-block pixel rows that contain payload slots (flat c = 1..num_ac)."""
    return num_ac // BLOCK + 1


def _rows_pad(stripe: int, rn: int) -> int:
    """Packed-rows chunk height per stripe, padded to a multiple of 8 (the
    TPU kernel's sublane tiling, kept as the interface layout)."""
    n = (stripe // BLOCK) * rn
    return -(-n // BLOCK) * BLOCK


def pick_stripe(h: int) -> int:
    import logging
    import os

    override = os.environ.get("STEGOTPU_PALLAS_STRIPE")
    if override:
        try:
            s = int(override)
        except ValueError:
            s = -1
        if s > 0 and s % BLOCK == 0 and h % s == 0:
            return s
        logging.getLogger("stegotpu_torch").warning(
            "ignoring STEGOTPU_PALLAS_STRIPE=%r: must be a positive multiple "
            "of %d dividing height %d", override, BLOCK, h,
        )
    for s in (120, 96, 72, 48, 24, 8):
        if h % s == 0:
            return s
    raise ValueError(f"height {h} is not a multiple of 8")


def _slot_span(g: int, num_ac: int) -> tuple[int, int]:
    """In-block column range [s0, s1) of payload slots on slot row g
    (flat coefficient c = 8g + s must lie in [1, num_ac])."""
    return max(0, 1 - BLOCK * g), max(0, min(BLOCK, num_ac - BLOCK * g + 1))


def packed_rows_to_bits_host(packed: np.ndarray, h: int, w: int, num_ac: int,
                             stripe: int) -> np.ndarray:
    """Host-side (numpy) wire-order unpack of K2's bit-packed compact rows
    -> (B, C).

    Accepts a STRIPE-GROUP PREFIX: an array whose row dim covers only the
    first g <= H/stripe groups (g inferred from the shape) unpacks to the
    first g * (stripe/8)*(W/8)*num_ac wire bits of each frame — the unit
    the pipeline's sliced device readback ships (pipeline._PackedBitBuf).
    """
    b = packed.shape[0]
    bw = w // BLOCK
    rn = rows_per_block(num_ac)
    bh_s = stripe // BLOCK
    rp = _rows_pad(stripe, rn)
    if packed.shape[1] % rp:
        raise ValueError(
            f"packed rows dim {packed.shape[1]} is not a multiple of the "
            f"per-stripe-group chunk {rp}"
        )
    g = packed.shape[1] // rp  # stripe groups present (full frame or prefix)
    r = packed.reshape(b, g, rp, bw)[:, :, : bh_s * rn]
    r = np.ascontiguousarray(r).reshape(b, g * bh_s, rn, bw, 1)
    shifts = np.arange(BLOCK, dtype=np.uint8)
    bits = (r >> shifts) & np.uint8(1)        # (b, bh, rn, bw, 8)
    parts = [
        bits[:, :, g, :, s0:s1]
        for g, (s0, s1) in ((g, _slot_span(g, num_ac)) for g in range(rn))
    ]
    return np.concatenate(parts, axis=-1).reshape(b, -1)


def _slot_lanes_to_bits(r: torch.Tensor, num_ac: int) -> torch.Tensor:
    """(B, bh, rn, bw, 8) per-lane bits -> (B, C) wire order."""
    rn = rows_per_block(num_ac)
    parts = [r[:, :, g, :, s0:s1]
             for g, (s0, s1) in ((g, _slot_span(g, num_ac)) for g in range(rn))]
    return torch.cat(parts, dim=-1).reshape(r.shape[0], -1)


def packed_rows_to_bits(packed: torch.Tensor, h: int, w: int, num_ac: int,
                        stripe: int) -> torch.Tensor:
    """packed_rows_to_bits_host on the tensor's own device: full frames of
    packed rows -> (B, C) wire-order bits."""
    b = packed.shape[0]
    rn = rows_per_block(num_ac)
    rp = _rows_pad(stripe, rn)
    r = packed.reshape(b, h // stripe, rp, w // BLOCK)[:, :, : (stripe // BLOCK) * rn]
    r = r.reshape(b, h // BLOCK, rn, w // BLOCK, 1)
    shifts = torch.arange(BLOCK, dtype=torch.uint8, device=packed.device)
    return _slot_lanes_to_bits((r >> shifts) & 1, num_ac)


def rows_to_bits(rows: torch.Tensor, h: int, w: int, num_ac: int,
                 stripe: int) -> torch.Tensor:
    """Wire-order unpack of K5's unpacked compact rows -> (B, C), on the
    tensor's own device (mirror of pallas_kernel.py:198-213)."""
    b = rows.shape[0]
    rn = rows_per_block(num_ac)
    rp = _rows_pad(stripe, rn)
    r = rows.reshape(b, h // stripe, rp, w)[:, :, : (stripe // BLOCK) * rn]
    return _slot_lanes_to_bits(
        r.reshape(b, h // BLOCK, rn, w // BLOCK, BLOCK), num_ac)


def count_wrong_bits(extracted: torch.Tensor, payload_bits: torch.Tensor,
                     total_bits: int) -> torch.Tensor:
    """(B,) int32: per frame, the slots below global bit total_bits whose
    extracted bit differs from the payload's ((B, C) wire order both)."""
    b, cap = payload_bits.shape
    idx = torch.arange(b * cap, dtype=torch.int64,
                       device=payload_bits.device).reshape(b, cap)
    wrong = (idx < int(total_bits)) & (extracted != payload_bits)
    return wrong.sum(dim=1, dtype=torch.int32)


# --- plain PyTorch versions ---------------------------------------------------

def _bits_per_frame(b: int, cap: int, total_bits: int, bit_offset: int,
                    device) -> torch.Tensor:
    first = total_bits - bit_offset - torch.arange(
        b, dtype=torch.int64, device=device) * cap
    return first.clamp(0, cap).to(torch.int32)


def _qim_sparse_delta(ys: torch.Tensor, bits: torch.Tensor,
                      valid: torch.Tensor, delta: float) -> torch.Tensor:
    """Directional-parity QIM + lattice snap as a sparse coefficient delta:
    snapped - original on valid slots, exactly 0 elsewhere. delta <= 0
    embeds nothing (reference config_and_setup.py:143-145)."""
    if not delta > 0:
        return torch.zeros_like(ys)
    q = torch.round(ys / delta)
    parity = torch.remainder(q, 2.0)
    adjust = torch.where(parity != bits, torch.where(bits == 1.0, 1.0, -1.0),
                         0.0)
    return torch.where(valid, (q + adjust) * delta - ys, 0.0)


def _extract_bits(y: torch.Tensor, delta: float) -> torch.Tensor:
    """round(c/delta) mod 2 as u8; delta <= 0 reads all-zero bits."""
    if not delta > 0:
        return torch.zeros(y.shape, dtype=torch.uint8, device=y.device)
    return torch.remainder(torch.round(y / delta), 2.0).to(torch.uint8)


def embed_frames_plain(frames: torch.Tensor, payload_bits: torch.Tensor,
                       total_bits: int, delta: float, num_ac: int,
                       bit_offset: int = 0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, same arguments and results."""
    b, h, w = frames.shape
    nb = (h // BLOCK) * (w // BLOCK)
    cap = nb * num_ac
    delta = float(np.float32(delta))
    xb = blockify(frames.to(torch.float32))            # (b, nb, 64)
    ks = kron_dct_tensor(frames.device)[1 : 1 + num_ac]  # (num_ac, 64)
    y = xb @ ks.T                                       # slot coefficients
    rem = (total_bits - bit_offset
           - torch.arange(b, dtype=torch.int64, device=frames.device)[:, None]
           * cap
           - torch.arange(nb, dtype=torch.int64, device=frames.device)[None, :]
           * num_ac)[..., None]                         # bits left at block start
    valid = torch.arange(num_ac, device=frames.device) < rem
    bits = payload_bits.reshape(b, nb, num_ac).to(torch.float32)
    dy = _qim_sparse_delta(y, bits, valid, delta)
    # dy == 0 for never-entered blocks -> exact passthrough of x
    x = unblockify(xb + dy @ ks, h, w)
    stego = x.clamp(0.0, 255.0).to(torch.int32).to(torch.uint8)  # truncating
    return stego, _bits_per_frame(b, cap, total_bits, bit_offset,
                                  frames.device)


def extract_frames_packed_plain(frames: torch.Tensor, delta: float,
                                num_ac: int) -> torch.Tensor:
    """Plain PyTorch version of K2, same arguments and result layout."""
    b, h, w = frames.shape
    stripe = pick_stripe(h)
    rn = rows_per_block(num_ac)
    rp = _rows_pad(stripe, rn)
    bh_s, bw = stripe // BLOCK, w // BLOCK
    delta = float(np.float32(delta))
    xb = blockify(frames.to(torch.float32))             # (b, nb, 64)
    k = kron_dct_tensor(frames.device)[: rn * BLOCK]     # slot rows, all lanes
    bits = _extract_bits(xb @ k.T, delta).reshape(b, -1, rn, BLOCK)
    weights = torch.tensor([1 << s for s in range(BLOCK)], dtype=torch.uint8,
                           device=frames.device)
    packed = (bits * weights).sum(-1, dtype=torch.uint8)  # (b, nb, rn)
    packed = packed.reshape(b, h // stripe, bh_s, bw, rn).permute(0, 1, 2, 4, 3)
    out = torch.zeros((b, h // stripe, rp, bw), dtype=torch.uint8,
                      device=frames.device)
    out[:, :, : bh_s * rn] = packed.reshape(b, h // stripe, bh_s * rn, bw)
    return out.reshape(b, (h // stripe) * rp, bw)


def extract_frames_rows_plain(frames: torch.Tensor, delta: float,
                              num_ac: int) -> torch.Tensor:
    """Plain PyTorch version of K5: K2's plain bytes spread one bit per
    lane, same result layout as K5."""
    b, _, w = frames.shape
    packed = extract_frames_packed_plain(frames, delta, num_ac)
    shifts = torch.arange(BLOCK, dtype=torch.uint8, device=frames.device)
    return ((packed[..., None] >> shifts) & 1).reshape(b, packed.shape[1], w)


def embed_and_extract_frames_packed_plain(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: K1's plain embed, then K2's plain
    extract of its stego."""
    stego, bpf = embed_frames_plain(frames, payload_bits, total_bits, delta,
                                    num_ac)
    return stego, bpf, extract_frames_packed_plain(stego, delta, num_ac)


def embed_and_extract_frames_rows_plain(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6: K1's plain embed, then K5's plain
    extract of its stego."""
    stego, bpf = embed_frames_plain(frames, payload_bits, total_bits, delta,
                                    num_ac)
    return stego, bpf, extract_frames_rows_plain(stego, delta, num_ac)


def embed_and_extract_frames_fused_plain(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's plain version, then the wire-order unpack: (stego, bits per
    frame, extracted (B, C))."""
    _, h, w = frames.shape
    stego, bpf, rows = embed_and_extract_frames_rows_plain(
        frames, payload_bits, total_bits, delta, num_ac)
    return stego, bpf, rows_to_bits(rows, h, w, num_ac, pick_stripe(h))


def embed_and_check_frames_plain(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: K4's plain version, then the count of
    valid slots that read back wrong, per frame."""
    _, h, w = frames.shape
    stego, bpf, packed = embed_and_extract_frames_packed_plain(
        frames, payload_bits, total_bits, delta, num_ac)
    got = packed_rows_to_bits(packed, h, w, num_ac, pick_stripe(h))
    return stego, bpf, count_wrong_bits(got, payload_bits, total_bits)


# --- kernel wrappers ----------------------------------------------------------

def _check_frames(frames: torch.Tensor) -> tuple[int, int, int]:
    if frames.dtype != torch.uint8 or frames.dim() != 3:
        raise ValueError(f"frames must be (B, H, W) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    b, h, w = frames.shape
    if h % BLOCK or w % BLOCK:
        raise ValueError(f"frame dims {h}x{w} must be multiples of {BLOCK}")
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"frames on unsupported device {frames.device}")
    if frames.device.type == "cuda" and (
            not frames.is_contiguous() or frames.data_ptr() % 8):
        # the kernels load and store 8-byte block rows
        raise ValueError("CUDA frames must be contiguous and 8-byte aligned")
    return b, h, w


def _check_payload(payload_bits: torch.Tensor, frames: torch.Tensor,
                   num_ac: int) -> int:
    """Validate (B, C) contiguous u8 payload bits on the frames' device;
    returns C, the capacity of one frame."""
    b, h, w = frames.shape
    cap = (h // BLOCK) * (w // BLOCK) * num_ac
    if (payload_bits.dtype != torch.uint8 or tuple(payload_bits.shape) != (b, cap)
            or payload_bits.device != frames.device
            or not payload_bits.is_contiguous()):
        raise ValueError(
            f"payload_bits must be contiguous ({b}, {cap}) uint8 on "
            f"{frames.device}, got {tuple(payload_bits.shape)} "
            f"{payload_bits.dtype} on {payload_bits.device}")
    return cap


_DCT_ON_DEVICE: dict[torch.device, torch.Tensor] = {}


def _dct_on(device: torch.device) -> torch.Tensor:
    """dct_matrix(8) as f32 on `device` (the kernels' 64-entry operand)."""
    if device not in _DCT_ON_DEVICE:
        from stegotpu_torch.ops.dct import dct_matrix

        _DCT_ON_DEVICE[device] = torch.tensor(dct_matrix(BLOCK, np.float32),
                                              device=device)
    return _DCT_ON_DEVICE[device]


def _launch(entry: str, *args) -> None:
    """Call a C entry point of the kernel library and raise on its CUDA
    error (a refused launch never runs, and a later synchronize would not
    report it)."""
    lib = _build.load_library()
    _build.check(lib, getattr(lib, entry)(*args), f"{entry} launch")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _packed_shape(b: int, h: int, w: int, num_ac: int, lanes: int
                  ) -> tuple[tuple[int, int, int], int, int]:
    """((B, (H/stripe)*rows_pad, lanes) output shape, stripe, rows_pad)."""
    stripe = pick_stripe(h)
    rp = _rows_pad(stripe, rows_per_block(num_ac))
    return (b, (h // stripe) * rp, lanes), stripe, rp


def embed_frames(frames: torch.Tensor, payload_bits: torch.Tensor,
                 total_bits: int, delta: float, num_ac: int,
                 bit_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: embed payload bits into a batch of frames.

    frames: (B, H, W) uint8, H and W multiples of 8. payload_bits: (B, C)
    uint8 0/1, C = (H/8)*(W/8)*num_ac; frame i consumes global bit indices
    [bit_offset + i*C, bit_offset + (i+1)*C), and total_bits (global) marks
    the payload end. Returns (stego (B, H, W) uint8, bits per frame (B,)
    int32) on the frames' device — the signature of ops/qim.embed_frames.
    """
    global EMBED_LAUNCHES
    b, h, w = _check_frames(frames)
    cap = _check_payload(payload_bits, frames, num_ac)
    if frames.device.type == "cpu":
        return embed_frames_plain(frames, payload_bits, total_bits, delta,
                                  num_ac, bit_offset)
    stego = torch.empty_like(frames)
    if stego.numel():
        dev = frames.device
        _launch("stegotpu_qim_embed", frames.data_ptr(),
                payload_bits.data_ptr(), stego.data_ptr(),
                _dct_on(dev).data_ptr(), dev.index, b, h, w, num_ac,
                int(total_bits), int(bit_offset), float(delta), _stream(dev))
        EMBED_LAUNCHES += 1
    return stego, _bits_per_frame(b, cap, int(total_bits), int(bit_offset),
                                  frames.device)


def extract_frames_packed(frames: torch.Tensor, delta: float,
                          num_ac: int) -> torch.Tensor:
    """K2: extract every slot bit, packed 8 per byte in the compact-rows
    layout (B, (H/stripe)*rows_pad, W/8) uint8, on the frames' device.
    Pair with packed_rows_to_bits_host (streaming pipeline) or
    packed_rows_to_bits (on the device)."""
    global EXTRACT_LAUNCHES
    b, h, w = _check_frames(frames)
    if frames.device.type == "cpu":
        return extract_frames_packed_plain(frames, delta, num_ac)
    shape, stripe, rp = _packed_shape(b, h, w, num_ac, w // BLOCK)
    packed = torch.empty(shape, dtype=torch.uint8, device=frames.device)
    if packed.numel():
        dev = frames.device
        _launch("stegotpu_qim_extract_packed", frames.data_ptr(),
                packed.data_ptr(), _dct_on(dev).data_ptr(), dev.index, b, h,
                w, num_ac, stripe, rp, float(delta), _stream(dev))
        EXTRACT_LAUNCHES += 1
    return packed


def extract_frames(frames: torch.Tensor, delta: float,
                   num_ac: int) -> torch.Tensor:
    """K2 then the wire-order unpack on the same device: (B, C) uint8 bits,
    the signature of ops/qim.extract_frames."""
    _, h, w = _check_frames(frames)
    return packed_rows_to_bits(extract_frames_packed(frames, delta, num_ac),
                               h, w, num_ac, pick_stripe(h))


def extract_frames_rows(frames: torch.Tensor, delta: float,
                        num_ac: int) -> torch.Tensor:
    """K5: extract every slot bit, one uint8 per lane, in the unpacked
    compact-rows layout (B, (H/stripe)*rows_pad, W) on the frames' device
    (the layout of pallas_kernel._extract_frames_pallas_rows). Lane x of
    row jg*rows_pad + i*rn + g holds the bit of coefficient 8g + x%8 of
    block (jg*stripe/8 + i, x//8); padding rows are 0. Pair with
    rows_to_bits."""
    global EXTRACT_ROWS_LAUNCHES
    b, h, w = _check_frames(frames)
    if frames.device.type == "cpu":
        return extract_frames_rows_plain(frames, delta, num_ac)
    shape, stripe, rp = _packed_shape(b, h, w, num_ac, w)
    rows = torch.empty(shape, dtype=torch.uint8, device=frames.device)
    if rows.numel():
        dev = frames.device
        _launch("stegotpu_qim_extract_rows", frames.data_ptr(),
                rows.data_ptr(), _dct_on(dev).data_ptr(), dev.index, b, h, w,
                num_ac, stripe, rp, float(delta), _stream(dev))
        EXTRACT_ROWS_LAUNCHES += 1
    return rows


def embed_and_extract_frames_packed(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: embed, then re-extract the quantized stego in the same pass.
    Returns (stego (B, H, W) uint8, bits per frame (B,) int32, packed
    (B, (H/stripe)*rows_pad, W/8) uint8 in K2's layout), on the frames'
    device. Global bit 0 is the payload's first bit (no bit offset)."""
    global ROUNDTRIP_LAUNCHES
    b, h, w = _check_frames(frames)
    cap = _check_payload(payload_bits, frames, num_ac)
    if frames.device.type == "cpu":
        return embed_and_extract_frames_packed_plain(
            frames, payload_bits, total_bits, delta, num_ac)
    shape, stripe, rp = _packed_shape(b, h, w, num_ac, w // BLOCK)
    stego = torch.empty_like(frames)
    packed = torch.empty(shape, dtype=torch.uint8, device=frames.device)
    if stego.numel():
        dev = frames.device
        _launch("stegotpu_qim_roundtrip_packed", frames.data_ptr(),
                payload_bits.data_ptr(), stego.data_ptr(), packed.data_ptr(),
                _dct_on(dev).data_ptr(), dev.index, b, h, w, num_ac,
                int(total_bits), stripe, rp, float(delta), _stream(dev))
        ROUNDTRIP_LAUNCHES += 1
    return stego, _bits_per_frame(b, cap, int(total_bits), 0,
                                  frames.device), packed


def embed_and_extract_frames(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 then the wire-order unpack on the same device: (stego, bits per
    frame, extracted (B, C) uint8), the counterpart of
    pallas_kernel.embed_and_extract_frames_pallas_packed."""
    _, h, w = _check_frames(frames)
    stego, bpf, packed = embed_and_extract_frames_packed(
        frames, payload_bits, total_bits, delta, num_ac)
    return stego, bpf, packed_rows_to_bits(packed, h, w, num_ac,
                                           pick_stripe(h))


def embed_and_check_frames(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: embed, re-extract the quantized stego in the same pass, and
    count the valid payload slots that read back wrong. Returns (stego
    (B, H, W) uint8, bits per frame (B,) int32, errors per frame (B,)
    int32) on the frames' device — the verified embed's fast path. Global
    bit 0 is the payload's first bit (no bit offset)."""
    global CHECK_LAUNCHES
    b, h, w = _check_frames(frames)
    cap = _check_payload(payload_bits, frames, num_ac)
    if frames.device.type == "cpu":
        return embed_and_check_frames_plain(frames, payload_bits, total_bits,
                                            delta, num_ac)
    stego = torch.empty_like(frames)
    # zeroed on the current stream, the stream the kernel launches on
    errors = torch.zeros(b, dtype=torch.int32, device=frames.device)
    if stego.numel():
        dev = frames.device
        _launch("stegotpu_qim_embed_check", frames.data_ptr(),
                payload_bits.data_ptr(), stego.data_ptr(), errors.data_ptr(),
                _dct_on(dev).data_ptr(), dev.index, b, h, w, num_ac,
                int(total_bits), float(delta), _stream(dev))
        CHECK_LAUNCHES += 1
    return stego, _bits_per_frame(b, cap, int(total_bits), 0,
                                  frames.device), errors


def embed_and_extract_frames_rows(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6: embed, then re-extract the quantized stego in the same pass into
    the unpacked compact rows. Returns (stego (B, H, W) uint8, bits per
    frame (B,) int32, rows (B, (H/stripe)*rows_pad, W) uint8 in K5's
    layout), on the frames' device. Global bit 0 is the payload's first bit
    (no bit offset)."""
    global ROUNDTRIP_ROWS_LAUNCHES
    b, h, w = _check_frames(frames)
    cap = _check_payload(payload_bits, frames, num_ac)
    if frames.device.type == "cpu":
        return embed_and_extract_frames_rows_plain(
            frames, payload_bits, total_bits, delta, num_ac)
    shape, stripe, rp = _packed_shape(b, h, w, num_ac, w)
    stego = torch.empty_like(frames)
    rows = torch.empty(shape, dtype=torch.uint8, device=frames.device)
    if stego.numel():
        dev = frames.device
        _launch("stegotpu_qim_roundtrip_rows", frames.data_ptr(),
                payload_bits.data_ptr(), stego.data_ptr(), rows.data_ptr(),
                _dct_on(dev).data_ptr(), dev.index, b, h, w, num_ac,
                int(total_bits), stripe, rp, float(delta), _stream(dev))
        ROUNDTRIP_ROWS_LAUNCHES += 1
    return stego, _bits_per_frame(b, cap, int(total_bits), 0,
                                  frames.device), rows


def embed_and_extract_frames_fused(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 then the wire-order unpack on the same device: (stego, bits per
    frame, extracted (B, C) uint8), the counterpart of
    pallas_kernel.embed_and_extract_frames_pallas_fused (:1049)."""
    _, h, w = _check_frames(frames)
    stego, bpf, rows = embed_and_extract_frames_rows(
        frames, payload_bits, total_bits, delta, num_ac)
    return stego, bpf, rows_to_bits(rows, h, w, num_ac, pick_stripe(h))


def embed_and_extract_frames_twokernel(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The round trip as two kernels: K1, then K2 and the wire-order
    unpack of its stego — the counterpart of
    pallas_kernel.embed_and_extract_frames_pallas_twokernel (:1040)."""
    stego, bpf = embed_frames(frames, payload_bits, total_bits, delta, num_ac)
    return stego, bpf, extract_frames(stego, delta, num_ac)

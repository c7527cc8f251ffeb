"""The dense Kronecker-DCT embed and extract: K7 and K8.

Counterpart of ``stegotpu/ops/experimental/pallas_kron.py``. Each kernel
is a hand-written CUDA C++ kernel for Hopper (csrc/qim_kron.cu, built and
bound by ops/_build.py) with its plain PyTorch version beside it:

- K7 ``embed_frames_kron`` replaces ``_embed_kernel`` (pallas_kron.py:58);
  plain version ``embed_frames_kron_plain``;
- K8 ``extract_frames_kron`` replaces ``_extract_kernel``
  (pallas_kron.py:80); plain version ``extract_frames_kron_plain``.

What they compute (pallas_kron.py:58-86): y = xb K64^T over all 64
coefficients of each 8x8 block, directional-parity QIM on the slots whose
state (qim_fast.build_plane_blocks) is < 2, the full inverse y_new K64,
exact passthrough of blocks never entered (state 3), clip, truncating u8
cast; the extract reads round(y / delta) mod 2 on AC slots 1..num_ac. The
plain versions build the state plane; the kernel derives each slot's state
from the bit indices, so the tests hold its state logic against the plane.

This is another rounding path than the stripe kernels' sparse delta, so no
zero-tolerance identity with K1 holds: K7 and K8 are held against their
plain versions and the oracle under the exactness envelope and the stego
flip budget. Against their first CUDA version, which studies/kron_ab.py
keeps as their witness (csrc/qim_kron_smem.cu), they are held byte for
byte: the redesign for Hopper (persistent CTAs that load K64 once, 8x8
register micro-tiles; K8 on its slot rows only, one thread a block) keeps
every output's fmaf chain in the same order.

The domain is the JAX function's: W % 128 == 0 (pallas_kron.py:102,145),
else ValueError. delta <= 0 raises ValueError here; the JAX kernel has no
guard there (y / 0 gives NaN, then an undefined u8 cast), and StegoConfig
rejects delta <= 0 anyway.

A wrapper runs the plain version only because the tensor it was given lies
on the CPU; on a CUDA tensor it launches the kernel or raises.
``KRON_EMBED_LAUNCHES`` and ``KRON_EXTRACT_LAUNCHES`` count the launches.
"""

from __future__ import annotations

import numpy as np
import torch

from stegotpu_torch.config import BLOCK
from stegotpu_torch.ops import _build
from stegotpu_torch.ops.dct import blockify, kron_dct_tensor, unblockify
from stegotpu_torch.ops.experimental.qim_fast import (build_plane_blocks,
                                                      qim_by_plane)
from stegotpu_torch.ops.stripe_kernel import (_bits_per_frame, _check_frames,
                                              _check_payload, _launch, _stream)

KRON_EMBED_LAUNCHES = 0
KRON_EXTRACT_LAUNCHES = 0

_LANE = 128


def _check_domain(frames: torch.Tensor, delta: float) -> tuple[int, int, int]:
    b, h, w = _check_frames(frames)
    if w % _LANE:
        raise ValueError(f"kron path needs W % {_LANE} == 0, got {w}")
    if not delta > 0:
        raise ValueError(f"kron path needs delta > 0, got {delta}")
    return b, h, w


_KRON_ON_DEVICE: dict[torch.device, torch.Tensor] = {}


def _kron_on(device: torch.device) -> torch.Tensor:
    """K64 as a contiguous (64, 64) f32 tensor on `device` (the kernels'
    operand)."""
    if device not in _KRON_ON_DEVICE:
        _KRON_ON_DEVICE[device] = kron_dct_tensor(device)
    return _KRON_ON_DEVICE[device]


# --- plain PyTorch versions ---------------------------------------------------

def embed_frames_kron_plain(frames: torch.Tensor, payload_bits: torch.Tensor,
                            total_bits: int, delta: float, num_ac: int,
                            bit_offset: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7, same arguments and results."""
    b, h, w = _check_domain(frames, delta)
    nb = (h // BLOCK) * (w // BLOCK)
    delta = float(np.float32(delta))
    plane = build_plane_blocks(payload_bits, total_bits, nb, num_ac,
                               bit_offset)                  # (B, nb, 64)
    k = kron_dct_tensor(frames.device)
    xb = blockify(frames.to(torch.float32))
    xb_out = qim_by_plane(xb @ k.T, plane, delta) @ k
    xb_final = torch.where(plane == 3, xb, xb_out)  # plane==3 is block-constant
    stego = unblockify(xb_final.clamp(0.0, 255.0).to(torch.int32)
                       .to(torch.uint8), h, w)       # truncating
    return stego, _bits_per_frame(b, nb * num_ac, int(total_bits),
                                  int(bit_offset), frames.device)


def extract_frames_kron_plain(frames: torch.Tensor, delta: float,
                              num_ac: int) -> torch.Tensor:
    """Plain PyTorch version of K8: (B, C) uint8 wire-order slot bits."""
    b, _, _ = _check_domain(frames, delta)
    delta = float(np.float32(delta))
    k = kron_dct_tensor(frames.device)[1 : 1 + num_ac]      # AC slot rows
    y = blockify(frames.to(torch.float32)) @ k.T
    return torch.remainder(torch.round(y / delta), 2.0).to(torch.uint8) \
        .reshape(b, -1)


# --- kernel wrappers ----------------------------------------------------------

def embed_frames_kron(frames: torch.Tensor, payload_bits: torch.Tensor,
                      total_bits: int, delta: float, num_ac: int,
                      bit_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: embed payload bits by the dense Kronecker transform.

    frames: (B, H, W) uint8, H % 8 == 0, W % 128 == 0. payload_bits: (B, C)
    uint8 0/1 in wire order, C = (H/8)*(W/8)*num_ac; frame i consumes global
    bit indices [bit_offset + i*C, bit_offset + (i+1)*C), and total_bits
    (global) marks the payload end. Returns (stego (B, H, W) uint8, bits per
    frame (B,) int32) on the frames' device; on the card both come from the
    one kernel launch."""
    global KRON_EMBED_LAUNCHES
    b, h, w = _check_domain(frames, delta)
    _check_payload(payload_bits, frames, num_ac)
    if frames.device.type == "cpu":
        return embed_frames_kron_plain(frames, payload_bits, total_bits,
                                       delta, num_ac, bit_offset)
    stego = torch.empty_like(frames)
    if not stego.numel():  # no block, no bit
        return stego, torch.zeros(b, dtype=torch.int32, device=frames.device)
    bpf = torch.empty(b, dtype=torch.int32, device=frames.device)
    dev = frames.device
    _launch("stegotpu_kron_embed", frames.data_ptr(), payload_bits.data_ptr(),
            stego.data_ptr(), bpf.data_ptr(), _kron_on(dev).data_ptr(),
            dev.index, b, h, w, num_ac, int(total_bits), int(bit_offset),
            float(delta), _stream(dev))
    KRON_EMBED_LAUNCHES += 1
    return stego, bpf


def extract_frames_kron(frames: torch.Tensor, delta: float,
                        num_ac: int) -> torch.Tensor:
    """K8: the slot bits of every block, (B, C) uint8 in wire order, on the
    frames' device (the signature of ops/qim.extract_frames)."""
    global KRON_EXTRACT_LAUNCHES
    b, h, w = _check_domain(frames, delta)
    if frames.device.type == "cpu":
        return extract_frames_kron_plain(frames, delta, num_ac)
    bits = torch.empty((b, (h // BLOCK) * (w // BLOCK) * num_ac),
                       dtype=torch.uint8, device=frames.device)
    if bits.numel():
        dev = frames.device
        _launch("stegotpu_kron_extract", frames.data_ptr(), bits.data_ptr(),
                _kron_on(dev).data_ptr(), dev.index, b, h, w, num_ac,
                float(delta), _stream(dev))
        KRON_EXTRACT_LAUNCHES += 1
    return bits


def embed_and_extract_frames_kron(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7, then K8 on its stego: (stego, bits per frame, extracted (B, C)),
    the counterpart of pallas_kron.embed_and_extract_frames_kron (:171)."""
    stego, bpf = embed_frames_kron(frames, payload_bits, total_bits, delta,
                                   num_ac)
    return stego, bpf, extract_frames_kron(stego, delta, num_ac)


def embed_and_extract_frames_kron_plain(
        frames: torch.Tensor, payload_bits: torch.Tensor, total_bits: int,
        delta: float, num_ac: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's plain version, then K8's plain version on its stego."""
    stego, bpf = embed_frames_kron_plain(frames, payload_bits, total_bits,
                                         delta, num_ac)
    return stego, bpf, extract_frames_kron_plain(stego, delta, num_ac)

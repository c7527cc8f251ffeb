"""Image-layout QIM embed/extract and the u8 state plane.

Counterpart of ``stegotpu/ops/experimental/qim_fast.py``, which is XLA in
the JAX package and plain PyTorch here (f32 ``torch.einsum``/``matmul``;
the port never enables TF32):

- vertical 8-point DCT: contract each 8-row group with M over a (B, H/8,
  8, W) view;
- horizontal 8-point DCT: reshape (H, W) -> (H*W/128, 128) and multiply by
  the 128x128 block-diagonal I_16 (x) M^T (W must be a multiple of 128);
- QIM per coefficient in image layout, driven by a u8 state plane:

      0/1 -> payload bit for this coefficient slot
      2   -> slot carries no payload but its block was entered
      3   -> block never entered (whole block passes through untransformed)

The plane is all integer logic and byte-identical to the JAX package's
(tests/test_torch_kron.py). The dense Kronecker kernels
(ops/experimental/kron_kernel.py) consume it in block layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from stegotpu_torch.config import BLOCK, BLOCK_AREA
from stegotpu_torch.ops import qim as qim_baseline
from stegotpu_torch.ops.dct import blockify, dct_matrix, unblockify
from stegotpu_torch.ops.stripe_kernel import _bits_per_frame

_LANE = 128
_BPL = _LANE // BLOCK  # blocks per 128-lane chunk


@functools.lru_cache(maxsize=None)
def _bdiag_matrix(transpose: bool) -> np.ndarray:
    """I_16 (x) M (or M^T): the 128x128 block-diagonal horizontal operator
    (qim_fast.py:47-52), computed in float64 and cast once."""
    m = dct_matrix(BLOCK, np.float64)
    out = np.kron(np.eye(_BPL), m.T if transpose else m).astype(np.float32)
    out.setflags(write=False)  # lru_cache shares this array process-wide
    return out


def _dct2_image(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """2-D 8x8 block DCT of (B, H, W) float32 frames in image layout
    (qim_fast.py:55-74)."""
    b, h, w = x.shape
    m = torch.tensor(dct_matrix(BLOCK, np.float32), device=x.device)
    mv = m.T if inverse else m  # vertical operator (contract row index)
    y = torch.einsum("kr,bgrw->bgkw", mv, x.reshape(b, h // BLOCK, BLOCK, w))
    bh = torch.tensor(_bdiag_matrix(not inverse), device=x.device)
    return (y.reshape(-1, _LANE) @ bh).reshape(b, h, w)


def build_plane_blocks(payload_bits: torch.Tensor, total_bits: int, nb: int,
                       num_ac: int, bit_offset: int = 0) -> torch.Tensor:
    """(B, C) payload -> (B, nb, 64) uint8 state plane in block layout
    (qim_fast.py:77-114), on the payload's device. Bit indices are int64."""
    b = payload_bits.shape[0]
    cap = nb * num_ac
    dev = payload_bits.device
    # remaining bits at each block's first slot: rem > 0 <=> block entered;
    # slot j (0-based AC index) is valid <=> j < rem
    rem = (int(total_bits) - int(bit_offset)
           - torch.arange(b, dtype=torch.int64, device=dev)[:, None] * cap
           - torch.arange(nb, dtype=torch.int64, device=dev)[None, :] * num_ac
           )[..., None]                                    # (B, nb, 1)
    col = torch.arange(BLOCK_AREA, dtype=torch.int64, device=dev)
    is_slot = (col >= 1) & (col <= num_ac)
    bits64 = F.pad(payload_bits.reshape(b, nb, num_ac).to(torch.uint8),
                   (1, BLOCK_AREA - 1 - num_ac))
    two = torch.full_like(bits64, 2)
    plane = torch.where(is_slot & (col - 1 < rem), bits64, two)
    return torch.where(rem <= 0, torch.full_like(plane, 3), plane)


def qim_by_plane(y: torch.Tensor, plane: torch.Tensor,
                 delta: float) -> torch.Tensor:
    """Directional-parity QIM of the coefficients `y` on the slots whose
    state is < 2 (a payload bit), `y` unchanged elsewhere; `plane` has
    y's layout (qim_fast.py:152-156, pallas_kron.py:68-72)."""
    q = torch.round(y / delta)
    parity = torch.remainder(q, 2.0)
    bit_f = plane.to(torch.float32)  # only meaningful where plane < 2
    adjust = torch.where(parity != bit_f,
                         torch.where(bit_f == 1.0, 1.0, -1.0), 0.0)
    return torch.where(plane < 2, (q + adjust) * delta, y)


def build_state_plane(payload_bits: torch.Tensor, total_bits: int, h: int,
                      w: int, num_ac: int, bit_offset: int = 0) -> torch.Tensor:
    """(B, C) payload -> (B, H, W) uint8 state plane (qim_fast.py:117-129)."""
    nb = (h // BLOCK) * (w // BLOCK)
    return unblockify(build_plane_blocks(payload_bits, total_bits, nb, num_ac,
                                         bit_offset), h, w)


def embed_frames_fast(frames: torch.Tensor, payload_bits: torch.Tensor,
                      total_bits: int, delta: float, num_ac: int,
                      bit_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Image-layout embed; the signature of ops/qim.embed_frames
    (qim_fast.py:132-165)."""
    b, h, w = frames.shape
    cap = (h // BLOCK) * (w // BLOCK) * num_ac
    delta = float(np.float32(delta))
    plane = build_state_plane(payload_bits, total_bits, h, w, num_ac,
                              bit_offset)
    x = frames.to(torch.float32)
    x_out = _dct2_image(qim_by_plane(_dct2_image(x), plane, delta),
                        inverse=True)
    x_final = torch.where(plane == 3, x, x_out)  # plane==3 is block-constant
    stego = x_final.clamp(0.0, 255.0).to(torch.int32).to(torch.uint8)
    return stego, _bits_per_frame(b, cap, int(total_bits), int(bit_offset),
                                  frames.device)


def extract_frames_fast(frames: torch.Tensor, delta: float,
                        num_ac: int) -> torch.Tensor:
    """Image-layout extract; the signature of ops/qim.extract_frames
    (qim_fast.py:168-177)."""
    b = frames.shape[0]
    delta = float(np.float32(delta))
    y = _dct2_image(frames.to(torch.float32))
    bits_img = torch.remainder(torch.round(y / delta), 2.0).to(torch.uint8)
    return blockify(bits_img)[..., 1 : 1 + num_ac].reshape(b, -1)


def _fast_ok(w: int) -> bool:
    return w % _LANE == 0


def embed_frames_auto(frames, payload_bits, total_bits, delta, num_ac,
                      bit_offset=0):
    """The image-layout path when W % 128 == 0, the oracle otherwise."""
    if _fast_ok(frames.shape[-1]):
        return embed_frames_fast(frames, payload_bits, total_bits, delta,
                                 num_ac, bit_offset)
    return qim_baseline.embed_frames(frames, payload_bits, total_bits, delta,
                                     num_ac, bit_offset=bit_offset)


def extract_frames_auto(frames, delta, num_ac):
    if _fast_ok(frames.shape[-1]):
        return extract_frames_fast(frames, delta, num_ac)
    return qim_baseline.extract_frames(frames, delta, num_ac)


def embed_and_extract_frames_fast(frames, payload_bits, total_bits, delta,
                                  num_ac):
    stego, bpf = embed_frames_fast(frames, payload_bits, total_bits, delta,
                                   num_ac)
    return stego, bpf, extract_frames_fast(stego, delta, num_ac)

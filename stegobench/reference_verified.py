"""The plain reference of the verified embed, and where its answer is
certain: plain PyTorch and numpy, nothing of the program.

The published description (the docstring of the port's ops/verified.py and
of the JAX package's): embed by QIM; re-extract every payload slot from the
truncated uint8 stego; for every 8x8 block holding a wrong bit, shift the
block's DC coefficient so that its pixels before the clip fit in [0, 255]
-- lift it out of the floor but never past the ceiling, and the reverse --
synthesize again, and repeat for `rounds` rounds; the valid slots still
wrong after the last round are the residual. The DC basis is exactly 1/8
on every pixel, so a DC shift of 8 d moves each pixel of its block by d;
the extracted slots (1..num_ac) are untouched by it.

Departures from the program, none of which changes the function:

- the rounds run whatever the first reading gives. Where no valid slot
  reads back wrong they shift nothing, so the answer is the plain embed, as
  in the program, which takes the repair only when K3 counts a wrong slot;
  running them anyway lets the envelope see the blocks whose first reading
  a float32 program could take either way;
- the slots change by the difference form x + (c' - c) K_slots, as
  stegobench/reference.py's embed does, and a shift is added to the pixels
  directly, where the program adds 8 d to the DC coefficient and inverts
  all 64 coefficients again;
- float64 by default ("f32" and "tf32", reference.py's precisions, run the
  same steps in those; "tf32" is the control that a check must refuse).

Where the answer is certain (``sure``), in the manner of
reference.embed_envelope, from the float64 readings:

- a block is uncertain from the round on in which a decision of the loop
  could go either way for a float32 program: a QIM rounding of one of its
  valid slots within reference.near_boundary's envelope, or a reading of
  the stego that makes the block bad or good only inside the envelope
  widened by the largest weight of a pixel in a slot for each uncertain
  pixel of the block, since those pixels may be one off in the program's stego.
  A block is repaired on its own pixels alone, so the uncertainty stays in
  the block;
- a pixel is uncertain where its value before truncation lies within the
  block's tolerance of an integer from 1 to 255 (near 0 it clamps to 0 and
  near 256 or above to 255 either way). In a block that was not shifted
  the tolerance is SYNTH_TOL, not reference.PIXEL_TOL: once K3 counts a
  wrong slot, the program synthesizes every block of the batch again, all
  64 coefficients from a float32 forward transform through the full
  float32 inverse, and those pixels lie farther from float64's than K1's
  difference form does (readings beside SYNTH_TOL). A shift is a float32
  minimum or maximum of pixels (each within the block's tolerance, and
  the shift is 1-Lipschitz in them) added to a DC coefficient below 4,096
  in float32 (half an ulp there, 2^-13, is DC_EPS * 8 a pixel), and the
  block is synthesized again (SYNTH_TOL). So each round that shifts a
  block adds its tolerance and DC_EPS to the block's drift, and its
  tolerance becomes SYNTH_TOL plus the drift: 8 (SYNTH_TOL + DC_EPS) at
  most after three rounds, 8.1e-3, against TF32's errors of about 0.5.

The residual is returned with the count of valid slots whose final reading
is not certain (``unsure``): those of uncertain blocks, and those within
the widened envelope; a float32 program's residual lies in
[residual, residual + unsure].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stegobench import reference
from stegobench.reference import BLOCK

# The repair loop's pixels before truncation against float64's, largest of
# a block: 1.91e-4 in textured blocks (3 seeds, 8 frames of 4K scope covers
# each, H100), 1.55e-4 on the CPU (4 frames of 256x512); reference.PIXEL_TOL,
# 1e-4, is K1's. SYNTH_TOL leaves five times the room.
SYNTH_TOL = 1e-3
# half an ulp of float32 in [2048, 4096), where a shifted DC coefficient
# lies (|DC| <= 8 * 255 + 8 * 255), over the DC basis' 8
DC_EPS = 2.0 ** -13 / 8


class Verified(NamedTuple):
    stego: torch.Tensor      # (B, H, W) uint8
    bpf: torch.Tensor        # (B,) int64, bits per frame
    residual: int            # valid slots read wrong after the last round
    unsure: int              # valid slots whose final reading is not certain
    sure: torch.Tensor       # (B, H, W) bool, pixels whose value is certain


def _uncertain_px(z: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """Pixels (B, nb, 64) before truncation within `tol` (B, nb) of an
    integer that truncation could take either way (1..255)."""
    k = torch.round(z)
    return ((z - k).abs() < tol[..., None]) & (k >= 1) & (k <= 255)


def _near(v: torch.Tensor, delta: float, extra: torch.Tensor) -> torch.Tensor:
    """reference.near_boundary's envelope widened by `extra` (B, nb), in
    coefficient units."""
    dist = (v - torch.floor(v) - 0.5).abs() * delta
    margin = torch.clamp(1e-2 + 2e-5 * (v * delta).abs(), max=0.45 * delta)
    return dist < margin + extra[..., None]


def embed_verified(frames: torch.Tensor, bits: torch.Tensor, total_bits: int,
                   delta: float, num_ac: int, rounds: int = 3,
                   precision: str = "f64") -> Verified:
    """The verified embed of wire-order payload bits (B, C) uint8 into
    (B, H, W) uint8 frames; global bit i lies in frame i // C, and slots at
    or past total_bits carry nothing."""
    b, h, w = frames.shape
    nb = (h // BLOCK) * (w // BLOCK)
    cap = nb * num_ac
    delta = float(np.float32(delta))
    dev = frames.device
    dtype = torch.float64 if precision == "f64" else torch.float32
    ks = reference.dct_kron(dev, dtype)[1:1 + num_ac]            # (n, 64)
    # one pixel off moves a slot's coefficient by at most this
    read_weight = float(ks.abs().max())
    x = reference.blocks(frames).to(dtype)                       # (b, nb, 64)
    idx = (torch.arange(b, device=dev)[:, None, None] * cap
           + torch.arange(nb, device=dev)[None, :, None] * num_ac
           + torch.arange(num_ac, device=dev)[None, None, :])
    valid = idx < int(total_bits)
    del idx
    entered = valid.any(-1)                                      # (b, nb)
    bit = bits.reshape(b, nb, num_ac).to(dtype)
    y = reference._mm(x, ks.T, precision)
    v = y / delta
    q = torch.round(v)
    move = torch.where(torch.remainder(q, 2.0) != bit,
                       torch.where(bit == 1.0, 1.0, -1.0), 0.0)
    dy = torch.where(valid, (q + move) * delta - y, 0.0)
    z = x + reference._mm(dy, ks, precision)       # pixels before the clip
    unsure_block = (_near(v, delta, torch.zeros_like(entered, dtype=dtype))
                    & valid).any(-1)
    del y, v, q, move, dy
    tol = torch.full((b, nb), SYNTH_TOL, dtype=dtype, device=dev)
    drift = torch.zeros_like(tol)

    def reading(z, tol):
        """(stego blocks, slot values c / delta, uncertain pixels)."""
        s = z.clamp(0.0, 255.0).floor()
        v = reference._mm(s, ks.T, precision) / delta
        return s, v, _uncertain_px(z, tol)

    stego, v, px = reading(z, tol)
    for _ in range(rounds):
        wrong = valid & (torch.remainder(torch.round(v), 2.0) != bit)
        near = valid & _near(v, delta, read_weight * px.sum(-1).to(dtype))
        bad = wrong.any(-1)
        unsure_block |= ~(wrong & ~near).any(-1) & near.any(-1)
        lo, hi = z.amin(-1), z.amax(-1)
        up = torch.minimum((-lo).clamp(min=0.0), (255.0 - hi).clamp(min=0.0))
        down = -torch.minimum((hi - 255.0).clamp(min=0.0), lo.clamp(min=0.0))
        shift = torch.where(bad, torch.where(lo < 0.0, up, down), 0.0)
        drift = torch.where(bad, drift + tol + DC_EPS, drift)
        tol = torch.where(bad, SYNTH_TOL + drift, tol)
        z = z + shift[..., None]
        stego, v, px = reading(z, tol)
    wrong = valid & (torch.remainder(torch.round(v), 2.0) != bit)
    near = valid & _near(v, delta, read_weight * px.sum(-1).to(dtype))
    open_ = near | (unsure_block[..., None] & valid)
    residual = int((wrong & ~open_).sum())
    unsure = int(open_.sum())
    sure = ~entered[..., None] | (~px & ~unsure_block[..., None])
    stego = torch.where(entered[..., None], stego, x).to(torch.uint8)
    bpf = (int(total_bits) - torch.arange(b, device=dev) * cap).clamp(0, cap)
    return Verified(reference.unblocks(stego, h, w), bpf, residual, unsure,
                    reference.unblocks(sure, h, w))

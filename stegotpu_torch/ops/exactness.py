"""Kernel exactness checks: the stripe kernels against the f32 oracle.

Counterpart of ``stegotpu/ops/exactness.py``, with the same constants,
row keys and policy, on the caller's ``device``: on a CUDA device the
hand-written kernels K1-K5 (ops/stripe_kernel.py, csrc/qim_stripe.cu) are
held against the port's f32 oracle ops/qim.py; on the CPU the same code
holds their plain versions. ``python -m stegotpu_torch.gpucheck`` runs the
sweep on the card and writes GPUCHECK.json. All comparisons run on the
device; only scalars come back to the host.

Policy (what "exact" means between two f32 implementations):

- An extracted bit is round(y/delta) mod 2. The oracle and the kernels
  compute y with differently ordered f32 sums (a Kronecker matmul against
  a separable transform in FMAs), so y differs by float noise: a bit can
  only legitimately flip where y sits within that noise of a rounding
  boundary. Each slot's distance to its nearest boundary is taken from y
  in float64, and mismatches are tolerated ONLY inside the envelope
  ``tol = TOL_ABS + TOL_REL * |y|`` (1e-2 + 2e-5|y|, capped at 0.45
  delta; the JAX package's calibration). Any mismatch OUTSIDE it, on any
  content, is a miscompile: zero tolerance.
- packed (K2) vs unpacked (K5) extract must be identical on ANY content:
  zero tolerance.
- the fused round trip's bits (K4) must equal extracting its own stego
  with the standalone kernel (K2): zero tolerance.
- the verified embed's check kernel (K3) must emit stego byte-identical
  to the plain embed kernel's (K1) and an error count EQUAL to K2's count
  over valid slots of K3's stego: zero tolerance.
- the verified embed's repair variant (``repair_identities``, a row of
  its own, REPAIR_KEYS): at repair_rounds 0 its stego is K3's and its
  residual K3's count, and at any rounds every block that K3's stego
  reads right keeps K1's bytes: zero tolerance.
- on ROBUST parameter pairs (8 <= delta <= 30, num_ac <= 30) both the
  kernels and the oracle must recover the payload within BER 1e-5 on
  uniform-random covers; larger deltas lose bits to clipping in the
  ALGORITHM (recorded, not asserted). The envelope is the JAX package's;
  at num_ac=30 uniform-random covers exceed the bound in the oracle and
  the kernels alike (GPUCHECK.json), as they do in the JAX package's own
  harness.
- precision='fast' rows run the wire arithmetic: the port has no
  single-pass bf16 mode, so they must equal the 'wire' rows. FAST_TOL_*
  was calibrated on the TPU's bf16 matmuls and is kept only so the
  constants match the JAX package; it is not applied.

content: 'noise' (uniform-random) or 'compressed' (a deterministic
moving-pattern cover round-tripped through the mpeg4 codec, mid-luma so
clipping cannot contribute): lossy compression leaves coefficients at
structured positions whose boundary distances are tight, the content
class where the JAX package's single-pass-bf16 inverse flipped bits that
uniform-random covers hid. TF32 in the oracle is the reverse: the
uniform-random rows catch it, the compressed rows do not.

Reference contract: config_and_setup.py:106-174.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from stegotpu_torch.device import resolve_device
from stegotpu_torch.ops import qim
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.ops.dct import blockify, kron_dct_tensor

TOL_ABS = 1e-2
TOL_REL = 2e-5
FAST_TOL_ABS = 4.0
FAST_TOL_REL = 2e-3
ROBUST_BER_BOUND = 1e-5

EXACT_KEYS = [
    "bpf_mismatch",
    "extract_mismatch_cover_nonboundary",
    "extract_mismatch_stego_nonboundary",
    "extract_packed_vs_unpacked_cover",
    "extract_packed_vs_unpacked_stego",
    "fused_vs_standalone_mismatch",
    # the verified embed's check kernel: stego byte-identical to the plain
    # embed kernel's, error count equal to a standalone re-extract's count
    "verified_stego_mismatch",
    "verified_errcount_delta",
]


def is_robust(delta: float, num_ac: int, precision: str = "wire") -> bool:
    """The BER<=1e-5 parameter envelope. delta > 30 is excluded: +-delta/2
    pixel-domain perturbations clip at 0/255 often enough on random covers
    to approach the bound (the algorithm's loss, not a kernel's). 'fast'
    starts at its config-enforced delta >= 12 (config.py qim_precision
    guard)."""
    lo = 12 if precision == "fast" else 8
    return lo <= delta <= 30 and num_ac <= 30


def _compare(frames: torch.Tensor, payload: torch.Tensor, total: int,
             delta: float, num_ac: int) -> list[float]:
    """The row's on-device comparisons, returned as one list of scalars."""
    b, h, w = frames.shape
    stripe = sk.pick_stripe(h)
    k64 = kron_dct_tensor(frames.device, torch.float64)[1 : 1 + num_ac]

    # --- embed: oracle and K1 ---
    stego_x, bpf_x = qim.embed_frames(frames, payload, total, delta, num_ac)
    stego_p, bpf_p = sk.embed_frames(frames, payload, total, delta, num_ac)
    bpf_mismatch = (bpf_x != bpf_p).sum()
    diff = (stego_x.to(torch.int32) - stego_p.to(torch.int32)).abs()

    def xdiff(fr):
        """(mismatches, nonboundary mismatches, max boundary distance
        among mismatches, packed-vs-unpacked mismatches, K2's bits)."""
        ex_x = qim.extract_frames(fr, delta, num_ac)
        ex_p = sk.extract_frames(fr, delta, num_ac)
        ex_u = sk.rows_to_bits(sk.extract_frames_rows(fr, delta, num_ac),
                               h, w, num_ac, stripe)
        ys = (blockify(fr.to(torch.float64)) @ k64.T).reshape(b, -1)
        frac = ys / delta - torch.floor(ys / delta)
        dist = (frac - 0.5).abs() * delta      # abs distance to boundary
        # noise envelope, CAPPED below the decision margin so the
        # zero-tolerance gate stays meaningful on large coefficients
        tol = torch.clamp(TOL_ABS + TOL_REL * ys.abs(), max=0.45 * delta)
        mm = ex_x != ex_p
        return (mm.sum(), (mm & (dist >= tol)).sum(),
                torch.where(mm, dist, 0.0).max(), (ex_u != ex_p).sum(), ex_p)

    mm_c, mm_c_nb, mm_c_dist, pu_c, _ = xdiff(frames)
    mm_s, mm_s_nb, mm_s_dist, pu_s, ex_stego = xdiff(stego_p)

    # --- fused round trip (K4): its bits == K2's extract of its stego ---
    st_f, _, ex_f = sk.embed_and_extract_frames(frames, payload, total, delta,
                                                num_ac)
    fused_vs_standalone = (ex_f != sk.extract_frames(st_f, delta, num_ac)).sum()

    # --- round-trip payload recovery, K1+K2 and the oracle, valid bits ---
    err_p = sk.count_wrong_bits(ex_stego, payload, total).sum()
    err_x = sk.count_wrong_bits(qim.extract_frames(stego_x, delta, num_ac),
                                payload, total).sum()

    # --- verified embed's check kernel (K3): stego byte-identical to K1's,
    # its count equal to K2's count over valid slots of its stego ---
    st_v, _, errs_v = sk.embed_and_check_frames(frames, payload, total, delta,
                                                num_ac)
    v_stego_mm = (st_v != stego_p).sum()
    v_err_standalone = sk.count_wrong_bits(
        sk.extract_frames(st_v, delta, num_ac), payload, total).sum()
    v_err_delta = (errs_v.sum() - v_err_standalone).abs()
    out = [bpf_mismatch, diff.max(), (diff > 1).sum(),
           mm_c, mm_c_nb, mm_c_dist, pu_c, mm_s, mm_s_nb, mm_s_dist, pu_s,
           fused_vs_standalone, err_p, err_x, v_stego_mm, v_err_delta]
    return torch.stack([v.to(torch.float64) for v in out]).tolist()


def _compressed_cover(b: int, h: int, w: int, seed: int) -> np.ndarray:
    """(b, h, w) u8 gray frames of an mpeg4-coded moving-pattern cover."""
    import os
    import tempfile

    from stegotpu_torch import fixtures
    from stegotpu_torch.video import VideoReader

    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "c.mp4")
        fixtures.make_cover_video(p, w, h, frames=b, kind="moving", seed=seed)
        with VideoReader(p) as reader:
            return np.concatenate(list(reader.batches(b, mode="gray")))[:b]


def check_config(b: int, h: int, w: int, num_ac: int, deltas, rng,
                 verbose: bool = True, precision: str = "wire",
                 content: str = "noise", device=None) -> list[dict]:
    """A row of on-device scalar comparisons per delta, on `device`.

    precision: the config.qim_precision the row is recorded under; the
    port computes the wire arithmetic under both names (module docstring).
    content: 'noise' or 'compressed' (module docstring). rng (a numpy
    Generator) is drawn in the JAX package's order, so one seed gives both
    packages the same covers and payload. device None is the card
    (device.resolve_device).
    """
    device = resolve_device(device)
    cap = (h // 8) * (w // 8) * num_ac
    if content == "compressed":
        frames_np = _compressed_cover(b, h, w, int(rng.integers(1 << 30)))
    else:
        frames_np = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    frames = torch.from_numpy(np.ascontiguousarray(frames_np)).to(device)
    payload = torch.from_numpy(
        rng.integers(0, 2, (b, cap), dtype=np.uint8)).to(device)
    rows = []
    for delta in deltas:
        # payload ends mid-block in the last frame (the parse-boundary case)
        total = b * cap - 13
        t0 = time.perf_counter()
        out = _compare(frames, payload, total, float(delta), num_ac)
        dt = time.perf_counter() - t0
        (bpf_mm, maxdiff, gt1, mc, mcnb, mcd, puc, ms, msnb, msd, pus,
         fvs, err_p, err_x, v_smm, v_ed) = out
        rows.append({
            "h": h, "w": w, "batch": b, "num_ac": num_ac, "delta": delta,
            "content": content,
            "precision": precision,
            "total_bits": total,
            "robust": is_robust(delta, num_ac, precision),
            "bpf_mismatch": int(bpf_mm),
            "stego_max_abs_diff": int(maxdiff),
            "stego_gt1_frac": round(gt1 / (b * h * w), 6),
            # boundary flips recorded; NONboundary = zero tolerance
            "extract_mismatch_cover": int(mc),
            "extract_mismatch_cover_nonboundary": int(mcnb),
            "max_mismatch_dist_cover": round(mcd, 6),
            "extract_mismatch_stego": int(ms),
            "extract_mismatch_stego_nonboundary": int(msnb),
            "max_mismatch_dist_stego": round(msd, 6),
            "extract_packed_vs_unpacked_cover": int(puc),   # ZERO tolerance
            "extract_packed_vs_unpacked_stego": int(pus),   # ZERO tolerance
            "fused_vs_standalone_mismatch": int(fvs),       # ZERO tolerance
            "verified_stego_mismatch": int(v_smm),          # ZERO tolerance
            "verified_errcount_delta": int(v_ed),           # ZERO tolerance
            "roundtrip_errors_pallas": int(err_p),
            "roundtrip_errors_xla": int(err_x),
            "wall_s": round(dt, 2),
        })
        if verbose:
            print(json.dumps(rows[-1]), flush=True)
    return rows


# letterboxed film, the covers on which the verified embed repairs (those
# of stegobench/configs/uhd2160p24scope.json at 4K): bars of
# letterbox_rows at letterbox_luma above and below; in the picture 10% of
# the 8x8 blocks flat at 255, 10% flat at 0, the rest textured mid-tones
SCOPE = {"letterbox_rows": 280, "letterbox_luma": 0, "texture": 20,
         "midtone_range": [24, 231], "highlight_share": 0.1,
         "shadow_share": 0.1}


def scope_covers(shape: tuple[int, ...], cfg: dict,
                 gen: torch.Generator, device) -> torch.Tensor:
    """(..., H, W) uint8 letterboxed covers from `gen` (cfg as SCOPE):
    rows [0, bars) and [H - bars, H) at the bar luma; in the picture
    between, each 8x8 block flat at 255 with probability highlight_share,
    flat at 0 with shadow_share, else a block base drawn in midtone_range
    narrowed by the texture on each side, plus uniform per-pixel texture
    in +-texture. The same draws as the benchmark's verified-device
    cell makes its covers with (scope_covers of its device_verified
    module, under stegobench/)."""
    *lead, h, w = shape
    bars = cfg["letterbox_rows"]
    tex = cfg["texture"]
    lo, hi = cfg["midtone_range"]
    ph = h - 2 * bars
    out = torch.full(shape, cfg["letterbox_luma"], dtype=torch.uint8,
                     device=device)
    bshape = (*lead, ph // 8, w // 8)
    kind = torch.rand(bshape, generator=gen, device=device)
    base = torch.randint(lo + tex, hi - tex + 1, bshape, generator=gen,
                         device=device, dtype=torch.int16)
    base = base.repeat_interleave(8, -2).repeat_interleave(8, -1)
    pic = base + torch.randint(-tex, tex + 1, (*lead, ph, w), generator=gen,
                               device=device, dtype=torch.int16)
    del base
    kind = kind.repeat_interleave(8, -2).repeat_interleave(8, -1)
    high = cfg["highlight_share"]
    pic = torch.where(kind < high, 255, pic)
    pic = torch.where((kind >= high) & (kind < high + cfg["shadow_share"]),
                      0, pic)
    out[..., bars:h - bars, :] = pic.to(torch.uint8)
    return out


# K3's repair variant (stripe_kernel.embed_and_repair_frames) against K3
# and K1, zero tolerance on any content: a row of its own, so that the
# sweep's rows keep the JAX package's keys
REPAIR_KEYS = [
    # at repair_rounds 0: K3's stego, and a residual equal to K3's count
    "repair_rounds0_stego_mismatch",
    "repair_rounds0_residual_delta",
    # at `rounds`: the bits per frame, and every block that K3's stego
    # reads right keeps K1's bytes (all of them on a clean cover)
    "repair_bpf_mismatch",
    "repair_right_blocks_mismatch",
]


def repair_identities(frames: torch.Tensor, payload: torch.Tensor,
                      total: int, delta: float, num_ac: int,
                      rounds: int = 3) -> dict:
    """The REPAIR_KEYS of the repair variant on these inputs (no bit
    offset), each a count that must be 0, with the residual and the blocks
    K3's stego reads wrong; on the inputs' device."""
    b, h, w = frames.shape
    s1, bpf1 = sk.embed_frames(frames, payload, total, delta, num_ac)
    s3, _, err3 = sk.embed_and_check_frames(frames, payload, total, delta,
                                            num_ac)
    s0, _, r0 = sk.embed_and_repair_frames(frames, payload, total, delta,
                                           num_ac, 0)
    s, bpf, residual = sk.embed_and_repair_frames(frames, payload, total,
                                                  delta, num_ac, rounds)
    valid = (torch.arange(b * payload.shape[1], device=frames.device)
             .reshape(payload.shape) < total)
    wrong = (sk.extract_frames(s3, delta, num_ac) != payload) & valid
    bad = wrong.reshape(b, h // 8, w // 8, num_ac).any(-1)     # (b, bh, bw)
    right_px = ~bad.repeat_interleave(8, 1).repeat_interleave(8, 2)
    out = [(s0 != s3).sum(), (r0 - err3.sum()).abs(), (bpf != bpf1).sum(),
           ((s != s1) & right_px).sum(), residual, bad.sum()]
    vals = [int(v) for v in torch.stack(
        [v.to(torch.int64) for v in out]).tolist()]
    return {**dict(zip(REPAIR_KEYS, vals)), "rounds": rounds,
            "residual": vals[4], "blocks_read_wrong": vals[5]}


def row_ok(row: dict) -> bool:
    """The full invariant set for one row (see module docstring)."""
    if any(row[k] != 0 for k in EXACT_KEYS):
        return False
    if row["robust"]:
        bound = ROBUST_BER_BOUND * row["total_bits"]
        return (row["roundtrip_errors_pallas"] <= bound
                and row["roundtrip_errors_xla"] <= bound)
    return True


def quick_exactness_check(rng=None, verbose: bool = False,
                          precision: str = "wire", device=None) -> dict:
    """One selftest-sized config; returns the result row plus ok flag
    (device None: the card)."""
    device = resolve_device(device)
    if rng is None:
        rng = np.random.default_rng(42)
    rows = check_config(4, 240, 384, 10, [20.0], rng, verbose=verbose,
                        precision=precision, device=device)
    row = rows[0]
    row["ok"] = row_ok(row)
    return row

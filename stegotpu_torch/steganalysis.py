"""Steganalysis: detect QIM/DCT embedding and estimate its parameters.

Counterpart of ``stegotpu/steganalysis.py``. The lattice scores
(``lattice_scores``, ``_per_slot_scores``) are computed in PyTorch on the
caller's device: blockify, then the 64x64 Kronecker DCT product in f32, a
plain product outside any kernel (the JAX package leaves it to XLA at
``Precision.HIGHEST``), at full float32 as in ``ops/qim.py``: the port
never enables TF32. The candidate grid is walked in chunks of candidates,
so the whole (candidates, B, slots) array is never built (95 x 4 x 324,000
floats at 1080p). ``estimate_num_ac``, ``analyze_frames``,
``read_gray_frames``, ``analyze_video`` and
``recover_params`` keep the JAX package's host logic line for line; their
``device`` argument is the card unless the caller names another
(device.resolve_device).

QIM's lattice snap is highly detectable: payload-carrying AC coefficients
sit exactly on multiples of delta (up to uint8 re-quantization noise),
while natural-content coefficients are spread continuously. Detector: for
candidate delta values, measure the fraction of AC coefficients (flat
indices 1..N) whose distance to the nearest delta-multiple is < eps*delta.
Clean video scores ~2*eps everywhere; a stego video spikes hard at the true
delta (and its divisors). Only the score vectors cross to the host.

This is also the honest security statement for users: QIM steganography is
NOT steganographically secure against a warden who suspects the channel —
its security rests entirely on the AES-GCM/ECDH layer protecting the
*content*, not the embedding's invisibility.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stegotpu_torch.device import resolve_device
from stegotpu_torch.ops.dct import blockify, kron_dct_tensor

# lattice_scores takes as many candidates at a time as keep each
# (candidates, B, slots) f32 intermediate under 2**24 elements (64 MB)
_CHUNK_ELEMS = 1 << 24


def _coefficients(frames: torch.Tensor) -> torch.Tensor:
    """(B, nb, 64) f32 DCT coefficients of every 8x8 block of (B, H, W)."""
    xb = blockify(frames.to(torch.float32))
    return xb @ kron_dct_tensor(frames.device).T


def _lattice_fraction(y: torch.Tensor, delta: torch.Tensor, eps: float,
                      dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(fraction of informative coefficients within eps*delta of the
    lattice, informative count), reduced over `dim`, in f32."""
    q = torch.round(y / delta)
    dist = (y - q * delta).abs() / delta
    # exclude near-zero coefficients: they sit on EVERY lattice and would
    # drown the signal (flat image regions have many exact zeros)
    informative = y.abs() > 0.75 * delta
    frac = (informative & (dist < eps)).sum(dim, dtype=torch.float32)
    count = informative.sum(dim, dtype=torch.float32)
    return frac / count.clamp(min=1.0), count


def lattice_scores(frames: torch.Tensor, deltas: torch.Tensor, num_ac: int,
                   eps: float = 0.08) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame fraction of AC coefficients within eps*delta of the lattice.

    frames: (B, H, W) uint8 gray; deltas: (K,) float32 candidates, on the
    frames' device. Returns (scores, counts), each (K, B): scores in [0, 1]
    with background expectation ~2*eps, counts = informative coefficients
    behind each score (a score backed by a handful of samples is
    statistical noise). Scoring is per frame because a payload may occupy
    only some frames: the true delta saturates (score -> ~1) on
    payload-carrying frames specifically.
    """
    b = frames.shape[0]
    ac = _coefficients(frames)[..., 1 : 1 + num_ac].reshape(b, -1)
    deltas = deltas.to(device=frames.device, dtype=torch.float32)
    step = max(1, _CHUNK_ELEMS // max(ac.numel(), 1))
    per = [_lattice_fraction(ac, d[:, None, None], eps, dim=-1)
           for d in deltas.split(step)]
    return (torch.cat([s for s, _ in per]),
            torch.cat([c for _, c in per]))


def _per_slot_scores(frames: torch.Tensor, delta: float,
                     eps: float = 0.08) -> tuple[torch.Tensor, torch.Tensor]:
    """Lattice score + informative count per flat coefficient index (64,).

    QIM snaps exactly the slots c = 1..N, so at the true delta the scores
    saturate for c <= N and fall to background beyond — which recovers N.
    The informative count distinguishes "slot failed the lattice test" from
    "slot had nothing to test" (all coefficients near zero, e.g. smooth
    covers where high-frequency slots snap to 0 at |y| <= 0.75*delta).
    Returns (scores, counts), each (B, 64).
    """
    d = torch.tensor(delta, dtype=torch.float32, device=frames.device)
    return _lattice_fraction(_coefficients(frames), d, eps, dim=1)


def _to_device(frames_gray: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(frames_gray)).to(device)


def estimate_num_ac(frames_gray: np.ndarray, delta: float,
                    score_floor: float = 0.85,
                    min_informative: int = 16, device=None) -> int:
    """Recover the out-of-band num_ac parameter from lattice structure.

    Returns the largest N such that every *conclusive* slot 1..N saturates
    the lattice at `delta` on its best (payload-carrying) frame — 0 if none
    do. A slot is conclusive only when some frame backs it with at least
    `min_informative` coefficients above the informative threshold: slots
    with nothing to test are skipped rather than treated as evidence the
    payload stopped, and slots with a mere handful of samples are skipped
    rather than trusted. Scanning still stops at the first conclusive slot
    below the floor. device: where the scores are computed (None: the
    card).
    """
    frames = _to_device(frames_gray, resolve_device(device))
    scores_bf, counts_bf = _per_slot_scores(frames, float(np.float32(delta)))
    valid = counts_bf.cpu().numpy() >= min_informative
    per_frame = np.where(valid, scores_bf.cpu().numpy(), 0.0)
    scores = per_frame.max(axis=0)  # best validly-backed frame per slot
    conclusive = valid.any(axis=0)
    n = 0
    for c in range(1, scores.shape[0]):
        if not conclusive[c]:
            continue  # inconclusive slot: no evidence either way
        if scores[c] > score_floor:
            n = c
        else:
            break
    return n


@dataclasses.dataclass
class SteganalysisReport:
    deltas: np.ndarray          # candidate grid
    scores: np.ndarray          # lattice scores per candidate
    background: float           # median score (clean expectation)
    best_delta: int             # strongest candidate
    best_score: float
    detection_ratio: float      # best_score / background
    verdict: str                # "stego-likely" | "clean-likely"

    @property
    def detected(self) -> bool:
        return self.verdict == "stego-likely"


def analyze_frames(
    frames_gray: np.ndarray,
    num_ac: int = 10,
    delta_min: int = 6,
    delta_max: int = 100,
    threshold: float = 3.0,
    score_floor: float = 0.85,
    min_informative: int = 32,
    device=None,
) -> SteganalysisReport:
    """Scan a delta grid and flag QIM lattice structure.

    Verdict requires BOTH a detection ratio above `threshold` AND a raw
    per-frame score above `score_floor`: true QIM saturates the lattice on
    payload frames (score ~0.95-1.0), while synthetic low-texture content can
    align coincidentally with some delta but never saturates. A candidate's
    per-frame score only counts when at least `min_informative` coefficients
    back it. device: where the scores are computed (None: the card).
    """
    deltas = np.arange(delta_min, delta_max + 1, dtype=np.float32)
    frames = _to_device(frames_gray, resolve_device(device))
    per_frame, counts = lattice_scores(frames, torch.from_numpy(deltas),
                                       num_ac)
    valid = counts.cpu().numpy() >= min_informative  # (K, B)
    per_frame = np.where(valid, per_frame.cpu().numpy(), 0.0)
    scores = per_frame.max(axis=1)  # best frame per candidate delta
    # background = the TYPICAL (candidate, frame) alignment, not the best
    # frame per candidate: a max-over-frames background is inflated by the
    # payload frames themselves
    background = (float(np.median(per_frame[valid])) if valid.any()
                  else float(np.median(per_frame)))
    best_idx = int(np.argmax(scores))
    best_score = float(scores[best_idx])
    # Large deltas blur the grid: re-score the candidates within ±10% of the
    # coarse winner at a much tighter eps — only the exact delta survives
    # uint8-requantization-level noise there.
    near = np.abs(deltas - deltas[best_idx]) <= 0.1 * deltas[best_idx]
    if near.sum() > 1 and best_score > score_floor:
        fine_s, fine_c = lattice_scores(frames, torch.from_numpy(deltas[near]),
                                        num_ac, eps=0.02)
        fine = np.where(fine_c.cpu().numpy() >= min_informative,
                        fine_s.cpu().numpy(), 0.0).max(axis=1)
        best_idx = int(np.flatnonzero(near)[np.argmax(fine)])
        best_score = float(scores[best_idx])
    ratio = best_score / max(background, 1e-6)
    detected = ratio > threshold and best_score > score_floor
    return SteganalysisReport(
        deltas=deltas,
        scores=scores,
        background=background,
        best_delta=int(deltas[best_idx]),
        best_score=best_score,
        detection_ratio=ratio,
        verdict="stego-likely" if detected else "clean-likely",
    )


def read_gray_frames(path, max_frames: int = 4) -> np.ndarray:
    """First frames of a video as a (B, H, W) uint8 gray stack (the shared
    front half of analyze_video and the steganalyze CLI)."""
    from stegotpu_torch.video import VideoReader

    with VideoReader(path) as reader:
        batch = next(iter(reader.batches(max_frames, mode="gray")), None)
    if batch is None or batch.shape[0] == 0:
        raise IOError(f"no frames readable from '{path}'")
    return batch


def analyze_video(
    path, num_ac: int = 10, max_frames: int = 4, **kw
) -> SteganalysisReport:
    """Steganalyze the first frames of a video file."""
    return analyze_frames(read_gray_frames(path, max_frames), num_ac=num_ac,
                          **kw)


def recover_params(stego_video, config, max_frames: int = 4, device=None):
    """RECOVERY MODE's shared core (CLI --auto-params): re-derive (delta,
    num_ac) from the stego's QIM lattice after a failed extraction.

    Returns (new_config | None, message). new_config is None when a retry
    cannot help; the message distinguishes the cases a user must tell
    apart — no lattice at all (not a stego / too smooth) vs lattice found
    but matching the parameters already tried (the failure is elsewhere:
    wrong key, corrupt payload).
    """
    gray = read_gray_frames(stego_video, max_frames)
    # Two detection passes: the configured-width scan first, then slot 1 as
    # the fallback. Scoring over config.num_ac_coeffs slots dilutes the
    # lattice fraction when the TRUE num_ac is smaller, but every
    # payload-carrying block snaps its FIRST AC coefficient regardless of
    # the embedder's num_ac, so a slot-1 scan catches that case. It runs
    # second, never instead: slot-1 evidence alone is weaker.
    rep = analyze_frames(gray, num_ac=config.num_ac_coeffs, device=device)
    if not rep.detected and config.num_ac_coeffs > 1:
        rep = analyze_frames(gray, num_ac=1, device=device)
    if not rep.detected:
        return None, (f"no QIM lattice detected (verdict: {rep.verdict}) — "
                      "not a stego video, or the cover is too smooth to "
                      "carry lattice evidence")
    n_est = estimate_num_ac(gray, rep.best_delta, device=device)
    if n_est <= 0:
        return None, (f"lattice detected at delta={rep.best_delta} but no "
                      "conclusive num_ac estimate — cover too smooth for "
                      "slot-level evidence")
    if (rep.best_delta, n_est) == (config.delta, config.num_ac_coeffs):
        return None, (f"steganalysis recovered delta={rep.best_delta}, "
                      f"coeffs={n_est} — the SAME parameters that already "
                      "failed: the problem is elsewhere (wrong private "
                      "key, or a corrupted payload region)")
    new = dataclasses.replace(config, delta=rep.best_delta,
                              num_ac_coeffs=n_est)
    return new, (f"steganalysis estimates delta={rep.best_delta} "
                 f"(lattice score {rep.best_score:.3f}), coeffs={n_est}")

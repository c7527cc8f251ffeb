"""Evaluation suite: stego quality, extraction fidelity, capacity, crypto cost.

A copy of ``stegotpu/evaluation.py``, which cannot be reused: it imports
the JAX package's metrics. Here ``compare_videos`` reduces each batch on
a ``device`` argument (metrics.psnr_batch/ssim_batch) and only the
per-frame scalars come back to the host; ``cv2`` is imported only where a
function needs it, so the module imports without it. The JAX package's
tail-batch padding (one compiled shape for jit) is gone: the metrics are
per frame, so a short tail batch gives the same values.

Parity with the reference's evaluation.py (C11 in SURVEY.md §2.1) with its
bugs fixed (SURVEY.md §6):

- PSNR computes differences in float (the reference's uint8 subtraction
  wraps around, evaluation.py:14);
- SSIM uses the standard data_range=255 (the reference uses max-min,
  evaluation.py:26);
- capacity reports the real QIM capacity (W//8)*(H//8)*N, not the
  "1 bit/pixel" figure (evaluation.py:266-283) — both are returned, the
  naive one labeled as such;
- the crypto timing probes measure REAL ECDH/HKDF/AES-GCM/SHA3 operations
  (the reference's are time.sleep simulations, evaluation.py:249-264).

Quality verdict thresholds match the reference (>30 dB good, >20 dB
acceptable; evaluation.py:40-45, 217-231).
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import torch

from stegotpu_torch import crypto
from stegotpu_torch.config import StegoConfig, crop_dims
from stegotpu_torch.image import load_image_gray
from stegotpu_torch.metrics import psnr_batch, psnr_np, ssim_batch, ssim_np
from stegotpu_torch.ops.color import bgr_to_gray_np


def quality_verdict(psnr_db: float) -> str:
    """Reference rubric (evaluation.py:40-45)."""
    if psnr_db > 30:
        return "GOOD"
    if psnr_db > 20:
        return "ACCEPTABLE"
    return "POOR"


@dataclasses.dataclass
class FrameComparison:
    psnr: float
    ssim: float

    @property
    def verdict(self) -> str:
        return quality_verdict(self.psnr)


def compare_frames(a: np.ndarray, b: np.ndarray) -> FrameComparison:
    """PSNR + SSIM between two grayscale frames (reference:
    bandingkan_frame_video, evaluation.py:28-47)."""
    return FrameComparison(psnr=psnr_np(a, b), ssim=ssim_np(a, b))


def compare_images(path_a: str | Path, path_b: str | Path) -> FrameComparison:
    """Compare two image files as grayscale, resizing b to a's shape on
    mismatch (reference: bandingkan_gambar, evaluation.py:49-91)."""
    a = load_image_gray(path_a)
    b = load_image_gray(path_b)
    if a.shape != b.shape:
        import cv2

        b = cv2.resize(b, (a.shape[1], a.shape[0]))
    return compare_frames(a, b)


@dataclasses.dataclass
class StegoEvaluation:
    video: FrameComparison | None
    image: FrameComparison | None
    frames_per_video: tuple[int, int] | None = None


def evaluate_stego_result(
    video_original: str | Path,
    video_stego: str | Path,
    image_original: str | Path | None = None,
    image_extracted: str | Path | None = None,
    dump_frames_dir: str | Path | None = None,
) -> StegoEvaluation:
    """First-frame video quality + optional extracted-image fidelity
    (reference: evaluasi_hasil_steganografi, evaluation.py:144-233)."""
    from stegotpu_torch.video import VideoReader

    with VideoReader(video_original) as r_o, VideoReader(video_stego) as r_s:
        f_o = r_o.read_frame(crop=False)
        f_s = r_s.read_frame(crop=False)
        if f_o is None or f_s is None:
            raise IOError("cannot read first frames")
        # stego video is cropped to multiples of 8; crop the original the same
        h8, w8 = crop_dims(f_s.shape[0], f_s.shape[1])
        g_o = bgr_to_gray_np(f_o[: f_s.shape[0], : f_s.shape[1]])
        g_s = bgr_to_gray_np(f_s)
        video_cmp = compare_frames(g_o[:h8, :w8], g_s[:h8, :w8])
        if dump_frames_dir is not None:
            import cv2

            d = Path(dump_frames_dir)
            d.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(d / "frame_original.png"), f_o)
            cv2.imwrite(str(d / "frame_stego.png"), f_s)
        counts = (r_o.info.frame_count, r_s.info.frame_count)

    image_cmp = None
    if image_original and image_extracted:
        if os.path.exists(image_original) and os.path.exists(image_extracted):
            image_cmp = compare_images(image_original, image_extracted)
    return StegoEvaluation(video=video_cmp, image=image_cmp, frames_per_video=counts)


@dataclasses.dataclass
class VideoComparison:
    frames: int
    mean_psnr: float
    min_psnr: float
    mean_ssim: float

    @property
    def verdict(self) -> str:
        return quality_verdict(self.mean_psnr)


def compare_videos(
    video_a: str | Path,
    video_b: str | Path,
    max_frames: int | None = None,
    batch_frames: int = 32,
    device="cpu",
) -> VideoComparison:
    """Full-video gray PSNR/SSIM (the reference compares only the first
    frame, evaluation.py:176-192; this walks every frame pair).

    Each decoded batch goes to `device` and through the batched PSNR/SSIM
    reductions (metrics.psnr_batch/ssim_batch) there — only the per-frame
    scalars cross back to the host.
    """
    from stegotpu_torch.video import VideoReader

    psnrs: list[float] = []
    ssims: list[float] = []
    with VideoReader(video_a) as ra, VideoReader(video_b) as rb:
        h = min(ra.info.cropped[0], rb.info.cropped[0])
        w = min(ra.info.cropped[1], rb.info.cropped[1])
        it_a = ra.batches(batch_frames, mode="gray")
        it_b = rb.batches(batch_frames, mode="gray")
        while True:
            a = next(it_a, None)
            b = next(it_b, None)
            if a is None or b is None:
                break
            n = min(a.shape[0], b.shape[0])
            if max_frames:
                n = min(n, max_frames - len(psnrs))
            if n <= 0:
                break
            ga = torch.from_numpy(np.ascontiguousarray(a[:n, :h, :w])).to(device)
            gb = torch.from_numpy(np.ascontiguousarray(b[:n, :h, :w])).to(device)
            psnrs.extend(psnr_batch(ga, gb).cpu().numpy().astype(np.float64))
            ssims.extend(ssim_batch(ga, gb).cpu().numpy().astype(np.float64))
            if max_frames and len(psnrs) >= max_frames:
                break
    if not psnrs:
        raise IOError("no comparable frames")
    finite = [p for p in psnrs if p != float("inf")]
    mean_psnr = float(np.mean(finite)) if finite else float("inf")
    return VideoComparison(
        frames=len(psnrs),
        mean_psnr=mean_psnr,
        min_psnr=float(min(psnrs)),
        mean_ssim=float(np.mean(ssims)),
    )


@dataclasses.dataclass
class CapacityReport:
    width: int
    height: int
    qim_bits_per_frame: int       # real capacity: (W//8)*(H//8)*num_ac
    naive_bits_per_frame: int     # the reference's 1 bit/px figure (for parity)
    frames: int
    total_qim_bits: int
    # default = payload.FIXED_HEADER_BITS; capacity_report passes the
    # config-aware value (2*(dims_bits - 16) wider for nonstandard dims)
    payload_header_bits: int = 976
    max_secret_pixels: int = 0    # gray pixels embeddable across the video

    def __post_init__(self):
        self.max_secret_pixels = max(
            0, (self.total_qim_bits - self.payload_header_bits) // 8
        )


def capacity_report(video_path: str | Path, config: StegoConfig = StegoConfig()) -> CapacityReport:
    """Embedding capacity of a cover video (fixes reference bug #8:
    evaluasi_capacity_bit_per_frame assumes 1 bit/pixel)."""
    from stegotpu_torch.video import VideoReader

    with VideoReader(video_path) as reader:
        w = reader.info.width
        h = reader.info.height
        n = reader.info.frame_count
    h8, w8 = crop_dims(h, w)
    qim = config.frame_capacity_bits(h8, w8)
    from stegotpu_torch.payload import DIMS_BITS, FIXED_HEADER_BITS

    return CapacityReport(
        width=w, height=h,
        qim_bits_per_frame=qim,
        naive_bits_per_frame=h8 * w8,
        frames=n,
        total_qim_bits=qim * max(n, 0),
        # derived, not the 976 literal: nonstandard dims_bits widens the
        # two dimension fields
        payload_header_bits=FIXED_HEADER_BITS
        + 2 * (config.dims_bits - DIMS_BITS),
    )


@dataclasses.dataclass
class CryptoTimings:
    keygen_ms: float
    ecdh_ms: float
    hkdf_ms: float
    aes_encrypt_ms: float
    aes_decrypt_ms: float
    sha3_ms: float
    payload_bytes: int


def measure_crypto_timings(payload_bytes: int = 64 * 64, repeats: int = 20) -> CryptoTimings:
    """Real wall-clock costs of the crypto stages (replaces the reference's
    time.sleep simulations, evaluation.py:249-264)."""
    data = os.urandom(payload_bytes)

    def clock(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats * 1e3

    keygen_ms = clock(lambda: crypto.generate_keypair())
    a_priv, a_pub = crypto.generate_keypair()
    b_priv, b_pub = crypto.generate_keypair()
    ecdh_ms = clock(lambda: crypto.ecdh_shared_secret(a_priv, b_pub))
    shared = crypto.ecdh_shared_secret(a_priv, b_pub)
    salt = crypto.hkdf_salt()
    hkdf_ms = clock(lambda: crypto.derive_aes_key(shared, salt))
    key = crypto.derive_aes_key(shared, salt)
    enc_ms = clock(lambda: crypto.aes_gcm_encrypt(data, key))
    ct, nonce, tag = crypto.aes_gcm_encrypt(data, key)
    dec_ms = clock(lambda: crypto.aes_gcm_decrypt(ct, key, nonce, tag))
    sha3_ms = clock(lambda: crypto.sha3_256(data))
    return CryptoTimings(keygen_ms, ecdh_ms, hkdf_ms, enc_ms, dec_ms, sha3_ms, payload_bytes)


def security_summary() -> dict:
    """Static security parameters (replaces the reference's simulated
    brute-force probe, evaluation.py:235-247, with factual statements)."""
    return {
        "curve": "SECP256R1 (P-256)",
        "ecdh_security_bits": 128,
        "aes": "AES-256-GCM",
        "aes_security_bits": 256,
        "kdf": "HKDF-SHA256 (16-byte random salt per message)",
        "integrity": ["AES-GCM 128-bit tag (authenticated)", "SHA3-256 plaintext digest"],
        "forward_secrecy": "ephemeral sender key per message",
    }

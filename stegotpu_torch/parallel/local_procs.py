"""Single-host segment-parallel product pipelines (``--procs N``).

Counterpart of ``stegotpu/parallel/local_procs.py``. The end-to-end
bottleneck is the host codec (FFV1 encode and decode; the reference's
single-threaded loop is embed_process.py:88-152). The multi-process
machinery already parallelizes it across processes (dist_pipeline); this
module is the same segment contract collapsed to ONE command on one host,
no coordinator ceremony: the video splits into batch-aligned frame-range
segments, N worker pipelines run them concurrently, and the native packet
concat stitches a byte-exact result.

Workers are threads by default: the hot stages (FFmpeg decode and encode,
the kernels) release the GIL, so workers overlap on multi-core hosts, and
they share the caller's device. ``mode='spawn'`` runs them as OS processes
for hosts where a stage holds the GIL (the cv2 fallback decoder); those
workers compute the plain versions on the CPU and never open the card (a
spawned child cannot use its parent's CUDA context, and must not contend
for the card).

Exact container seek (video.py:VideoReader.seek) is what makes this scale:
worker k jumps straight to its segment instead of decoding the whole prefix.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from stegotpu_torch import payload as payload_mod
from stegotpu_torch.bitstream import bits_to_bytes
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.device import resolve_device
from stegotpu_torch.image import image_to_bits
from stegotpu_torch.parallel.dist_pipeline import segment_bounds
from stegotpu_torch.utils.logging import get_logger

log = get_logger(__name__)

CPU = torch.device("cpu")


def resolve_procs(procs, frame_count: int, batch_frames: int) -> int:
    """'auto' -> min(effective host cores, batch-aligned segments in the
    work) — the `--procs auto` default policy. Integers pass through."""
    if procs in (None, "", "auto"):
        from stegotpu_torch import video

        segs = max(1, -(-frame_count // batch_frames)) if frame_count > 0 else 1
        return max(1, min(video.effective_cpu_count(), segs))
    return int(procs)


def _spawn_init() -> None:
    """Spawn-worker initializer: hide every CUDA device from the worker
    before anything in it can initialise CUDA. `--procs-mode spawn` is for
    hosts where a stage holds the GIL (the cv2 fallback decoder); its
    workers are handed device='cpu' and run the kernels' plain versions,
    byte-identical to thread mode and --procs 1 on the CPU. On the card the
    plain versions and the CUDA kernels may differ by ±1 stego pixel level
    at f32 rounding boundaries (the exactness envelope, ops/exactness.py):
    the embedded payload decodes identically, but the stego file is not
    byte-equal to a --procs 1 run on the card; prefer thread mode there."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _embed_segment_task(video_in, img_bytes, width, height, seg_path,
                        receiver_pub_compressed, config, batch_frames,
                        lo, hi, sealed_bits, device):
    """Top-level (picklable) worker body shared by thread and spawn pools."""
    from stegotpu_torch.pipeline import _embed_payload

    return _embed_payload(
        video_in, img_bytes, width, height, seg_path,
        receiver_pub_compressed, config, batch_frames,
        frame_range=(lo, hi), sealed_bits=sealed_bits, device=device,
    )


def _make_pool(mode: str, max_workers: int):
    """Worker pool for `mode` ('thread' default, 'spawn' = OS processes
    off the card; see _spawn_init)."""
    if mode == "spawn":
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        return ProcessPoolExecutor(
            max_workers=max_workers,
            mp_context=mp.get_context("spawn"),
            initializer=_spawn_init,
        )
    if mode != "thread":
        raise ValueError(f"unknown procs mode {mode!r} (thread|spawn)")
    return ThreadPoolExecutor(max_workers=max_workers)


def _worker_device(mode: str, device: torch.device) -> torch.device:
    """Threads share the caller's device; spawn workers run on the CPU."""
    return CPU if mode == "spawn" else device


def parallel_embed(
    video_in: str | Path,
    secret_image: str | Path,
    video_out: str | Path,
    receiver_pub_compressed: bytes,
    config: StegoConfig = StegoConfig(),
    batch_frames: int = 8,
    procs: int | str = 2,
    rng=None,
    sealed_bits=None,
    mode: str = "thread",
    device=None,
) -> "EmbedResult":
    """One-command segment-parallel embed across `procs` local workers.

    The payload is sealed ONCE (one ephemeral key/salt/nonce — every worker
    embeds slices of the identical crypto stream), segments are cut on
    batch boundaries, and the output is stitched by packet stream-copy:
    byte-for-byte what the segment encoders produced, pixel-identical to a
    single-pipeline run of the same sealed payload.

    procs: worker count, or 'auto' = min(host cores, segments) — resolves
    to the plain single-pipeline path on 1-core hosts.
    mode: 'thread' (default — every hot stage releases the GIL) or 'spawn'
    (OS processes computing on the CPU, for hosts where a stage holds the
    GIL, e.g. the cv2 fallback decoder).
    device: the caller's device (None: the card), that of thread workers
    and of the plain pipeline when 'auto' resolves to one worker.
    """
    width, height, img_bits = image_to_bits(secret_image)
    return _parallel_embed_payload(
        video_in, bits_to_bytes(img_bits), width, height, video_out,
        receiver_pub_compressed, config, batch_frames, procs, rng,
        sealed_bits, mode, device)


def parallel_embed_data(
    video_in: str | Path,
    data: bytes,
    video_out: str | Path,
    receiver_pub_compressed: bytes,
    config: StegoConfig = StegoConfig(),
    batch_frames: int = 8,
    procs: int | str = 2,
    rng=None,
    mode: str = "thread",
    device=None,
) -> "EmbedResult":
    """Segment-parallel raw-bytes embed (extension mode, `embed-data
    --procs`): same wire format with the RAW_DATA_DIMS marker."""
    w, h = payload_mod.RAW_DATA_DIMS
    return _parallel_embed_payload(video_in, data, w, h, video_out,
                                   receiver_pub_compressed, config,
                                   batch_frames, procs, rng, None, mode,
                                   device)


def _parallel_embed_payload(
    video_in, img_bytes: bytes, width: int, height: int, video_out,
    receiver_pub_compressed: bytes, config: StegoConfig, batch_frames: int,
    procs, rng, sealed_bits, mode: str = "thread", device=None,
) -> "EmbedResult":
    from stegotpu_torch.native.videoio import (available, build_error,
                                               concat_videos)
    from stegotpu_torch.pipeline import EmbedResult, _embed_payload
    from stegotpu_torch.video import VideoReader, force_avi_path

    if procs != "auto" and int(procs) < 2:
        raise ValueError("parallel_embed needs procs >= 2 (use the plain "
                         "pipeline for 1)")
    device = resolve_device(device)

    if sealed_bits is None:
        sealed_bits, _ = payload_mod.seal_payload(
            img_bytes, width, height, receiver_pub_compressed,
            config.dims_bits, rng=rng,
        )
    sealed_bits = np.asarray(sealed_bits, dtype=np.uint8)
    total = int(sealed_bits.size)

    with VideoReader(video_in) as probe:
        frame_count = probe.info.frame_count
        h8, w8 = probe.info.cropped
    if config.frame_capacity_bits(h8, w8) == 0:
        return EmbedResult(False, None, total, 0, 0,
                           error="zero embedding capacity per frame "
                                 "(num_ac_coeffs/frame size)")

    # resolve 'auto' BEFORE demanding the native concat layer or a
    # container frame count: when it resolves to 1 (1-core host, or no
    # frame count to cut segments from), the plain pipeline is the
    # documented fallback and needs neither
    procs = resolve_procs(procs, frame_count, batch_frames)
    if procs < 2:  # 'auto' on a 1-core host: the plain pipeline IS optimal
        return _embed_payload(video_in, img_bytes, width, height, video_out,
                              receiver_pub_compressed, config, batch_frames,
                              sealed_bits=sealed_bits, device=device)
    if not available():
        raise OSError(f"--procs needs the native concat layer ({build_error()})")
    if frame_count <= 0:
        raise ValueError(
            "--procs needs a container-reported frame count to cut segments")

    bounds = segment_bounds(frame_count, procs, batch_frames)
    out_path = Path(force_avi_path(video_out))
    live = [(i, lo, hi) for i, (lo, hi) in enumerate(bounds)
            if lo < frame_count]
    seg_paths = {i: out_path.with_suffix(f".seg{i}.avi") for i, _, _ in live}
    worker_device = _worker_device(mode, device)

    with _make_pool(mode, len(live)) as pool:
        futures = [
            (i, pool.submit(
                _embed_segment_task, str(video_in), img_bytes, width, height,
                str(seg_paths[i]), receiver_pub_compressed, config,
                batch_frames, lo, hi, sealed_bits, worker_device))
            for i, lo, hi in live
        ]
        results = {}
        errors = []
        for i, fut in futures:
            try:
                results[i] = fut.result()
            except Exception as e:  # noqa: BLE001 — cleanup, then re-raise
                errors.append(e)

    def cleanup():
        for p in seg_paths.values():
            Path(p).unlink(missing_ok=True)

    if errors:
        cleanup()
        raise errors[0]
    bits_embedded = max(r.bits_embedded for r in results.values())
    residual = sum(r.residual_bits for r in results.values())
    ok = all(r.success for r in results.values()) and bits_embedded >= total
    if not ok or (residual and not config.allow_residual):
        cleanup()
        first = results.get(live[0][0])
        seg_errs = "; ".join(r.error for r in results.values() if r.error)
        return EmbedResult(
            False, None, total, bits_embedded, frame_count,
            first.first_original_gray if first else None,
            first.first_stego_gray if first else None, residual,
            error=seg_errs or (
                f"verified embed: {residual} unrepairable payload bits"
                if residual else
                f"video ended before full payload embedded "
                f"({bits_embedded}/{total} bits)"))
    try:
        concat_videos(out_path, [str(seg_paths[i]) for i, _, _ in live])
    finally:
        cleanup()  # segment temps must not outlive a failed stitch
    first = results[live[0][0]]
    log.info("parallel embed: %d segments, %d bits, %d frames",
             len(live), total, frame_count)
    return EmbedResult(True, str(out_path), total, bits_embedded, frame_count,
                       first.first_original_gray, first.first_stego_gray,
                       residual)


def _segment_bits(stego_video, lo: int, hi: int, h8: int, w8: int,
                  config: StegoConfig, batch_frames: int,
                  device) -> np.ndarray:
    """Worker body: the wire-order QIM bits of stego frames [lo, hi),
    extracted on `device`."""
    from stegotpu_torch.ops.dispatch import extract_fn
    from stegotpu_torch.pipeline import _to_device
    from stegotpu_torch.video import VideoReader

    xfn = extract_fn(config.kernel, h8, w8, config.qim_precision)
    out: list[np.ndarray] = []
    got, need = 0, hi - lo
    with VideoReader(stego_video) as reader:
        try:
            if lo > 0:  # matching pipeline/dist guards: never seek(0)
                reader.seek(lo)
        except OSError as e:
            # unseekable container: decode-and-discard fallback, matching
            # the embed-segment and dist-extract call sites — a file that
            # extracts fine with --procs 1 must not fail with --procs N
            log.warning("segment seek failed (%s); falling back to "
                        "decode-and-discard", e)
            skipped = 0
            for gray in reader.batches(batch_frames, mode="gray"):
                skipped += gray.shape[0]
                if skipped > lo:
                    raise OSError(
                        f"decode-and-discard overshot segment start {lo} "
                        f"(reader yielded {skipped} frames; batch-aligned "
                        "segments should land exactly)") from e
                if skipped == lo:
                    break
        for gray in reader.batches(batch_frames, mode="gray"):
            n = gray.shape[0]
            take = min(n, need - got)
            if n < batch_frames:
                gray = np.concatenate(
                    [gray, np.zeros((batch_frames - n, h8, w8), np.uint8)])
            bits = xfn(_to_device(gray, device), float(config.delta),
                       config.num_ac_coeffs)[:take].cpu().numpy()
            out.append(bits.reshape(-1))
            got += take
            if got >= need:
                break
    return (np.concatenate(out) if out else np.zeros((0,), np.uint8))


def parallel_extract(
    stego_video: str | Path,
    receiver_private,
    config: StegoConfig = StegoConfig(),
    output_image: str | Path | None = None,
    batch_frames: int = 8,
    procs: int | str = 2,
    mode: str = "thread",
    device=None,
) -> "ExtractResult":
    """One-command segment-parallel extract across `procs` local workers.

    Phase 1 parses only the HEADER (pipeline.inspect_stego_header) to learn
    the exact payload length, so the frame range to decode is known up
    front; phase 2 splits that range into batch-aligned segments, each
    worker seeks to its start and extracts its bits; the assembled stream
    then decrypts exactly as in the single-pipeline path.

    procs: worker count or 'auto'; mode, device: as for parallel_embed
    (the header is read on `device`).
    """
    from stegotpu_torch.payload import NeedMoreBits, parse_payload_bits
    from stegotpu_torch.pipeline import (ExtractResult, finalize_extract,
                                         inspect_stego_header)
    from stegotpu_torch.video import VideoReader

    if procs != "auto" and int(procs) < 2:
        raise ValueError("parallel_extract needs procs >= 2")
    device = resolve_device(device)
    try:
        hdr = inspect_stego_header(stego_video, config, device=device)
    except ValueError as e:
        return ExtractResult(False, error=str(e))
    frames_needed = int(hdr["payload_frames"])

    with VideoReader(stego_video) as probe:
        h8, w8 = probe.info.cropped
        frame_count = probe.info.frame_count
    if 0 < frame_count < frames_needed:
        return ExtractResult(
            False, frames_read=frame_count,
            error=f"payload spans {frames_needed} frames but the video has "
                  f"{frame_count}")

    procs = resolve_procs(procs, frames_needed, batch_frames)
    if procs < 2:  # 'auto' on a 1-core host
        from stegotpu_torch.pipeline import extract_image_from_video

        return extract_image_from_video(stego_video, receiver_private,
                                        config, output_image, batch_frames,
                                        device=device)

    bounds = segment_bounds(frames_needed, procs, batch_frames)
    live = [(lo, hi if hi is not None else frames_needed)
            for lo, hi in bounds if lo < frames_needed]
    worker_device = _worker_device(mode, device)
    with _make_pool(mode, len(live)) as pool:
        futures = [pool.submit(_segment_bits, str(stego_video), lo, hi, h8,
                               w8, config, batch_frames, worker_device)
                   for lo, hi in live]
        try:
            chunks = [f.result() for f in futures]
        except OSError as e:
            return ExtractResult(False, error=f"video read failed: {e}",
                                 frames_read=frames_needed)
    have = np.concatenate(chunks)

    try:
        parts, _ = parse_payload_bits(have, config.dims_bits)
    except NeedMoreBits:
        # segment workers decoded short (truncated container mid-payload)
        return ExtractResult(
            False, frames_read=frames_needed,
            error=f"video ended before payload complete ({have.size} bits read)")
    except ValueError as e:
        return ExtractResult(False, error=str(e), frames_read=frames_needed)
    return finalize_extract(parts, receiver_private, output_image,
                            frames_needed)

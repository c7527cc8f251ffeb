"""Multi-process PRODUCT pipelines: cooperative file->file embed/extract.

Counterpart of ``stegotpu/parallel/dist_pipeline.py`` over torch.distributed
(the CLI's `dist-embed` / `dist-extract`; parallel/distributed.initialize
forms the Gloo group). The video splits into contiguous frame-range
*segments*, one per process; payload bit offsets are statically computable
from the frame index (capacity per frame is constant), so every process
embeds its segment independently with `cursor = segment_start * capacity`.
The only cross-process data is the sealed payload broadcast (rank 0's crypto
randomness must be the one embedded everywhere), the agreement on each
phase's status, and, on extract, the gathered bit stream — small host
tensors, hence Gloo.

Segments are stitched by PACKET stream-copy (`native.videoio.concat_videos`
-> svx_concat): no decode or re-encode — the final container's frames are
byte-for-byte the segment encoders' output. A machine without the FFmpeg
development libraries has no concat: there rank 0 fails dist-embed in its
preflight, before any segment is written (the JAX package fails at the
stitch, with the segments written).

Decode note: the reader supports exact container seek
(video.py:VideoReader.seek), so a process jumps straight to its segment;
decode-and-discard remains the fallback where seek raises.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from stegotpu_torch import payload as payload_mod
from stegotpu_torch.bitstream import bits_to_bytes
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.device import resolve_device
from stegotpu_torch.image import image_to_bits
from stegotpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def segment_bounds(frame_count: int, nproc: int, batch_frames: int
                   ) -> list[tuple[int, int | None]]:
    """Disjoint frame ranges [(lo, hi), ...] covering the video, one per
    process: equal shares rounded UP to batch_frames so every interior cut
    lands on a batch boundary; the last segment runs to EOF (hi=None)."""
    if frame_count <= 0:
        raise ValueError("cannot segment a video with unknown frame count")
    per = -(-frame_count // nproc)
    per = -(-per // batch_frames) * batch_frames
    bounds: list[tuple[int, int | None]] = []
    for i in range(nproc):
        lo = min(i * per, frame_count)
        hi = min((i + 1) * per, frame_count)
        bounds.append((lo, None if i == nproc - 1 else hi))
    return bounds


def _broadcast_bits(all_bits: np.ndarray) -> np.ndarray:
    """Rank 0's sealed payload becomes every rank's (crypto randomness —
    ephemeral key, salt, nonce — must be identical in every segment). Every
    rank seals a payload of the same length, so the shapes agree."""
    t = torch.from_numpy(np.ascontiguousarray(all_bits, dtype=np.uint8))
    dist.broadcast(t, src=0)
    return t.numpy()


def _allgather(value) -> np.ndarray:
    """(world_size, *shape) stack of every rank's `value` (same shape and
    dtype everywhere), the counterpart of multihost_utils.process_allgather."""
    t = torch.from_numpy(np.array(value))  # a copy, 0-d for a scalar
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _local_mesh(mesh_spec, device, host_devices):
    from stegotpu_torch.parallel.mesh import local_devices, product_mesh

    return product_mesh(mesh_spec, devices=local_devices(device, host_devices))


def distributed_embed(
    video_in: str | Path,
    secret_image: str | Path,
    video_out: str | Path,
    receiver_pub_compressed: bytes,
    config: StegoConfig = StegoConfig(),
    batch_frames: int = 8,
    rng=None,
    mesh_spec: str | None = None,
    device=None,
    host_devices: int | None = None,
) -> "EmbedResult | None":
    """Cooperative multi-process embed; call in EVERY process of an
    initialized process group (parallel/distributed.initialize). Returns the
    final EmbedResult on rank 0 and None elsewhere (segment results are
    logged per process).

    mesh_spec: optional 'data=N,space=M' PER-PROCESS mesh over this
    process's devices (mesh.local_devices(device, host_devices)) — frame
    range segments across processes, frames x block rows across each
    process's devices. The spec is resolved here (not by the caller) so a
    process whose devices don't satisfy it still joins the preflight
    collective below instead of leaving its peers hanging.
    device: the torch device of an unsharded segment (None: the card).
    """
    from stegotpu_torch.pipeline import EmbedResult, _embed_payload
    from stegotpu_torch.video import VideoReader, force_avi_path

    nproc, pid = dist.get_world_size(), dist.get_rank()
    # preflight: EVERYTHING that can fail before the first collective (the
    # secret read, the cover probe, the device and mesh) resolves here,
    # then the processes agree — a pre-collective exit would hang every peer
    mesh = None
    preflight_error: Exception | None = None
    try:
        width, height, img_bits = image_to_bits(secret_image)
        img_bytes = bits_to_bytes(img_bits)
        all_bits, _ = payload_mod.seal_payload(
            img_bytes, width, height, receiver_pub_compressed,
            config.dims_bits, rng=rng,
        )  # every rank derives the same SHAPE; rank 0's VALUES win below
        with VideoReader(video_in) as probe:
            frame_count = probe.info.frame_count
            h8, w8 = probe.info.cropped
        if frame_count <= 0:
            raise ValueError(
                "cannot segment a video with unknown frame count")
        if config.frame_capacity_bits(h8, w8) == 0:
            raise ValueError("zero capacity (num_ac_coeffs=0?)")
        if pid == 0:
            from stegotpu_torch.native.videoio import available, build_error

            if not available():
                raise OSError("dist-embed needs the native concat layer "
                              f"({build_error()})")
        if mesh_spec:
            from stegotpu_torch.pipeline import _mesh_setup

            mesh = _local_mesh(mesh_spec, device, host_devices)
            device = None  # the mesh's devices run the kernels
            # _mesh_setup rounds the batch up to the mesh data axis; that
            # MUST happen before segment bounds are computed, or batches
            # straddle segment boundaries and frames duplicate
            batch_frames, _ = _mesh_setup(mesh, config, h8, w8, batch_frames)
        else:
            device = resolve_device(device)
    except Exception as e:  # noqa: BLE001 - re-raised after the agreement
        preflight_error = e
    ok_pre = _allgather(np.int32(0 if preflight_error is not None else 1))
    if int(ok_pre.min()) == 0:
        if preflight_error is not None:
            raise preflight_error
        return (EmbedResult(False, None, 0, 0, 0,
                            error="preflight failed on a peer process (see "
                                  "its log)")
                if pid == 0 else None)

    all_bits = _broadcast_bits(all_bits)
    bounds = segment_bounds(frame_count, nproc, batch_frames)
    lo, hi = bounds[pid]

    out_path = Path(force_avi_path(video_out))
    seg_path = out_path.with_suffix(f".seg{pid}.avi")
    seg_error: Exception | None = None
    if lo >= frame_count:
        seg_res = None  # more processes than segments: idle process
    else:
        # a raising process must STILL join the collectives below, or every
        # other process hangs in all_gather waiting for it
        try:
            seg_res = _embed_payload(
                video_in, img_bytes, width, height, seg_path,
                receiver_pub_compressed, config, batch_frames,
                mesh=mesh, frame_range=(lo, hi), sealed_bits=all_bits,
                device=device,
            )
            log.info("segment %d/%d: frames [%d, %s) -> %s (%d bits in)",
                     pid, nproc, lo, hi if hi is not None else "EOF",
                     seg_path, seg_res.bits_embedded)
        except Exception as e:  # noqa: BLE001 - incl. device errors
            seg_error = e
            seg_res = EmbedResult(False, None, int(all_bits.size), 0, 0)
            log.error("segment %d/%d failed: %s", pid, nproc, e)

    # segment status travels through the group so every process agrees;
    # the bits watermark is each segment's ACTUAL cursor (a truncated cover
    # can decode fewer frames than the container header claims, so metadata
    # capacity must not substitute for it)
    ok_local = 1 if (seg_res is None or seg_res.success) else 0
    stats = _allgather(np.asarray(
        [ok_local, seg_res.bits_embedded if seg_res else 0,
         seg_res.residual_bits if seg_res else 0], np.int64))
    ok_all = int(stats[:, 0].min())
    cursor_global = int(stats[:, 1].max())
    residual_global = int(stats[:, 2].sum())
    dist.barrier()  # every segment file is closed before rank 0 stitches

    if pid != 0:
        if seg_error is not None:
            raise seg_error  # after the collectives: peers not left hanging
        return None
    total = int(all_bits.size)
    segs = [str(out_path.with_suffix(f".seg{i}.avi")) for i in range(nproc)
            if bounds[i][0] < frame_count]

    def cleanup():
        for s in segs:
            Path(s).unlink(missing_ok=True)

    success = bool(ok_all) and cursor_global >= total
    if not success:
        log.error(
            "distributed embed failed (%d/%d bits; segment ok=%d) — "
            "removing segments", cursor_global, total, ok_all)
        cleanup()
        if seg_error is not None:  # cleanup happened first; now surface it
            raise seg_error
        return EmbedResult(
            False, None, total, cursor_global, frame_count,
            residual_bits=residual_global,
            error=f"distributed embed failed ({cursor_global}/{total} "
                  f"bits; segment ok={ok_all})")
    from stegotpu_torch.native.videoio import concat_videos

    try:
        concat_videos(out_path, segs)
    finally:
        cleanup()  # segment files must not outlive a failed stitch
    # rank 0's segment result carries the first-frame PSNR frames
    return EmbedResult(
        True, str(out_path), total, cursor_global, frame_count,
        seg_res.first_original_gray if seg_res else None,
        seg_res.first_stego_gray if seg_res else None,
        residual_bits=residual_global,  # verified mode: never silently 0
    )


def distributed_extract(
    stego_video: str | Path,
    receiver_private,
    config: StegoConfig = StegoConfig(),
    output_image: str | Path | None = None,
    batch_frames: int = 8,
    mesh_spec: str | None = None,
    device=None,
    host_devices: int | None = None,
) -> "ExtractResult":
    """Cooperative multi-process extract: each process reads ONLY its frame
    segment's bits, and the processes assemble the global bit prefix in
    DEMAND-DRIVEN rounds — the parser's NeedMoreBits watermark decides how
    many frames the next round gathers, so a typical payload (a few frames)
    never ships a long video's full QIM capacity between processes. The
    gathered stream parses identically on every process (extraction is
    stateless given the format), so all processes return the same
    ExtractResult — but only rank 0 writes output_image.

    mesh_spec / device / host_devices: as for distributed_embed.
    """
    from stegotpu_torch.ops.dispatch import extract_fn
    from stegotpu_torch.payload import NeedMoreBits, parse_payload_bits
    from stegotpu_torch.pipeline import (ExtractResult, _mesh_setup,
                                         _to_device, finalize_extract)
    from stegotpu_torch.video import VideoReader

    nproc, pid = dist.get_world_size(), dist.get_rank()
    # preflight: EVERYTHING that can fail before the first round gather
    # (file open, device and mesh, geometry validation) resolves here, then
    # the processes agree before any work — a pre-collective exit would hang
    # peers. The reader opened here is the one the round loop streams from.
    mesh = None
    kern = None
    reader = None
    preflight_error: Exception | None = None
    try:
        reader = VideoReader(stego_video)
        h8, w8 = reader.info.cropped
        frame_count = reader.info.frame_count
        if frame_count <= 0:
            raise ValueError(
                "cannot segment a video with unknown frame count")
        cap = config.frame_capacity_bits(h8, w8)
        if cap == 0:
            raise ValueError("zero capacity (num_ac_coeffs=0?)")
        if mesh_spec:
            mesh = _local_mesh(mesh_spec, device, host_devices)
            batch_frames, kern = _mesh_setup(mesh, config, h8, w8,
                                             batch_frames)
        else:
            device = resolve_device(device)
    except Exception as e:  # noqa: BLE001 - re-raised after the agreement
        preflight_error = e
    ok_pre = _allgather(np.int32(0 if preflight_error is not None else 1))
    if int(ok_pre.min()) == 0:
        if reader is not None:
            reader.release()
        if preflight_error is not None:
            raise preflight_error
        return ExtractResult(False, error="a peer process failed preflight")

    with reader:
        bounds = segment_bounds(frame_count, nproc, batch_frames)
        lo, hi = bounds[pid]
        hi_eff = hi if hi is not None else frame_count
        delta = float(config.delta)
        if mesh is not None:
            from stegotpu_torch.parallel.mesh import sharded_extract_frames

            sharded = sharded_extract_frames(mesh, config.num_ac_coeffs,
                                             kernel=kern,
                                             precision=config.qim_precision)

            def xfn(gray):
                return sharded(_to_device(gray, "cpu"), delta)
        else:
            extract = extract_fn(config.kernel, h8, w8, config.qim_precision)

            def xfn(gray):
                return extract(_to_device(gray, device), delta,
                               config.num_ac_coeffs)

        # lazy forward reader over THIS process's segment: per-frame bit
        # rows, buffered across rounds (round windows need not align to
        # batches)
        seen = 0
        if 0 < lo < frame_count:
            try:
                reader.seek(lo)  # exact (video.py): skip the decode of the
                seen = lo        # pre-segment prefix entirely
            except OSError as e:
                log.warning("segment seek failed (%s); falling back to "
                            "decode-and-discard", e)
        batches_iter = reader.batches(batch_frames, mode="gray")
        buf: list[np.ndarray] = []  # per-frame (cap,) bit arrays, in order
        exhausted = False

        def take(n_frames: int) -> list[np.ndarray]:
            """Next n frames' bits of this process's segment. A decode error
            marks the segment exhausted instead of raising: this process
            must keep joining the round all_gathers or its peers hang."""
            nonlocal seen, exhausted
            while len(buf) < n_frames and not exhausted:
                try:
                    gray = next(batches_iter, None)
                    if gray is None or seen >= hi_eff:
                        exhausted = True
                        break
                    n = gray.shape[0]
                    if seen + n <= lo:  # pre-segment: decode and discard
                        seen += n
                        continue
                    if n < batch_frames:
                        gray = np.concatenate(
                            [gray,
                             np.zeros((batch_frames - n, h8, w8), np.uint8)])
                    bits = xfn(gray)[:n].cpu().numpy()
                except Exception as e:  # noqa: BLE001 - decode OR device
                    log.error("segment read failed mid-round: %s", e)
                    exhausted = True  # stay in the round protocol
                    break
                keep = min(n, hi_eff - seen)
                buf.extend(bits[:keep])
                seen += n
            out, buf[:] = buf[:n_frames], buf[n_frames:]
            return out

        have = np.zeros((0,), np.uint8)  # assembled global prefix
        frames_done = 0  # global frames already gathered
        parts = None
        parse_error: str | None = None
        while True:
            try:
                parts, _ = parse_payload_bits(have, config.dims_bits)
                break
            except NeedMoreBits as e:
                needed_frames = min(-(-e.needed // cap), frame_count)
            except ValueError as e:
                parse_error = str(e)
                break
            if frames_done >= frame_count:
                parse_error = (f"video ended before payload complete "
                               f"({have.size} bits read)")
                break
            window = needed_frames - frames_done
            if window <= 0:  # defensive: watermark must advance
                window = batch_frames
            # my contribution: my segment's frames inside the round window
            my_lo = max(lo, frames_done)
            my_hi = min(hi_eff, frames_done + window)
            mine = take(my_hi - my_lo) if my_hi > my_lo else []
            contrib = (np.concatenate(mine) if mine
                       else np.zeros((0,), np.uint8))
            padded = np.zeros((window * cap,), np.uint8)
            padded[: contrib.size] = contrib
            counts = _allgather(np.int64(contrib.size))
            gathered = _allgather(padded)
            round_bits = np.concatenate(
                [gathered[i, : int(counts[i])] for i in range(nproc)])
            if round_bits.size == 0:  # nothing decodable anywhere: stop
                parse_error = (f"video ended before payload complete "
                               f"({have.size} bits read)")
                break
            have = np.concatenate([have, round_bits])
            frames_done += window
            if int(counts.sum()) < window * cap:
                # some segment decoded short (truncated container): the
                # assembled prefix may now be missing interior bits — stop
                # after one final parse attempt rather than looping forever
                frames_done = frame_count

    if parse_error is not None:
        return ExtractResult(False, error=parse_error,
                             frames_read=frames_done)
    return finalize_extract(parts, receiver_private, output_image,
                            frames_done, write_output=(pid == 0))

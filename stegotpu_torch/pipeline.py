"""Top-level embed / extract pipelines: file-to-file, streaming, batched.

Counterpart of ``stegotpu/pipeline.py``. The host logic is the JAX
package's, line for line; only the device sites differ: arrays go to the
device as ``torch.from_numpy(...).to(device)`` and come back as
``.cpu().numpy()``, on the ``device`` the caller names (no global device
guessing). The verified embed runs the CUDA kernel K3 through
ops/verified.py. The mesh branches are not ported yet and raise
NotImplementedError; ``inspect_stego_header`` is not ported yet.

Same observable semantics as the reference's L3 orchestration
(``embed_gambar_ke_video_final`` embed_process.py:17-152,
``ekstraksi_gambar_video_final`` extract_process.py:22-216):

- frames are cropped top-left to multiples of 8;
- frames carrying payload are written as the gray stego frame replicated to
  BGR; once the payload is exhausted the remaining frames are copied through
  in original (cropped) color;
- extraction reads full frame capacity per frame, accumulating bits until the
  length-driven header parse succeeds, then decrypts, verifies SHA3
  (warn-only on mismatch, like the reference), and rebuilds the image.

Frames move in fixed-size batches through the device kernel, with a
background decode thread double-buffering host I/O against device compute.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from pathlib import Path

import numpy as np
import torch

from stegotpu_torch import image as image_codec
from stegotpu_torch import payload as payload_mod
from stegotpu_torch.bitstream import bits_to_bytes, pad_bits
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.metrics import psnr_np
from stegotpu_torch.ops.dispatch import embed_fn, extract_fn, extract_packed_fn
from stegotpu_torch.payload import (NeedMoreBits, PayloadParts, open_payload,
                                    parse_header_bits, parse_payload_bits)
from stegotpu_torch.video import (FrameBudget, GraySwitch, Prefetcher,
                                  VideoReader, VideoWriter, force_avi_path)

log = logging.getLogger("stegotpu_torch")


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to stegotpu_torch yet (ROADMAP.md queue 1, "
        f"{item}); use the JAX package stegotpu for it")


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _timed_iter(iterable, timer, name: str):
    """Yield from iterable, attributing the time spent WAITING on it (i.e.
    host decode not hidden by the Prefetcher) to a timer stage."""
    if timer is None:
        yield from iterable
        return
    it = iter(iterable)
    while True:
        with timer.stage(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def _pad_batch(gray: np.ndarray, batch_frames: int, h8: int, w8: int
               ) -> np.ndarray:
    """Zero-pad a tail batch UP TO batch_frames frames (stable batch shape).

    Pad frames must be APPENDED, never prepended: every consumer slices the
    device result back with [:n]."""
    n = gray.shape[0]
    if n == batch_frames:
        return gray
    return np.concatenate(
        [gray, np.zeros((batch_frames - n, h8, w8), np.uint8)])


def _stage(timer, name: str):
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


@dataclasses.dataclass
class EmbedResult:
    success: bool
    output_path: str | None
    total_payload_bits: int
    bits_embedded: int
    frames_used: int
    first_original_gray: np.ndarray | None = None
    first_stego_gray: np.ndarray | None = None
    residual_bits: int = 0  # verified mode: unrepairable slots (0 = BER-0)
    error: str | None = None  # human-readable failure reason (success=False)

    @property
    def first_frame_psnr(self) -> float | None:
        if self.first_original_gray is None or self.first_stego_gray is None:
            return None
        return psnr_np(self.first_original_gray, self.first_stego_gray)


@dataclasses.dataclass
class ExtractResult:
    success: bool
    pixels: np.ndarray | None = None
    data: bytes | None = None      # raw-byte payloads (extension mode)
    hash_ok: bool = False
    parts: PayloadParts | None = None
    error: str | None = None
    output_path: str | None = None
    frames_read: int = 0  # stego frames actually decoded — exactly
    # max(first batch, header-derived payload frames) on the streaming path

    @property
    def is_raw_data(self) -> bool:
        return self.parts is not None and self.parts.is_raw_data


def embed_image_in_video(
    video_in: str | Path,
    secret_image: str | Path,
    video_out: str | Path,
    receiver_pub_compressed: bytes,
    config: StegoConfig = StegoConfig(),
    batch_frames: int = 8,
    rng=None,
    timer=None,
    mesh=None,
    frame_range=None,
    sealed_bits=None,
    device="cpu",
) -> EmbedResult:
    """Embed an encrypted secret image into a video, file to file.

    device: the torch device the QIM kernel runs on ('cuda' for the CUDA
    stripe kernel, 'cpu' for its plain version).

    rng: optional numpy Generator for a DETERMINISTIC crypto stage
    (ephemeral key/salt/nonce) — test builds only; see payload.seal_payload.
    mesh: not ported yet (must be None).
    timer: optional object with a ``stage(name)`` context manager (the JAX
    package's utils.profiling.StageTimer shape) collecting decode_wait /
    device_dispatch / device_readback / encode stage totals.
    frame_range / sealed_bits: segment embedding (see _embed_payload) — the
    resume / multi-host building blocks: embed only frames [lo, hi) with
    globally-consistent bit offsets, optionally against a pre-sealed
    payload so separate runs embed the identical crypto stream.
    """
    width, height, img_bits = image_codec.image_to_bits(secret_image)
    if (width, height) == payload_mod.RAW_DATA_DIMS:
        # 65535x65535 is the reserved raw-bytes marker: an image with
        # exactly those dims would be misparsed as a raw payload on extract
        raise ValueError(
            f"secret dimensions {width}x{height} collide with the reserved "
            "raw-data marker; use embed-data for byte payloads")
    img_bytes = bits_to_bytes(img_bits)
    return _embed_payload(video_in, img_bytes, width, height, video_out,
                          receiver_pub_compressed, config, batch_frames, rng,
                          timer, mesh, frame_range, sealed_bits, device)


def embed_data_in_video(
    video_in: str | Path,
    data: bytes,
    video_out: str | Path,
    receiver_pub_compressed: bytes,
    config: StegoConfig = StegoConfig(),
    batch_frames: int = 8,
    device="cpu",
) -> EmbedResult:
    """Embed arbitrary encrypted bytes (extension mode, not in the reference).

    Uses the same wire format with the RAW_DATA_DIMS marker in the dims
    header; extraction auto-detects it and returns the raw bytes.
    """
    w, h = payload_mod.RAW_DATA_DIMS
    return _embed_payload(video_in, data, w, h, video_out,
                          receiver_pub_compressed, config, batch_frames,
                          device=device)


def _embed_payload(
    video_in, plaintext: bytes, width: int, height: int, video_out,
    receiver_pub_compressed: bytes, config: StegoConfig, batch_frames: int,
    rng=None, timer=None, mesh=None, frame_range=None, sealed_bits=None,
    device="cpu",
) -> EmbedResult:
    """frame_range: optional (lo, hi) source-frame window this call owns —
    the multi-host segment contract (parallel/dist_pipeline.py): frames
    before lo are decoded and discarded (payload offsets stay global via
    cursor = lo*capacity), frames from hi on are never read. lo (and hi,
    except for the final segment) must be batch_frames-aligned so segments
    cut on batch boundaries. sealed_bits: pre-sealed payload bits shared
    across hosts (crypto randomness must be identical on every segment).
    """
    if config.delta <= 0:
        raise ValueError("embedding requires delta > 0 (delta <= 0 embeds nothing)")
    if mesh is not None:
        raise _not_ported("mesh embedding", "M11 parallel/")
    if sealed_bits is not None:
        all_bits = np.asarray(sealed_bits, dtype=np.uint8)
    else:
        all_bits, _parts = payload_mod.seal_payload(
            plaintext, width, height, receiver_pub_compressed, config.dims_bits,
            rng=rng,
        )
    total = int(all_bits.size)
    lo, hi = frame_range if frame_range is not None else (0, None)
    if lo < 0 or (hi is not None and hi <= lo):
        # a negative lo would pass the batch-alignment check below (-8 % 8
        # == 0) and then Python-wrap the payload slice to the END of the
        # bitstream — a silently-corrupt embed; reject up front
        raise ValueError(f"frame_range {frame_range} invalid: need "
                         "0 <= start < end")

    with VideoReader(video_in) as reader:
        h8, w8 = reader.info.cropped
        if h8 == 0 or w8 == 0:
            return EmbedResult(False, None, total, 0, 0,
                               error="cover frames smaller than one 8x8 "
                                     "block after cropping")
        cap_bits = config.frame_capacity_bits(h8, w8)
        if cap_bits == 0:
            return EmbedResult(False, None, total, 0, 0,
                               error="zero embedding capacity per frame "
                                     "(num_ac_coeffs/frame size)")
        if config.verified_embed:
            from stegotpu_torch.ops.verified import embed_frames_verified_fast

            def run_embed_verified(gray, seg, remaining):
                return embed_frames_verified_fast(
                    _to_device(gray, device), _to_device(seg, device),
                    remaining, float(config.delta), config.num_ac_coeffs,
                    repair_rounds=config.repair_rounds, kernel=config.kernel,
                    precision=config.qim_precision)
        else:
            embed = embed_fn(config.kernel, h8, w8, config.qim_precision)

            def run_embed(gray, seg, remaining):
                return embed(_to_device(gray, device), _to_device(seg, device),
                             remaining, float(config.delta),
                             config.num_ac_coeffs)

        if lo % batch_frames:
            raise ValueError(
                f"frame_range start {lo} must align to batch_frames="
                f"{batch_frames}")

        out_path = force_avi_path(video_out)
        cursor = min(total, lo * cap_bits)  # bits owned by earlier segments
        frames_seen = 0
        if lo > 0:
            # exact container seek (video.py): the pre-segment frames are
            # never decoded — this is what makes N local segment pipelines
            # scale instead of each re-decoding the whole prefix. The
            # decode-and-discard branch below stays as both the semantic
            # spec and the fallback for unseekable containers.
            try:
                reader.seek(lo)
                frames_seen = lo
            except OSError as e:
                log.warning("segment seek failed (%s); falling back to "
                            "decode-and-discard", e)
        residual_total = 0
        first_orig = first_stego = None
        # One-deep device pipeline: batch k+1 is dispatched before batch k's
        # stego frames are pulled back for encoding, overlapping device
        # compute with host decode (Prefetcher) and FFV1 encode. Possible
        # because bits-per-frame is host-computable (capacity is static), so
        # the payload cursor never waits on the device.
        # (batch_bgr, gray, n, bpf_np, stego_dev, is_first)
        pending: tuple | None = None

        def drain(writer, item):
            nonlocal first_orig, first_stego
            batch_bgr, gray, n, bpf, stego_dev, is_first = item
            with _stage(timer, "device_readback"):
                stego = stego_dev[:n].cpu().numpy()
            if is_first:
                first_orig = gray[0].copy()
                first_stego = stego[0].copy()
            with _stage(timer, "encode"):
                # write RUNS of same-kind frames in one call: the native
                # FFV1 encoder pool parallelizes across the frames of a
                # write() batch, so per-frame writes would serialize it
                i = 0
                while i < n:
                    j = i + 1
                    while j < n and (bpf[j] > 0) == (bpf[i] > 0):
                        j += 1
                    if bpf[i] > 0:
                        writer.write_gray_batch(stego[i:j])
                    else:
                        writer.write_bgr_batch(batch_bgr[i:j])
                    i = j

        # mode='both': the native decoder emits the cv2-bit-exact gray plane
        # alongside BGR during decode (C++, on the prefetch thread) — the old
        # host-side gray_convert stage is gone from the hot loop entirely.
        # gray_switch turns the conversion off for the passthrough tail
        # (post-payload frames only need BGR).
        gray_switch = GraySwitch()
        try:
            with VideoWriter(out_path, reader.info.fps, w8, h8,
                             config.codec) as writer, \
                    Prefetcher.maybe(
                        reader.batches(batch_frames, mode="both",
                                       gray_switch=gray_switch)) as prefetched:
                for batch_bgr, gray in _timed_iter(prefetched, timer,
                                                   "decode_wait"):
                    n = batch_bgr.shape[0]
                    if frames_seen + n <= lo:  # pre-segment: decode and discard
                        frames_seen += n
                        continue
                    if cursor < total:
                        gray = _pad_batch(gray, batch_frames, h8, w8)
                        remaining = total - cursor
                        seg = pad_bits(
                            all_bits[cursor : cursor + batch_frames * cap_bits],
                            batch_frames * cap_bits,
                        ).reshape(batch_frames, cap_bits)
                        if config.verified_embed:
                            with _stage(timer, "device_dispatch"):
                                stego_dev, _bpf_dev, residual = run_embed_verified(
                                    gray, seg, remaining)
                            residual = int(residual)
                            if residual:
                                residual_total += residual
                                log.error(
                                    "verified embed: %d unrepairable slots "
                                    "(extremely saturated cover)", residual,
                                )
                        else:
                            with _stage(timer, "device_dispatch"):
                                stego_dev, _bpf_dev = run_embed(gray, seg, remaining)
                        # host-side bits-per-frame (identical to the device calc)
                        bpf = np.clip(
                            remaining - np.arange(n, dtype=np.int64) * cap_bits,
                            0, cap_bits,
                        ).astype(np.int64)
                        if pending is not None:
                            drain(writer, pending)
                            pending = None
                        pending = (batch_bgr, gray, n, bpf, stego_dev,
                                   frames_seen == lo and n > 0)
                        cursor += int(bpf.sum())
                        # live progress (reference: per-frame prints,
                        # embed_process.py:129 — streamed into the GUI log)
                        log.debug("embed progress: %d/%d bits, frame %d",
                                  min(cursor, total), total, frames_seen + n)
                    else:
                        # Payload complete: stream remaining frames as original
                        # color (reference: embed_process.py:134-139) — but only
                        # after the in-flight stego batch is written, preserving
                        # frame order.
                        gray_switch.on = False  # tail batches skip gray convert
                        if pending is not None:
                            drain(writer, pending)
                            pending = None
                        with _stage(timer, "encode"):
                            writer.write_bgr_batch(batch_bgr)
                    frames_seen += n
                    if hi is not None and frames_seen >= hi:
                        break
                if pending is not None:
                    drain(writer, pending)
        except OSError as e:
            # corrupt/truncated cover mid-decode: the same structured
            # failure contract extract_image_from_video honors for the
            # identical condition — the partial output stays on disk for
            # forensics, and the result carries the counters
            return EmbedResult(
                False, out_path, total, cursor, frames_seen, first_orig,
                first_stego, residual_total,
                error=f"video read failed: {e}")

    if frame_range is None:
        success = cursor >= total
    else:
        # segment-local completion: all bits this frame window owns are in
        # (global completion is the orchestrator's sum over segments)
        hi_eff = hi if hi is not None else frames_seen
        success = cursor >= min(total, hi_eff * cap_bits)
    if not success:
        log.warning(
            "video ended before full payload embedded (%d/%d bits)", cursor, total
        )
    if residual_total and not config.allow_residual:
        # verified mode's whole point: a wrong bit kills the AES-GCM tag on
        # extract, so emit a FAILURE the caller can act on, not a log line
        # (the file is still on disk for forensics; the result names why)
        log.error(
            "verified embed FAILED: %d unrepairable payload bits "
            "(use allow_residual to emit anyway)", residual_total,
        )
        return EmbedResult(
            False, out_path, total, cursor, frames_seen, first_orig,
            first_stego, residual_total,
            error=f"verified embed: {residual_total} unrepairable payload "
                  "bits (use allow_residual to emit anyway)")
    return EmbedResult(
        success, out_path if success else None, total, cursor, frames_seen,
        first_orig, first_stego, residual_total,
        error=None if success else
        f"video ended before full payload embedded ({cursor}/{total} bits)")


class _EagerBitBuf:
    """Wire-order bit collector with immediate device readback (the oracle
    path: its extract output IS the wire-order bit plane, so there is
    nothing to defer)."""

    def __init__(self, to_bits, timer=None):
        self._to_bits = to_bits
        self._timer = timer
        self._parts: list[np.ndarray] = []
        self.capacity_bits = 0  # bits materializable from ingested batches
        self.frames = 0

    def add(self, n: int, dev, eager_frames: int | None = None) -> None:
        with _stage(self._timer, "device_readback"):
            bits = self._to_bits(dev, n)
        self._parts.append(bits)
        self.capacity_bits += bits.size
        self.frames += n

    def bits(self, k: int | None = None) -> np.ndarray:
        if not self._parts:
            return np.zeros(0, np.uint8)
        if len(self._parts) > 1:
            self._parts[:] = [np.concatenate(self._parts)]
        return self._parts[0]


class _PackedBitBuf:
    """Lazy collector over the stripe kernel's packed-compact-rows output.

    Retains each batch's device array and reads back only the (frame,
    stripe-group) prefix that the requested bit count spans — the sliced
    readback ships `ceil(bits/spg)` groups of `rows_pad x W/8` bytes
    instead of the batch's full rows. A typical payload (header + small
    secret, one stripe group of one 1080p frame) moves ~8 KB over the
    host link instead of ~540 KB for an 8-frame batch. Wire order is
    frame-major then stripe-group-major, so a group prefix is a strict
    bit-stream prefix (ops/pallas_kernel.packed_rows_to_bits_host).

    `eager_frames` on add() keeps the bulk phase's readback/compute
    overlap: frames known to be fully inside the payload are read back
    immediately (one-deep pipelined by the caller), and only the final
    partial frame waits for the closing bits(total) slice.
    """

    def __init__(self, h: int, w: int, num_ac: int, stripe: int, timer=None):
        from stegotpu_torch.ops.stripe_kernel import (_rows_pad,
                                                      packed_rows_to_bits_host,
                                                      rows_per_block)

        self._unpack = packed_rows_to_bits_host
        self._h, self._w, self._num_ac, self._stripe = h, w, num_ac, stripe
        self._rp = _rows_pad(stripe, rows_per_block(num_ac))
        self._gpf = h // stripe                       # stripe groups / frame
        self._cap = (h // 8) * (w // 8) * num_ac      # wire bits / frame
        self._spg = self._cap // self._gpf            # wire bits / group
        self._timer = timer
        self._items: list[dict] = []  # {'n','dev','groups','chunks'}
        self.capacity_bits = 0
        self.frames = 0

    def add(self, n: int, dev, eager_frames: int = 0) -> None:
        item = {"n": n, "dev": dev, "groups": 0, "chunks": []}
        self._items.append(item)
        self.capacity_bits += n * self._cap
        self.frames += n
        if eager_frames > 0:
            self._materialize(item, min(eager_frames, n) * self._gpf)

    def _materialize(self, item: dict, groups: int) -> None:
        groups = min(groups, item["n"] * self._gpf)
        if groups <= item["groups"]:
            return
        # growth re-reads the whole prefix: it happens at most a couple of
        # times per extract and the superseded read was no larger than this
        full, part = divmod(groups, self._gpf)
        chunks: list[np.ndarray] = []
        with _stage(self._timer, "device_readback"):
            if full:
                chunks.append(
                    self._unpack(item["dev"][:full].cpu().numpy(), self._h,
                                 self._w, self._num_ac,
                                 self._stripe).reshape(-1))
            if part:
                rows = item["dev"][full, : part * self._rp].cpu().numpy()
                chunks.append(
                    self._unpack(rows[None], self._h, self._w, self._num_ac,
                                 self._stripe).reshape(-1))
        item["chunks"] = chunks
        item["groups"] = groups
        if groups == item["n"] * self._gpf:
            item["dev"] = None  # fully read back: release the device array

    def bits(self, k: int | None = None) -> np.ndarray:
        """First >= min(k, capacity) wire bits (rounded up to a stripe
        group), reading back only what the prefix spans."""
        remaining = self.capacity_bits if k is None else min(
            k, self.capacity_bits)
        for item in self._items:
            take = min(remaining, item["n"] * self._cap)
            if take > 0:
                self._materialize(item, -(-take // self._spg))
            remaining -= take
        parts = [c for item in self._items for c in item["chunks"]]
        if not parts:
            return np.zeros(0, np.uint8)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


def extract_image_from_video(
    stego_video: str | Path,
    receiver_private,
    config: StegoConfig = StegoConfig(),
    output_image: str | Path | None = None,
    batch_frames: int = 8,
    timer=None,
    mesh=None,
    device="cpu",
) -> ExtractResult:
    """Extract, decrypt, and verify the secret image from a stego video.

    Decodes exactly the frames the payload spans: an unpipelined first
    batch yields the header (hence the exact total bit count), then a
    FrameBudget caps the decoder at ceil(total/capacity) frames — the
    batched equivalent of the reference's read-until-enough loop
    (extract_process.py:55-86,173-182). On the stripe-kernel path the
    device ships bit-packed compact rows (no full-capacity wire-order
    unpack pass) and the host reads back ONLY the (frame, stripe-group)
    prefix the payload spans before unpacking in numpy (_PackedBitBuf /
    ops/stripe_kernel.packed_rows_to_bits_host).

    timer: optional stage timer (see embed_image_in_video).
    mesh: not ported yet (must be None).
    device: the torch device the extract kernel runs on.
    """
    if mesh is not None:
        raise _not_ported("mesh extraction", "M11 parallel/")
    with VideoReader(stego_video) as reader:
        h8, w8 = reader.info.cropped
        if h8 == 0 or w8 == 0:
            return ExtractResult(False, error="video dimensions too small")
        cap_bits = config.frame_capacity_bits(h8, w8)
        if cap_bits == 0:
            return ExtractResult(False, error="zero capacity (num_ac_coeffs=0?)")
        delta = float(config.delta)

        packed = extract_packed_fn(config.kernel, h8, w8, config.qim_precision)
        if packed is not None:
            # stripe-kernel fast path: the device ships bit-PACKED compact
            # rows and never runs the full-capacity wire-order unpack pass;
            # the host reads back only the (frame, stripe-group) prefix the
            # payload spans and unpacks in numpy (_PackedBitBuf).
            from stegotpu_torch.ops.stripe_kernel import pick_stripe

            def run_extract(gray):
                return packed(_to_device(gray, device), delta,
                              config.num_ac_coeffs)

            buf = _PackedBitBuf(h8, w8, config.num_ac_coeffs,
                                pick_stripe(h8), timer)
        else:
            extract = extract_fn(config.kernel, h8, w8, config.qim_precision)

            def run_extract(gray):
                return extract(_to_device(gray, device), delta,
                               config.num_ac_coeffs)

            buf = _EagerBitBuf(
                lambda dev, n: dev[:n].cpu().numpy().reshape(-1), timer)

        # Two phases (reference: reads only until enough bits accumulate,
        # extract_process.py:55-86,173-182 — the batched equivalent):
        #   1. header hunt, UNpipelined: pull batches lazily (no Prefetcher,
        #      no in-flight speculation) until the header parses, which
        #      yields the exact total payload bit count;
        #   2. bounded bulk, pipelined: the FrameBudget caps the decoder at
        #      exactly ceil(total/cap) frames, and the one-deep device
        #      pipeline + Prefetcher overlap decode with device compute.
        # Net: exactly max(batch_frames, payload_frames) frames decoded.
        # Phase 1's lack of overlap is bounded even on garbage input
        # (wrong key/params): every variable header field carries an
        # 8-bit byte length (config.LEN_FIELD_BITS), so parse_header_bits
        # can demand at most payload.max_header_bits() ~= 10 kbit before
        # it either parses, raises ValueError, or the video ends — on a
        # real header it is one batch. The speculative read-ahead a
        # Prefetcher would add here is exactly what the exact-frame-count
        # contract forbids.
        frames_read = 0
        needed = payload_mod.FIXED_HEADER_BITS  # lower bound, grows as parsed
        total_bits: int | None = None           # exact once header parses
        parts = None
        parse_error: str | None = None

        def try_parse_header() -> bool:
            """Attempt the header parse on the current buffer; True when the
            phase-1 loop should stop (parsed or hard error). NeedMoreBits may
            be satisfiable from bits already sitting on device — grow the
            materialized prefix before deciding more frames are required."""
            nonlocal needed, total_bits, parse_error
            while buf.capacity_bits >= needed:
                try:
                    _hdr, ct_len, hdr_pos = parse_header_bits(
                        buf.bits(needed), config.dims_bits)
                    total_bits = hdr_pos + 8 * ct_len
                    return True
                except NeedMoreBits as e:
                    needed = e.needed  # strictly grows: terminates
                except ValueError as e:
                    parse_error = str(e)
                    return True
            return False

        budget = FrameBudget()
        gen = reader.batches(batch_frames, mode="gray", budget=budget)
        try:
            # mode='gray': the native decoder converts to gray in C++ during
            # decode; the 3x-larger BGR plane never reaches the host arrays.
            # Phase 1 drives gen with explicit next(): breaking a for loop
            # over a wrapping generator would close gen itself (GeneratorExit
            # propagates through `yield from`), killing phase 2's stream.
            while True:
                with _stage(timer, "decode_wait"):
                    gray = next(gen, None)
                if gray is None:
                    break
                n = gray.shape[0]
                frames_read += n
                gray = _pad_batch(gray, batch_frames, h8, w8)
                with _stage(timer, "device_dispatch"):
                    dev = run_extract(gray)
                buf.add(n, dev)
                log.debug("extract progress: %d bits buffered, frame %d",
                          buf.capacity_bits, frames_read)
                if try_parse_header():
                    break

            if parse_error is None and total_bits is not None \
                    and buf.capacity_bits < total_bits:
                # phase 2: decode EXACTLY the frames the payload spans
                budget.limit = -(-total_bits // cap_bits)
                full_frames = total_bits // cap_bits  # fully-needed frames
                pending: tuple | None = None  # (n, device_result)

                def ingest(item) -> None:
                    # frames wholly inside the payload read back eagerly
                    # (one-deep overlap with the next batch's compute); the
                    # final partial frame waits for the closing bits(total)
                    n_, dev_ = item
                    buf.add(n_, dev_,
                            eager_frames=max(0, min(n_,
                                                    full_frames - buf.frames)))

                with Prefetcher.maybe(gen) as prefetched:
                    for gray in _timed_iter(prefetched, timer, "decode_wait"):
                        n = gray.shape[0]
                        frames_read += n
                        gray = _pad_batch(gray, batch_frames, h8, w8)
                        with _stage(timer, "device_dispatch"):
                            dev = run_extract(gray)
                        if pending is not None:
                            ingest(pending)
                        pending = (n, dev)
                        log.debug("extract progress: %d bits buffered, "
                                  "frame %d", buf.capacity_bits, frames_read)
                    if pending is not None:
                        ingest(pending)
        except OSError as e:
            # corrupt/truncated container mid-stream: structured failure
            return ExtractResult(False, error=f"video read failed: {e}",
                                 frames_read=frames_read)
        if parse_error is None and total_bits is not None \
                and buf.capacity_bits >= total_bits:
            try:
                parts, _consumed = parse_payload_bits(buf.bits(total_bits),
                                                      config.dims_bits)
            except NeedMoreBits:  # pragma: no cover - total_bits is exact
                pass
            except ValueError as e:
                parse_error = str(e)
        if parse_error is not None:
            return ExtractResult(False, error=parse_error,
                                 frames_read=frames_read)
        if parts is None:
            return ExtractResult(
                False,
                error="video ended before payload complete "
                      f"({buf.capacity_bits} bits read)",
                frames_read=frames_read,
            )

    return finalize_extract(parts, receiver_private, output_image,
                            frames_read)


def finalize_extract(parts: PayloadParts, receiver_private, output_image,
                     frames_read: int, write_output: bool = True
                     ) -> ExtractResult:
    """Shared payload finalization: decrypt, SHA3-verify (warn-only, like
    the reference), rebuild the image or return raw bytes, save.

    The single implementation behind the streaming extract, parallel
    (--procs) extract, and the multi-host dist-extract — these used to be
    three hand-maintained copies that had already drifted (the wrong-key
    hint and the SHA3 warning were missing from some). write_output=False
    skips filesystem writes (dist-extract: only process 0 writes)."""
    try:
        plaintext, hash_ok = open_payload(parts, receiver_private)
    except ValueError as e:
        # e.g. garbage bits parsed into a structurally-plausible header
        # whose "compressed point" is not on the curve — keep the
        # structured error contract rather than leaking an exception
        return ExtractResult(False, parts=parts, frames_read=frames_read,
                             error=f"payload fields invalid ({e}) — wrong "
                                   "delta/coeffs or not a stego video")
    if plaintext is None:
        return ExtractResult(False, parts=parts, frames_read=frames_read,
                             error="AES-GCM authentication failed")
    if not hash_ok:
        log.warning("SHA3-256 mismatch: image may be corrupt "
                    "(continuing, like reference)")
    if parts.is_raw_data:  # extension mode: arbitrary bytes, no image decode
        out_path = None
        if output_image is not None and write_output:
            Path(output_image).write_bytes(plaintext)
            out_path = str(output_image)
        return ExtractResult(True, data=plaintext, hash_ok=hash_ok,
                             parts=parts, output_path=out_path,
                             frames_read=frames_read)
    try:
        pixels = image_codec.bytes_to_pixels(
            plaintext, parts.secret_width, parts.secret_height
        )
    except ValueError as e:
        return ExtractResult(False, parts=parts, hash_ok=hash_ok,
                             error=str(e), frames_read=frames_read)
    out_path = None
    if output_image is not None and write_output:
        image_codec.save_image_gray(pixels, output_image)
        out_path = str(output_image)
    return ExtractResult(True, pixels=pixels, hash_ok=hash_ok, parts=parts,
                         output_path=out_path, frames_read=frames_read)


# Array-level API (no container round-trip) -----------------------------------

def embed_payload_into_gray_frames(
    frames_gray: np.ndarray,
    payload_bits: np.ndarray,
    config: StegoConfig = StegoConfig(),
    device="cpu",
) -> tuple[np.ndarray, np.ndarray]:
    """Embed raw payload bits into a (B, H, W) uint8 gray frame stack.

    Returns (stego frames, bits embedded per frame). Frames must already be
    cropped to multiples of 8.
    """
    b, h, w = frames_gray.shape
    cap = config.frame_capacity_bits(h, w)
    seg = pad_bits(payload_bits[: b * cap], b * cap).reshape(b, cap)
    stego, bpf = embed_fn(config.kernel, h, w, config.qim_precision)(
        _to_device(frames_gray, device),
        _to_device(seg, device),
        min(payload_bits.size, b * cap),
        float(config.delta),
        config.num_ac_coeffs,
    )
    return stego.cpu().numpy(), bpf.cpu().numpy()


def extract_bits_from_gray_frames(
    frames_gray: np.ndarray, config: StegoConfig = StegoConfig(), device="cpu"
) -> np.ndarray:
    """Extract the full capacity bitstream from a (B, H, W) gray frame stack."""
    _, h, w = frames_gray.shape
    bits = extract_fn(config.kernel, h, w, config.qim_precision)(
        _to_device(frames_gray, device), float(config.delta),
        config.num_ac_coeffs
    )
    return bits.cpu().numpy().reshape(-1)

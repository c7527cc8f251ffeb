"""Host-side video I/O: streaming decode, lossless FFV1 encode, prefetching.

A copy of ``stegotpu/video.py`` (VideoReader, VideoWriter, GraySwitch,
FrameBudget, Prefetcher, force_avi_path) with ``cv2`` imported only on its
fallback path, so the pipeline imports without it. The native FFmpeg
layer is the port's own ctypes wrapper (stegotpu_torch/native/videoio.py).

The reference streams one frame at a time through ``cv2.VideoCapture`` /
``cv2.VideoWriter`` with FFV1-in-.avi output (reference:
embed_process.py:89-146, extract_process.py:30-62). Here frames move in
batches so the device kernel amortizes dispatch, and a background decode
thread double-buffers host I/O against device compute.

Output container parity: the writer forces a ``.avi`` extension like the
reference's ``get_avi_path`` (reference: helpers.py:184-187,
embed_process.py:97-98) and uses the FFV1 lossless codec so QIM parities
survive the encode exactly.
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue
import shutil
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from stegotpu_torch import avi
from stegotpu_torch.config import crop_dims
from stegotpu_torch.native import videoio as native_io

# Frames the cv2 writer encoded: "lane" counts the runs (chunks) that an
# encoder lane encoded and that were joined into their output, "serial" the
# frames one cv2.VideoWriter encoded alone. The native writer counts nothing.
ENCODE_CHUNKS: collections.Counter = collections.Counter()

# cv2's FFV1 writer starts a keyframe every 12 frames, so a run of at most
# 12 frames encoded by a fresh writer is the serial writer's packets from a
# keyframe on (tests/test_torch_video_lanes.py pins it)
KEY_INTERVAL = 12
# a fresh cv2 writer's first frame costs about two later ones (the card's
# host, 1080p: 191-208 ms against 99-135), so a write is cut into runs of
# at least this many frames where it has them
MIN_RUN = 4
# a lane's raw frames stay under half a RIFF, so each lane file is one RIFF
_LANE_RAW_BYTES = 512 << 20


def force_avi_path(path: str | Path) -> str:
    """Force a .avi extension (reference: helpers.py:184-187)."""
    base, _ = os.path.splitext(str(path))
    return base + ".avi"


def _use_native(backend: str) -> bool:
    # an EXPLICIT backend choice always wins over the env kill-switch
    if backend == "native":
        if not native_io.available():
            raise RuntimeError(
                f"native video backend requested but unavailable: {native_io.build_error()}"
            )
        return True
    if backend == "cv2" or os.environ.get("STEGOTPU_VIDEO_BACKEND") == "cv2":
        return False
    return native_io.available()


@dataclass(frozen=True)
class VideoInfo:
    width: int
    height: int
    fps: float
    frame_count: int  # container-reported; may be 0/unreliable for streams

    @property
    def cropped(self) -> tuple[int, int]:
        """(height, width) cropped to multiples of 8, top-left anchored."""
        return crop_dims(self.height, self.width)


class VideoReader:
    """Streaming BGR frame reader with batched iteration.

    Uses the native FFmpeg layer (stegotpu_torch/native) when built — threaded
    decode, batch delivery in one C call — and falls back to cv2 otherwise
    (force with backend='cv2'/'native' or STEGOTPU_VIDEO_BACKEND=cv2).
    """

    def __init__(self, path: str | Path, backend: str = "auto"):
        self.path = str(path)
        self._native = None
        self._cap = None
        self._cv2_pos = 0  # frames delivered/skipped (cv2 backend only)
        if _use_native(backend):
            self._native = native_io.NativeVideoReader(self.path)
            self.info = VideoInfo(
                width=self._native.width,
                height=self._native.height,
                fps=self._native.fps,
                frame_count=self._native.frame_count,
            )
        else:
            import cv2

            self._cap = cv2.VideoCapture(self.path)
            if not self._cap.isOpened():
                raise IOError(f"cannot open video '{self.path}'")
            self.info = VideoInfo(
                width=int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                height=int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                fps=float(self._cap.get(cv2.CAP_PROP_FPS)),
                frame_count=int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            )

    def seek(self, frame_index: int) -> None:
        """Position so the next read delivers frame `frame_index` (0-based),
        EXACTLY (absolute index). Native backend: C-side keyframe seek +
        decode-forward (intra-only stego containers land directly; can
        seek anywhere, any time). cv2 fallback: grab()s forward from the
        TRACKED read position — correct for any codec (cv2's
        CAP_PROP_POS_FRAMES setter is not exactness-guaranteed on
        inter-coded streams, and a wrong frame silently corrupts segment
        embeds) — but cannot seek backwards: that raises.
        """
        if self._native is not None:
            self._native.seek(frame_index)
            return
        # cv2 fallback: absolute position via the tracked read count (the
        # grab() loop is relative; trusting CAP_PROP_POS_FRAMES setters is
        # not exactness-safe on inter-coded streams)
        if frame_index < self._cv2_pos:
            raise IOError(
                f"cv2 backend cannot seek backwards ({self._cv2_pos} -> "
                f"{frame_index}); open a fresh VideoReader")
        while self._cv2_pos < frame_index:
            if not self._cap.grab():
                self._cv2_pos = frame_index  # past EOF: reads return None
                break
            self._cv2_pos += 1

    def read_frame(self, crop: bool = True) -> np.ndarray | None:
        h, w = self.info.cropped if crop else (self.info.height, self.info.width)
        if self._native is not None:
            batch = self._native.read_batch(1, h, w)
            return None if batch is None else batch[0]
        ret, frame = self._cap.read()
        if not ret:
            return None
        self._cv2_pos += 1
        return frame[:h, :w]

    def batches(self, batch_size: int, crop: bool = True,
                mode: str = "bgr", gray_switch=None, budget=None) -> Iterator:
        """Yield uint8 frame batches; the last may be short.

        mode='bgr'  -> (n, H, W, 3) BGR (default)
        mode='gray' -> (n, H, W) cv2-bit-exact gray — on the native backend
                       the conversion happens in C++ during decode and BGR
                       never crosses into numpy; extract-side pipelines use
                       this (3x less host traffic)
        mode='both' -> ((n, H, W, 3) BGR, (n, H, W) gray) tuples — the embed
                       pipeline needs gray for the kernel and BGR for the
                       post-payload color passthrough

        gray_switch (mode='both' only): a GraySwitch the consumer flips off
        once it stops needing the gray plane (payload complete) — later
        batches yield (bgr, None) and skip the conversion entirely. With a
        Prefetcher in front, at most `depth` already-decoded batches still
        carry gray after the flip.

        budget: optional FrameBudget capping TOTAL frames this generator
        decodes. The consumer sets budget.limit once it learns how many
        frames it actually needs (the extract pipeline: exactly the
        header-derived payload frame count, pipeline.py) — the generator
        then shortens its final batch and stops, so frames past the limit
        are never decoded. The reference's extract loop reads frame-by-frame
        only until enough bits accumulate (extract_process.py:55-86); this
        is the batched equivalent of that early stop.

        On the cv2 fallback, gray is computed in numpy inside this generator,
        so a Prefetcher wrapping it still overlaps the conversion with
        device compute.
        """
        h, w = self.info.cropped if crop else (self.info.height, self.info.width)
        emitted = 0

        def next_n() -> int:
            """Frames the next batch may hold under the budget (0 = stop)."""
            if budget is None or budget.limit is None:
                return batch_size
            return min(batch_size, budget.limit - emitted)

        def want_gray() -> bool:
            return gray_switch is None or gray_switch.on

        if self._native is not None:
            read = {
                "bgr": self._native.read_batch,
                "gray": self._native.read_batch_gray,
                "both": self._native.read_batch_both,
            }[mode]
            while True:
                n = next_n()
                if n <= 0:
                    return
                if mode == "both" and not want_gray():
                    bgr = self._native.read_batch(n, h, w)
                    batch = None if bgr is None else (bgr, None)
                else:
                    batch = read(n, h, w)
                if batch is None:
                    return
                emitted += (batch[0] if mode == "both" else batch).shape[0]
                yield batch
        from stegotpu_torch.ops.color import bgr_to_gray_np

        buf: list[np.ndarray] = []

        def emit(frames: list[np.ndarray]):
            nonlocal emitted
            emitted += len(frames)
            bgr = np.stack(frames)
            if mode == "bgr":
                return bgr
            if mode == "both" and not want_gray():
                return (bgr, None)
            gray = bgr_to_gray_np(bgr)
            return gray if mode == "gray" else (bgr, gray)

        while True:
            n = next_n()
            if n <= 0:
                if buf:
                    yield emit(buf)
                return
            frame = self.read_frame(crop)
            if frame is None:
                break
            buf.append(frame)
            # >=: a limit that lands while buf is partially full may shrink n
            # below len(buf); the already-decoded frames still flush
            if len(buf) >= n:
                yield emit(buf)
                buf = []
        if buf:
            yield emit(buf)

    def release(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def encoder_lanes() -> int:
    """Encoder lanes of the cv2 FFV1 writer: one a usable core, less two,
    one for the thread that feeds them and one for the Prefetcher's decode
    (the file cells' pace once the encode is spread; 6 lanes on 8 cores
    were at least as fast as 7 on the card's host), at most 8 (the native
    writer's cap)."""
    return min(8, effective_cpu_count() - 2)


def lane_chunks(n: int, lanes: int, longest: int,
                shortest: int = 1) -> list[int]:
    """Sizes of the contiguous runs that a write of `n` frames is cut into.

    A run is n spread over `lanes`, but at least `shortest` frames and at
    most `longest`; the runs are as few as that allows, as even as they
    come, the longer first: 8 frames over 7 lanes are 4 runs of 2, or 2
    runs of 4 at 4 or more a run; 25 over 4 are 7, 6, 6, 6. The sizes
    depend on nothing else, so the same writes always give the same file."""
    if n <= 0:
        return []
    size = min(longest, max(shortest, -(-n // lanes)))
    c = -(-n // size)
    q, r = divmod(n, c)
    return [q + 1] * r + [q] * (c - r)


def _stage(timer, name: str):
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


@contextlib.contextmanager
def _shared_stage(timer, name: str, lock: threading.Lock):
    """``timer.stage(name)`` on threads that share the timer: the timer adds
    up at the stage's end under `lock`, so no thread's sum is lost."""
    if timer is None:
        yield
        return
    stage = timer.stage(name)
    stage.__enter__()
    try:
        yield
    except BaseException:
        with lock:
            if not stage.__exit__(*sys.exc_info()):
                raise
    else:
        with lock:
            stage.__exit__(None, None, None)


class _Lanes:
    """A pool of cv2 FFV1 encoder lanes writing one AVI.

    Each run of frames is encoded by a fresh ``cv2.VideoWriter`` on a lane
    thread (cv2 releases the interpreter lock while it encodes) into a
    temporary AVI in a directory beside the output, so every run starts on
    a keyframe. One joiner thread takes the runs in frame order, copies
    their packets into the output (``avi.AviJoiner``) and removes each
    temporary file as soon as its packets are in. At most 2 * lanes runs
    are queued or encoding; a write past that waits for the oldest.
    """

    def __init__(self, path: str, fourcc: int, fps: float,
                 size: tuple[int, int], lanes: int, timer=None):
        w, h = size
        self.lanes = lanes
        self.max_frames = max(1, min(KEY_INTERVAL,
                                     _LANE_RAW_BYTES // (w * h * 3)))
        self._args = (fourcc, fps, size)
        self._timer = timer
        self._joiner = avi.AviJoiner(path)
        out = Path(path)
        self._dir = Path(tempfile.mkdtemp(prefix=f".{out.name}.lanes-",
                                          dir=out.parent))
        self._pool = ThreadPoolExecutor(lanes, thread_name_prefix="ffv1-lane")
        self._slots = threading.Semaphore(2 * lanes)
        self._order: queue.Queue = queue.Queue()
        self._n = 0
        self._timer_lock = threading.Lock()
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._join_runs, daemon=True)
        self._thread.start()

    def _encode(self, frames: np.ndarray, gray: bool, path: Path) -> None:
        import cv2

        fourcc, fps, size = self._args
        with _shared_stage(self._timer, "encode_lane", self._timer_lock):
            out = cv2.VideoWriter(str(path), fourcc, fps, size, isColor=True)
            if not out.isOpened():
                raise IOError(f"cannot open an FFV1 lane writer for '{path}'")
            try:
                for f in frames:
                    out.write(cv2.cvtColor(np.ascontiguousarray(f),
                                           cv2.COLOR_GRAY2BGR)
                              if gray else np.ascontiguousarray(f))
            finally:
                out.release()

    def _join_runs(self) -> None:
        while True:
            item = self._order.get()
            if item is None:
                return
            fut, path, n = item
            try:
                if self.error is None:
                    fut.result()
                    with _shared_stage(self._timer, "encode_lane",
                                       self._timer_lock):
                        lane = avi.read_lane(path)
                        if len(lane.packets) != n:
                            raise IOError(
                                f"an FFV1 lane wrote {len(lane.packets)} of "
                                f"{n} frames to '{path}' (disk full or "
                                "encoder failure?)")
                        self._joiner.add(lane)
                    ENCODE_CHUNKS["lane"] += 1
                else:
                    fut.cancel()
            except BaseException as e:  # raised by the next write or release
                if self.error is None:
                    self.error = e
            finally:
                if not fut.cancelled():
                    fut.exception()  # the lane is done with its file
                path.unlink(missing_ok=True)
                self._slots.release()

    def write(self, frames: np.ndarray, gray: bool) -> None:
        """Queue `frames` as runs over the lanes (``lane_chunks``, at least
        ``MIN_RUN`` frames a run); returns once they are queued."""
        a = 0
        for size in lane_chunks(len(frames), self.lanes, self.max_frames,
                                MIN_RUN):
            self._slots.acquire()
            if self.error is not None:
                self._slots.release()
                raise self.error
            path = self._dir / f"{self._n:08d}.avi"
            self._n += 1
            self._order.put((self._pool.submit(self._encode, frames[a:a + size],
                                               gray, path), path, size))
            a += size
        if self.error is not None:
            raise self.error

    def close(self) -> None:
        """Wait for every run, finish the output and remove the temporary
        directory, on error too; raises the first lane error."""
        self._order.put(None)
        try:
            with _stage(self._timer, "encode"):
                self._thread.join()
                self._pool.shutdown()
            if self.error is not None:
                raise self.error
            self._joiner.finish()
        finally:
            self._joiner.close()
            shutil.rmtree(self._dir, ignore_errors=True)


class VideoWriter:
    """Lossless stego video writer (FFV1 in .avi by default).

    Native FFmpeg backend (frame-parallel encoder-lane pool, batched C
    calls) when available for FFV1, HuffYUV, and raw BGR (RGBA); cv2
    otherwise.

    On cv2, FFV1 is encoded by a pool of ``encoder_lanes()`` lanes (one a
    usable core of this process, less two, at most 8) when there are two
    or more: each write is cut into runs of at most 12 frames, spread over
    the lanes, at least ``MIN_RUN`` frames a run where the write has them
    (``lane_chunks``: a fresh writer's first frame costs more than the
    others), each run encoded by a fresh ``cv2.VideoWriter`` on its own
    thread into a temporary AVI in a directory beside the output
    (``.<name>.lanes-*``), and the runs' packets are joined in frame order
    into the one output AVI (``stegotpu_torch.avi``). Every frame decodes
    as the serial writer's would; only the keyframes differ (each run's
    first frame is one). The runs depend only on the writes and the lane
    count, so the same writes give the same file, however the lanes are
    scheduled. A temporary file is removed as soon as its
    packets are in the output, the directory at ``release()``, on error
    too. A write returns once its runs are queued, so the lanes read the
    frames after it returns: do not modify them until ``release()``. At
    most twice as many runs as lanes are in flight; a write past that
    waits. A lane's error is raised by the next write or by ``release()``.
    With one lane, for HFYU and RGBA, and on the native backend the writer
    is one encoder as before.

    timer: optional stage timer (``stage(name)``). The lanes time their
    encode and join under ``encode_lane`` (they overlap, so its total can
    pass the wall time); ``release()`` times its wait for the lanes under
    ``encode``, the stage the pipeline times its writes under.
    """

    _NATIVE_CODECS = {"FFV1": "ffv1", "HFYU": "huffyuv", "RGBA": "rawvideo"}

    def __init__(
        self,
        path: str | Path,
        fps: float,
        width: int,
        height: int,
        codec: str = "FFV1",
        backend: str = "auto",
        timer=None,
    ):
        self.path = force_avi_path(path)
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._native = None
        self._out = None
        self._lanes = None
        self._frames_written = 0
        if codec not in self._NATIVE_CODECS and backend == "native":
            # an EXPLICIT native request must not silently fall back (the
            # reader raises for the same request; the writer used to
            # short-circuit on the codec check before _use_native could)
            raise ValueError(
                f"native video backend does not support codec {codec!r}; "
                f"supported: {sorted(self._NATIVE_CODECS)}")
        if codec in self._NATIVE_CODECS and _use_native(backend):
            self._native = native_io.NativeVideoWriter(
                self.path, width, height, fps,
                codec=self._NATIVE_CODECS[codec],
            )
        else:
            import cv2

            fourcc = cv2.VideoWriter_fourcc(*codec)
            self._out = cv2.VideoWriter(
                self.path, fourcc, fps, (width, height), isColor=True
            )
            if not self._out.isOpened():
                raise IOError(f"cannot open {codec} VideoWriter for '{self.path}'")
            lanes = encoder_lanes()
            if codec == "FFV1" and lanes > 1:
                # the opened writer checked the settings; released with no
                # frame it leaves the empty AVI that a writer given no frame
                # leaves, which the lanes' output replaces
                self._out.release()
                self._out = None
                self._lanes = _Lanes(self.path, fourcc, fps, (width, height),
                                     lanes, timer)

    def write_bgr(self, frame: np.ndarray) -> None:
        if self._native is not None:
            self._native.write(frame)
        elif self._lanes is not None:
            self._lanes.write(frame[None], gray=False)
        else:
            self._out.write(frame)
            ENCODE_CHUNKS["serial"] += 1
        self._frames_written += 1

    def write_bgr_batch(self, frames: np.ndarray) -> None:
        if self._native is not None:
            self._native.write(frames)
        elif self._lanes is not None:
            self._lanes.write(frames, gray=False)
        else:
            for f in frames:
                self._out.write(np.ascontiguousarray(f))
            ENCODE_CHUNKS["serial"] += len(frames)
        self._frames_written += len(frames)

    def write_gray_batch(self, frames_gray: np.ndarray) -> None:
        """Write gray frames replicated to BGR (reference: embed_process.py:126).

        The native backend replicates inside the encoder lanes — the 3x BGR
        array is never built on the host; so do the cv2 lanes, a frame at
        a time."""
        if self._native is not None:
            self._native.write_gray(frames_gray)
        elif self._lanes is not None:
            self._lanes.write(frames_gray, gray=True)
        else:
            import cv2

            for f in frames_gray:
                self._out.write(
                    cv2.cvtColor(np.ascontiguousarray(f), cv2.COLOR_GRAY2BGR)
                )
            ENCODE_CHUNKS["serial"] += len(frames_gray)
        self._frames_written += len(frames_gray)

    def release(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None
        cv2_path = self._out is not None or self._lanes is not None
        if self._out is not None:
            self._out.release()
            self._out = None
        if self._lanes is not None:
            lanes, self._lanes = self._lanes, None
            lanes.close()
        if cv2_path:
            # cv2.VideoWriter.write returns no status: a disk-full or dead
            # encoder is invisible per-write (the native backend raises).
            # Fail-closed at close: the container must report the frame
            # count we wrote (skip when the container reports none).
            if self._frames_written:
                import cv2

                cap = cv2.VideoCapture(self.path)
                n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) if cap.isOpened() \
                    else -1
                cap.release()
                if n >= 0 and n != self._frames_written:
                    raise IOError(
                        f"cv2 writer emitted {n} of {self._frames_written} "
                        f"frames to '{self.path}' (disk full or encoder "
                        "failure?)")

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.release()
        except IOError:
            if exc and exc[0] is not None:
                return  # don't mask the exception already propagating
            raise


class GraySwitch:
    """Mutable flag shared between the embed loop and its batches()
    generator: .on=False stops the per-batch gray conversion once the
    payload is complete (the passthrough tail only needs BGR)."""

    __slots__ = ("on",)

    def __init__(self) -> None:
        self.on = True


class FrameBudget:
    """Mutable total-frame cap shared between a consumer and its batches()
    generator: .limit=N stops decoding after N frames total (None =
    unbounded). The extract pipeline sets it to the exact header-derived
    payload frame count so no frame past the payload is ever decoded."""

    __slots__ = ("limit",)

    def __init__(self, limit: int | None = None) -> None:
        self.limit = limit


def effective_cpu_count() -> int:
    """CPUs this PROCESS may use — cgroup/affinity aware.

    os.cpu_count() reports host cores; a container pinned to 1 CPU on a
    16-core host would still spawn overlap threads that only add scheduler
    thrash. sched_getaffinity reflects the real quota where available."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # non-Linux
        return os.cpu_count() or 1


class _PassthroughPrefetcher:
    """Prefetcher-shaped wrapper that iterates inline (no worker thread).

    Used on single-core hosts where decode/compute overlap is physically
    impossible and a background thread only adds scheduler + cache thrash
    (measured: ~14% e2e loss at 1080p, benchmarks/e2e_product.py).
    """

    def __init__(self, iterator: Iterator):
        self._it = iter(iterator)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def close(self) -> None:
        self._it = iter(())

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Prefetcher:
    """Background-thread iterator: overlaps host decode with device compute.

    Keeps up to `depth` batches in flight (double buffering at depth=2).
    cv2 releases the GIL inside decode, so the worker genuinely overlaps.

    MUST be close()d (or iterated to exhaustion) before the underlying
    video source is released: the worker thread holds a live reference into
    the decoder, and releasing the capture under it is a use-after-free.
    Use as a context manager to guarantee this.

    Use `Prefetcher.maybe(...)` in pipelines: it returns an inline
    passthrough on single-core hosts, where the thread can't overlap
    anything and measurably slows the codec down.
    """

    @staticmethod
    def maybe(iterator: Iterator, depth: int = 2):
        """Prefetcher when overlap can help, inline passthrough when not."""
        if effective_cpu_count() <= 1:
            return _PassthroughPrefetcher(iterator)
        return Prefetcher(iterator, depth)

    _DONE = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()

        def _put_or_stop(item) -> bool:
            """Blocking put that aborts when close() raises the stop flag.
            Returns False if stopped."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in iterator:
                    if not _put_or_stop(item):
                        return
            except BaseException as e:  # propagate decode errors to consumer
                self._err = e
            finally:
                # the DONE sentinel must not be dropped: a consumer blocked in
                # get() would hang forever (close() drains, so this terminates)
                _put_or_stop(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        if getattr(self, "_exhausted", False):
            # iterator protocol: once exhausted, KEEP raising StopIteration
            # (a second get() on the drained queue would block forever)
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._exhausted = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker and wait for it; safe to call at any point."""
        self._stop.set()
        while True:  # drain so a blocked put can observe the stop flag
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():  # pragma: no cover - defensive
            # The worker is stuck inside a decoder call; releasing the video
            # source under it would be a use-after-free, so surface loudly.
            raise RuntimeError("Prefetcher worker did not stop within 10s")

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

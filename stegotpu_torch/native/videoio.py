"""ctypes bindings for the native FFmpeg video I/O library.

A copy of ``stegotpu/native/videoio.py``. The C++ source is the JAX
package's ``stegotpu/native/videoio.cpp``, read where it lies (never copied
or edited); the library is built on demand (g++ + FFmpeg dev headers) into
the port's git-ignored ``stegotpu_torch/_build/``. Exposes NativeVideoReader
/ NativeVideoWriter mirroring the cv2-backed classes in
stegotpu_torch.video. `available()` reports whether the native path can be
used; callers fall back to cv2 when it can't. A failed build is reported
by `build_error()` as one line, the compiler's first error.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "stegotpu" / "native" / "videoio.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_SO = _BUILD / "libstegovideo.so"
# same flags and libraries as stegotpu/native/Makefile
_CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared"]
_LDLIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]
_lib = None
_build_error: str | None = None


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    def _stale() -> bool:
        return (not _SO.exists()
                or _SO.stat().st_mtime < _SRC.stat().st_mtime)

    try:
        if _stale():
            # cross-process build lock: concurrent first uses must not
            # compile twice; the build writes via an atomic rename so a
            # reader never dlopens a half-written .so
            import fcntl
            import os

            _BUILD.mkdir(exist_ok=True)
            with open(_BUILD / ".videoio.lock", "w") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                if _stale():
                    tmp = _SO.with_name(f"{_SO.name}.tmp.{os.getpid()}")
                    proc = subprocess.run(
                        ["g++", *_CXXFLAGS, "-o", str(tmp), str(_SRC),
                         *_LDLIBS],
                        capture_output=True, text=True,
                    )
                    if proc.returncode != 0:
                        _build_error = _compiler_error(proc.stderr)
                        return None
                    os.replace(tmp, _SO)
        lib = ctypes.CDLL(str(_SO))
        lib.svx_last_error.restype = ctypes.c_char_p
        lib.svx_reader_open.restype = ctypes.c_void_p
        lib.svx_reader_open.argtypes = [ctypes.c_char_p]
        lib.svx_reader_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.svx_reader_read_batch.restype = ctypes.c_int
        lib.svx_reader_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.svx_reader_close.argtypes = [ctypes.c_void_p]
        lib.svx_reader_seek.restype = ctypes.c_int
        lib.svx_reader_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.svx_writer_open.restype = ctypes.c_void_p
        lib.svx_writer_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_char_p,
        ]
        lib.svx_writer_write.restype = ctypes.c_int
        lib.svx_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.svx_writer_write_gray.restype = ctypes.c_int
        lib.svx_writer_write_gray.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.svx_writer_close.restype = ctypes.c_int
        lib.svx_writer_close.argtypes = [ctypes.c_void_p]
        lib.svx_concat.restype = ctypes.c_int
        lib.svx_concat.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
        ]
        _lib = lib
    except Exception as e:  # pragma: no cover - environment dependent
        _build_error = str(e)
    return _lib


def _compiler_error(stderr: str) -> str:
    """One line for the messages that quote a failed build (`--procs`,
    `dist-embed`, `concat` exit with one line): the compiler's first error
    line, else its last line."""
    lines = [ln.strip() for ln in stderr.splitlines() if ln.strip()]
    for ln in lines:
        if "error" in ln:
            return ln
    return lines[-1] if lines else "g++ failed without output"


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


class NativeVideoReader:
    """FFmpeg-native batched BGR24 reader (threaded decode)."""

    def __init__(self, path: str | Path):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native video lib unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.svx_reader_open(str(path).encode())
        if not self._h:
            raise IOError(lib.svx_last_error().decode())
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        n = ctypes.c_int64()
        lib.svx_reader_info(self._h, ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(fps), ctypes.byref(n))
        self.width, self.height = w.value, h.value
        self.fps, self.frame_count = fps.value, int(n.value)

    def _read(self, batch: int, crop_h: int, crop_w: int, want_bgr: bool,
              want_gray: bool):
        if not (0 < crop_h <= self.height and 0 < crop_w <= self.width):
            raise ValueError(
                f"crop ({crop_h}, {crop_w}) exceeds decoded frame "
                f"({self.height}, {self.width})"
            )
        bgr = np.empty((batch, crop_h, crop_w, 3), np.uint8) if want_bgr else None
        gray = np.empty((batch, crop_h, crop_w), np.uint8) if want_gray else None
        got = self._lib.svx_reader_read_batch(
            self._h,
            bgr.ctypes.data_as(ctypes.c_void_p) if want_bgr else None,
            gray.ctypes.data_as(ctypes.c_void_p) if want_gray else None,
            batch, crop_h, crop_w,
        )
        if got < 0:
            raise IOError(self._lib.svx_last_error().decode())
        if got == 0:
            return None
        return (bgr[:got] if want_bgr else None,
                gray[:got] if want_gray else None)

    def seek(self, frame_index: int) -> None:
        """Position so the next read delivers `frame_index` (0-based),
        EXACTLY: keyframe seek + decode-forward discard in C (intra-only
        stego containers land directly; inter-coded covers decode only the
        keyframe->target stretch). Seeking past EOF parks at EOF."""
        if self._lib.svx_reader_seek(self._h, int(frame_index)) < 0:
            raise IOError(self._lib.svx_last_error().decode())

    def read_batch(self, batch: int, crop_h: int, crop_w: int) -> np.ndarray | None:
        """Returns (n, crop_h, crop_w, 3) uint8 BGR, or None at EOF."""
        r = self._read(batch, crop_h, crop_w, True, False)
        return None if r is None else r[0]

    def read_batch_gray(self, batch: int, crop_h: int, crop_w: int) -> np.ndarray | None:
        """Returns (n, crop_h, crop_w) uint8 cv2-bit-exact gray, or None at
        EOF. The BGR intermediate never crosses the ctypes boundary."""
        r = self._read(batch, crop_h, crop_w, False, True)
        return None if r is None else r[1]

    def read_batch_both(
        self, batch: int, crop_h: int, crop_w: int
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Returns (bgr, gray) for the same frames, or None at EOF (the embed
        pipeline needs gray for the kernel and BGR for color passthrough)."""
        return self._read(batch, crop_h, crop_w, True, True)

    def close(self) -> None:
        if self._h:
            self._lib.svx_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeVideoWriter:
    """FFmpeg-native FFV1-in-.avi lossless writer.

    Frame-parallel: `workers` identical FFV1 encoder lanes encode a batch's
    frames concurrently (every frame is an independent keyframe at
    gop_size=1) and the packets mux in pts order. workers=0 auto-sizes to
    the host's cores (capped at 8); workers=1 falls back to one
    slice-threaded encoder.
    """

    def __init__(self, path: str | Path, width: int, height: int, fps: float,
                 workers: int = 0, codec: str = "ffv1"):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native video lib unavailable: {_build_error}")
        self._lib = lib
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._h = lib.svx_writer_open(str(path).encode(), width, height,
                                      float(fps), int(workers),
                                      codec.encode())
        if not self._h:
            raise IOError(lib.svx_last_error().decode())
        self.width, self.height = width, height

    def write(self, frames_bgr: np.ndarray) -> None:
        """frames_bgr: (n, H, W, 3) or (H, W, 3) uint8."""
        if frames_bgr.ndim == 3:
            frames_bgr = frames_bgr[None]
        # the C layer reads height*width*3 bytes per frame unconditionally; a
        # smaller array would be an out-of-bounds read
        if frames_bgr.shape[1:] != (self.height, self.width, 3):
            raise ValueError(
                f"frame shape {frames_bgr.shape[1:]} != configured "
                f"({self.height}, {self.width}, 3)"
            )
        if frames_bgr.dtype != np.uint8:
            # an unsafe cast here (float -1.0 -> 255, 256 -> 0) would write
            # silently corrupt stego; surface the caller's dtype bug instead
            raise ValueError(f"frames must be uint8, got {frames_bgr.dtype}")
        frames_bgr = np.ascontiguousarray(frames_bgr)
        rc = self._lib.svx_writer_write(
            self._h, frames_bgr.ctypes.data_as(ctypes.c_void_p),
            frames_bgr.shape[0],
        )
        if rc != 0:
            raise IOError(self._lib.svx_last_error().decode())

    def write_gray(self, frames_gray: np.ndarray) -> None:
        """frames_gray: (n, H, W) or (H, W) uint8 — replicated to BGR
        (GRAY2BGR) inside the native encoder lanes."""
        if frames_gray.ndim == 2:
            frames_gray = frames_gray[None]
        if frames_gray.shape[1:] != (self.height, self.width):
            raise ValueError(
                f"frame shape {frames_gray.shape[1:]} != configured "
                f"({self.height}, {self.width})"
            )
        if frames_gray.dtype != np.uint8:
            raise ValueError(f"frames must be uint8, got {frames_gray.dtype}")
        frames_gray = np.ascontiguousarray(frames_gray)
        rc = self._lib.svx_writer_write_gray(
            self._h, frames_gray.ctypes.data_as(ctypes.c_void_p),
            frames_gray.shape[0],
        )
        if rc != 0:
            raise IOError(self._lib.svx_last_error().decode())

    def close(self) -> None:
        if self._h:
            rc = self._lib.svx_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("native writer close failed: "
                              + self._lib.svx_last_error().decode())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.close()
        except IOError:
            # after a failed write() the close reports the truncation too;
            # re-raising here would MASK the original write exception that
            # is already propagating. Only surface close errors on the
            # clean-exit path.
            if exc and exc[0] is not None:
                return
            raise


def concat_videos(out_path: str | Path, inputs: list[str | Path]) -> None:
    """Packet-level stream-copy concat of same-codec segments (no decode or
    re-encode). The multi-host embed path's stitch step: each host writes
    its frame-range segment; one remux produces the final container."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native video lib unavailable: {_build_error}")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    enc = [str(p).encode() for p in inputs]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    rc = lib.svx_concat(str(out_path).encode(), arr, len(enc))
    if rc != 0:
        raise IOError(lib.svx_last_error().decode())

"""Build and bind the CUDA stripe kernels (csrc/qim_stripe.cu).

``nvcc`` compiles the source into a shared library with a plain C
interface, loaded with ctypes: no PyTorch headers, so the build takes
seconds. It happens at first use, under a file lock, into the git-ignored
``stegotpu_torch/_build/``, and again whenever the ``.cu`` is newer than
the library. Nothing is built or imported when this module is imported.

No ``--use_fast_math``: it makes ``y / delta`` an approximate divide and
flushes denormals, which moves ``round(y / delta)`` at the rounding
boundary of the f32 wire contract.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "qim_stripe.cu"
_BUILD = _PKG / "_build"
_LIB = _BUILD / "libqim_stripe.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA stripe "
                           "kernels are built from source at first use")
    return found


def _stale() -> bool:
    return not _LIB.exists() or _LIB.stat().st_mtime < SOURCE.stat().st_mtime


def build() -> str:
    """Compile the library if it is missing or older than its source.
    Returns the compiler's output (ptxas register/spill report), or '' when
    the library was already up to date."""
    if not _stale():
        return ""
    import fcntl

    _BUILD.mkdir(exist_ok=True)
    with open(_BUILD / ".qim_stripe.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():  # another process built it while we waited
            return ""
        tmp = _LIB.with_name(f"{_LIB.name}.tmp.{os.getpid()}")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {SOURCE.name}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, _LIB)  # atomic: no reader dlopens a partial file
        return proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_LIB))
        p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
            ctypes.c_float
        lib.stegotpu_qim_embed.argtypes = [p, p, p, p, i, i, i, i, i, i64,
                                           i64, f, p]
        lib.stegotpu_qim_embed.restype = i
        lib.stegotpu_qim_extract_packed.argtypes = [p, p, p, i, i, i, i, i,
                                                    i, i, f, p]
        lib.stegotpu_qim_extract_packed.restype = i
        lib.stegotpu_qim_extract_rows.argtypes = [p, p, p, i, i, i, i, i,
                                                  i, i, f, p]
        lib.stegotpu_qim_extract_rows.restype = i
        lib.stegotpu_qim_roundtrip_packed.argtypes = [p, p, p, p, p, i, i, i,
                                                      i, i, i64, i, i, f, p]
        lib.stegotpu_qim_roundtrip_packed.restype = i
        lib.stegotpu_qim_embed_check.argtypes = [p, p, p, p, p, i, i, i, i,
                                                 i, i64, f, p]
        lib.stegotpu_qim_embed_check.restype = i
        lib.stegotpu_cuda_error_string.argtypes = [i]
        lib.stegotpu_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.stegotpu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

"""Build and bind the CUDA kernels (every ``csrc/*.cu``, into one library).

``nvcc`` compiles each source into an object, all of them at once, and
links the objects into one shared library with a plain C interface, loaded
with ctypes: no PyTorch headers, so the build takes seconds. It happens at
first use, under a file lock, into the git-ignored
``stegotpu_torch/_build/``. Beside the library lies a stamp: a hash of
every source's name and bytes and of ``NVCC_FLAGS``. The library is rebuilt
whenever the stamp is missing or differs, so an edit to any source or to
the flags is never answered by a stale library. Nothing is built or
imported when this module is imported.

No ``--use_fast_math``: it makes ``y / delta`` an approximate divide and
flushes denormals, which moves ``round(y / delta)`` at the rounding
boundary of the f32 wire contract.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libstegotpu_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def sources() -> list[Path]:
    """The kernel sources compiled into the library, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def digest() -> str:
    """Hash of every source and header under csrc/ (name and bytes) and of
    NVCC_FLAGS: the library's stamp."""
    h = hashlib.sha256()
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def library_path() -> Path:
    return BUILD_DIR / LIB_NAME


def _stamp_path() -> Path:
    return BUILD_DIR / (LIB_NAME + ".stamp")


def stale() -> bool:
    """True when the library is missing or was built from other sources or
    flags than the current ones."""
    stamp = _stamp_path()
    return (not library_path().exists() or not stamp.exists()
            or stamp.read_text().strip() != digest())


def _compile(srcs: list[Path], out: Path, defines: tuple[str, ...] = (),
             includes: tuple[Path, ...] = ()) -> str:
    """nvcc every source into an object in parallel, then link them into
    the shared library `out`; `defines` adds -D flags and `includes` -I
    directories (the builds of studies/stripe_cap.py). Returns the
    compilers' output."""
    nvcc = _nvcc()
    objs = [out.with_name(f"{out.name}.{src.stem}.o") for src in srcs]
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines),
             *(f"-I{d}" for d in includes)]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(src.name, log) for src, p, log in zip(srcs, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(
            f"{name}:\n{log[-4000:]}" for name, log in failed))
    link = subprocess.run([nvcc, *flags, "-shared", "-o", str(out),
                           *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr[-4000:]}")
    return "".join(logs) + link.stdout + link.stderr


def build() -> str:
    """Compile the library if it is stale. Returns the compilers' output
    (ptxas register/spill report), or '' when the library was up to date."""
    if not stale():
        return ""
    import fcntl

    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / ".kernels.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not stale():  # another process built it while we waited
            return ""
        want = digest()
        lib = library_path()
        tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
        log = _compile(sources(), tmp)
        os.replace(tmp, lib)  # atomic: no reader dlopens a partial file
        _stamp_path().write_text(want + "\n")
        return log


_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# argtypes of every C entry point; each returns an int (a cudaError_t)
ARGTYPES = {
    "stegotpu_qim_embed": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i64, _i64, _f,
                           _p],
    "stegotpu_qim_extract_packed": [_p, _p, _i, _i, _i, _i, _i, _i, _i, _f, _p],
    "stegotpu_qim_extract_rows": [_p, _p, _i, _i, _i, _i, _i, _i, _i, _f, _p],
    "stegotpu_qim_roundtrip_packed": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                                      _i64, _i, _i, _f, _p],
    "stegotpu_qim_roundtrip_rows": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                                    _i64, _i, _i, _f, _p],
    "stegotpu_qim_embed_check": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i64,
                                 _f, _p],
    "stegotpu_qim_embed_repair": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                                  _i64, _f, _i, _p],
    "stegotpu_kron_embed": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i64, _i64,
                            _f, _p],
    "stegotpu_kron_extract": [_p, _p, _p, _i, _i, _i, _i, _i, _f, _p],
    "stegotpu_kron_embed_smem": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i64, _i64,
                                 _f, _p],
    "stegotpu_kron_extract_smem": [_p, _p, _p, _i, _i, _i, _i, _i, _f, _p],
    "stegotpu_qim_ablation": [_p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f,
                              _p],
    "stegotpu_qim_embed_packedin": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i64,
                                    _i, _i, _f, _p],
    "stegotpu_qim_roundtrip_dual": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                                    _i64, _i, _i, _f, _p],
    "stegotpu_copy": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p],
    "stegotpu_qim_roundtrip_pipe": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                                    _i, _i64, _i, _i, _f, _p],
    "stegotpu_qim_eval": [_p, _p, _i64, _p, _p, _i64, _i64, _p, _p, _p, _i, _p],
    "stegotpu_qim_unpack_packed": [_p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p],
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the entry points that `lib`
    exports (a variant build may hold only some of them)."""
    for name, types in ARGTYPES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = types, _i
    lib.stegotpu_cuda_error_string.argtypes = [_i]
    lib.stegotpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        _lib = bind(ctypes.CDLL(str(library_path())))
    return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.stegotpu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

"""The register caps of K4's family, and other builds of their sources,
timed on the card against the library.

At num_ac <= 15 the library builds K1 (``qim_embed_kernel`` in
``csrc/qim_stripe.cu``), K3 (``qim_embed_check_kernel``), K4
(``qim_roundtrip_packed_kernel``), K6 (``qim_roundtrip_rows_kernel``) and
K11 (``qim_roundtrip_dual_kernel`` in ``csrc/qim_study.cu``) with
``__launch_bounds__`` asking ptxas to fit ``STEGOTPU_K1_MINB``,
``STEGOTPU_K3_MINB``, ``STEGOTPU_K4_MINB``, ``STEGOTPU_K6_MINB`` and
``STEGOTPU_K11_MINB`` CTAs an SM, and K13 (``qim_roundtrip_pipe_kernel`` in
``csrc/qim_pipe.cu``, one key per ring depth) with
``STEGOTPU_K13_BUF{2,3,4}_MINB`` (1: no cap; a capped build also
re-derives each pixel instead of keeping the block live). K5
(``qim_extract_rows_kernel``) has no cap, as K2 has none: it is timed and
held byte for byte, and no ``--minb`` entry names it. This study builds
one library per entry of ``--minb`` (``k3:9`` is nvcc
``-DSTEGOTPU_K3_MINB=9``; ``k11:1`` is K11 without its cap) and one per
entry of ``--src`` (``name=DIR``, or ``name=DIR:NAME=VALUE...`` with -D
flags: each source that DIR holds in place of csrc/'s, its headers found
beside it or else in csrc/: sources with the same C interface, such as
one step of a redesign), each under
``_build/stripe_cap/``, all nvcc at once, and reads each build's
registers and spill bytes from ptxas. The kernels it holds and times are
K4 (the yardstick) and those the builds vary: the kernels whose cap
``--minb`` names and those whose source a ``--src`` DIR holds; every
kernel when there are no such builds. It reads one call of each from the
library's device timeline (``torch.profiler``: the kernel's time and the
other device ops of a call, the wrapper's glue). Then, for the library
and every build in turn, forward and backward over ``--rounds`` rounds, it
holds each kernel's outputs to the library's byte for byte (at delta 20
and 2^-11) and times each kernel (ms per call, and its share of the
bound), queued behind a sleep kernel over 1920x1080 B=8 input sets that
together exceed the L2 (the inputs of chip_smoke.py phase 4; ``--batch
128`` is one set of 580 MB). One JSON row per build and round; the first
row names the card.

    python -m stegotpu_torch.studies.stripe_cap [--minb k1:1,k13_2:7]
        [--src step1=DIR,step2=DIR:NAME=VALUE] [--num-ac 10]
        [--batch 8]
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import functools
import re
import sys
import tempfile
from pathlib import Path

import torch

from stegotpu_torch.ops import _build
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.studies import (bounds, dualchain_r5, emitpipe_r4, harness,
                                    sass)

# the sets rotate over at least this many bytes, five times the 50 MB L2
COLD_BYTES = 256 << 20


def _extract_rows(frames, payload, total_bits, delta, num_ac):
    """K5 called as the embedding kernels are: (rows,) of the frames."""
    return (sk.extract_frames_rows(frames, delta, num_ac),)


def _pipe(bufs: int):
    """K13 at ring depth `bufs`, called as the embedding kernels are."""
    return functools.partial(emitpipe_r4.roundtrip_pipelined_packed, bufs=bufs)


# kernel key -> (its name on chip_smoke.py's kernels line, its template
# name, its wrapper (frames, payload, total_bits, delta, num_ac) -> a tuple
# of tensors, the -D of its register cap or None)
KERNELS = {
    "k1": ("embed", "qim_embed_kernel", sk.embed_frames, "STEGOTPU_K1_MINB"),
    "k3": ("embed_check", "qim_embed_check_kernel", sk.embed_and_check_frames,
           "STEGOTPU_K3_MINB"),
    "k4": ("roundtrip_packed", "qim_roundtrip_packed_kernel",
           sk.embed_and_extract_frames_packed, "STEGOTPU_K4_MINB"),
    "k5": ("extract_rows", "qim_extract_rows_kernel", _extract_rows, None),
    "k6": ("roundtrip_rows", "qim_roundtrip_rows_kernel",
           sk.embed_and_extract_frames_rows, "STEGOTPU_K6_MINB"),
    "k11": ("roundtrip_dual", "qim_roundtrip_dual_kernel",
            dualchain_r5.dual_roundtrip_packed, "STEGOTPU_K11_MINB"),
    **{f"k13_{n}": (f"roundtrip_pipe_buf{n}", "qim_roundtrip_pipe_kernel",
                    _pipe(n), f"STEGOTPU_K13_BUF{n}_MINB")
       for n in emitpipe_r4.BUFS},
}
# the source of each kernel key, under csrc/
SOURCES = {k: "qim_study.cu" if k == "k11" else
           "qim_pipe.cu" if k.startswith("k13") else "qim_stripe.cu"
           for k in KERNELS}
# the kernels with a register cap: the keys that --minb takes
CAPPED = tuple(k for k, v in KERNELS.items() if v[3])


def variants_of(minb: str, src: str = "") -> list[tuple[str, dict | None]]:
    """The library's own build (None: nothing to build), then one build per
    entry of `minb` ('k1:1,k3:8': a kernel's CTAs per SM) and of `src`
    ('name=DIR' or 'name=DIR:NAME=VALUE:...'): (name, {"defines": {...}}
    or {"src": DIR} with the entry's "defines" if it has any)."""
    out: list[tuple[str, dict | None]] = [("library", None)]
    for spec in filter(None, minb.split(",")):
        k, _, n = spec.partition(":")
        if k not in CAPPED or not n.isdigit() or int(n) < 1:
            raise ValueError(f"--minb {spec!r}: want {', '.join(CAPPED)}, a "
                             "colon and the CTAs per SM, an integer >= 1")
        out.append((f"{k}_minb_{int(n)}",
                    {"defines": {KERNELS[k][3]: int(n)}}))
    for spec in filter(None, src.split(",")):
        name, _, rest = spec.partition("=")
        path, *defs = rest.split(":")
        pairs = [d.partition("=") for d in defs]
        if not name or not path or name == "library" or any(
                not k or not eq or not v for k, eq, v in pairs):
            raise ValueError(f"--src {spec!r}: want name=DIR or "
                             "name=DIR:NAME=VALUE:...")
        how: dict = {"src": path}
        if pairs:
            how["defines"] = {k: int(v) if v.isdigit() else v
                              for k, _, v in pairs}
        out.append((name, how))
    return out


def keys_of(variants: list[tuple[str, dict | None]]) -> list[str]:
    """The kernels to hold and time: K4 (the yardstick), then those whose
    cap a build sets and those whose source a build's DIR holds; every
    kernel when the library is the only build."""
    varied = set()
    for _, how in variants:
        if how is None:
            continue
        defines = how.get("defines", {})
        varied.update(k for k, v in KERNELS.items() if v[3] in defines)
        if "src" in how:
            varied.update(k for k in KERNELS
                          if (Path(how["src"]) / SOURCES[k]).is_file())
    if all(how is None for _, how in variants):
        varied = set(KERNELS)
    return ["k4", *(k for k in KERNELS if k in varied and k != "k4")]


def build_variants(variants: list[tuple[str, dict | None]],
                   keys=tuple(KERNELS)) -> dict[str, tuple[ctypes.CDLL, dict]]:
    """Each variant's bound library and ptxas report (registers, spills by
    kernel label); a variant compiles qim_stripe.cu (K4, the yardstick)
    and the sources of the kernels `keys`, each from the variant's DIR
    where it holds one, else from csrc/."""
    files = sorted({"qim_stripe.cu", *(SOURCES[k] for k in keys)})
    root = _build.BUILD_DIR / "stripe_cap"

    def one(name: str, how: dict | None):
        if how is None:
            log = _build.build()  # '' when it was built already
            return name, _build.load_library(), log
        out = root / name / _build.LIB_NAME
        out.parent.mkdir(parents=True, exist_ok=True)
        src = Path(how.get("src", _build.CSRC))
        log = _build._compile(
            [src / f if (src / f).is_file() else _build.CSRC / f
             for f in files], out,
            tuple(f"{k}={v}" for k, v in how.get("defines", {}).items()),
            includes=(_build.CSRC,))
        return name, _build.bind(ctypes.CDLL(str(out))), log

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        done = list(pool.map(lambda v: one(*v), variants))
    return {name: (lib, sass.ptxas(log)) for name, lib, log in done}


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """The stripe wrappers launch from `lib` inside the block."""
    saved = _build._lib
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def cold_sets(dev: torch.device, b: int, h: int, w: int, n: int) -> list:
    """(frames, payload, total) sets at n slots a block: mid-range
    (16..239) covers and a payload ending in the last block, made on the
    card from the studies' seed, enough of them to hold COLD_BYTES."""
    gen = torch.Generator(device=dev).manual_seed(harness.SEED)
    cap = (h // 8) * (w // 8) * n
    n = -(-COLD_BYTES // (b * h * w + b * cap))
    return [(torch.randint(16, 240, (b, h, w), generator=gen, device=dev,
                           dtype=torch.uint8),
             torch.randint(0, 2, (b, cap), generator=gen, device=dev,
                           dtype=torch.uint8), b * cap - 13)
            for _ in range(n)]


def timeline(fn, iters: int = 8) -> dict:
    """One call of fn read from the device timeline: the kernel's time and
    period, and the other device ops of a call (studies/device_roofline)."""
    from stegotpu_torch.studies import device_roofline as dr

    with tempfile.TemporaryDirectory() as tmp:
        summ = dr.parse_device_timeline(
            dr._trace(fn, iters, Path(tmp) / "trace.json"), iters)
    return {k: summ.get(k) for k in ("kernel_name", "kernel_ms_each",
                                     "kernel_count", "iter_period_ms",
                                     "glue_top", "glue_per_iter")}


def main(argv=None) -> int:
    ap = harness.parser("Build K4's family with other register caps or "
                        "from other sources and time each build against "
                        "the library's.", 8)
    ap.add_argument("--minb", default="",
                    help="extra builds, comma-separated kernel:CTAs per SM "
                         f"({', '.join(CAPPED)}; 1 is the build without a "
                         "cap)")
    ap.add_argument("--src", default="",
                    help="extra builds, comma-separated name=DIR or "
                         "name=DIR:NAME=VALUE:... (-D flags): the sources "
                         "DIR holds (qim_stripe.cu, qim_study.cu for K11, "
                         "qim_pipe.cu for K13) with the same C interface, "
                         "csrc/'s for the others")
    ap.add_argument("--num-ac", type=int, default=harness.NUM_AC,
                    help="slots a block (default the scripts' 10; above 15 "
                         "no kernel has a cap)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="passes over the builds, forward then backward")
    ap.set_defaults(iters=20)
    args = ap.parse_args(argv)
    dev = harness.require_cuda("stripe_cap")
    if dev is None:
        return 2
    variants = variants_of(args.minb, args.src)
    keys = keys_of(variants)
    harness.header("stripe_cap", dev, args)
    b, h, w, n = args.batch, args.height, args.width, args.num_ac
    built = build_variants(variants, keys)
    for name, (_, regs) in built.items():
        harness.emit({"variant": name, "build": dict(variants)[name],
                      "ptxas": {k: list(v) for k, v in sorted(regs.items())
                                if any(re.match(rf"{KERNELS[x][1]}<{n // 8 + 1}[,>]", k)
                                       for x in keys)}})

    sets = cold_sets(dev, b, h, w, n)
    f0, p0, t0 = sets[0]
    deltas = (harness.DELTA, 2.0**-11)
    with using(built["library"][0]):
        want = {(k, d): KERNELS[k][2](f0, p0, t0, d, n)
                for k in keys for d in deltas}
        harness.emit({"variant": "library", "timeline": {
            k: timeline(lambda k=k: KERNELS[k][2](f0, p0, t0, harness.DELTA,
                                                  n))
            for k in keys}})
    bound = {k: bounds.bound_ms(*bounds.work(KERNELS[k][0], b, h, w, n,
                                             sk.pick_stripe(h)))[0]
             for k in keys}
    names = [name for name, _ in variants]
    ok = True
    for rnd in range(args.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            row = {"variant": name, "round": rnd, "batch": b}
            with using(built[name][0]):
                for k in keys:
                    fn = KERNELS[k][2]
                    same = all(torch.equal(a, c) for d in deltas for a, c in
                               zip(fn(f0, p0, t0, d, n), want[k, d]))
                    behind = harness.BEHIND
                    ms = harness.queued_ms(
                        [lambda s=s, fn=fn: fn(*s, harness.DELTA, n)
                         for s in sets], runs=args.iters)
                    ok = ok and same
                    # a reading kept although the host fell behind holds
                    # host gaps
                    row.update({f"{k}_identical_to_library": same,
                                f"{k}_ms": ms, f"{k}_share": bound[k] / ms,
                                f"{k}_host_behind": harness.BEHIND > behind})
            harness.emit(row)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

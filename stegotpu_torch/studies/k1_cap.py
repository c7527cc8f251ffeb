"""K1's register cap, built both ways and timed on the card.

At num_ac <= 15, K1 (``qim_embed_kernel`` in ``csrc/qim_stripe.cu``)
launches a build that asks ptxas, through ``__launch_bounds__``, to fit
``STEGOTPU_K1_MINB`` CTAs an SM (8 in the library; a capped build also
re-derives each pixel instead of keeping the block live). This study
rebuilds ``qim_stripe.cu`` once per value of ``--minb`` (nvcc
``-DSTEGOTPU_K1_MINB=n``; 1 is the build without the cap) into a library
of its own under ``_build/k1_cap/``, all nvcc at once, and reads each
build's K1 registers and spill bytes from ptxas. Then, for the library and
every build in turn, forward and backward over ``--rounds`` rounds, it
holds K1's stego and bits per frame to the library's byte for byte (at
delta 20 and 2^-11) and times K1 (``k1_ms``, ms per call, and its share of
the bound), queued behind a sleep kernel over 1920x1080 B=8 input sets
that together exceed the L2 (the inputs of chip_smoke.py phase 4). One
JSON row per build and round; the first row names the card.

    python -m stegotpu_torch.studies.k1_cap [--minb 1,9] [--num-ac 10]
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import sys

import torch

from stegotpu_torch.ops import _build
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.studies import bounds, harness, sass

# the sets rotate over at least this many bytes, five times the 50 MB L2
COLD_BYTES = 256 << 20


def variants_of(minb: str) -> list[tuple[str, dict | None]]:
    """The library's own build (None: nothing to build), then one build per
    entry of `minb` ('1,9': K1's CTAs per SM): (name, -D values)."""
    out: list[tuple[str, dict | None]] = [("library", None)]
    for spec in filter(None, minb.split(",")):
        if not spec.isdigit() or int(spec) < 1:
            raise ValueError(f"--minb {spec!r}: CTAs per SM must be an integer >= 1")
        out.append((f"minb_{int(spec)}", {"STEGOTPU_K1_MINB": int(spec)}))
    return out


def build_variants(variants: list[tuple[str, dict | None]]
                   ) -> dict[str, tuple[ctypes.CDLL, dict]]:
    """Each variant's bound library and ptxas report (registers, spills by
    kernel label)."""
    root = _build.BUILD_DIR / "k1_cap"
    src = _build.CSRC / "qim_stripe.cu"

    def one(name: str, defines: dict | None):
        if defines is None:
            log = _build.build()  # '' when it was built already
            return name, _build.load_library(), log
        out = root / name / _build.LIB_NAME
        out.parent.mkdir(parents=True, exist_ok=True)
        log = _build._compile([src], out, tuple(f"{k}={v}"
                                                for k, v in defines.items()))
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


def main(argv=None) -> int:
    ap = harness.parser("Build K1 with other register caps and time each "
                        "build against the library's.", 8)
    ap.add_argument("--minb", default="1",
                    help="K1's CTAs per SM of each extra build, comma-"
                         "separated; 1 is the build without the cap")
    ap.add_argument("--num-ac", type=int, default=harness.NUM_AC,
                    help="slots a block (default the scripts' 10; above 15 "
                         "K1 has no cap and every build is the same)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="passes over the builds, forward then backward")
    ap.set_defaults(iters=20)
    args = ap.parse_args(argv)
    dev = harness.require_cuda("k1_cap")
    if dev is None:
        return 2
    variants = variants_of(args.minb)
    harness.header("k1_cap", dev, args)
    b, h, w, n = args.batch, args.height, args.width, args.num_ac
    built = build_variants(variants)
    for name, (_, regs) in built.items():
        harness.emit({"variant": name, "defines": dict(variants)[name],
                      "ptxas": {k: list(v) for k, v in sorted(regs.items())
                                if k.startswith(f"qim_embed_kernel<{n // 8 + 1},")}})

    sets = cold_sets(dev, b, h, w, n)
    f0, p0, t0 = sets[0]
    deltas = (harness.DELTA, 2.0**-11)
    with using(built["library"][0]):
        want = {d: sk.embed_frames(f0, p0, t0, d, n) for d in deltas}
    bound = bounds.bound_ms(*bounds.work("embed", b, h, w, n,
                                         sk.pick_stripe(h)))[0]
    names = [name for name, _ in variants]
    ok = True
    for rnd in range(args.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            with using(built[name][0]):
                same = all(torch.equal(a, c) for d in deltas for a, c in
                           zip(sk.embed_frames(f0, p0, t0, d, n), want[d]))
                behind = harness.BEHIND
                ms = harness.queued_ms(
                    [lambda s=s: sk.embed_frames(*s, harness.DELTA, n)
                     for s in sets], runs=args.iters)
            ok = ok and same
            # a reading kept although the host fell behind holds host gaps
            harness.emit({"variant": name, "round": rnd, "batch": b,
                          "identical_to_library": same, "k1_ms": ms,
                          "k1_share": bound / ms,
                          "host_behind": harness.BEHIND > behind})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (stegotpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the CUDA kernels from stegotpu_torch/csrc (one nvcc per source,
all started together: K1-K6 in qim_stripe.cu, K7-K8 in qim_kron.cu, the
study kernels K9-K12 in qim_study.cu, K13 in qim_pipe.cu, the witness of
K7 and K8 in qim_kron_smem.cu, the round trip's evaluation in
qim_eval.cu, the wire-order unpack in qim_unpack.cu), prints each kernel's
registers and spills (ptxas) and the opcode counts of K1-K8, K11, K13 and
the witness from cuobjdump -sass of the library (failing if the Hopper
arithmetic of any of K1-K6, K11 and K13 holds a conversion instruction or
a shared load beyond what its layout and its ring need), and runs fifteen
phases:

1-2. K1 (embed) and K2 (packed extract) against their plain PyTorch
     versions at 1920x1080 and 1360x768;
3.   the port's default embed -> extract round trip at 1920x1080 through
     the pipeline's entry points (the path of K1 and K2);
4.   every kernel's time and its plain version's, with CUDA events
     (K1-K8, the witness of K7 and K8 and the evaluation kernel), and the
     share of their bound that K1-K8 and the evaluation reach (K7's
     against the separable and the dense form; the evaluation also at
     3840x2160, B=128), and the wire-order unpack kernel against its
     plain version byte for byte, its time beside its bound and the plain
     version's at 3840x2160 B=128 and 1920x1080 B=8;
5.   the file-to-file embed and extract, where cryptography, Pillow and a
     video backend are installed;
6.   K3 (embed + check), K4 (fused round trip) and K5 (unpacked extract)
     against their plain versions;
7.   the zero-tolerance identities kernel against kernel at delta 20 and
     2^-11 (K3, K4, K6 stego == K1's; K4 bits == K2's; K5 == K2 lane for
     lane; K6 rows == K5 of its stego; K9 full == K5), also on odd shapes
     at delta 0 and -4, then the exactness harness (ops/exactness.py, the
     path of K4 and K5);
8.   the TF32 sentinel: a row fails with TF32 in the oracle, and passes
     without;
9.   the verified embed at full width (the path of K3), on arrays and file
     to file;
10.  K6 (unpacked fused round trip) against K1, K5 and K4 with zero
     tolerance and against its plain version; K7 and K8 (Kronecker embed
     and extract) against their plain versions, and against their
     witness (studies/kron_ab.py, their first CUDA version) with zero
     tolerance at 1080p and 1280x768 (B=8) and on odd shapes, at delta 20
     and 2^-11, num_ac 1, 10 and 63, payloads full or ending mid-block or
     mid-frame, bit offset 0 and 13; then the path of the three kernels:
     the fused and the Kronecker round trips at 1080p with their quality
     metrics (ops/qim.roundtrip_metrics: the evaluation kernel, held to
     its plain version and to the exact PSNR, also on damaged bits), the
     oracle's
     embed_extract_evaluate, and the device PSNR/SSIM against the host's;
     and the witness's path, the kron_ab study at 1080p B=8 and B=128;
11.  the study kernels (stegotpu_torch/studies): K9 (the extract with
     stages removed, one entry per variant), K10 (embed from a bit-packed
     payload), K11 (two-chain fused round trip) and K12 (copy, dmaspec)
     against K5, K1, K4, the frames and payload_to_rows_packed with zero
     tolerance (K11 at delta 20 and 2^-11) and against their plain
     versions; their times; then the path of the four kernels: every
     study's main at 1080p, and one roofline pass at B=128 (a working set
     far beyond the 50 MB L2); the device timeline must show a K1, K4,
     K11 or K13 call as one kernel and nothing else, and a K3 call as its
     kernel behind at most one memset;
12.  K13 (the fused round trip through a cp.async ring of 2, 3 or 4 tiles)
     against K4 with zero tolerance at 1080p and 768p (B=8) at delta 20
     and 2^-11, at the study's 1080p B=128 and on odd shapes, capped and
     not, some at batches where the ring wraps many times, K11 beside it
     where B is even, and against its plain version; K13 at each ring depth beside
     K4 at B=128 in one line; its times and its plain version's; then its
     path: the emitpipe_r4 study at B=128 for each ring depth, with and
     without the register cap, and the roofline's fused_buf3/4;
13.  the command line at full width (stegotpu_torch.cli, in process):
     fixtures, genkey, embed, extract, inspect, steganalyze, capacity,
     evaluate, selftest and bench on a 1920x1080 cover;
14.  the parallel layer (stegotpu_torch.parallel) at 1920x1080, the paths
     of K1 and K2 behind a mesh, segment workers and ranks: the mesh
     library on grids that repeat the card ((2, 1), (1, 3), (2, 3) at B=8)
     byte-identical to the unsharded K1 and K2, with K1 launched once a
     shard at space 1 and once a frame of each shard otherwise; a
     24-frame file embedded through a --mesh data=1 mesh equal to the
     plain pipeline's, the verified embed through it on a letterboxed
     cover; extract with --procs 2 in thread and spawn mode (the spawn
     worker never initialises CUDA) and a 2-rank dist-extract over Gloo,
     each with the secret back pixel-identical and its host-clock time;
     embed --procs 2 and dist-embed, which need the native packet concat:
     run where it is built, else checked for their one-line failure;
15.  the serving path at 1920x1080 (stegotpu_torch.server, gui, tools), the
     paths of K1, K2, K3 and K4 behind a daemon, the GUI's workers and the
     soak and trace tools, all with no device named: the in-process server
     answers /healthz, /capacity, /embed (K1), /inspect and /extract (K2;
     pixel-identical, hash_ok), /steganalyze (delta 20), the verified
     /embed (K3, residual 0) and the error codes 422, 400 and 404; the
     daemon as users start it (`python -m stegotpu_torch.cli serve`),
     with the host seconds to its first /healthz and of a first and a
     second /embed; the GUI's embed and extract workers headless (procs 1
     and 2); soak_kernels (20 configurations, three arms), soak_product
     (3 draws) and profile_roundtrip (K4 events in its trace, in a
     process of its own).

Every phase prints; any failure exits non-zero. The line before the last
is a JSON object with each kernel's route, source, launches on its path,
error and times: "ms"/"plain_ms" the median CUDA-event time of one call
(host time where the host side outlasts the device work),
"device_ms"/"plain_device_ms" the device time per call with the host
queued ahead (null where the host fell behind the queue in every try, so
that the reading holds host gaps), "bound_ms"/"bound_by" the least time
an H100 SXM could take for the call at the published peaks
(studies/bounds.py), "library_ms" the
time of the one PyTorch call that computes the same function, where there
is one (Tensor.copy_ for K12 copy; null elsewhere). The witness rows
(kron_embed_smem, kron_extract_smem) replace no TPU kernel: their
"replaces" is null and "study" names the kernel they witness. The last
line is {"ok": true, "device": {...}}.

Without a CUDA device, or outside a checkout that holds stegotpu_torch,
it exits non-zero and prints no result. It imports only torch, numpy and
stegotpu_torch (which imports cryptography, Pillow and cv2 only in the
file-to-file phases and those of the command line, the parallel layer and
the serving path, phases 13-15, which fail without them, and scipy in
phase 15's kernel soak). Phase 14 starts two processes of the port's command line
twice, on a free localhost port, and waits at most four minutes for them;
phase 15 starts one `serve` daemon on a free localhost port, waits at most
three minutes for it to answer, and stops it with SIGINT (killing it if it
outlives a minute more).
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import math
import re
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# exactness envelope of the f32 wire contract (stegotpu/ops/exactness.py:
# TOL_ABS, TOL_REL): an extracted bit may differ between two f32
# implementations only where its coefficient lies within this distance of
# a rounding boundary of round(y / delta)
TOL_ABS = 1e-2
TOL_REL = 2e-5
# stego pixels differing by more than 1 between two f32 embeds: a
# coefficient at a rounding boundary may snap to the other lattice point
# (same parity, same decoded bit); budget of tests/test_pallas_kernel.py:22-32
STEGO_FLIP_BUDGET = 0.01
DELTA = 20.0
NUM_AC = 10
# the timed calls of phases 4 and 11 rotate over input sets that together
# hold at least this many bytes, five times the H100's 50 MB L2, so that
# each call reads its inputs from HBM, as a stream of new frames does
COLD_BYTES = 256 << 20


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _gpu_line() -> str:
    from stegotpu_torch.studies.harness import gpu_line

    return gpu_line()


ABLATIONS = ("full", "no_qim", "no_horiz", "io_only", "io_f4", "full_notrunc")


def _ptxas_summary(log: str) -> str:
    """Registers and spill-store bytes of every kernel from nvcc's
    -Xptxas=-v report: 'embed<2>:128r/0s(max 168r/0s) ...' for the stripe
    and study kernels, the instantiation of the default num_ac=10 (rn=2,
    or the only rn a kernel has) and the largest over rn=1..8, with one
    entry per K9 variant ('ablation_no_qim<2>:...'), per K13 ring depth,
    capped and not ('roundtrip_pipe_buf2_uncapped<2>:...'), and per K1-K6
    and K11 arithmetic and register cap ('extract_packed<2>' the Hopper
    arithmetic, 'embed_minb8<2>' K1's with __launch_bounds__(128, 8) at
    rn <= 2, 'embed<3>' without the cap above, 'embed_small_delta_minb8<2>'
    the build for delta < 2^-10; K13's 'roundtrip_pipe_buf2_small_delta');
    'kron_embed:64r/0s' and 'copy:16r/0s' for the kernels with one
    instantiation."""
    from stegotpu_torch.studies import sass

    per: dict[str, dict[int, tuple[int, int]]] = {}
    for label, regs in sass.ptxas(log).items():
        m = re.fullmatch(r"(\w+?)_kernel(?:<(.*)>)?", label)
        if m is None:
            continue
        kind = m.group(1).removeprefix("qim_")
        args = m.group(2).split(", ") if m.group(2) else []
        rn = int(args[0]) if args and kind != "copy" else 0
        if kind == "copy":  # copy_kernel<V>: V is the variant
            name = ("copy", "dmaspec")[int(args[0])]
        elif kind == "roundtrip_pipe":  # <RN, Arith, BUFS, MINB>
            name = f"roundtrip_pipe_buf{args[2]}" + (
                "_small_delta" if args[1].endswith("SmallDelta") else "")
            if rn <= 2 and args[3] == "1":  # the build without the cap
                name += "_uncapped"
        elif kind == "unpack":  # <RN, STORE>: the store width in bytes
            name = f"unpack_st{args[1]}"
        elif kind == "ablation":  # <RN, V>
            name = f"ablation_{ABLATIONS[int(args[1])]}"
        elif len(args) >= 2:  # K1/K3/K4/K6 <RN, Arith, MINB>, K2/K5 <RN, Arith>
            name = kind + ("_small_delta" if args[1].endswith("SmallDelta")
                           else "")
            if args[2:] and args[2] != "1":
                name += f"_minb{args[2]}"
        else:
            name = kind
        per.setdefault(name, {})[rn] = regs
    out = []
    for kernel, by_rn in sorted(per.items()):
        if set(by_rn) == {0}:
            out.append(f"{kernel}:{by_rn[0][0]}r/{by_rn[0][1]}s")
            continue
        rn = 2 if 2 in by_rn else min(by_rn)
        r2, s2 = by_rn[rn]
        out.append(f"{kernel}<{rn}>:{r2}r/{s2}s(max "
                   f"{max(r for r, _ in by_rn.values())}r/"
                   f"{max(s for _, s in by_rn.values())}s)")
    return " ".join(out)


# conversion and shared-memory opcodes that the Hopper arithmetic of K1-K6
# (ArithHopper, delta >= 2^-10) leaves out of their SASS
NO_SLOW_PIPE = ("I2F", "I2FP", "F2I", "FRND", "LDS")
# what is left, and why: the packed and unpacked layouts of K2, K4, K5 and
# K6 divide the block row by the stripe's block rows (group_row in
# csrc/qim_common.cuh), an integer division whose reciprocal takes one I2F
# and one F2I a thread, outside the block arithmetic
SLOW_PIPE_LEFT = {k: {"I2F": 1, "F2I": 1} for k in (
    "qim_extract_packed_kernel", "qim_roundtrip_packed_kernel",
    "qim_extract_rows_kernel", "qim_roundtrip_rows_kernel")}


def _sass_counts(lib) -> None:
    """Print the opcode counts of K1-K6 (rn=2) from cuobjdump -sass of the
    built library (studies/sass.py), and fail unless each has an
    ArithHopper build, or if one of those holds a conversion instruction
    or a shared load beyond SLOW_PIPE_LEFT."""
    from stegotpu_torch.studies import sass

    rows = sass.rows(lib)
    print("sass (cuobjdump -sass of the built library, rn=2; I2F/I2FP/F2I/"
          "FRND conversions, MUFU reciprocals, FCHK divide checks, LDS "
          "shared loads, FFMA and those with an immediate or a constant-"
          "bank operand, PRMT byte permutes): "
          + sass.summary(rows), flush=True)
    fast = [r for r in rows if re.search(r", ArithHopper\b", r["kernel"])]
    found = {r["kernel"].split("<")[0] for r in fast}
    check(found == set(sass.DEFAULT_KERNELS),
          f"no ArithHopper build of {set(sass.DEFAULT_KERNELS) - found}: {rows}")
    bad = {}
    for r in fast:
        left = SLOW_PIPE_LEFT.get(r["kernel"].split("<")[0], {})
        over = {k: r[k] for k in NO_SLOW_PIPE if r[k] > left.get(k, 0)}
        if over:
            bad[r["kernel"]] = over
    check(not bad, f"K1-K6 ArithHopper builds hold slow-pipe instructions: {bad}")


# K11 and K13, K4's spelling in two study kernels: their ArithHopper builds
# hold no FRND or I2FP, K11 (K4 with two chains) at most K4's one I2F and
# one F2I (SLOW_PIPE_LEFT) and no LDS. K13 reads each tile from its ring in
# shared memory (8 row loads and up to 15 payload bytes a block, LDS, in a
# copy of the loop body per ring slot that ptxas unrolls, so the count
# grows with the ring's depth) and decomposes its first tile and the grid
# stride by the column chunks and the block rows (TileWalk.start in
# csrc/qim_pipe.cu: two 32-bit divisions, an I2F and an F2I each) besides
# group_row's stripe division; these are the counts of its builds at rn=2
# by ring depth (the BUFS template argument), capped or not.
STUDY_SASS_LEFT = {
    "qim_roundtrip_dual_kernel": SLOW_PIPE_LEFT["qim_roundtrip_packed_kernel"],
    "qim_roundtrip_pipe_kernel": {
        bufs: {"I2F": 3, "F2I": 3, "LDS": lds}
        for bufs, lds in ((2, 143), (3, 239), (4, 311))},
}


def _study_left(kernel: str) -> dict:
    """STUDY_SASS_LEFT's allowance of a K11 or K13 build, by its label
    ('qim_roundtrip_pipe_kernel<2, ArithHopper, 3, 7>': ring depth 3)."""
    name, _, args = kernel.partition("<")
    left = STUDY_SASS_LEFT[name]
    if name == "qim_roundtrip_pipe_kernel":
        left = left[int(args.split(",")[2])]
    return left


def _study_sass(lib, log: str) -> None:
    """Print the opcode counts of K11 and K13 (rn=2, every build) from
    cuobjdump -sass of the built library, with registers and spills from
    the build's ptxas report where this run built it, and fail if an
    ArithHopper build holds an FRND or I2FP, or a conversion or shared load
    beyond STUDY_SASS_LEFT."""
    from stegotpu_torch.studies import sass

    regs = sass.ptxas(log)
    rows = sass.rows(lib, tuple(STUDY_SASS_LEFT))
    print("sass K11/K13 (cuobjdump -sass of the built library, rn=2; "
          "registers/spill bytes from ptxas): " + "; ".join(
              f"{r['kernel']} " + " ".join(
                  f"{k}={r[k]}" for k in ("I2F", "I2FP", "F2I", "FRND", "LDS",
                                          "FFMA", "BAR", "instructions"))
              + " regs=" + ("{}/{}".format(*regs[r['kernel']])
                            if r['kernel'] in regs else "not built here")
              for r in rows), flush=True)
    fast = [r for r in rows if re.search(r", ArithHopper\b", r["kernel"])]
    check({r["kernel"].split("<")[0] for r in fast} == set(STUDY_SASS_LEFT),
          f"no ArithHopper build of K11 or K13: {rows}")
    bad = {}
    for r in fast:
        left = _study_left(r["kernel"])
        over = {k: r[k] for k in NO_SLOW_PIPE if r[k] > left.get(k, 0)}
        if over:
            bad[r["kernel"]] = over
    check(not bad, f"K11/K13 ArithHopper builds hold slow-pipe instructions "
          f"beyond STUDY_SASS_LEFT: {bad}")


# K7, K8 and their witness (studies/kron_ab.py)
KRON_KERNELS = ("kron_embed_kernel", "kron_extract_kernel",
                "kron_embed_smem_kernel", "kron_extract_smem_kernel")


def _kron_sass(lib, log: str) -> None:
    """Print the opcode counts of K7, K8 and their witness from cuobjdump
    -sass of the built library (studies/sass.py), with registers and
    spills from the build's ptxas report where this run built it."""
    from stegotpu_torch.studies import sass

    regs = sass.ptxas(log)
    print("sass kron (cuobjdump -sass of the built library; FFMA, LDS "
          "shared loads, LDG global loads, BAR barriers, all instructions; "
          "registers/spill bytes from ptxas): " + "; ".join(
              f"{r['kernel']} FFMA={r['FFMA']} LDS={r['LDS']} LDG={r['LDG']} "
              f"BAR={r['BAR']} instructions={r['instructions']} regs="
              + ("{}/{}".format(*regs[r['kernel']]) if r['kernel'] in regs
                 else "not built here")
              for r in sass.rows(lib, KRON_KERNELS)), flush=True)


def _time_ms(fns, runs: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, over `runs` calls after warm-up.
    `fns` is a callable or a list of them, one per input set, called in
    turn. The events bracket the host's work too: where a call's host side
    (the wrapper's checks, the launch, its small torch ops) outlasts its
    device work, the device waits and this is host time."""
    import torch

    fns = fns if isinstance(fns, list) else [fns]
    for i in range(warmup):
        fns[i % len(fns)]()
    times = []
    for i in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fns[i % len(fns)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# label -> (readings taken again, kept behind) where harness.queued_ms had
# to take a reading again because the host fell behind its sleep kernel
RETAKEN: dict[str, tuple[int, int]] = {}


def _queued_ms(fns, label: str, runs: int = 20, warmup: int = 3) -> float:
    """Device time of one call, queued behind a sleep kernel, rotating over
    the input sets of `fns` (studies/harness.queued_ms); notes in RETAKEN
    the readings of `label` that were taken again."""
    from stegotpu_torch.studies import harness

    before = harness.RETAKES, harness.BEHIND
    ms = harness.queued_ms(fns, runs, warmup)
    if harness.RETAKES > before[0]:
        RETAKEN[label] = (harness.RETAKES - before[0],
                          harness.BEHIND - before[1])
    return ms


def _device_ms(label: str, ms: float) -> float | None:
    """ms, or None where the reading of `label` was kept although the host
    fell behind the sleep kernel in every try: it then holds host gaps."""
    return None if RETAKEN.get(label, (0, 0))[1] else ms


def _exact_psnr(frames, stego) -> float:
    """PSNR of the exact squared error: float64 sums, 8 frames at a time
    (every partial sum an integer under 2^53)."""
    sse = 0.0
    for f in range(0, frames.shape[0], 8):
        d = frames[f:f + 8].double() - stego[f:f + 8].double()
        sse += float((d * d).sum())
    return math.inf if sse == 0 else 10.0 * math.log10(
        65025.0 * frames.numel() / sse)


def _eval_against_plain(frames, stego, extracted, payload, total,
                        label: str) -> tuple[int, int, float]:
    """The evaluation kernel against its plain version on a damaged copy of
    a round trip's bits: every 997th slot flipped, every 1999th a byte
    2..255, and the payload ending 9 bytes before a 16-byte vector's end
    (slots beside that end flipped on both sides). Bit errors and payload
    bits must equal the plain version's exactly, and the errors must be
    some; the PSNR at most one float32 rounding off the exact one.
    Returns (bit errors, payload bits, PSNR gap in dB)."""
    import numpy as np
    import torch

    from stegotpu_torch.ops import qim
    from stegotpu_torch.ops import stripe_kernel as sk

    bad = extracted.clone()
    flat = bad.view(-1)
    t = 16 * (min(total, flat.numel()) // 16) - 9
    flip = torch.cat([torch.arange(5, flat.numel(), 997, device=flat.device),
                      torch.tensor([t - 1, t, t + 1], device=flat.device)])
    flat[flip] = flat[flip] ^ 1
    odd = torch.arange(11, flat.numel(), 1999, device=flat.device)
    flat[odd] = (odd % 254 + 2).to(torch.uint8)
    m = sk.roundtrip_eval(frames, stego, bad, payload, t)
    want = qim.roundtrip_metrics_plain(frames, stego, bad, payload, t)
    errors, n = int(m["bit_errors"]), int(m["payload_bits"])
    check(errors == int(want["bit_errors"]) and n == int(want["payload_bits"])
          == t and errors > 0,
          f"evaluation kernel at {label}: bit errors {errors} (plain "
          f"{int(want['bit_errors'])}), payload bits {n} (plain "
          f"{int(want['payload_bits'])}, want {t})")
    exact = _exact_psnr(frames, stego)
    gap = abs(float(m["psnr_db"]) - exact)
    check(gap <= np.spacing(np.float32(exact)),
          f"evaluation kernel at {label}: PSNR {float(m['psnr_db'])} is "
          f"more than a float32 rounding off the exact {exact}")
    return errors, n, gap


def _eval_4k(dev, gpu: str) -> None:
    """Phase 4's evaluation at the 4K cell's batch: the kernel and its plain
    version, queued, on two 128-frame 3840x2160 round trips of K4 (4.9 GB,
    so every call reads HBM), beside the kernel's byte bound; and on one of
    them, damaged, held to the plain version and the exact PSNR
    (_eval_against_plain)."""
    import torch

    from stegotpu_torch.ops import qim
    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.studies import bounds

    b, h, w = 128, 2160, 3840
    cap = (h // 8) * (w // 8) * NUM_AC
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    sets = []
    for _ in range(2):
        f = torch.randint(32, 224, (b, h, w), generator=gen, device=dev,
                          dtype=torch.uint8)
        p = torch.randint(0, 2, (b, cap), generator=gen, device=dev,
                          dtype=torch.uint8)
        s, _, ex = sk.embed_and_extract_frames(f, p, b * cap, DELTA, NUM_AC)
        sets.append((f, s, ex, p, b * cap))
    counts = sk.LAUNCHES.copy()
    ms = {k: _queued_ms(_per_set(fn, sets), k, runs=10)
          for k, fn in (("eval 4K", sk.roundtrip_eval),
                        ("eval 4K plain", qim.roundtrip_metrics_plain))}
    errors, n, gap = _eval_against_plain(*sets[0], "3840x2160 B=128")
    sk.LAUNCHES.clear()
    sk.LAUNCHES.update(counts)
    bound, by = bounds.bound_ms(*bounds.work("roundtrip_eval", b, h, w,
                                             NUM_AC, 120))
    print(f"phase 4 evaluation roundtrip_eval 3840x2160 B=128 ({gpu}): "
          f"device_ms {ms['eval 4K']:.4f} bound_ms {bound:.5f} ({by}) share "
          f"{bound / ms['eval 4K']:.1%}; plain device_ms "
          f"{ms['eval 4K plain']:.4f}; damaged bits: {errors} errors of {n} "
          f"payload bits == plain, PSNR off the exact by {gap:.3g} dB",
          flush=True)
    del sets
    torch.cuda.empty_cache()


def _unpack(dev, gpu: str, times: dict, queued: dict) -> dict[str, int]:
    """Phase 4's wire-order unpack (ops/stripe_kernel.packed_rows_to_bits,
    csrc/qim_unpack.cu) and its plain version, queued, at the 4K cells'
    3840x2160 B=128 (two input sets: 199 MB in and out a call, four times
    the L2) and at 1920x1080 B=8 (enough sets that a rotation moves
    COLD_BYTES, so every call reads HBM), beside the kernel's byte bound
    (slot rows read once, wire bits written once); the 1080p times go to
    the kernels line. The kernel's bits equal the plain version's on every
    set (random packed bytes, non-slot bits and padding rows included).
    Returns {"unpack_packed": bytes that differ}."""
    import torch

    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.studies import bounds

    counts = sk.LAUNCHES.copy()
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    fns = {"unpack_packed": sk.packed_rows_to_bits,
           "unpack_packed_plain": sk.packed_rows_to_bits_plain}
    wrong = 0
    for b, h, w in ((128, 2160, 3840), (8, 1080, 1920)):
        stripe = sk.pick_stripe(h)
        rows = (h // stripe) * sk._rows_pad(stripe, sk.rows_per_block(NUM_AC))
        nbytes, flops = bounds.work("unpack_packed", b, h, w, NUM_AC, stripe)
        n_sets = max(2, -(-COLD_BYTES // nbytes))
        pool = torch.randint(0, 256, (n_sets, b, rows, w // 8), generator=gen,
                             device=dev, dtype=torch.uint8)
        sets = [(pool[i], h, w, NUM_AC, stripe) for i in range(n_sets)]
        runs = max(10, n_sets)
        # the 1080p readings are the kernels line's: their labels its keys
        ms = {k: _queued_ms(_per_set(fn, sets), k if b == 8 else f"{k} 4K",
                            runs=runs) for k, fn in fns.items()}
        for s in sets:
            wrong += int((sk.packed_rows_to_bits(*s)
                          != sk.packed_rows_to_bits_plain(*s)).sum())
        check(wrong == 0, f"unpack kernel at {w}x{h} B={b}: {wrong} bytes "
              "differ from the plain version")
        bound, by = bounds.bound_ms(nbytes, flops)
        store = sk.unpack_store_width(sk.packed_rows_to_bits(*sets[0]), w,
                                      NUM_AC)
        if b == 8:
            for k, fn in fns.items():
                times[k] = _time_ms(_per_set(fn, sets))
                queued[k] = ms[k]
        print(f"phase 4 unpack unpack_packed {w}x{h} B={b} ({gpu}): device_ms "
              f"{ms['unpack_packed']:.4f} bound_ms {bound:.5f} ({by}; "
              f"{nbytes} B) share {bound / ms['unpack_packed']:.1%}; plain "
              f"device_ms {ms['unpack_packed_plain']:.4f} "
              f"({ms['unpack_packed_plain'] / ms['unpack_packed']:.1f}x); "
              f"store width {store}; "
              f"== plain on {n_sets} sets of random packed rows, "
              f"{n_sets * nbytes >> 20} MiB in and out a rotation", flush=True)
        del pool, sets
        torch.cuda.empty_cache()
    sk.LAUNCHES.clear()
    sk.LAUNCHES.update(counts)
    return {"unpack_packed": wrong}


def _cold_sets(dev, rng) -> list:
    """(frames, payload, total) sets at 1920x1080, B=8, mid-range covers
    (_covers), enough of them to hold COLD_BYTES of frames and payload."""
    b, h, w = 8, 1080, 1920
    per_set = b * h * w + b * (h // 8) * (w // 8) * NUM_AC
    return [_covers(dev, rng, b, h, w, "mid")
            for _ in range(-(-COLD_BYTES // per_set))]


def _per_set(fn, sets) -> list:
    """fn bound to each input set: the list that _time_ms and _queued_ms
    rotate over."""
    return [functools.partial(fn, *s) for s in sets]


# the witness kernels (studies/kron_ab.py): they replace no TPU kernel;
# each computes the function of the kernel it witnesses
WITNESS = {"kron_embed_smem": "kron_embed", "kron_extract_smem": "kron_extract"}

def _near_boundary_t(frames, delta: float, num_ac: int):
    """Per wire-order slot bit, a (B, C) bool tensor on the frames' device:
    True where the float64 coefficient lies within the exactness envelope
    of a rounding boundary."""
    import torch

    from stegotpu_torch.ops.dct import blockify, kron_dct_tensor

    k = kron_dct_tensor(frames.device, torch.float64)[1 : 1 + num_ac]
    y = blockify(frames.to(torch.float64)) @ k.T      # (B, nb, num_ac)
    r = y / delta
    dist = (r - torch.floor(r) - 0.5).abs() * delta
    return (dist <= TOL_ABS + TOL_REL * y.abs()).reshape(frames.shape[0], -1)


def _near_boundary(frames, delta: float, num_ac: int):
    """_near_boundary_t on the host, as a numpy array."""
    return _near_boundary_t(frames, delta, num_ac).cpu().numpy()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "stegotpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no stegotpu_torch package beside {__file__}; run "
              "it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import stegotpu_torch

    if Path(stegotpu_torch.__file__).resolve().parent != ROOT / "stegotpu_torch":
        print("chip_smoke: imported stegotpu_torch from "
              f"{stegotpu_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2
    from stegotpu_torch import payload as payload_mod
    from stegotpu_torch.config import StegoConfig
    from stegotpu_torch.ops import _build, qim
    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.ops.experimental import kron_kernel as kk
    from stegotpu_torch.pipeline import (embed_payload_into_gray_frames,
                                         extract_bits_from_gray_frames)
    from stegotpu_torch.studies import kron_ab

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    log = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s nvcc "
          f"{' '.join(_build.NVCC_FLAGS)} ptxas {_ptxas_summary(log)}",
          flush=True)
    _sass_counts(_build.library_path())
    _study_sass(_build.library_path(), log)
    _kron_sass(_build.library_path(), log)

    rng = np.random.default_rng(20261016)
    embed_err = 0
    extract_err = 0
    stegos = []

    # phase 1: K1 against its plain version at the main path's shapes
    for (h, w) in ((1080, 1920), (768, 1360)):
        for cover in ("mid", "uniform"):
            lo, hi = (16, 240) if cover == "mid" else (0, 256)
            b = 8
            frames = torch.from_numpy(
                rng.integers(lo, hi, (b, h, w), dtype=np.uint8)).to(dev)
            cap = (h // 8) * (w // 8) * NUM_AC
            offset = 4321
            total = offset + int(0.6 * b * cap)
            payload = torch.from_numpy(
                rng.integers(0, 2, (b, cap), dtype=np.uint8)).to(dev)
            s_k, bpf_k = sk.embed_frames(frames, payload, total, DELTA,
                                         NUM_AC, offset)
            s_p, bpf_p = sk.embed_frames_plain(frames, payload, total, DELTA,
                                               NUM_AC, offset)
            torch.cuda.synchronize()
            check(torch.equal(bpf_k, bpf_p),
                  f"K1 bits_per_frame differ at {h}x{w}")
            d = (s_k.to(torch.int32) - s_p.to(torch.int32)).abs()
            flips = (d > 1).double().mean().item()
            embed_err = max(embed_err, int(d.max().item()))
            check(flips < STEGO_FLIP_BUDGET,
                  f"K1 vs plain: {flips:.4%} of pixels differ by >1 at {h}x{w}")
            n = total - offset
            exact = None
            if cover == "mid":
                got = qim.extract_frames(s_k, DELTA, NUM_AC).reshape(-1)[:n]
                exact = torch.equal(got, payload.reshape(-1)[:n])
                check(exact, f"K1 payload not recovered at {h}x{w}")
            print(f"phase 1 K1 {h}x{w} B={b} {cover}: bpf identical, "
                  f">1 px {flips:.5%} (budget {STEGO_FLIP_BUDGET:.0%}), max "
                  f"|diff| {int(d.max().item())}, payload exact {exact}",
                  flush=True)
            stegos.append((h, w, cover, frames, s_k, payload, n))

    # phase 2: K2 against its plain version, on the covers and on K1's stego
    for (h, w, cover, frames, s_k, payload, n) in stegos:
        stripe = sk.pick_stripe(h)
        rn = sk.rows_per_block(NUM_AC)
        rp = sk._rows_pad(stripe, rn)
        for what, x in (("cover", frames), ("stego", s_k)):
            p_k = sk.extract_frames_packed(x, DELTA, NUM_AC)
            p_p = sk.extract_frames_packed_plain(x, DELTA, NUM_AC)
            torch.cuda.synchronize()
            pad = torch.arange(p_k.shape[1], device=dev) % rp >= (stripe // 8) * rn
            check(not p_k[:, pad].any().item(), "K2 padding rows not zero")
            bits_k = sk.packed_rows_to_bits_host(p_k.cpu().numpy(), h, w,
                                                 NUM_AC, stripe)
            bits_p = sk.packed_rows_to_bits_host(p_p.cpu().numpy(), h, w,
                                                 NUM_AC, stripe)
            diff = bits_k != bits_p
            near = _near_boundary(x, DELTA, NUM_AC)
            outside = int((diff & ~near).sum())
            extract_err = max(extract_err, int((diff & ~near).any()))
            check(outside == 0,
                  f"K2 vs plain: {outside} bits differ outside the exactness "
                  f"envelope at {h}x{w} ({what}, {cover})")
            exact = None
            if what == "stego" and cover == "mid":
                exact = np.array_equal(bits_k.reshape(-1)[:n],
                                       payload.reshape(-1)[:n].cpu().numpy())
                check(exact, f"K2 payload not recovered at {h}x{w}")
            print(f"phase 2 K2 {h}x{w} {what} {cover}: {int(diff.sum())} of "
                  f"{diff.size} wire bits differ, all within the envelope; "
                  f"padding rows zero; payload exact {exact}", flush=True)
    del stegos

    # phase 3: the port's main path at 1080p, through the pipeline API
    parts = payload_mod.PayloadParts(
        secret_width=1024, secret_height=640,
        sender_pub_compressed=b"\x02" + rng.bytes(32),
        hkdf_salt=rng.bytes(16), sha3_hash=rng.bytes(32), nonce=rng.bytes(12),
        tag=rng.bytes(16), ciphertext=rng.bytes(1024 * 640))
    bits = payload_mod.build_payload_bits(parts)
    cover = rng.integers(16, 240, (24, 1080, 1920), dtype=np.uint8)
    cfg = StegoConfig()
    sk.LAUNCHES.clear()
    t0 = time.perf_counter()
    stego, bpf = embed_payload_into_gray_frames(cover, bits, cfg, device=dev)
    out = extract_bits_from_gray_frames(stego, cfg, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"embed": sk.LAUNCHES["stegotpu_qim_embed"],
                "extract_packed": sk.LAUNCHES["stegotpu_qim_extract_packed"]}
    check(int(bpf.sum()) == bits.size, "main path: not every bit embedded")
    got, _consumed = payload_mod.parse_payload_bits(out, cfg.dims_bits)
    check(got == parts, "main path: payload did not round-trip")
    tail = np.flatnonzero(bpf == 0)
    check(tail.size > 0 and np.array_equal(stego[tail], cover[tail]),
          "main path: frames past the payload differ from the cover")
    check(launches["embed"] > 0 and launches["extract_packed"] > 0,
          f"main path did not launch both kernels: {launches}")
    print(f"phase 3 main path 1080p: {bits.size} payload bits over "
          f"{int((bpf > 0).sum())} of {len(cover)} frames round-trip exactly "
          f"(parse_payload_bits); frames {tail[0]}..{tail[-1]} byte-identical "
          f"to the cover; stegotpu_qim_embed={launches['embed']} "
          f"stegotpu_qim_extract_packed={launches['extract_packed']}; "
          f"{seconds:.2f} s host clock", flush=True)
    del stego, out

    # phase 4: kernel and plain times at 1920x1080, B=8, inputs from HBM
    sets = _cold_sets(dev, rng)
    counts = sk.LAUNCHES.copy()

    def embed_args(fn):
        return lambda f, p, t: fn(f, p, t, DELTA, NUM_AC)

    def extract_args(fn):
        return lambda f, p, t: fn(f, DELTA, NUM_AC)

    calls = {
        "embed": embed_args(sk.embed_frames),
        "embed_plain": embed_args(sk.embed_frames_plain),
        "extract_packed": extract_args(sk.extract_frames_packed),
        "extract_packed_plain": extract_args(sk.extract_frames_packed_plain),
        "embed_check": embed_args(sk.embed_and_check_frames),
        "embed_check_plain": embed_args(sk.embed_and_check_frames_plain),
        "roundtrip_packed": embed_args(sk.embed_and_extract_frames_packed),
        "roundtrip_packed_plain":
            embed_args(sk.embed_and_extract_frames_packed_plain),
        "extract_rows": extract_args(sk.extract_frames_rows),
        "extract_rows_plain": extract_args(sk.extract_frames_rows_plain),
        "roundtrip_rows": embed_args(sk.embed_and_extract_frames_rows),
        "roundtrip_rows_plain":
            embed_args(sk.embed_and_extract_frames_rows_plain),
        "kron_embed": embed_args(kk.embed_frames_kron),
        "kron_embed_plain": embed_args(kk.embed_frames_kron_plain),
        "kron_extract": extract_args(kk.extract_frames_kron),
        "kron_extract_plain": extract_args(kk.extract_frames_kron_plain),
        "kron_embed_smem": embed_args(kron_ab.embed_frames_kron_smem),
        "kron_extract_smem": extract_args(kron_ab.extract_frames_kron_smem),
    }
    times = {k: _time_ms(_per_set(fn, sets)) for k, fn in calls.items()}
    queued = {k: _queued_ms(_per_set(fn, sets), k) for k, fn in calls.items()}
    # the evaluation kernel, on each set's K4 round trip
    eval_sets = [(f, *sk.embed_and_extract_frames(f, p, t, DELTA,
                                                  NUM_AC)[::2], p, t)
                 for f, p, t in sets]
    for k, fn in (("roundtrip_eval", sk.roundtrip_eval),
                  ("roundtrip_eval_plain", qim.roundtrip_metrics_plain)):
        times[k] = _time_ms(_per_set(fn, eval_sets))
        queued[k] = _queued_ms(_per_set(fn, eval_sets), k)
    del eval_sets
    for k in WITNESS:  # the witness's plain version is its kernel's
        times[f"{k}_plain"] = times[f"{WITNESS[k]}_plain"]
        queued[f"{k}_plain"] = queued[f"{WITNESS[k]}_plain"]
    sk.LAUNCHES.clear()  # timing is not a path's run
    sk.LAUNCHES.update(counts)
    cold = (f"rotating over {len(sets)} input sets of "
            f"{sum(f.numel() + p.numel() for f, p, _ in sets) >> 20} MiB")
    print(f"phase 4 times 1920x1080 B=8 (median of 20 CUDA-event runs, {cold}, "
          f"{gpu}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
          flush=True)
    print(f"phase 4 device times 1920x1080 B=8 (mean of 20 calls queued "
          f"behind a sleep kernel, {cold}, {gpu}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in queued.items()), flush=True)
    from stegotpu_torch.studies import bounds

    for k, kn in (("embed", "K1"), ("extract_packed", "K2"),
                  ("embed_check", "K3"), ("roundtrip_packed", "K4"),
                  ("extract_rows", "K5"), ("roundtrip_rows", "K6")):
        bound, by = bounds.bound_ms(*bounds.work(k, 8, 1080, 1920, NUM_AC,
                                                 sk.pick_stripe(1080)))
        print(f"phase 4 {kn} {k} 1920x1080 B=8 ({gpu}): ms {times[k]:.4f} "
              f"device_ms {queued[k]:.4f} bound_ms {bound:.5f} ({by}) share "
              f"{bound / queued[k]:.1%}", flush=True)
    bound, by = bounds.bound_ms(*bounds.work("roundtrip_eval", 8, 1080, 1920,
                                             NUM_AC, 120))
    print(f"phase 4 evaluation roundtrip_eval 1920x1080 B=8 ({gpu}): ms "
          f"{times['roundtrip_eval']:.4f} device_ms "
          f"{queued['roundtrip_eval']:.4f} bound_ms {bound:.5f} ({by}) share "
          f"{bound / queued['roundtrip_eval']:.1%}; plain ms "
          f"{times['roundtrip_eval_plain']:.4f} device_ms "
          f"{queued['roundtrip_eval_plain']:.4f}", flush=True)
    _eval_4k(dev, gpu)
    errs4 = _unpack(dev, gpu, times, queued)
    for k, kn in (("kron_embed", "K7"), ("kron_extract", "K8")):
        forms = [("", k)] + ([("dense ", "kron_embed_dense")]
                             if k == "kron_embed" else [])
        shares = []
        for form, key in forms:
            bound, by = bounds.bound_ms(*bounds.work(key, 8, 1080, 1920,
                                                     NUM_AC, 8))
            shares.append(f"{form}bound_ms {bound:.5f} ({by}) share "
                          f"{bound / queued[k]:.1%}")
        w = f"{k}_smem"
        print(f"phase 4 {kn} {k} 1920x1080 B=8 ({gpu}): ms {times[k]:.4f} "
              f"device_ms {queued[k]:.4f} against its witness {w} ms "
              f"{times[w]:.4f} device_ms {queued[w]:.4f} "
              f"({queued[w] / queued[k]:.2f}x); " + "; ".join(shares)
              + (" (the separable transform's work, and the dense form's "
                 "that K7 computes)" if k == "kron_embed" else ""),
              flush=True)

    # phase 5: file to file, where the host libraries are installed
    libs = {m: importlib.util.find_spec(m) is not None
            for m in ("cryptography", "PIL", "cv2")}
    from stegotpu_torch.video import _use_native

    backend = "native" if _use_native("auto") else (
        "cv2" if libs["cv2"] else None)
    files = all(libs.values()) and backend is not None
    if files:
        print(f"phase 5 file-to-file: runs (video backend {backend})",
              flush=True)
        _file_to_file(dev, rng, "phase 5 file-to-file 1080p",
                      (rng.integers(16, 240, (6, 1080, 1920, 3), dtype=np.uint8)
                       for _ in range(4)), (480, 640), StegoConfig())
    else:
        print(f"phase 5 file-to-file: skipped, missing {libs} video backend "
              f"{backend}", flush=True)

    errs = _fused_vs_plain(dev, rng)                          # phase 6
    launches.update(_identities_and_harness(dev, rng, libs["cv2"]))  # phase 7
    _tf32_sentinel(dev)                                       # phase 8
    launches.update(_verified_path(dev, rng, files))          # phase 9
    errs10, launches10 = _variants_and_metrics(dev, rng)      # phase 10
    errs.update(errs10)
    launches.update(launches10)
    errs11, launches11, times11, queued11, library = _studies(dev, rng, gpu,
                                                              sets)
    errs.update(errs11)                                       # phase 11
    launches.update(launches11)
    times.update(times11)
    queued.update(queued11)
    errs12, launches12, times12, queued12 = _pipe(dev, rng, gpu, sets)
    del sets
    errs.update(errs12)                                       # phase 12
    launches.update(launches12)
    times.update(times12)
    queued.update(queued12)
    _cli()                                                    # phase 13
    _parallel(dev, rng, gpu)                                  # phase 14
    _serving(gpu)                                             # phase 15

    stripe = ("stegotpu_torch/csrc/qim_stripe.cu", "stegotpu/ops/pallas_kernel.py")
    kron = ("stegotpu_torch/csrc/qim_kron.cu",
            "stegotpu/ops/experimental/pallas_kron.py")
    study = "stegotpu_torch/csrc/qim_study.cu"
    replaces = {"embed": (stripe, 529), "extract_packed": (stripe, 577),
                "embed_check": (stripe, 906), "roundtrip_packed": (stripe, 804),
                "extract_rows": (stripe, 545), "roundtrip_rows": (stripe, 785),
                "kron_embed": (kron, 58), "kron_extract": (kron, 80),
                **{f"ablation_{v}": ((study, "benchmarks/extract_ablation.py"),
                                     92 if v == "io_f4" else 61)
                   for v in ABLATIONS},
                "embed_packedin": ((study, "benchmarks/ab_packed_payload.py"),
                                   111),
                "roundtrip_dual": ((study, "benchmarks/dualchain_r5.py"), 91),
                "copy": ((study, "benchmarks/roofline_r4.py"), 91),
                "dmaspec": ((study, "benchmarks/roofline_r4.py"), 149),
                **{f"roundtrip_pipe_buf{n}": (
                    ("stegotpu_torch/csrc/qim_pipe.cu",
                     "benchmarks/emitpipe_r4.py"), 119) for n in (2, 3, 4)},
                **{k: (("stegotpu_torch/csrc/qim_kron_smem.cu", None), None)
                   for k in WITNESS},
                "roundtrip_eval": (("stegotpu_torch/csrc/qim_eval.cu", None),
                                   None),
                "unpack_packed": (("stegotpu_torch/csrc/qim_unpack.cu", None),
                                  None)}
    errs.update(embed=embed_err, extract_packed=extract_err, **errs4)
    kernels = []
    for k, ((source, tpu_file), line) in replaces.items():
        # the least time for this run's inputs: phase 4's, 11's and 12's
        # timed calls, 1920x1080, B=8, num_ac=10, every block entered
        bound, bound_by = bounds.bound_ms(*bounds.work(
            k, 8, 1080, 1920, NUM_AC, sk.pick_stripe(1080)))
        plain = ("K13 plain" if k.startswith("roundtrip_pipe")
                 else f"{WITNESS.get(k, k)}_plain")
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": f"{tpu_file}:{line}" if tpu_file else None,
            "launches": launches[k], "max_abs_err": errs[k],
            "ms": times[k], "plain_ms": times[f"{k}_plain"],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library.get(k),
            "device_ms": _device_ms(k, queued[k]),
            "plain_device_ms": _device_ms(plain, queued[f"{k}_plain"]),
            **({"study": f"witness of {WITNESS[k]}: its first CUDA version, "
                         "held to it byte for byte; replaces no TPU kernel"}
               if k in WITNESS else {}),
            **({"note": "replaces no TPU kernel: the JAX package evaluates "
                        "in XLA code (stegotpu/ops/qim.py:165-189); "
                        "max_abs_err is its largest PSNR gap in dB"}
               if k == "roundtrip_eval" else {}),
            **({"note": "replaces no TPU kernel: the JAX package unpacks in "
                        "XLA ops (stegotpu/ops/pallas_kernel.py:217); "
                        "max_abs_err counts the bytes that differ from the "
                        "plain version"}
               if k == "unpack_packed" else {})})
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was not launched on its path: {launches}")
    from stegotpu_torch.studies import harness

    studies = harness.RETAKES - sum(n for n, _ in RETAKEN.values())
    print("queued readings taken again because the host fell behind the "
          f"sleep kernel (studies/harness.queued_ms): {harness.RETAKES}, "
          f"kept behind after three tries {harness.BEHIND}; "
          + ", ".join(f"{k} {n} ({b} kept behind)" for k, (n, b) in RETAKEN.items())
          + f"; the studies' own {studies}", flush=True)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def _file_to_file(dev, rng, label: str, cover_batches, secret_hw,
                  cfg) -> dict[str, int]:
    """embed_image_in_video(cfg) -> extract_image_from_video (standard
    config) at 1080p on `dev`: the secret comes back pixel-identical with
    SHA3 OK and no residual. cover_batches: (n, 1080, 1920, 3) u8 BGR
    batches, written losslessly (FFV1). Returns the run's launch counts."""
    import numpy as np

    from stegotpu_torch import crypto
    from stegotpu_torch.config import StegoConfig
    from stegotpu_torch.image import save_image_gray
    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.pipeline import (embed_image_in_video,
                                         extract_image_from_video)
    from stegotpu_torch.utils.profiling import StageTimer
    from stegotpu_torch.video import VideoWriter

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        secret = rng.integers(0, 256, secret_hw, dtype=np.uint8)
        save_image_gray(secret, tmp / "secret.png")
        with VideoWriter(tmp / "cover.avi", 30.0, 1920, 1080) as writer:
            for batch in cover_batches:
                writer.write_bgr_batch(batch)
        priv, pub = crypto.generate_keypair(rng)
        crypto.save_keypair_pem(priv, tmp / "priv.pem", tmp / "pub.pem")
        sk.LAUNCHES.clear()
        embed_stages, extract_stages = StageTimer(), StageTimer()
        t0 = time.perf_counter()
        res = embed_image_in_video(
            tmp / "cover.avi", tmp / "secret.png", tmp / "stego.avi",
            crypto.serialize_public_compressed(pub), cfg, batch_frames=8,
            timer=embed_stages, device=dev)
        t1 = time.perf_counter()
        check(res.success and res.residual_bits == 0,
              f"file embed failed: {res.error}")
        out = extract_image_from_video(
            tmp / "stego.avi", crypto.load_private_pem(tmp / "priv.pem"),
            StegoConfig(), tmp / "extracted.png", batch_frames=8,
            timer=extract_stages, device=dev)
        t2 = time.perf_counter()
        counts = sk.LAUNCHES.copy()
        embed_rep, extract_rep = (t.report().replace("\n", "; ")
                                  for t in (embed_stages, extract_stages))
        check(out.success and out.hash_ok, f"file extract failed: {out.error}")
        check(np.array_equal(out.pixels, secret),
              "file extract: secret not pixel-identical")
        print(f"{label}: {res.total_payload_bits} bits in {res.frames_used} "
              f"frames, residual {res.residual_bits}, secret "
              f"{secret_hw[1]}x{secret_hw[0]} pixel-identical, SHA3 ok; host "
              f"clock: embed {t1 - t0:.3f} s ({embed_rep}), "
              f"extract {t2 - t1:.3f} s ({extract_rep}); launches "
              + " ".join(f"{k}={v}" for k, v in counts.items() if v),
              flush=True)
    return counts


def _covers(dev, rng, b: int, h: int, w: int, cover: str):
    """(frames, payload, total) at the phase shapes: a mid-range (16..239)
    or full-range (0..255) uniform cover and a payload ending mid-block,
    with no bit offset (K3 and K4 take none)."""
    import numpy as np
    import torch

    lo, hi = (16, 240) if cover == "mid" else (0, 256)
    frames = torch.from_numpy(rng.integers(lo, hi, (b, h, w), dtype=np.uint8))
    cap = (h // 8) * (w // 8) * NUM_AC
    payload = torch.from_numpy(rng.integers(0, 2, (b, cap), dtype=np.uint8))
    return frames.to(dev), payload.to(dev), b * cap - 13


def _wire(sk, packed, h: int):
    return sk.packed_rows_to_bits(packed, h, packed.shape[-1] * 8, NUM_AC,
                                  sk.pick_stripe(h))


def _fused_vs_plain(dev, rng) -> dict[str, int]:
    """Phase 6: K3, K4 and K5 against their plain versions at the main
    path's shapes. Returns each kernel's max_abs_err: the largest stego
    pixel difference for K3 and K4, and 1 if any K5 bit differed outside
    the envelope (the run fails then)."""
    import torch

    from stegotpu_torch.ops import stripe_kernel as sk

    errs = {"embed_check": 0, "roundtrip_packed": 0, "extract_rows": 0}
    for (h, w) in ((1080, 1920), (768, 1360)):
        for cover in ("mid", "uniform"):
            frames, payload, total = _covers(dev, rng, 8, h, w, cover)
            args = (frames, payload, total, DELTA, NUM_AC)
            s3, bpf3, err3 = sk.embed_and_check_frames(*args)
            s3p, bpf3p, _ = sk.embed_and_check_frames_plain(*args)
            s4, bpf4, p4 = sk.embed_and_extract_frames_packed(*args)
            s4p, bpf4p, _ = sk.embed_and_extract_frames_packed_plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(bpf3, bpf3p) and torch.equal(bpf4, bpf4p),
                  f"K3/K4 bits_per_frame differ from plain at {h}x{w}")
            flips = []
            for key, s_k, s_p in (("embed_check", s3, s3p),
                                  ("roundtrip_packed", s4, s4p)):
                d = (s_k.to(torch.int32) - s_p.to(torch.int32)).abs()
                flips.append((d > 1).double().mean().item())
                errs[key] = max(errs[key], int(d.max().item()))
                check(flips[-1] < STEGO_FLIP_BUDGET,
                      f"{key} vs plain: {flips[-1]:.4%} of pixels differ by "
                      f">1 at {h}x{w}")
            # K4's bits against the plain extract of K4's own stego
            near4 = _near_boundary_t(s4, DELTA, NUM_AC)
            out4 = int(((_wire(sk, p4, h) != _wire(
                sk, sk.extract_frames_packed_plain(s4, DELTA, NUM_AC), h))
                & ~near4).sum())
            check(out4 == 0, f"K4 vs plain: {out4} bits outside the envelope "
                  f"at {h}x{w} ({cover})")
            # K3's count against the plain extract of K3's own stego; the two
            # f32 reads may differ only on valid slots inside the envelope
            count_p = sk.count_wrong_bits(_wire(
                sk, sk.extract_frames_packed_plain(s3, DELTA, NUM_AC), h),
                payload, total)
            valid = torch.arange(payload.numel(), device=dev).reshape(
                payload.shape) < total
            slack = (_near_boundary_t(s3, DELTA, NUM_AC) & valid).sum(1)
            check(bool(((err3 - count_p).abs() <= slack).all()),
                  f"K3 count {err3.tolist()} vs plain {count_p.tolist()} "
                  f"beyond the envelope slack {slack.tolist()} at {h}x{w}")
            check(cover != "mid" or not err3.any(),
                  f"K3 counted wrong bits on a mid-range cover at {h}x{w}")
            # K5 on the cover and on K4's stego against its plain version
            stripe = sk.pick_stripe(h)
            out5 = 0
            for x in (frames, s4):
                r5 = sk.extract_frames_rows(x, DELTA, NUM_AC)
                r5p = sk.extract_frames_rows_plain(x, DELTA, NUM_AC)
                rp = sk._rows_pad(stripe, sk.rows_per_block(NUM_AC))
                pad = torch.arange(r5.shape[1], device=dev) % rp >= \
                    (stripe // 8) * sk.rows_per_block(NUM_AC)
                check(not r5[:, pad].any().item(), "K5 padding rows not zero")
                out5 += int(((sk.rows_to_bits(r5, h, w, NUM_AC, stripe)
                              != sk.rows_to_bits(r5p, h, w, NUM_AC, stripe))
                             & ~_near_boundary_t(x, DELTA, NUM_AC)).sum())
            errs["extract_rows"] = max(errs["extract_rows"], int(out5 > 0))
            check(out5 == 0, f"K5 vs plain: {out5} bits outside the envelope "
                  f"at {h}x{w} ({cover})")
            print(f"phase 6 K3/K4/K5 {h}x{w} B=8 {cover}: bpf identical; >1 px "
                  f"K3 {flips[0]:.5%} K4 {flips[1]:.5%}; K3 count "
                  f"{int(err3.sum())} vs plain extract of its stego "
                  f"{int(count_p.sum())} (envelope slack {int(slack.sum())}); "
                  "K4 and K5 bits within the envelope; K5 padding rows zero",
                  flush=True)
    return errs


# phase 7's odd shapes (B, H, W, num_ac, fraction of the batch's slots
# the payload fills): W % 16 == 8, payloads ending mid-frame, num_ac 1, 7,
# 10, 30 and 63 (rn 1-8); those of tests/test_torch_cuda.py's
# test_zero_tolerance_identities and of phase 12
IDENTITY_ODD = [(3, 40, 136, 1, 0.47), (3, 48, 1048, 63, 0.53),
                (3, 48, 1048, 10, 0.7), (4, 96, 1360, 7, 0.3),
                (2, 64, 64, 63, 0.5), (2, 768, 1360, 30, 1.0)]


def _identities_and_harness(dev, rng, with_cv2: bool) -> dict[str, int]:
    """Phase 7: the zero-tolerance identities kernel against kernel, then
    the exactness harness (ops/exactness.py), the path that runs K4 and K5.

    K3's, K4's and K6's stego and bits per frame are K1's, K4's packed
    bits K2's reading of K4's stego, K6's rows K5's reading of K6's stego,
    K5 K2 lane for lane and K9 full K5 byte for byte (on the cover and on
    K1's stego), and K3's count a count from K2 on K3's stego: at 1920x1080
    and 1360x768, B=8, both covers, at delta 20 (K1-K6 in ArithHopper) and
    2^-11 (ArithHopperSmallDelta; K9 keeps ArithCvt at both, the extract
    side's witness across the spellings), then on IDENTITY_ODD at delta
    20, 2^-11, 0 and -4. Returns the K4 and K5 launches of the harness's
    run, and those of the wire-order unpack kernel."""
    import numpy as np
    import torch

    from stegotpu_torch.ops import exactness
    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.studies import extract_ablation as ea

    spread = torch.arange(8, dtype=torch.uint8, device=dev)

    def identities(frames, payload, total, delta, num_ac, at: str) -> int:
        """Every identity on one input; returns K3's count of wrong bits."""
        args = (frames, payload, total, delta, num_ac)
        s1, bpf1 = sk.embed_frames(*args)
        s3, bpf3, err3 = sk.embed_and_check_frames(*args)
        s4, bpf4, p4 = sk.embed_and_extract_frames_packed(*args)
        s6, bpf6, r6 = sk.embed_and_extract_frames_rows(*args)
        for k, s_k, bpf_k in (("K3", s3, bpf3), ("K4", s4, bpf4),
                              ("K6", s6, bpf6)):
            check(torch.equal(s_k, s1), f"{k} stego != K1 stego at {at}")
            check(torch.equal(bpf_k, bpf1), f"{k} bpf != K1 bpf at {at}")
        check(torch.equal(p4, sk.extract_frames_packed(s4, delta, num_ac)),
              f"K4 bits != K2 of K4's stego at {at}")
        check(torch.equal(r6, sk.extract_frames_rows(s6, delta, num_ac)),
              f"K6 rows != K5 of K6's stego at {at}")
        for x in (frames, s1):
            r5 = sk.extract_frames_rows(x, delta, num_ac)
            p2 = sk.extract_frames_packed(x, delta, num_ac)
            check(torch.equal(r5, ((p2[..., None] >> spread) & 1)
                              .reshape(r5.shape)),
                  f"K5 lanes != K2 bytes at {at}")
            check(torch.equal(ea.ablate(x, delta, num_ac, "full"), r5),
                  f"K9 full != K5 at {at}")
        count = sk.count_wrong_bits(sk.extract_frames(s3, delta, num_ac),
                                    payload, total)
        check(torch.equal(err3, count),
              f"K3 count {err3.tolist()} != K2 count {count.tolist()} at {at}")
        if delta <= 0:
            check(torch.equal(s1, frames) and not r6.any(),
                  f"delta {delta}: not a passthrough at {at}")
        return int(count.sum())

    for delta in (DELTA, 2.0**-11):
        for (h, w) in ((1080, 1920), (768, 1360)):
            for cover in ("mid", "uniform"):
                frames, payload, total = _covers(dev, rng, 8, h, w, cover)
                n = identities(frames, payload, total, delta, NUM_AC,
                               f"{h}x{w} {cover} delta {delta}")
                print(f"phase 7 identities {h}x{w} B=8 {cover} delta "
                      f"{delta}: K3, K4, K6 stego and bpf == K1's; K4 bits "
                      "== K2(K4 stego); K6 rows == K5(K6 stego); K5 == K2 "
                      "lane for lane; K9 full == K5; K3 count == K2 count "
                      f"({n})", flush=True)
    for b, h, w, num_ac, frac in IDENTITY_ODD:
        cap = (h // 8) * (w // 8) * num_ac
        frames = torch.from_numpy(
            rng.integers(16, 240, (b, h, w), dtype=np.uint8)).to(dev)
        payload = torch.from_numpy(
            rng.integers(0, 2, (b, cap), dtype=np.uint8)).to(dev)
        total = int(frac * b * cap) - 5
        for delta in (DELTA, 2.0**-11, 0.0, -4.0):
            identities(frames, payload, total, delta, num_ac,
                       f"B={b} {h}x{w} num_ac={num_ac} delta {delta}")
        print(f"phase 7 identities odd shape B={b} {h}x{w} num_ac={num_ac} "
              f"(W%16={w % 16}, payload ends at {total} of {b * cap} bits): "
              "every identity above at delta 20, 2^-11, 0, -4", flush=True)

    sk.LAUNCHES.clear()
    rows = [exactness.quick_exactness_check(device=dev)]
    for content in ("noise", "compressed") if with_cv2 else ("noise",):
        rows += exactness.check_config(4, 1080, 1920, 10, [DELTA],
                                       np.random.default_rng(42),
                                       verbose=False, content=content,
                                       device=dev)
    launches = {k: sk.LAUNCHES[f"stegotpu_qim_{k}"]
                for k in ("roundtrip_packed", "extract_rows", "unpack_packed")}
    for row in rows:
        check(exactness.row_ok(row), f"exactness row failed: {row}")
        print(f"phase 7 exactness {row['w']}x{row['h']} B={row['batch']} "
              f"delta {row['delta']} {row['content']}: row_ok; "
              + " ".join(f"{k}={row[k]}" for k in exactness.EXACT_KEYS)
              + f" roundtrip_errors {row['roundtrip_errors_pallas']}/"
              f"{row['roundtrip_errors_xla']} cover boundary flips "
              f"{row['extract_mismatch_cover']}", flush=True)
    check(all(v > 0 for v in launches.values()),
          f"the exactness harness did not launch K4, K5 and the unpack "
          f"kernel: {launches}")
    print("phase 7 harness launches: " + " ".join(
        f"stegotpu_qim_{k}={v}" for k, v in launches.items()), flush=True)
    return launches


def _tf32_sentinel(dev) -> None:
    """Phase 8: with TF32 allowed around the oracle only, the 1080p noise
    row must fail row_ok; with the flag restored, the same row must pass."""
    import functools

    import numpy as np
    import torch

    from stegotpu_torch.ops import exactness, qim

    def under_tf32(fn):
        @functools.wraps(fn)
        def call(*a, **k):
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return fn(*a, **k)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return call

    def row():
        return exactness.check_config(4, 1080, 1920, 10, [DELTA],
                                      np.random.default_rng(42),
                                      verbose=False, device=dev)[0]

    oracle = (qim.embed_frames, qim.extract_frames)
    qim.embed_frames, qim.extract_frames = map(under_tf32, oracle)
    try:
        bad = row()
    finally:
        qim.embed_frames, qim.extract_frames = oracle
    good = row()
    check(not exactness.row_ok(bad),
          f"TF32 sentinel: the row passed with a TF32 oracle: {bad}")
    check(exactness.row_ok(good), f"TF32 sentinel: the restored row failed: "
          f"{good}")
    keys = ("extract_mismatch_cover_nonboundary",
            "extract_mismatch_stego_nonboundary", "roundtrip_errors_xla")
    print("phase 8 TF32 sentinel 1920x1080 B=4 noise delta 20: TF32 oracle "
          "fails row_ok (" + " ".join(f"{k}={bad[k]}" for k in keys)
          + "); restored it passes (" + " ".join(f"{k}={good[k]}" for k in keys)
          + f"); allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)


def _letterboxed(rng, b: int, bar: int = 136, h: int = 1080, w: int = 1920):
    """(b, h, w) u8: black bars of `bar` rows above and below a picture of
    luma 60..195 (136 rows = 17 block rows: no block straddles the edge)."""
    import numpy as np

    frames = np.zeros((b, h, w), np.uint8)
    frames[:, bar:-bar] = rng.integers(60, 196, (b, h - 2 * bar, w),
                                       dtype=np.uint8)
    return frames


def _verified_path(dev, rng, files: bool) -> dict[str, int]:
    """Phase 9: the verified embed at full width, array level and (where
    the host libraries are installed) file to file. Returns K3's launches
    on that path."""
    import numpy as np
    import torch

    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.ops.verified import embed_frames_verified_fast

    b, h, w = 8, 1080, 1920
    cap = (h // 8) * (w // 8) * NUM_AC
    payload = torch.from_numpy(
        rng.integers(0, 2, (b, cap), dtype=np.uint8)).to(dev)
    total = b * cap
    mid = torch.from_numpy(
        rng.integers(16, 240, (b, h, w), dtype=np.uint8)).to(dev)
    boxed = torch.from_numpy(_letterboxed(rng, b)).to(dev)
    plain, _ = sk.embed_frames(boxed, payload, total, DELTA, NUM_AC)
    lost = int((sk.extract_frames(plain, DELTA, NUM_AC) != payload).sum())
    check(lost > 0, "test premise: the plain embed must lose bits on the "
          "letterboxed cover")

    sk.LAUNCHES.clear()
    t0 = time.perf_counter()
    s_mid, bpf_mid, r_mid = embed_frames_verified_fast(mid, payload, total,
                                                       DELTA, NUM_AC)
    after_mid = sk.LAUNCHES["stegotpu_qim_embed_check"]
    s_box, bpf_box, r_box = embed_frames_verified_fast(boxed, payload, total,
                                                       DELTA, NUM_AC)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"embed_check": sk.LAUNCHES["stegotpu_qim_embed_check"]}
    check(after_mid == 1 and int(r_mid) == 0
          and torch.equal(bpf_mid, bpf_box),
          f"verified fast branch: launches {after_mid}, residual {int(r_mid)}")
    check(torch.equal(s_mid, sk.embed_frames(mid, payload, total, DELTA,
                                             NUM_AC)[0]),
          "verified fast branch: stego is not K3's (== K1's)")
    check(torch.equal(sk.extract_frames(s_mid, DELTA, NUM_AC), payload),
          "verified fast branch: payload not recovered")
    check(int(r_box) == 0, f"verified repair: residual {int(r_box)}")
    check(not torch.equal(s_box, plain), "verified repair branch did not run")
    check(torch.equal(sk.extract_frames(s_box, DELTA, NUM_AC), payload),
          "verified repair: K2 does not recover the payload")
    print(f"phase 9 verified 1920x1080 B=8: mid cover fast branch residual 0, "
          f"stego == K1's, payload exact; letterboxed cover (bars 136 rows): "
          f"plain K1 embed loses {lost} bits, repair branch residual 0, K2 "
          f"recovers all {total} bits; stegotpu_qim_embed_check="
          f"{launches['embed_check']}; {seconds:.3f} s host clock", flush=True)
    if files:
        from stegotpu_torch.config import StegoConfig

        n = _file_to_file(
            dev, rng, "phase 9 verified file-to-file 1080p letterboxed",
            [np.repeat(_letterboxed(rng, 6)[..., None], 3, axis=-1)],
            (240, 320),
            StegoConfig(verified_embed=True))["stegotpu_qim_embed_check"]
        check(n > 0, "the verified file embed did not launch K3")
        launches["embed_check"] += n
    else:
        print("phase 9 verified file-to-file: skipped (host libraries)",
              flush=True)
    return launches


def _variants_and_metrics(dev, rng) -> tuple[dict[str, int], dict[str, int]]:
    """Phase 10: K6 against K1, K5 and K4 (zero tolerance) and against its
    plain version at 1920x1080 and 1360x768; K7 and K8 against their plain
    versions at 1920x1080 and 1280x720, with a bit offset and a payload
    that ends in the batch; both covers. Then the path of the three
    kernels: the fused (K6) and Kronecker (K7 + K8) round trips at 1080p,
    B=8, scored by roundtrip_metrics, then the oracle's
    embed_extract_evaluate and the device PSNR/SSIM against the host's.
    K7 and K8 are held to their witness with zero tolerance too
    (_kron_witness), which then runs its own path, the kron_ab study.
    Returns each kernel's max_abs_err (largest stego pixel difference for
    K6, K7 and K7's witness; 1 if a K8 bit, or its witness's, differed
    outside the envelope) and its launches on the path."""
    import numpy as np
    import torch

    from stegotpu_torch.metrics import psnr_batch, psnr_np, ssim_batch, ssim_np
    from stegotpu_torch.ops import qim
    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.ops.experimental import kron_kernel as kk
    from stegotpu_torch.ops.experimental.qim_fast import build_state_plane
    from stegotpu_torch.studies import kron_ab

    errs = {"roundtrip_rows": 0, "kron_embed": 0, "kron_extract": 0,
            "kron_embed_smem": 0, "kron_extract_smem": 0}
    for (h, w) in ((1080, 1920), (768, 1360)):
        for cover in ("mid", "uniform"):
            frames, payload, total = _covers(dev, rng, 8, h, w, cover)
            args = (frames, payload, total, DELTA, NUM_AC)
            s6, bpf6, rows6 = sk.embed_and_extract_frames_rows(*args)
            s1, bpf1 = sk.embed_frames(*args)
            _, _, p4 = sk.embed_and_extract_frames_packed(*args)
            stripe = sk.pick_stripe(h)
            bits6 = sk.rows_to_bits(rows6, h, w, NUM_AC, stripe)
            check(torch.equal(s6, s1) and torch.equal(bpf6, bpf1),
                  f"K6 stego != K1 stego at {h}x{w} ({cover})")
            check(torch.equal(rows6, sk.extract_frames_rows(s6, DELTA, NUM_AC)),
                  f"K6 rows != K5(K6 stego) at {h}x{w} ({cover})")
            check(torch.equal(bits6, _wire(sk, p4, h)),
                  f"K6 bits != K4 bits unpacked at {h}x{w} ({cover})")
            s6p, bpf6p, _ = sk.embed_and_extract_frames_rows_plain(*args)
            bits6p = sk.rows_to_bits(sk.extract_frames_rows_plain(
                s6, DELTA, NUM_AC), h, w, NUM_AC, stripe)
            torch.cuda.synchronize()
            check(torch.equal(bpf6, bpf6p), f"K6 bpf differ at {h}x{w}")
            d = (s6.to(torch.int32) - s6p.to(torch.int32)).abs()
            flips = (d > 1).double().mean().item()
            errs["roundtrip_rows"] = max(errs["roundtrip_rows"], int(d.max()))
            check(flips < STEGO_FLIP_BUDGET,
                  f"K6 vs plain: {flips:.4%} of pixels differ by >1 at {h}x{w}")
            outside = int(((bits6 != bits6p)
                           & ~_near_boundary_t(s6, DELTA, NUM_AC)).sum())
            check(outside == 0, f"K6 vs plain: {outside} bits outside the "
                  f"envelope at {h}x{w} ({cover})")
            valid = torch.arange(payload.numel(), device=dev).reshape(
                payload.shape) < total
            exact = None
            if cover == "mid":
                exact = torch.equal(bits6[valid], payload[valid])
                check(exact, f"K6 payload not recovered at {h}x{w}")
            print(f"phase 10 K6 {h}x{w} B=8 {cover}: stego == K1 stego, rows "
                  "== K5(K6 stego), bits == K4 bits unpacked, byte for byte; "
                  f"vs plain: bpf identical, >1 px {flips:.5%}, max |diff| "
                  f"{int(d.max())}, bits within the envelope; payload exact "
                  f"{exact}", flush=True)

    for (h, w) in ((1080, 1920), (720, 1280)):
        for cover in ("mid", "uniform"):
            lo, hi = (16, 240) if cover == "mid" else (0, 256)
            b, offset = 8, 4321
            frames = torch.from_numpy(
                rng.integers(lo, hi, (b, h, w), dtype=np.uint8)).to(dev)
            cap = (h // 8) * (w // 8) * NUM_AC
            total = offset + int(0.6 * b * cap)
            payload = torch.from_numpy(
                rng.integers(0, 2, (b, cap), dtype=np.uint8)).to(dev)
            args = (frames, payload, total, DELTA, NUM_AC, offset)
            s7, bpf7 = kk.embed_frames_kron(*args)
            s7p, bpf7p = kk.embed_frames_kron_plain(*args)
            s7w, _ = kron_ab.embed_frames_kron_smem(*args)
            torch.cuda.synchronize()
            check(torch.equal(bpf7, bpf7p), f"K7 bpf differ at {h}x{w}")
            d = (s7.to(torch.int32) - s7p.to(torch.int32)).abs()
            flips = (d > 1).double().mean().item()
            errs["kron_embed"] = max(errs["kron_embed"], int(d.max()))
            errs["kron_embed_smem"] = max(errs["kron_embed_smem"], int(
                (s7w.to(torch.int32) - s7p.to(torch.int32)).abs().max()))
            check(flips < STEGO_FLIP_BUDGET,
                  f"K7 vs plain: {flips:.4%} of pixels differ by >1 at {h}x{w}")
            never = build_state_plane(payload, total, h, w, NUM_AC,
                                      offset) == 3
            check(bool(never.any()) and torch.equal(s7[never], frames[never]),
                  f"K7: blocks never entered not passed through at {h}x{w}")
            counts = []
            for x in (frames, s7):
                b8 = kk.extract_frames_kron(x, DELTA, NUM_AC)
                b8p = kk.extract_frames_kron_plain(x, DELTA, NUM_AC)
                diff = b8 != b8p
                far = ~_near_boundary_t(x, DELTA, NUM_AC)
                outside = int((diff & far).sum())
                errs["kron_extract"] = max(errs["kron_extract"], int(outside > 0))
                errs["kron_extract_smem"] = max(
                    errs["kron_extract_smem"], int(bool(
                        ((kron_ab.extract_frames_kron_smem(x, DELTA, NUM_AC)
                          != b8p) & far).any())))
                check(outside == 0, f"K8 vs plain: {outside} bits outside the "
                      f"envelope at {h}x{w} ({cover})")
                counts.append(int(diff.sum()))
            n = total - offset
            exact = None
            if cover == "mid":
                exact = torch.equal(b8.reshape(-1)[:n], payload.reshape(-1)[:n])
                check(exact, f"K8 payload not recovered at {h}x{w}")
            print(f"phase 10 K7/K8 {h}x{w} B=8 {cover}: bpf identical; >1 px "
                  f"{flips:.5%}, max |diff| {int(d.max())}; "
                  f"{int(never.sum())} px never entered byte-identical; K8 "
                  f"bits differing from plain {counts[0]} (cover) "
                  f"{counts[1]} (stego), all within the envelope; payload "
                  f"exact {exact}", flush=True)

    # the path of K6, K7 and K8: round trips scored by their metrics
    frames, payload, total = _covers(dev, rng, 8, 1080, 1920, "mid")
    args = (frames, payload, total, DELTA, NUM_AC)
    sk.LAUNCHES.clear()
    t0 = time.perf_counter()
    s6, _, ex6 = sk.embed_and_extract_frames_fused(*args)
    m6 = qim.roundtrip_metrics(frames, s6, ex6, payload, total)
    s7, _, ex7 = kk.embed_and_extract_frames_kron(*args)
    m7 = qim.roundtrip_metrics(frames, s7, ex7, payload, total)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    entries = {"roundtrip_rows": "stegotpu_qim_roundtrip_rows",
               "kron_embed": "stegotpu_kron_embed",
               "kron_extract": "stegotpu_kron_extract",
               "roundtrip_eval": "stegotpu_qim_eval"}
    launches = {k: sk.LAUNCHES[e] for k, e in entries.items()}
    check(all(v > 0 for v in launches.values()),
          f"the round trips did not launch K6, K7, K8 and the evaluation "
          f"kernel: {launches}")
    # the evaluation kernel against its plain version, and its PSNR against
    # the exact one (float64 sums of integers), at most a float32 rounding
    # off; then on a damaged copy of K6's bits, where the count is not 0
    gaps = []
    for s, ex, m in ((s6, ex6, m6), (s7, ex7, m7)):
        want = qim.roundtrip_metrics_plain(frames, s, ex, payload, total)
        check(int(m["bit_errors"]) == int(want["bit_errors"])
              and int(m["payload_bits"]) == int(want["payload_bits"]),
              "evaluation kernel: bit errors or payload bits != plain")
        exact = _exact_psnr(frames, s)
        gaps.append(abs(float(m["psnr_db"]) - exact))
        check(gaps[-1] <= np.spacing(np.float32(exact)),
              f"evaluation kernel: PSNR {float(m['psnr_db'])} is more than "
              f"a float32 rounding off the exact {exact}")
    bad_errors, bad_n, gap = _eval_against_plain(frames, s6, ex6, payload,
                                                 total, "1920x1080 B=8")
    gaps.append(gap)
    errs["roundtrip_eval"] = max(gaps)
    _, bpf_o, _, m_o = qim.embed_extract_evaluate(*args)
    for label, m in (("K6", m6), ("kron", m7), ("oracle", m_o)):
        check(int(m["bit_errors"]) == 0 and int(m["payload_bits"]) == total,
              f"{label} round trip: {int(m['bit_errors'])} bit errors, "
              f"{int(m['payload_bits'])} payload bits of {total}")
        check(m["psnr_db"].device == frames.device,
              f"{label} metrics are not on the card")
    check(int(bpf_o.sum()) == total, "oracle round trip: bits per frame")
    a, s = frames[:1], s6[:1]
    p_dev, p_host = float(psnr_batch(a, s)[0]), psnr_np(a[0].cpu().numpy(),
                                                        s[0].cpu().numpy())
    q_dev, q_host = float(ssim_batch(a, s)[0]), ssim_np(a[0].cpu().numpy(),
                                                        s[0].cpu().numpy())
    # f32 sums on the card against float64 on the host
    check(abs(p_dev - p_host) < 1e-3 and abs(q_dev - q_host) < 1e-4,
          f"device PSNR/SSIM {p_dev}/{q_dev} vs host {p_host}/{q_host}")
    print(f"phase 10 path 1920x1080 B=8 mid: bit_errors K6 "
          f"{int(m6['bit_errors'])} kron {int(m7['bit_errors'])} oracle "
          f"{int(m_o['bit_errors'])} of {total} payload bits; psnr_db K6 "
          f"{float(m6['psnr_db']):.4f} kron {float(m7['psnr_db']):.4f} oracle "
          f"{float(m_o['psnr_db']):.4f}; frame 0 PSNR {p_dev:.6f} dB (host "
          f"{p_host:.6f}) SSIM {q_dev:.7f} (host {q_host:.7f}); "
          + " ".join(f"{e}={launches[k]}" for k, e in entries.items())
          + "; evaluation kernel "
          f"== plain in bits (damaged K6 bits: {bad_errors} errors of "
          f"{bad_n} payload bits), PSNR off the exact by at most "
          f"{max(gaps):.3g} dB; {seconds:.3f} s host clock", flush=True)
    launches.update(_kron_witness(dev, rng))
    return errs, launches


# phase 10's shapes of K7/K8 against their witness (B, H, W): 1080p and
# 768p at B=8, then odd ones: B=1 at 1080p (126.6 tiles of 256 blocks),
# 720p and the smallest frame the kernels take (8x128, 16 blocks), and a
# batch of 720 blocks whose frames straddle tiles
KRON_WITNESS_SHAPES = [(8, 1080, 1920), (8, 768, 1280), (1, 1080, 1920),
                       (1, 720, 1280), (1, 8, 128), (3, 40, 384)]


def _kron_witness(dev, rng) -> dict[str, int]:
    """K7 and K8 against their witness (studies/kron_ab.py, their first
    CUDA version) with zero tolerance: stego, bits per frame and K8's bits
    of the cover and the stego, on KRON_WITNESS_SHAPES at delta 20 and
    2^-11, num_ac 1, 10 and 63, payloads filling every slot or ending
    mid-block or mid-frame, at bit offsets 0 and 13. Then the witness's
    path, the kron_ab study at 1080p, B=8 and 128. Returns the witness's
    launches on that path."""
    import numpy as np
    import torch

    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.studies import kron_ab

    for b, h, w in KRON_WITNESS_SHAPES:
        frames = torch.from_numpy(
            rng.integers(16, 240, (b, h, w), dtype=np.uint8)).to(dev)
        checked = 0
        for num_ac in (1, 10, 63):
            cap = (h // 8) * (w // 8) * num_ac
            payload = torch.from_numpy(
                rng.integers(0, 2, (b, cap), dtype=np.uint8)).to(dev)
            ends = {"full": b * cap, "mid-block": b * cap - num_ac // 2 - 1,
                    "mid-frame": cap // 2 + 3}
            for delta in (DELTA, 2.0**-11):
                for end, n in ends.items():
                    for offset in (0, 13):
                        check(kron_ab.same_bytes(frames, payload, offset + n,
                                                 delta, num_ac, offset),
                              f"K7/K8 != their witness at B={b} {h}x{w} "
                              f"num_ac={num_ac} delta {delta} payload {end} "
                              f"offset {offset}")
                        checked += 1
        print(f"phase 10 K7/K8 == witness B={b} {h}x{w}: stego, bpf and K8 "
              f"bits of cover and stego byte for byte in {checked} cases "
              "(num_ac 1/10/63, delta 20 and 2^-11, payload full, ending "
              "mid-block or mid-frame, offset 0 and 13)", flush=True)
    sk.LAUNCHES.clear()
    rows = _run_main("kron_ab", kron_ab.main, ["--iters", "10"], phase=10)
    launches = {k: sk.LAUNCHES[f"stegotpu_{k}"]
                for k in ("kron_embed_smem", "kron_extract_smem")}
    check(all(r["ok"] for r in rows if "check" in r),
          f"kron_ab: K7/K8 != their witness: {rows}")
    check(all(v > 0 for v in launches.values()),
          f"the kron_ab study did not launch the witness: {launches}")
    print("phase 10 kron_ab path: " + ", ".join(
        f"{r['kernel']} B={r['batch']} {r['new_ms']:.4f} ms against the "
        f"witness's {r['witness_ms']:.4f} ({r['speedup']:.2f}x)"
        for r in rows if "kernel" in r)
        + "; " + " ".join(f"stegotpu_{k}={v}" for k, v in launches.items()),
        flush=True)
    return launches


def _ablation_near(frames, delta: float, num_ac: int, stripe: int):
    """K9's tolerance masks in K5's layout, from float64 coefficients of
    the frames on their device: (near a rounding boundary of round(t/delta)
    for the vertical coefficients t of no_horiz, near an integer for the
    slot-row coefficients y of no_qim), each within the exactness
    envelope."""
    import numpy as np
    import torch

    from stegotpu_torch.ops.dct import blockify, dct_matrix
    from stegotpu_torch.studies.extract_ablation import _lanes_to_rows

    b, h, w = frames.shape
    rn = num_ac // 8 + 1
    m = torch.tensor(dct_matrix(8, np.float64), device=frames.device)
    t = m[:rn] @ blockify(frames.to(torch.float64)).reshape(b, -1, 8, 8)
    y = t @ m.T
    r = t / delta
    near_t = (r - torch.floor(r) - 0.5).abs() * delta <= TOL_ABS + TOL_REL * t.abs()
    near_y = (y - torch.round(y)).abs() <= TOL_ABS + TOL_REL * y.abs()
    return tuple(_lanes_to_rows(x.to(torch.uint8), h, w, stripe).bool()
                 for x in (near_t, near_y))


def _run_main(label: str, main, argv: list[str], rc_want: int = 0,
              phase: int = 11) -> list[dict]:
    """Run a study's main(argv), capturing its standard output; it must
    exit `rc_want` and print JSON rows, one to a line. Returns the rows."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    try:
        rows = [json.loads(ln) for ln in lines]
    except json.JSONDecodeError as e:
        raise SmokeFailure(f"{label}: a row does not parse: {e}: {lines}")
    check(rc == rc_want and len(rows) >= 2
          and all(isinstance(r, dict) for r in rows),
          f"{label} exited {rc} with rows {rows}")
    for row in rows:
        print(f"phase {phase} {label} ({' '.join(argv)}) row: "
              f"{json.dumps(row)}", flush=True)
    print(f"phase {phase} {label}: {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f} s host clock", flush=True)
    return rows


def _studies(dev, rng, gpu: str, sets: list):
    """Phase 11: the study kernels K9-K12 (stegotpu_torch.studies).

    At 1920x1080 and 1360x768, B=8, on the mid and uniform covers, the
    zero-tolerance identities K9 full == K5, K10 == K1, K11 == K4 (stego,
    bits per frame, packed; at delta 20 and 2^-11), K12 copy == frames
    and dmaspec's packed ==
    payload_to_rows_packed, and every kernel against its plain version:
    full, full_notrunc and K11's bits within the exactness envelope,
    no_horiz's bits within it on the vertical coefficients, no_qim's bytes
    equal or off by 1 (mod 256) where the coefficient lies within the
    envelope of an integer, io_only, io_f4, copy and dmaspec equal, and
    K10's and K11's stego within the flip budget. Then each kernel's time
    and its plain version's at 1920x1080, B=8, with Tensor.copy_ beside
    K12 copy, rotating over phase 4's input `sets`. Then the path: every
    study's main at 1080p with a small batch and iteration count, and one
    roofline pass at B=128, with the launch counters set to 0 before and
    read after; device_roofline's timeline must show a K1 or K4 call as
    one kernel, a K3 call must be its kernel behind at most one memset,
    and a K11 and a K13 call one kernel each with nothing beside it.

    Returns (max_abs_err, launches on the path, per-call ms, queued ms,
    library ms) by kernel name."""
    import numpy as np
    import torch

    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.studies import (ab_packed_payload, device_roofline,
                                        dualchain_r5, extract_ablation,
                                        harness, roofline_r4, stripe_cap)

    ea, ab, dc, rr = extract_ablation, ab_packed_payload, dualchain_r5, \
        roofline_r4
    names = [f"ablation_{v}" for v in ABLATIONS] + [
        "embed_packedin", "roundtrip_dual", "copy", "dmaspec"]
    errs = dict.fromkeys(names, 0)
    rn = sk.rows_per_block(NUM_AC)
    for (h, w) in ((1080, 1920), (768, 1360)):
        for cover in ("mid", "uniform"):
            frames, payload, total = _covers(dev, rng, 8, h, w, cover)
            args = (frames, payload, total, DELTA, NUM_AC)
            stripe = sk.pick_stripe(h)
            rp = sk._rows_pad(stripe, rn)
            pad = torch.arange(rp * (h // stripe), device=dev) % rp >= \
                (stripe // 8) * rn

            # K9 against K5 and against its plain version
            x32 = frames.to(torch.float32)
            out = {v: ea.ablate(x32 if v == "full_notrunc" else frames, DELTA,
                                NUM_AC, v) for v in ABLATIONS}
            check(torch.equal(out["full"], sk.extract_frames_rows(
                frames, DELTA, NUM_AC)), f"K9 full != K5 at {h}x{w} ({cover})")
            check(torch.equal(out["full_notrunc"], out["full"]),
                  f"K9 full_notrunc != full at {h}x{w} ({cover})")
            near_t, near_y = _ablation_near(frames, DELTA, NUM_AC, stripe)
            near_slot = _near_boundary_t(frames, DELTA, NUM_AC)
            notes = []
            for v in ABLATIONS:
                got = out[v]
                want = ea.ablate_plain(x32 if v == "full_notrunc" else frames,
                                       DELTA, NUM_AC, v)
                torch.cuda.synchronize()
                check(got.shape == want.shape, f"K9 {v} shape {got.shape}")
                if v.startswith("io"):
                    check(torch.equal(got, want), f"K9 {v} != plain at {h}x{w}")
                    notes.append(f"{v} equal")
                    continue
                check(not got[:, pad].any().item(),
                      f"K9 {v} padding rows not zero")
                if v in ("full", "full_notrunc"):
                    diff = (sk.rows_to_bits(got, h, w, NUM_AC, stripe)
                            != sk.rows_to_bits(want, h, w, NUM_AC, stripe))
                    outside = int((diff & ~near_slot).sum())
                    errs[f"ablation_{v}"] = max(errs[f"ablation_{v}"],
                                                int(outside > 0))
                elif v == "no_horiz":
                    diff = got != want
                    outside = int((diff & ~near_t).sum())
                    errs["ablation_no_horiz"] = max(errs["ablation_no_horiz"],
                                                    int(outside > 0))
                else:  # no_qim: the truncating cast steps at integers
                    step = (got.to(torch.int32) - want.to(torch.int32)) % 256
                    diff = step != 0
                    outside = int((diff & ~near_y).sum()) + int(
                        (diff & (step != 1) & (step != 255)).sum())
                    if diff.any():
                        errs["ablation_no_qim"] = max(
                            errs["ablation_no_qim"], 1)
                check(outside == 0, f"K9 {v} vs plain: {outside} lanes outside "
                      f"the tolerance at {h}x{w} ({cover})")
                notes.append(f"{v} {int(diff.sum())} differ, all inside")
            del out, x32

            # K10 against K1 and its plain version
            packed = sk.payload_to_rows_packed(payload, h, w, NUM_AC, stripe)
            s1, bpf1 = sk.embed_frames(*args)
            s10, bpf10 = ab.embed_frames_packedin(frames, packed, total, DELTA,
                                                  NUM_AC)
            check(torch.equal(s10, s1) and torch.equal(bpf10, bpf1),
                  f"K10 != K1 at {h}x{w} ({cover})")
            s10p, bpf10p = ab.embed_frames_packedin_plain(frames, packed,
                                                          total, DELTA, NUM_AC)
            torch.cuda.synchronize()
            d10 = (s10.to(torch.int32) - s10p.to(torch.int32)).abs()
            flips10 = (d10 > 1).double().mean().item()
            errs["embed_packedin"] = max(errs["embed_packedin"], int(d10.max()))
            check(torch.equal(bpf10, bpf10p) and flips10 < STEGO_FLIP_BUDGET,
                  f"K10 vs plain: {flips10:.4%} px differ by >1 at {h}x{w}")

            # K11 against K4 (both spellings: delta 2^-11 takes
            # ArithHopperSmallDelta) and its plain version
            for d in (2.0**-11, DELTA):
                a = (frames, payload, total, d, NUM_AC)
                s4, bpf4, p4 = sk.embed_and_extract_frames_packed(*a)
                s11, bpf11, p11 = dc.dual_roundtrip_packed(*a)
                check(torch.equal(s11, s4) and torch.equal(bpf11, bpf4)
                      and torch.equal(p11, p4),
                      f"K11 != K4 at {h}x{w} ({cover}) delta {d}")
            s11p, bpf11p, _ = dc.dual_roundtrip_packed_plain(*args)
            torch.cuda.synchronize()
            d11 = (s11.to(torch.int32) - s11p.to(torch.int32)).abs()
            flips11 = (d11 > 1).double().mean().item()
            errs["roundtrip_dual"] = max(errs["roundtrip_dual"], int(d11.max()))
            check(torch.equal(bpf11, bpf11p) and flips11 < STEGO_FLIP_BUDGET,
                  f"K11 vs plain: {flips11:.4%} px differ by >1 at {h}x{w}")
            out11 = int(((_wire(sk, p11, h) != _wire(
                sk, sk.extract_frames_packed_plain(s11, DELTA, NUM_AC), h))
                & ~_near_boundary_t(s11, DELTA, NUM_AC)).sum())
            check(out11 == 0, f"K11 vs plain: {out11} bits outside the "
                  f"envelope at {h}x{w} ({cover})")

            # K12 against the frames, the packed payload and its plain version
            c = rr.copy_frames(frames)
            sd, pd = rr.dmaspec(frames, payload, NUM_AC)
            sdp, pdp = rr.dmaspec_plain(frames, payload, NUM_AC)
            torch.cuda.synchronize()
            check(torch.equal(c, frames) and torch.equal(c, rr.copy_frames_plain(
                frames)), f"K12 copy != frames at {h}x{w}")
            check(torch.equal(sd, frames) and torch.equal(pd, packed)
                  and torch.equal(sd, sdp) and torch.equal(pd, pdp),
                  f"K12 dmaspec != (frames, payload_to_rows_packed) at {h}x{w}")
            print(f"phase 11 K9-K12 {h}x{w} B=8 {cover}: K9 full == K5 and "
                  "full_notrunc == full byte for byte; vs plain: "
                  + ", ".join(notes) + "; K10 == K1 (stego, bpf) byte for "
                  f"byte, vs plain >1 px {flips10:.5%} max |diff| "
                  f"{int(d10.max())}; K11 == K4 (stego, bpf, packed) byte for "
                  f"byte at delta 20 and 2^-11, vs plain >1 px "
                  f"{flips11:.5%}, bits within the "
                  "envelope; K12 copy == frames, dmaspec == (frames, "
                  "payload_to_rows_packed)", flush=True)

    # times at 1920x1080, B=8, rotating over phase 4's input sets, so
    # that each call reads its inputs from HBM: not a path's run
    counts = sk.LAUNCHES.copy()
    stripe = sk.pick_stripe(1080)
    # (frames, f32 frames, packed payload, payload, total, copy_ target)
    sets = [(f, f.to(torch.float32),
             sk.payload_to_rows_packed(p, 1080, 1920, NUM_AC, stripe), p, t,
             torch.empty_like(f)) for f, p, t in sets]
    calls = {}
    for v in ABLATIONS:
        x = int(v == "full_notrunc")  # full_notrunc reads the f32 frames
        calls[f"ablation_{v}"] = (
            lambda *s, v=v, x=x: ea.ablate(s[x], DELTA, NUM_AC, v))
        calls[f"ablation_{v}_plain"] = (
            lambda *s, v=v, x=x: ea.ablate_plain(s[x], DELTA, NUM_AC, v))
    calls.update({
        "embed_packedin": lambda f, x, q, p, t, d: ab.embed_frames_packedin(
            f, q, t, DELTA, NUM_AC),
        "embed_packedin_plain": lambda f, x, q, p, t, d:
            ab.embed_frames_packedin_plain(f, q, t, DELTA, NUM_AC),
        "roundtrip_dual": lambda f, x, q, p, t, d: dc.dual_roundtrip_packed(
            f, p, t, DELTA, NUM_AC),
        "roundtrip_dual_plain": lambda f, x, q, p, t, d:
            dc.dual_roundtrip_packed_plain(f, p, t, DELTA, NUM_AC),
        "copy": lambda f, x, q, p, t, d: rr.copy_frames(f),
        "copy_plain": lambda f, x, q, p, t, d: rr.copy_frames_plain(f),
        "dmaspec": lambda f, x, q, p, t, d: rr.dmaspec(f, p, NUM_AC),
        "dmaspec_plain": lambda f, x, q, p, t, d: rr.dmaspec_plain(f, p,
                                                                   NUM_AC),
    })
    times = {k: _time_ms(_per_set(fn, sets)) for k, fn in calls.items()}
    queued = {k: _queued_ms(_per_set(fn, sets), k) for k, fn in calls.items()}
    # the yardstick of K12 copy: one PyTorch call, never on a path
    copy_ = _per_set(lambda f, x, q, p, t, d: d.copy_(f), sets)
    library = {"copy": _time_ms(copy_)}
    library_queued = _queued_ms(copy_, "library copy_")
    sk.LAUNCHES.clear()
    sk.LAUNCHES.update(counts)
    cold = f"rotating over {len(sets)} input sets"
    print(f"phase 11 times 1920x1080 B=8 (median of 20 CUDA-event runs, "
          f"{cold}, {gpu}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
          + f", library copy_ {library['copy']:.4f} ms", flush=True)
    print(f"phase 11 device times 1920x1080 B=8 (mean of 20 calls queued "
          f"behind a sleep kernel, {cold}, {gpu}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in queued.items())
          + f", library copy_ {library_queued:.4f} ms", flush=True)
    del sets, copy_

    # the path: each study's entry point, as a user runs it
    small = ["--batch", "8", "--iters", "3"]
    sk.LAUNCHES.clear()
    _run_main("extract_ablation", ea.main, small)
    _run_main("ab_packed_payload", ab.main, small)
    _run_main("dualchain_r5", dc.main, small)
    _run_main("roofline_r4", rr.main, small)
    _run_main("roofline_r4", rr.main, ["--batch", "128", "--iters", "3",
                                       "--variants", "copy,dmaspec,fused,embed"])
    # at 768p the default stripe is 96; 216 and 360 do not divide the
    # height, so their variants are error rows and the study exits 1
    rows = _run_main("roofline_r4", rr.main, [
        "--batch", "8", "--iters", "3", "--height", "768", "--width", "1360"],
        rc_want=1)
    stripes = {r["variant"]: r.get("stripe") for r in rows[1:]
               if "ms_per_batch" in r}
    errors = {r["variant"] for r in rows[1:] if "error" in r}
    check(stripes == dict.fromkeys(("copy", "dmaspec", "fused", "embed",
                                    "fused_buf3", "fused_buf4"), 96)
          and errors == {"fused_s216", "fused_s360"},
          f"roofline_r4 at 768p: stripes {stripes}, error rows {errors}")
    rows = _run_main("device_roofline", device_roofline.main,
                     ["--batch", "8", "--iters", "5"])
    launches = dict(zip(names, (sk.LAUNCHES[e] for e in (
        *(f"stegotpu_qim_ablation:{v}" for v in ABLATIONS),
        "stegotpu_qim_embed_packedin", "stegotpu_qim_roundtrip_dual",
        "stegotpu_copy:copy", "stegotpu_copy:dmaspec"))))
    check(all(n > 0 for n in launches.values()),
          f"the studies did not launch every study kernel: {launches}")
    check(all("kernel_ms_each" in r for r in rows[1:]),
          f"device_roofline read no kernel from the timeline: {rows}")
    for variant, kn in (("embed", "K1"), ("fused", "K4")):
        row = [r for r in rows[1:] if r["variant"] == variant]
        check(len(row) == 1 and row[0]["glue_top"] == [],
              f"device_roofline: a {kn} call is more than its kernel: {row}")
        print(f"phase 11 device_roofline {variant} B=8: one {kn} kernel a "
              f"call, no glue (kernel {row[0]['kernel_ms_each']:.4f} ms, "
              f"period {row[0].get('iter_period_ms', float('nan')):.4f} ms)",
              flush=True)
    # a K3 call: its kernel behind the memset of its counts, nothing else
    counts = sk.LAUNCHES.copy()
    frames, payload = harness.inputs(dev, 8, 1080, 1920)
    k3 = stripe_cap.timeline(lambda: sk.embed_and_check_frames(
        frames, payload, payload.numel(), DELTA, NUM_AC), iters=5)
    sk.LAUNCHES.clear()
    sk.LAUNCHES.update(counts)
    glue = k3["glue_per_iter"]
    check("qim_embed_check_kernel" in (k3["kernel_name"] or "")
          and set(glue) <= {"gpu_memset"} and glue.get("gpu_memset", 0) <= 1,
          f"device timeline: a K3 call is more than its kernel and one "
          f"memset: {k3}")
    print("phase 11 device timeline embed_and_check B=8: one K3 kernel a "
          f"call behind {glue.get('gpu_memset', 0):g} memset (kernel "
          f"{k3['kernel_ms_each']:.4f} ms, period "
          f"{k3.get('iter_period_ms') or float('nan'):.4f} ms)", flush=True)
    # a K11 and a K13 call: one kernel each, with no torch op beside it
    # (each writes its bits per frame itself)
    from stegotpu_torch.studies import emitpipe_r4

    counts = sk.LAUNCHES.copy()
    total = payload.numel()
    for kn, template, fn in (
            ("K11", "qim_roundtrip_dual_kernel", dc.dual_roundtrip_packed),
            ("K13", "qim_roundtrip_pipe_kernel",
             emitpipe_r4.roundtrip_pipelined_packed)):
        row = stripe_cap.timeline(lambda fn=fn: fn(frames, payload, total,
                                                   DELTA, NUM_AC), iters=5)
        check(template in (row["kernel_name"] or "")
              and not row["glue_per_iter"],
              f"device timeline: a {kn} call is more than its kernel: {row}")
        print(f"phase 11 device timeline {kn} B=8: one {template} a call, no "
              f"glue (kernel {row['kernel_ms_each']:.4f} ms, period "
              f"{row.get('iter_period_ms') or float('nan'):.4f} ms)",
              flush=True)
    sk.LAUNCHES.clear()
    sk.LAUNCHES.update(counts)
    print("phase 11 study launches: "
          + " ".join(f"{k}={v}" for k, v in launches.items()), flush=True)
    return errs, launches, times, queued, library


def _misaligned(x, offset: int):
    """A contiguous copy of x whose storage starts `offset` bytes past an
    allocation's start (rows or payload off 16-byte alignment)."""
    import torch

    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = flat[offset:].view(x.shape)
    out.copy_(x)
    return out


# K13's odd shapes (B, H, W, num_ac, share of the capacity embedded): W % 16
# != 0, block columns no multiple of the 128-block chunk, odd num_ac, a
# payload that ends mid-frame. At the small batches every CTA walks at most
# one tile; at the large ones the tiles outnumber the resident CTAs (the
# SMs times 1-4) some 10-60 times, so every slot of every ring depth is
# refilled again and again, misaligned rows and payloads included.
PIPE_ODD = [(3, 48, 1048, 10, 0.7), (2, 40, 136, 1, 1.0),
            (2, 64, 64, 63, 0.5), (4, 96, 1360, 7, 0.3),
            (512, 96, 1360, 7, 0.3), (512, 48, 1048, 10, 0.7),
            (2048, 40, 136, 1, 1.0), (2048, 64, 64, 63, 0.5)]


def _pipe(dev, rng, gpu: str, sets: list):
    """Phase 12: K13 (studies/emitpipe_r4, csrc/qim_pipe.cu).

    At 1920x1080 and 1360x768, B=8, on both covers, K13 at bufs 2, 3 and 4
    equals K4 byte for byte (stego, bits per frame, packed bits) at delta
    20 and 2^-11, and is held against its plain version (K4's) as K4 is in
    phase 6: stego within the flip budget, bits within the exactness
    envelope. At the path's own input (the study's 1080p, B=128, where each
    CTA walks some 65 tiles) it equals K4 byte for byte at every bufs, with
    and without its register cap, and so does K11, at delta 20 and 2^-11;
    then K13 at each bufs and K4 are timed there, queued, and printed in
    one line. On the odd shapes, with frames 8 bytes and payloads 1-3
    bytes off 16-byte alignment and at delta 20, 8, 2^-11, 0 and -4, K13
    (capped and not at 20 and 2^-11) and, at an even B, K11 equal K4 byte
    for byte. Its times and its plain version's at 1920x1080, B=8, rotating
    over phase 4's input `sets`, per call and queued. Then the path,
    counters set to 0 before and read after: the study's main at B=128 for
    each bufs, capped and not, and roofline_r4's fused_buf3 and fused_buf4
    rows (K13 at bufs 3 and 4) beside fused (K4) at B=128.

    Returns (max_abs_err against K4, launches on the path, per-call ms,
    queued ms) by kernel name, the plain version's times under
    "<name>_plain"."""
    import numpy as np
    import torch

    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.studies import dualchain_r5 as dc
    from stegotpu_torch.studies import emitpipe_r4 as ep
    from stegotpu_torch.studies import harness
    from stegotpu_torch.studies import roofline_r4 as rr

    names = {n: f"roundtrip_pipe_buf{n}" for n in ep.BUFS}
    errs = dict.fromkeys(names.values(), 0)

    def max_diff(got, ref) -> int:
        return max(int((a.to(torch.int32) - c.to(torch.int32)).abs().max())
                   for a, c in zip(got, ref))

    for (h, w) in ((1080, 1920), (768, 1360)):
        for cover in ("mid", "uniform"):
            frames, payload, total = _covers(dev, rng, 8, h, w, cover)
            # delta 2^-11 (ArithHopperSmallDelta): K13 == K4 there too
            small = (frames, payload, total, 2.0**-11, NUM_AC)
            ref = sk.embed_and_extract_frames_packed(*small)
            for n in ep.BUFS:
                got = ep.roundtrip_pipelined_packed(*small, bufs=n)
                check(all(torch.equal(a, c) for a, c in zip(got, ref)),
                      f"K13 bufs={n} != K4 at {h}x{w} ({cover}) delta 2^-11")
            args = (frames, payload, total, DELTA, NUM_AC)
            ref = sk.embed_and_extract_frames_packed(*args)
            s_p, bpf_p, _ = ep.roundtrip_pipelined_packed_plain(*args)
            notes = []
            for n, name in names.items():
                got = ep.roundtrip_pipelined_packed(*args, bufs=n)
                torch.cuda.synchronize()
                d4 = max_diff(got, ref)
                errs[name] = max(errs[name], d4)
                check(d4 == 0, f"K13 bufs={n} != K4 at {h}x{w} ({cover}): "
                      f"max |diff| {d4}")
                stego, bpf, packed = got
                check(torch.equal(bpf, bpf_p), f"K13 bpf != plain at {h}x{w}")
                d = (stego.to(torch.int32) - s_p.to(torch.int32)).abs()
                flips = (d > 1).double().mean().item()
                check(flips < STEGO_FLIP_BUDGET,
                      f"K13 vs plain: {flips:.4%} of pixels differ by >1 at "
                      f"{h}x{w}")
                out = int(((_wire(sk, packed, h) != _wire(
                    sk, sk.extract_frames_packed_plain(stego, DELTA, NUM_AC),
                    h)) & ~_near_boundary_t(stego, DELTA, NUM_AC)).sum())
                check(out == 0, f"K13 vs plain: {out} bits outside the "
                      f"envelope at {h}x{w} ({cover})")
                notes.append(f"bufs {n} >1 px {flips:.5%} max |diff| "
                             f"{int(d.max())}")
            print(f"phase 12 K13 {h}x{w} B=8 {cover}: == K4 (stego, bpf, "
                  "packed) byte for byte at bufs 2, 3, 4, delta 20 and "
                  "2^-11; vs plain: bpf "
                  "identical, bits within the envelope, " + ", ".join(notes),
                  flush=True)

    # the path's own input: emitpipe_r4's 1080p, B=128; K11 (two frames a
    # thread) too
    frames, payload = harness.inputs(dev, 128, 1080, 1920)
    for delta in (DELTA, 2.0**-11):
        args = (frames, payload, frames.shape[0] * payload.shape[1], delta,
                NUM_AC)
        ref = sk.embed_and_extract_frames_packed(*args)
        for n, name in names.items():
            for capped in (True, False):
                got = ep.roundtrip_pipelined_packed(*args, bufs=n,
                                                    capped=capped)
                torch.cuda.synchronize()
                d4 = max_diff(got, ref)
                errs[name] = max(errs[name], d4)
                check(all(torch.equal(a, c) for a, c in zip(got, ref)),
                      f"K13 bufs={n} capped={capped} != K4 at 128x1080x1920 "
                      f"delta {delta}: max |diff| {d4}")
                del got
        got = dc.dual_roundtrip_packed(*args)
        check(all(torch.equal(a, c) for a, c in zip(got, ref)),
              f"K11 != K4 at 128x1080x1920 delta {delta}")
        del got, ref
    print("phase 12 K13 1080p B=128 (the study's input, some 65 tiles a "
          "CTA): == K4 (stego, bpf, packed) byte for byte at bufs 2, 3, 4, "
          "with and without the register cap, and K11 == K4, at delta 20 "
          "and 2^-11", flush=True)
    # K13 beside K4 on that input in one call: queued, one 580 MB set (far
    # beyond the L2, so every call reads from HBM)
    counts = sk.LAUNCHES.copy()
    total = frames.shape[0] * payload.shape[1]
    b128 = {"K4": _queued_ms(lambda: sk.embed_and_extract_frames_packed(
        frames, payload, total, DELTA, NUM_AC), "K4 B=128")}
    for n in ep.BUFS:
        b128[f"K13 bufs {n}"] = _queued_ms(
            lambda n=n: ep.roundtrip_pipelined_packed(
                frames, payload, total, DELTA, NUM_AC, n), f"K13 bufs {n} B=128")
    sk.LAUNCHES.clear()
    sk.LAUNCHES.update(counts)
    del frames, payload
    print(f"phase 12 K13 beside K4 1080p B=128 (mean of 20 calls queued "
          f"behind a sleep kernel, {gpu}): " + ", ".join(
              f"{k} {v:.4f} ms ({v / b128['K4']:.3f}x K4)"
              for k, v in b128.items()), flush=True)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, h, w, num_ac, frac in PIPE_ODD:
        cap = (h // 8) * (w // 8) * num_ac
        frames = torch.from_numpy(
            rng.integers(16, 240, (b, h, w), dtype=np.uint8)).to(dev)
        payload = torch.from_numpy(
            rng.integers(0, 2, (b, cap), dtype=np.uint8)).to(dev)
        total = int(frac * b * cap) - 5
        for f_off, p_off, delta in ((0, 0, DELTA), (8, 3, DELTA), (8, 1, 8.0),
                                    (0, 1, 2.0**-11), (0, 2, 0.0),
                                    (0, 0, -4.0)):
            fr = _misaligned(frames, f_off) if f_off else frames
            pl = _misaligned(payload, p_off) if p_off else payload
            args = (fr, pl, total, delta, num_ac)
            ref = sk.embed_and_extract_frames_packed(*args)
            # the build without the cap at the two spellings' deltas
            uncapped = delta in (DELTA, 2.0**-11)
            for n in ep.BUFS:
                for capped in (True, False) if uncapped else (True,):
                    got = ep.roundtrip_pipelined_packed(*args, bufs=n,
                                                        capped=capped)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, c) for a, c in zip(got, ref)),
                          f"K13 bufs={n} capped={capped} != K4 at "
                          f"{b}x{h}x{w} num_ac={num_ac} frames+{f_off} "
                          f"payload+{p_off} delta={delta}")
            if b % 2 == 0:  # K11 takes frames in pairs
                got = dc.dual_roundtrip_packed(*args)
                check(all(torch.equal(a, c) for a, c in zip(got, ref)),
                      f"K11 != K4 at {b}x{h}x{w} num_ac={num_ac} "
                      f"frames+{f_off} payload+{p_off} delta={delta}")
            if delta <= 0:
                check(torch.equal(ref[0], frames) and not ref[2].any(),
                      f"delta {delta}: not a passthrough at {h}x{w}")
        tiles = b * (h // 8) * -(-(w // 8) // 128)
        print(f"phase 12 K13 odd shape B={b} {h}x{w} num_ac={num_ac} "
              f"(W%16={w % 16}, {(w // 8) % 128} blocks in the last chunk, "
              f"payload ends at {total} of {b * cap} bits, {tiles} tiles, "
              f"{tiles / sms:.1f} an SM): == K4 byte for byte at bufs 2, 3, "
              "4 (capped and not at delta 20 and 2^-11), frames +0/+8 B, "
              "payload +0..3 B, delta 20, 8, 2^-11, 0, -4"
              + ("; K11 == K4 too" if b % 2 == 0 else ""), flush=True)

    counts = sk.LAUNCHES.copy()
    calls = {name: (lambda f, p, t, n=n: ep.roundtrip_pipelined_packed(
        f, p, t, DELTA, NUM_AC, n)) for n, name in names.items()}

    def plain(f, p, t):
        return ep.roundtrip_pipelined_packed_plain(f, p, t, DELTA, NUM_AC)

    def k4(f, p, t):
        return sk.embed_and_extract_frames_packed(f, p, t, DELTA, NUM_AC)

    times = {k: _time_ms(_per_set(fn, sets)) for k, fn in calls.items()}
    queued = {k: _queued_ms(_per_set(fn, sets), k) for k, fn in calls.items()}
    # K13's plain version is K4's: one time for the three ring depths
    plain_ms, plain_q = (_time_ms(_per_set(plain, sets)),
                         _queued_ms(_per_set(plain, sets), "K13 plain"))
    k4_q = _queued_ms(_per_set(k4, sets), "K4 in turn")
    sk.LAUNCHES.clear()  # timing is not a path's run
    sk.LAUNCHES.update(counts)
    print(f"phase 12 times 1920x1080 B=8 (median of 20 CUDA-event runs, "
          f"rotating over {len(sets)} input sets, {gpu}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
          + f", plain (K4's) {plain_ms:.4f} ms", flush=True)
    print(f"phase 12 device times 1920x1080 B=8 (mean of 20 calls queued "
          f"behind a sleep kernel, rotating over {len(sets)} input sets, "
          f"{gpu}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in queued.items())
          + f", plain (K4's) {plain_q:.4f} ms, K4 in turn {k4_q:.4f} ms",
          flush=True)
    for name in names.values():
        times[f"{name}_plain"], queued[f"{name}_plain"] = plain_ms, plain_q

    sk.LAUNCHES.clear()
    t0 = time.perf_counter()
    gbps = {}
    for n in ep.BUFS:
        for flags in ([], ["--uncapped"]):
            rows = _run_main("emitpipe_r4", ep.main, [
                "--batch", "128", "--bufs", str(n), *flags], phase=12)
            chk, row = rows[1], rows[2]
            check(chk.get("check") == "roundtrip_errors_vs_xla_extract"
                  and chk["ok"] and chk["errors"] <= ep.BER_BOUND * chk["total"],
                  f"emitpipe_r4 --bufs {n} {flags}: check row {chk}")
            variant = f"emitpipe_buf{n}" + ("_uncapped" if flags else "")
            check(row.get("variant") == variant and row["ms_per_128"] > 0,
                  f"emitpipe_r4 rows {rows}")
            gbps[variant] = row["gbps"]
    print(f"phase 12 emitpipe_r4 1080p B=128 ({gpu}): "
          + ", ".join(f"{k} {v:.1f} GB/s" for k, v in gbps.items()),
          flush=True)
    rows = _run_main("roofline_r4", rr.main, [
        "--batch", "128", "--iters", "3", "--variants",
        "fused,fused_buf3,fused_buf4"], phase=12)
    timed = {r["variant"] for r in rows[1:] if "ms_per_batch" in r}
    check(timed == {"fused", "fused_buf3", "fused_buf4"},
          f"roofline_r4 did not time K13's rows: {rows}")
    launches = {name: sk.LAUNCHES[f"stegotpu_qim_roundtrip_pipe:buf{n}"]
                for n, name in names.items()}
    check(all(v > 0 for v in launches.values()),
          f"the path did not launch K13 at every bufs: {launches}")
    print("phase 12 path: " + " ".join(
        f"stegotpu_qim_roundtrip_pipe:buf{n}={launches[name]}"
        for n, name in names.items())
        + f"; {time.perf_counter() - t0:.1f} s host clock", flush=True)
    return errs, launches, times, queued


def _cli_run(*argv, phase: int = 13) -> tuple[int, str, str]:
    """stegotpu_torch.cli.main(argv) in this process: (exit code, stdout,
    stderr), each output line echoed under `phase`."""
    import io

    from stegotpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(list(argv))
    seconds = time.perf_counter() - t0
    for stream, text in (("out", out.getvalue()), ("err", err.getvalue())):
        for line in text.splitlines():
            print(f"phase {phase} {argv[0]} {stream}: {line}", flush=True)
    print(f"phase {phase} {' '.join(argv)}: exit {rc}, {seconds:.2f} s host "
          "clock",
          flush=True)
    return rc, out.getvalue(), err.getvalue()


def _cli() -> None:
    """Phase 13: the port's command line at full width, in process, on the
    card, in a temporary directory: fixtures (1920x1080, 12 frames, a
    256x256 secret that fills more than a frame), genkey, embed and extract
    with --timing (the secret back pixel-identical, SHA3 OK, K1 and K2
    launched), inspect --json (the header embed wrote), steganalyze --json
    (stego-likely, delta 20, num_ac 10), capacity --json (324,000 bits a
    frame), evaluate, selftest and bench (its JSON line, exactness_ok, K4
    launched).
    cryptography, Pillow and cv2 are required here: a missing one fails
    the phase."""
    import numpy as np

    from stegotpu_torch.image import load_image_gray
    from stegotpu_torch.ops import stripe_kernel as sk

    def ok(*argv) -> tuple[str, str]:
        rc, out, err = _cli_run(*argv)
        check(rc == 0, f"cli {' '.join(argv)} exited {rc}: {err[-2000:]}")
        return out, err

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        ok("fixtures", "--dir", "media", "--width", "1920", "--height",
           "1080", "--frames", "12", "--secret-size", "256")
        ok("genkey")
        sk.LAUNCHES.clear()
        out, _ = ok("embed", "media/cover.mp4", "media/secret.png",
                    "out/stego", "--timing")
        m = re.search(r"embedded (\d+) bits", out)
        check(m is not None, f"embed printed no bit count: {out}")
        total_bits = int(m.group(1))
        out, _ = ok("extract", "out/stego.avi", "out/extracted.png",
                    "--timing")
        check("SHA3-256 integrity: OK" in out, f"extract: {out}")
        check(np.array_equal(load_image_gray("out/extracted.png"),
                             load_image_gray("media/secret.png")),
              "cli: the secret is not pixel-identical")
        k1, k2 = (sk.LAUNCHES[e] for e in ("stegotpu_qim_embed",
                                            "stegotpu_qim_extract_packed"))
        check(k1 > 0 and k2 > 0, f"cli embed/extract launched "
              f"stegotpu_qim_embed={k1} stegotpu_qim_extract_packed={k2}")
        print(f"phase 13 embed -> extract 1920x1080: pixel-identical, SHA3 "
              f"OK; stegotpu_qim_embed={k1} stegotpu_qim_extract_packed={k2}",
              flush=True)

        ins = json.loads(ok("inspect", "out/stego.avi", "--json")[0])
        check((ins["width"], ins["height"], ins["payload_type"],
               ins["secret_width"], ins["secret_height"],
               ins["ciphertext_bytes"], ins["total_payload_bits"],
               ins["capacity_bits_per_frame"])
              == (1920, 1080, "image", 256, 256, 256 * 256, total_bits,
                  324_000), f"inspect: {ins}")
        stz = json.loads(ok("steganalyze", "out/stego.avi", "--json")[0])
        check(stz["verdict"] == "stego-likely"
              and (stz["estimated_delta"], stz["estimated_num_ac"]) == (20, 10),
              f"steganalyze: {stz}")
        cap = json.loads(ok("capacity", "media/cover.mp4", "--json")[0])
        check(cap["qim_bits_per_frame"] == 324_000, f"capacity: {cap}")
        out, _ = ok("evaluate", "media/cover.mp4", "out/stego.avi", "--secret",
                    "media/secret.png", "--extracted", "out/extracted.png",
                    "--all-frames")
        check("SSIM" in out and "security" in out, f"evaluate: {out}")
        out, _ = ok("selftest", "--dir", "selftest")
        check("SELFTEST PASSED" in out and "kernel exactness: OK" in out,
              f"selftest: {out}")
        sk.LAUNCHES.clear()
        out, _ = ok("bench")
        lines = [ln for ln in out.splitlines() if ln.strip()]
        check(len(lines) == 1, f"bench printed {len(lines)} lines")
        row = json.loads(lines[0])
        check(row.get("exactness_ok") is True and row.get("value", 0) > 0
              and "error" not in row, f"bench: {row}")
        k4 = sk.LAUNCHES["stegotpu_qim_roundtrip_packed"]
        check(k4 > 0, f"bench launched stegotpu_qim_roundtrip_packed={k4}")
        print(f"phase 13 bench ({row['gpu']}; stegotpu_qim_roundtrip_packed="
              f"{k4}): {json.dumps(row)}", flush=True)

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(*argv, timeout: float = 240.0) -> tuple[list, float]:
    """`python -m stegotpu_torch.cli <argv> --coordinator ... --process-id
    i` as two processes of one Gloo group on a free localhost port, both on
    the card: ([(exit code, output)] by rank, host seconds). Both are
    killed if either outlives `timeout`."""
    import os
    import subprocess

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stegotpu_torch.cli", *argv, "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(rank)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            print(f"phase 14 {argv[0]} rank {rank}: {line}", flush=True)
    return [(p.returncode, out) for p, out in zip(procs, outs)], seconds


def _decoded(path):
    """Every frame of a video, BGR, as one array (stegotpu_torch.video)."""
    import numpy as np

    from stegotpu_torch.video import VideoReader

    with VideoReader(path) as reader:
        return np.concatenate(list(reader.batches(8)))


def _parallel(dev, rng, gpu: str, h: int = 1080, w: int = 1920) -> None:
    """Phase 14: the parallel layer (stegotpu_torch.parallel) on the card,
    1920x1080 (h x w), delta 20, num_ac 10.

    The mesh library on grids that repeat the card, (2, 1), (1, 3) and
    (2, 3) at B=8 on a uniform 16..239 cover: stego and bits per frame
    byte-identical to one unsharded K1 call, bits to the unsharded K2 and
    unpack, the round-trip step 0 errors there and, on a letterboxed cover,
    the unsharded count_wrong_bits (non-zero); K1 launched n_data times at
    space 1 and B*space times otherwise, K2 once a shard. Then file to file
    on a 24-frame 1080p cover: the embed through a --mesh data=1 mesh equals
    the plain pipeline's frame for frame (same seeded crypto stream), the
    verified embed through the mesh works on a letterboxed cover, the plain
    extract, `extract --procs 2` in thread and spawn mode (a spawn worker
    never initialises CUDA) and a 2-rank dist-extract return the secret
    pixel-identical; `embed --procs 2` and dist-embed, which stitch with the
    native packet concat, run where it is built and otherwise fail with one
    line naming it, leaving no segment file. Host-clock lines for the four
    extracts. cryptography, Pillow and cv2 are required."""
    import numpy as np
    import torch

    from stegotpu_torch import crypto
    from stegotpu_torch.config import StegoConfig
    from stegotpu_torch.image import load_image_gray, save_image_gray
    from stegotpu_torch.native.videoio import available
    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.parallel.local_procs import _make_pool, _segment_bits
    from stegotpu_torch.parallel.mesh import (make_mesh, product_mesh,
                                              sharded_embed_frames,
                                              sharded_extract_frames,
                                              sharded_roundtrip_step)
    from stegotpu_torch.pipeline import (embed_image_in_video,
                                         extract_image_from_video)
    from stegotpu_torch.utils.profiling import StageTimer
    from stegotpu_torch.video import VideoReader, VideoWriter

    t_phase = time.perf_counter()
    b = 8
    cap = (h // 8) * (w // 8) * NUM_AC
    bar = 136 * h // 1080 // 8 * 8
    frames = torch.from_numpy(
        rng.integers(16, 240, (b, h, w), dtype=np.uint8)).to(dev)
    boxed = torch.from_numpy(_letterboxed(rng, b, bar, h, w)).to(dev)
    payload = torch.from_numpy(
        rng.integers(0, 2, (b, cap), dtype=np.uint8)).to(dev)
    total = int(0.7 * b * cap) + 13  # ends mid-frame, inside a stripe
    one_stego, one_bpf = sk.embed_frames(frames, payload, total, DELTA, NUM_AC)
    one_bits = sk.extract_frames(one_stego, DELTA, NUM_AC)
    box_stego, _ = sk.embed_frames(boxed, payload, total, DELTA, NUM_AC)
    box_errors = int(sk.count_wrong_bits(
        sk.extract_frames(box_stego, DELTA, NUM_AC), payload, total).sum())
    check(box_errors > 0, "test premise: K1 must lose bits on the "
          "letterboxed cover")
    for n_data, n_space in ((2, 1), (1, 3), (2, 3)):
        mesh = make_mesh(n_data, n_space, [dev] * (n_data * n_space))
        sk.LAUNCHES.clear()
        t0 = time.perf_counter()
        stego, bpf = sharded_embed_frames(mesh, NUM_AC, kernel="pallas")(
            frames, payload, total, DELTA)
        k1 = sk.LAUNCHES["stegotpu_qim_embed"]
        bits = sharded_extract_frames(mesh, NUM_AC, kernel="pallas")(
            one_stego, DELTA)
        k2 = sk.LAUNCHES["stegotpu_qim_extract_packed"]
        step = sharded_roundtrip_step(mesh, NUM_AC, kernel="pallas")
        s_step, b_step, x_step, e_step = step(frames, payload, total, DELTA)
        _, _, _, e_box = step(boxed, payload, total, DELTA)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        grid = f"data={n_data},space={n_space}"
        want_k1 = n_data if n_space == 1 else b * n_space
        check(torch.equal(stego, one_stego) and torch.equal(bpf, one_bpf),
              f"mesh {grid}: stego or bits per frame differ from one K1 call")
        check(torch.equal(bits, one_bits),
              f"mesh {grid}: bits differ from the unsharded K2 + unpack")
        check(torch.equal(s_step, one_stego) and torch.equal(b_step, one_bpf)
              and torch.equal(x_step, one_bits) and int(e_step) == 0,
              f"mesh {grid}: round-trip step differs or errs ({int(e_step)})")
        check(int(e_box) == box_errors,
              f"mesh {grid}: step counts {int(e_box)} errors on the "
              f"letterboxed cover, count_wrong_bits {box_errors}")
        check(k1 == want_k1 and k2 == n_data * n_space,
              f"mesh {grid}: stegotpu_qim_embed {k1} (want {want_k1}), "
              f"stegotpu_qim_extract_packed {k2} (want {n_data * n_space})")
        print(f"phase 14 mesh {grid} over {mesh.devices.size} x {dev} "
              f"{w}x{h} B=8: stego, bpf == one K1 call; bits == K2 + "
              f"unpack; step errors 0, letterboxed {int(e_box)} == "
              f"count_wrong_bits; stegotpu_qim_embed={k1} "
              f"stegotpu_qim_extract_packed={k2}; "
              f"{seconds:.3f} s host clock", flush=True)
    del frames, boxed, payload, one_stego, one_bits, box_stego

    cfg = StegoConfig()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # a 1024x768 secret spans 20 of the 24 frames: both --procs
        # segments and both dist-extract ranks hold payload
        secret = rng.integers(0, 256, (768 * h // 1080, 1024 * w // 1920),
                              dtype=np.uint8)
        save_image_gray(secret, tmp / "secret.png")
        with VideoWriter(tmp / "cover.avi", 30.0, w, h) as writer:
            for _ in range(3):
                writer.write_bgr_batch(
                    rng.integers(16, 240, (8, h, w, 3), dtype=np.uint8))
        priv, pub = crypto.generate_keypair(rng)
        crypto.save_keypair_pem(priv, tmp / "priv.pem", tmp / "pub.pem")
        pub_c = crypto.serialize_public_compressed(pub)
        key = crypto.load_private_pem(tmp / "priv.pem")

        mesh = product_mesh("data=1")
        sk.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = embed_image_in_video(tmp / "cover.avi", tmp / "secret.png",
                                   tmp / "mesh", pub_c, cfg, batch_frames=8,
                                   rng=np.random.default_rng(14), mesh=mesh)
        t_mesh = time.perf_counter() - t0
        k1 = sk.LAUNCHES["stegotpu_qim_embed"]
        check(res.success and k1 > 0,
              f"mesh file embed: {res.error}, stegotpu_qim_embed {k1}")
        t0 = time.perf_counter()
        plain = embed_image_in_video(tmp / "cover.avi", tmp / "secret.png",
                                     tmp / "plain", pub_c, cfg,
                                     batch_frames=8,
                                     rng=np.random.default_rng(14),
                                     device=dev)
        t_plain = time.perf_counter() - t0
        check(plain.success, f"plain file embed: {plain.error}")
        check(np.array_equal(_decoded(res.output_path),
                             _decoded(plain.output_path)),
              "mesh file embed: decoded frames differ from the plain "
              "pipeline's")
        stego = res.output_path
        sk.LAUNCHES.clear()
        out = extract_image_from_video(stego, key, cfg, tmp / "x_mesh.png",
                                       mesh=mesh)
        check(out.success and out.hash_ok and np.array_equal(out.pixels,
                                                             secret),
              f"mesh file extract: {out.error}")
        print(f"phase 14 file --mesh data=1 {w}x{h}: "
              f"{res.total_payload_bits} bits in {res.frames_used} frames, "
              f"decoded stego == the plain pipeline's, secret "
              f"{secret.shape[1]}x{secret.shape[0]} pixel-identical, SHA3 ok; "
              "stegotpu_qim_extract_packed="
              f"{sk.LAUNCHES['stegotpu_qim_extract_packed']}; embed "
              f"{t_mesh:.3f} s, plain pipeline's {t_plain:.3f} s host clock "
              f"({gpu})",
              flush=True)

        verified = StegoConfig(verified_embed=True)
        with VideoWriter(tmp / "boxed.avi", 30.0, w, h) as writer:
            writer.write_bgr_batch(
                np.repeat(_letterboxed(rng, 6, bar, h, w)[..., None], 3,
                          axis=-1))
        small = rng.integers(0, 256, (240 * h // 1080, 320 * w // 1920),
                             dtype=np.uint8)
        save_image_gray(small, tmp / "small.png")
        vres = embed_image_in_video(tmp / "boxed.avi", tmp / "small.png",
                                    tmp / "boxed_st", pub_c, verified,
                                    mesh=mesh)
        check(vres.success and vres.residual_bits == 0,
              f"verified mesh embed: {vres.error}")
        vout = extract_image_from_video(vres.output_path, key, cfg,
                                        device=dev)
        check(vout.success and vout.hash_ok
              and np.array_equal(vout.pixels, small),
              f"verified mesh extract: {vout.error}")
        print(f"phase 14 verified file --mesh data=1 {w}x{h} letterboxed: "
              f"{vres.total_payload_bits} bits, residual 0, secret "
              "pixel-identical", flush=True)

        timer = StageTimer()
        t0 = time.perf_counter()
        out = extract_image_from_video(stego, key, cfg, tmp / "x_plain.png",
                                       timer=timer, device=dev)
        times = {"plain": time.perf_counter() - t0}
        check(out.success and out.hash_ok and np.array_equal(out.pixels,
                                                             secret),
              f"plain extract: {out.error}")
        for mode in ("thread", "spawn"):
            sk.LAUNCHES.clear()
            t0 = time.perf_counter()
            rc, text, err = _cli_run(
                "extract", str(stego), str(tmp / f"x_{mode}.png"),
                "--private-key", str(tmp / "priv.pem"), "--procs", "2",
                "--procs-mode", mode, phase=14)
            times[mode] = time.perf_counter() - t0
            check(rc == 0 and "SHA3-256 integrity: OK" in text
                  and np.array_equal(load_image_gray(tmp / f"x_{mode}.png"),
                                     secret),
                  f"extract --procs 2 --procs-mode {mode}: {err[-2000:]}")
            if mode == "thread":
                check(sk.LAUNCHES["stegotpu_qim_extract_packed"] > 0,
                      "extract --procs 2 thread launched no K2")
        with VideoReader(stego) as reader:
            gray = next(reader.batches(8, mode="gray"))
        with _make_pool("spawn", 1) as pool:
            cpu_bits = pool.submit(_segment_bits, str(stego), 0, 8, h, w,
                                   cfg, 8, torch.device("cpu")).result()
            cuda_state = (pool.submit(torch.cuda.is_available).result(),
                          pool.submit(torch.cuda.is_initialized).result())
        card_bits = _segment_bits(str(stego), 0, 8, h, w, cfg, 8, dev)
        near = _near_boundary(torch.from_numpy(gray).to(dev), DELTA,
                              NUM_AC).reshape(-1)
        off = int(((cpu_bits != card_bits) & ~near).sum())
        check(cuda_state == (False, False) and off == 0,
              f"spawn worker: cuda available/initialised {cuda_state}, "
              f"{off} bits off the card's outside the envelope")
        print("phase 14 spawn worker: torch.cuda.is_available() False, "
              "is_initialized() False after a segment; its plain K2 bits "
              f"of frames 0-7 == the card's outside the envelope "
              f"({int((cpu_bits != card_bits).sum())} inside)", flush=True)

        ranks, times["dist"] = _ranks(
            "dist-extract", str(stego), str(tmp / "x_dist.png"),
            "--private-key", str(tmp / "priv.pem"))
        check(all(rc == 0 for rc, _ in ranks)
              and "SHA3-256 integrity: OK" in ranks[0][1]
              and np.array_equal(load_image_gray(tmp / "x_dist.png"), secret),
              f"dist-extract: exit codes {[rc for rc, _ in ranks]}")
        print(f"phase 14 timing 24-frame {w}x{h} extract, payload of 20 frames "
              f"({gpu}): plain {times['plain']:.3f} s (timer= "
              f"{timer.report().replace(chr(10), '; ')}), --procs 2 thread "
              f"{times['thread']:.3f} s, --procs 2 spawn {times['spawn']:.3f} "
              f"s, dist-extract 2 ranks {times['dist']:.3f} s (two process "
              "starts included); host clock, findings only", flush=True)

        if available():
            rc, _, err = _cli_run(
                "embed", str(tmp / "cover.avi"), str(tmp / "secret.png"),
                str(tmp / "par"), "--public-key", str(tmp / "pub.pem"),
                "--procs", "2", phase=14)
            check(rc == 0, f"embed --procs 2: {err[-2000:]}")
            ranks, _ = _ranks("dist-embed", str(tmp / "cover.avi"),
                              str(tmp / "secret.png"), str(tmp / "dist"),
                              "--public-key", str(tmp / "pub.pem"))
            check(all(rc == 0 for rc, _ in ranks), "dist-embed failed")
            for name in ("par.avi", "dist.avi"):
                x = extract_image_from_video(tmp / name, key, cfg, device=dev)
                check(x.success and np.array_equal(x.pixels, secret),
                      f"{name}: {x.error}")
            print("phase 14 embed --procs 2 and dist-embed (native concat "
                  "built): secret pixel-identical", flush=True)
        else:
            rc, _, err = _cli_run(
                "embed", str(tmp / "cover.avi"), str(tmp / "secret.png"),
                str(tmp / "par"), "--public-key", str(tmp / "pub.pem"),
                "--procs", "2", phase=14)
            lines = err.strip().splitlines()
            check(rc == 1 and len(lines) == 1 and lines[0].startswith(
                "error: --procs needs the native concat layer"),
                f"embed --procs 2 without the concat: exit {rc}, {err}")
            ranks, _ = _ranks("dist-embed", str(tmp / "cover.avi"),
                              str(tmp / "secret.png"), str(tmp / "dist"),
                              "--public-key", str(tmp / "pub.pem"))
            check([rc for rc, _ in ranks] == [1, 0] and
                  "error: dist-embed needs the native concat layer"
                  in ranks[0][1],
                  f"dist-embed without the concat: exit codes "
                  f"{[rc for rc, _ in ranks]}")
            print("phase 14 embed --procs 2 and dist-embed without the "
                  "native concat layer: exit 1 naming it (dist-embed: rank "
                  "0 in its preflight, rank 1 exit 0)", flush=True)
        left = sorted(p.name for p in tmp.glob("*seg*"))
        check(not left and (tmp / "par.avi").exists() == available(),
              f"segment files left behind: {left}")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s host clock",
          flush=True)


class _GuiStandIn:
    """The GUI's workers without a window: StegoApp's embed and extract
    methods bound to an object that holds only the log queue (the workers
    read everything else from the snapshot)."""

    def __init__(self):
        import queue

        from stegotpu_torch.gui import StegoApp

        self._q = queue.Queue()
        self.embed = StegoApp._do_embed.__get__(self)
        self.extract = StegoApp._do_extract.__get__(self)

    def _log(self, msg: str, tag: str = "INFO") -> None:
        self._q.put(("log", msg, tag))

    def logs(self) -> list[tuple[str, str]]:
        out = []
        while not self._q.empty():
            kind, *rest = self._q.get_nowait()
            if kind == "log":
                out.append(tuple(rest))
        return out


def _http(base: str, path: str, body: dict | None = None,
          timeout: float = 120.0) -> tuple[int, dict, float]:
    """(status, JSON body, host seconds) of a GET (body None) or a JSON
    POST to the daemon at `base`."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, out = e.code, json.loads(e.read())
    return code, out, time.perf_counter() - t0


def _tool(main, argv: list[str]) -> tuple[int, str]:
    """A tool's main(argv) in this process: (exit code, stdout), its
    output echoed under phase 15."""
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    for line in out.getvalue().splitlines():
        print(f"phase 15 {main.__module__.rsplit('.', 1)[-1]}: {line}",
              flush=True)
    print(f"phase 15 {main.__module__} {' '.join(argv)}: exit {rc}, "
          f"{time.perf_counter() - t0:.2f} s host clock", flush=True)
    return rc, out.getvalue()


def _serving(gpu: str, h: int = 1080, w: int = 1920) -> None:
    """Phase 15: the serving path at 1920x1080 (h x w) on the card, device
    None everywhere (no CPU fallback), delta 20, num_ac 10.

    The in-process server (make_server(port=0), in a thread) on a 12-frame
    FFV1 fixture and a 640x480 noise secret (2.46 M payload bits, 8
    frames): /healthz, /capacity (324,000 bits a frame), /embed (K1
    launched), /inspect and /extract (K2 launched; the secret back
    pixel-identical, hash_ok), /steganalyze (delta 20), the verified
    /embed (K3 launched, residual 0) and its extract, then the error codes
    (422 for delta 19, 400 for a missing field, 404 for an unknown route)
    and /healthz again. Then `python -m stegotpu_torch.cli serve` as a
    subprocess on a free port with the library built: host seconds until
    /healthz answers, of a first and a second identical /embed, and its
    exit on SIGINT. Then the GUI's workers headless (embed, extract with
    procs 1 and procs 2), and the tools: soak_kernels (20 configurations,
    seed 0, three arms), soak_product (3 draws, seed 0) and, as a
    subprocess, profile_roundtrip (B=8, 3 iterations: 3 K4 launches and at
    least 3 K4 events in its trace). cryptography, Pillow and cv2 are
    required."""
    import importlib
    import os
    import signal
    import subprocess
    import threading

    import numpy as np

    from stegotpu_torch import crypto, fixtures
    from stegotpu_torch.config import StegoConfig
    from stegotpu_torch.device import resolve_device
    from stegotpu_torch.image import load_image_gray
    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.server import make_server
    from stegotpu_torch.tools import soak_kernels, soak_product

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cover, secret_png = tmp / "cover.avi", tmp / "secret.png"
        fixtures.make_cover_video(cover, w, h, frames=12, kind="moving",
                                  codec="FFV1")
        fixtures.make_secret_image(secret_png, 640 * w // 1920,
                                   480 * h // 1080, kind="noise", seed=15)
        secret = load_image_gray(secret_png)
        crypto.setup_receiver_keys(tmp / "k.pem", tmp / "p.pem")
        keys = {"public_key": str(tmp / "p.pem"),
                "private_key": str(tmp / "k.pem")}

        srv = make_server(port=0)
        check(srv.device.type == "cuda", f"server device {srv.device}")
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            def post(path, body, want=200, counter=None):
                sk.LAUNCHES.clear()
                code, out, seconds = _http(base, path, body)
                n = None if counter is None else sk.LAUNCHES[counter]
                check(code == want, f"POST {path}: {code}, want {want}: {out}")
                check(n is None or n > 0, f"POST {path} launched no kernel "
                      f"({counter}={n})")
                print(f"phase 15 server POST {path}: {code} in {seconds:.3f} "
                      f"s host clock" + ("" if n is None else
                                         f"; {counter}={n}"), flush=True)
                return out

            code, out, _ = _http(base, "/healthz")
            check(code == 200 and out["ok"], f"/healthz: {code} {out}")
            cap = post("/capacity", {"video": str(cover)})
            check(cap["qim_bits_per_frame"] == (w // 8) * (h // 8) * 10
                  and cap["frames"] == 12, f"/capacity: {cap}")
            embed = {"cover": str(cover), "secret": str(secret_png),
                     "output": str(tmp / "st"), **keys}
            emb = post("/embed", embed, counter="stegotpu_qim_embed")
            check(emb["success"] and emb["residual_bits"] == 0
                  and emb["frames_used"] == 12
                  and emb["payload_bits"] > 8 * secret.size, f"/embed: {emb}")
            ins = post("/inspect", {"stego": str(tmp / "st.avi")},
                       counter="stegotpu_qim_extract_packed")
            check((ins["payload_type"], ins["secret_height"],
                   ins["secret_width"], ins["total_payload_bits"],
                   ins["payload_frames"])
                  == ("image", *secret.shape, emb["payload_bits"], 8),
                  f"/inspect: {ins}")
            ext = post("/extract", {"stego": str(tmp / "st.avi"),
                                    "output": str(tmp / "x.png"), **keys},
                       counter="stegotpu_qim_extract_packed")
            check(ext["success"] and ext["hash_ok"]
                  and np.array_equal(load_image_gray(tmp / "x.png"), secret),
                  f"/extract: {ext}")
            stz = post("/steganalyze", {"video": str(tmp / "st.avi")})
            check(stz["detected"] and stz["estimated_delta"] == 20,
                  f"/steganalyze: {stz}")
            ver = post("/embed", {**embed, "output": str(tmp / "vst"),
                                  "verified": True},
                       counter="stegotpu_qim_embed_check")
            check(ver["success"] and ver["residual_bits"] == 0,
                  f"verified /embed: {ver}")
            vext = post("/extract", {"stego": str(tmp / "vst.avi"),
                                     "output": str(tmp / "vx.png"), **keys},
                        counter="stegotpu_qim_extract_packed")
            check(vext["hash_ok"] and np.array_equal(
                load_image_gray(tmp / "vx.png"), secret),
                f"verified /extract: {vext}")
            post("/extract", {"stego": str(tmp / "st.avi"), "delta": 19,
                              **keys}, want=422)
            miss = post("/embed", {"secret": str(secret_png), **keys},
                        want=400)
            check("missing required field: 'cover'" in miss["error"],
                  f"missing field: {miss}")
            post("/nope", {}, want=404)
            code, out, _ = _http(base, "/healthz")
            check(code == 200, f"/healthz after the errors: {code}")
            print(f"phase 15 server {w}x{h} ({gpu}): {emb['payload_bits']} "
                  f"bits over {ins['payload_frames']} of {emb['frames_used']} "
                  "frames, first-frame PSNR "
                  f"{emb['first_frame_psnr_db']} dB; extract pixel-identical, "
                  f"hash_ok; steganalyze delta {stz['estimated_delta']} "
                  f"num_ac {stz.get('estimated_num_ac')} ratio "
                  f"{stz['detection_ratio']}; verified residual 0 "
                  f"(PSNR {ver.get('first_frame_psnr_db')} dB); 422/400/404; "
                  "healthy", flush=True)
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "the in-process server did not stop")

        port = _free_port()
        log_path = tmp / "serve.log"
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            daemon = subprocess.Popen(
                [sys.executable, "-m", "stegotpu_torch.cli", "serve",
                 "--port", str(port)], cwd=tmp, env=env, stdout=log,
                stderr=subprocess.STDOUT)
        base = f"http://127.0.0.1:{port}"
        try:
            up = None
            while time.perf_counter() - t0 < 180 and daemon.poll() is None:
                try:
                    if _http(base, "/healthz", timeout=5)[0] == 200:
                        up = time.perf_counter() - t0
                        break
                except OSError:
                    time.sleep(0.1)
            check(up is not None, f"serve did not answer /healthz (exit "
                  f"{daemon.poll()}): {log_path.read_text()[-2000:]}")
            body = {**embed, "output": str(tmp / "dst")}
            firsts = []
            for _ in range(2):
                code, out, seconds = _http(base, "/embed", body)
                check(code == 200 and out["success"],
                      f"serve /embed: {code} {out}")
                firsts.append(seconds)
            daemon.send_signal(signal.SIGINT)
            rc = daemon.wait(timeout=60)
        finally:
            if daemon.poll() is None:
                daemon.kill()
                daemon.wait()
        for line in log_path.read_text().splitlines():
            print(f"phase 15 serve: {line}", flush=True)
        check(rc == 0, f"serve exited {rc} on SIGINT")
        print(f"phase 15 serve subprocess ({gpu}): /healthz after {up:.2f} s, "
              f"first /embed {firsts[0]:.3f} s, second {firsts[1]:.3f} s, "
              "exit 0 on SIGINT; host clock, a finding", flush=True)

        gui = _GuiStandIn()
        snap = {"paths": {"cover": str(cover), "secret": str(secret_png),
                          "stego_out": str(tmp / "gui.avi"),
                          "stego_in": str(tmp / "gui.avi"),
                          "image_out": str(tmp / "gui.png"),
                          "pub_key": str(tmp / "p.pem"),
                          "priv_key": str(tmp / "k.pem")},
                "config": StegoConfig(), "procs": 1, "auto_recover": False,
                "device": resolve_device()}
        sk.LAUNCHES.clear()
        t0 = time.perf_counter()
        gui.embed(snap)
        k1 = sk.LAUNCHES["stegotpu_qim_embed"]
        logs = gui.logs()
        check(any(m.startswith("embedded ") for m, _ in logs)
              and not any(tag == "ERR" for _, tag in logs),
              f"GUI embed: {logs}")
        for procs in (1, 2):
            gui.extract({**snap, "procs": procs})
            logs = gui.logs()
            check(("SHA3-256 integrity: OK", "OK") in logs
                  and np.array_equal(load_image_gray(tmp / "gui.png"), secret),
                  f"GUI extract procs {procs}: {logs}")
            (tmp / "gui.png").unlink()
        try:
            importlib.import_module("tkinter")
            tk = "importable"
        except ImportError as e:
            tk = f"not importable ({e})"
        k2 = sk.LAUNCHES["stegotpu_qim_extract_packed"]
        print(f"phase 15 GUI workers {w}x{h} on {snap['device']}: embed, "
              "extract procs 1 and procs 2 (thread): SHA3-256 integrity OK, "
              f"pixel-identical; stegotpu_qim_embed={k1} "
              f"stegotpu_qim_extract_packed={k2} (both extracts); "
              f"{time.perf_counter() - t0:.2f} s host clock; tkinter {tk}",
              flush=True)
        check(k1 > 0 and k2 > 0, f"GUI workers launched stegotpu_qim_embed="
              f"{k1} stegotpu_qim_extract_packed={k2}")

        sk.LAUNCHES.clear()
        rc, out = _tool(soak_kernels.main, ["20", "0"])
        check(rc == 0 and out.strip().splitlines()[-1].endswith(
            "20 configs, 0 failures (arms on cuda: oracle 0, xla 0, "
            "pallas 0, plain 0)"), f"soak_kernels: exit {rc}")
        k1, k2 = (sk.LAUNCHES[e] for e in ("stegotpu_qim_embed",
                                            "stegotpu_qim_extract_packed"))
        check(k1 > 0 and k2 > 0, f"soak_kernels launched stegotpu_qim_embed="
              f"{k1} stegotpu_qim_extract_packed={k2}")
        print(f"phase 15 soak_kernels launches: stegotpu_qim_embed={k1} "
              f"stegotpu_qim_extract_packed={k2}", flush=True)
        sk.LAUNCHES.clear()
        rc, _ = _tool(soak_product.main, ["3", "0"])
        check(rc == 0, f"soak_product: exit {rc}")
        print("phase 15 soak_product launches: " + " ".join(
            f"{k}={v}" for k, v in sk.LAUNCHES.items() if v), flush=True)
        # the trace tool as users run it, in a process of its own: a trace
        # taken late in a long process that has traced before can lose
        # device events (PERF.md, the serving path's finding)
        argv = ["--batch", "8", "--iters", "3", "--out", str(tmp / "trace")]
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "stegotpu_torch.tools.profile_roundtrip",
             *argv], cwd=tmp, env=env, capture_output=True, text=True,
            timeout=300)
        for line in (run.stdout + run.stderr).splitlines():
            print(f"phase 15 profile_roundtrip: {line}", flush=True)
        check(run.returncode == 0, f"profile_roundtrip: exit {run.returncode}")
        line = json.loads(run.stdout.strip().splitlines()[-1])
        check(line["k4_launches"] == 3 and line["k4_events"] >= 3,
              f"profile_roundtrip: {line}")
        print(f"phase 15 profile_roundtrip {' '.join(argv[:-2])}: exit 0, "
              f"{line['k4_launches']} K4 launches traced, {line['k4_events']} "
              f"K4 events in the trace; {time.perf_counter() - t0:.2f} s host "
              "clock, the process start included", flush=True)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s host clock",
          flush=True)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (stegotpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the eight CUDA kernels from stegotpu_torch/csrc (one nvcc per
source, all started together) and runs ten phases:

1-2. K1 (embed) and K2 (packed extract) against their plain PyTorch
     versions at 1920x1080 and 1360x768;
3.   the port's default embed -> extract round trip at 1920x1080 through
     the pipeline's entry points (the path of K1 and K2);
4.   every kernel's time and its plain version's, with CUDA events
     (K1-K8);
5.   the file-to-file embed and extract, where cryptography, Pillow and a
     video backend are installed;
6.   K3 (embed + check), K4 (fused round trip) and K5 (unpacked extract)
     against their plain versions;
7.   the zero-tolerance identities kernel against kernel, then the
     exactness harness (ops/exactness.py, the path of K4 and K5);
8.   the TF32 sentinel: a row fails with TF32 in the oracle, and passes
     without;
9.   the verified embed at full width (the path of K3), on arrays and file
     to file;
10.  K6 (unpacked fused round trip) against K1, K5 and K4 with zero
     tolerance and against its plain version; K7 and K8 (Kronecker embed
     and extract) against their plain versions; then the path of the three
     kernels: the fused and the Kronecker round trips at 1080p with their
     quality metrics (ops/qim.roundtrip_metrics), the oracle's
     embed_extract_evaluate, and the device PSNR/SSIM against the host's.

Every phase prints; any failure exits non-zero. The line before the last
is a JSON object with each kernel's route, source, launches on its path,
error and times: "ms"/"plain_ms" the median CUDA-event time of one call
(host time where the host side outlasts the device work),
"device_ms"/"plain_device_ms" the device time per call with the host
queued ahead. The last line is {"ok": true, "device": {...}}.

Without a CUDA device, or outside a checkout that holds stegotpu_torch,
it exits non-zero and prints no result. It imports only torch, numpy and
stegotpu_torch (which imports cryptography, Pillow and cv2 only in the
file-to-file phase).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import re
import subprocess
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


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _ptxas_summary(log: str) -> str:
    """Registers and spill-store bytes of every kernel from nvcc's
    -Xptxas=-v report: 'embed<2>:128r/0s(max 168r/0s) ...' for the stripe
    kernels, the instantiation of the default num_ac=10 (rn=2) and the
    largest over rn=1..8; 'kron_embed:64r/0s' for the Kronecker kernels,
    which have one instantiation."""
    per: dict[str, dict[int, tuple[int, int]]] = {}
    name, rn, spill = None, 0, 0
    for line in log.splitlines():
        m = re.search(r"\d(?:qim_([a-z_]+)_kernelILi(\d)E|(kron_[a-z]+)_kernelE)",
                      line)
        if m and "Compiling entry" in line:
            name = m.group(1) or m.group(3)
            rn, spill = int(m.group(2) or 0), 0
        m2 = re.search(r"(\d+) bytes spill stores", line)
        if m2 and name:
            spill = int(m2.group(1))
        m3 = re.search(r"Used (\d+) registers", line)
        if m3 and name:
            per.setdefault(name, {})[rn] = (int(m3.group(1)), spill)
            name = None
    out = []
    for kernel, by_rn in sorted(per.items()):
        if set(by_rn) == {0}:
            out.append(f"{kernel}:{by_rn[0][0]}r/{by_rn[0][1]}s")
            continue
        r2, s2 = by_rn.get(2, (-1, -1))
        out.append(f"{kernel}<2>:{r2}r/{s2}s(max "
                   f"{max(r for r, _ in by_rn.values())}r/"
                   f"{max(s for _, s in by_rn.values())}s)")
    return " ".join(out)


def _time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, over `runs` calls after warm-up.
    The events bracket the host's work too: where a call's host side (the
    wrapper's checks, the launch, its small torch ops) outlasts its device
    work, the device waits and this is host time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _queued_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Device time of one call: the mean over `runs` calls that the host
    queued while the stream was held by a sleep kernel, so they run back to
    back (a wrapper's small torch ops count, the host's time does not)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s: the host queues every call
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


COUNTERS = {
    "stripe_kernel": ("EMBED_LAUNCHES", "EXTRACT_LAUNCHES", "CHECK_LAUNCHES",
                      "ROUNDTRIP_LAUNCHES", "EXTRACT_ROWS_LAUNCHES",
                      "ROUNDTRIP_ROWS_LAUNCHES"),
    "kron_kernel": ("KRON_EMBED_LAUNCHES", "KRON_EXTRACT_LAUNCHES"),
}


def _counter_modules():
    from stegotpu_torch.ops import stripe_kernel
    from stegotpu_torch.ops.experimental import kron_kernel

    return {"stripe_kernel": stripe_kernel, "kron_kernel": kron_kernel}


def _counts() -> dict[str, int]:
    return {c: getattr(mod, c) for key, mod in _counter_modules().items()
            for c in COUNTERS[key]}


def _set_counts(counts: dict[str, int] | None = None) -> None:
    """Set every launch counter of every kernel module (to 0 without
    `counts`)."""
    for key, mod in _counter_modules().items():
        for c in COUNTERS[key]:
            setattr(mod, c, 0 if counts is None else counts[c])


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
    _set_counts()
    t0 = time.perf_counter()
    stego, bpf = embed_payload_into_gray_frames(cover, bits, cfg, device=dev)
    out = extract_bits_from_gray_frames(stego, cfg, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"embed": sk.EMBED_LAUNCHES,
                "extract_packed": sk.EXTRACT_LAUNCHES}
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
          f"to the cover; EMBED_LAUNCHES={launches['embed']} "
          f"EXTRACT_LAUNCHES={launches['extract_packed']}; {seconds:.2f} s "
          "host clock",
          flush=True)
    del stego, out

    # phase 4: kernel and plain times at 1920x1080, B=8
    b, h, w = 8, 1080, 1920
    frames = torch.from_numpy(
        rng.integers(16, 240, (b, h, w), dtype=np.uint8)).to(dev)
    cap = (h // 8) * (w // 8) * NUM_AC
    payload = torch.from_numpy(
        rng.integers(0, 2, (b, cap), dtype=np.uint8)).to(dev)
    total = b * cap
    counts = _counts()
    args = (frames, payload, total, DELTA, NUM_AC)
    calls = {
        "embed": lambda: sk.embed_frames(*args),
        "embed_plain": lambda: sk.embed_frames_plain(*args),
        "extract_packed": lambda: sk.extract_frames_packed(frames, DELTA,
                                                           NUM_AC),
        "extract_packed_plain": lambda: sk.extract_frames_packed_plain(
            frames, DELTA, NUM_AC),
        "embed_check": lambda: sk.embed_and_check_frames(*args),
        "embed_check_plain": lambda: sk.embed_and_check_frames_plain(*args),
        "roundtrip_packed": lambda: sk.embed_and_extract_frames_packed(*args),
        "roundtrip_packed_plain":
            lambda: sk.embed_and_extract_frames_packed_plain(*args),
        "extract_rows": lambda: sk.extract_frames_rows(frames, DELTA, NUM_AC),
        "extract_rows_plain": lambda: sk.extract_frames_rows_plain(
            frames, DELTA, NUM_AC),
        "roundtrip_rows": lambda: sk.embed_and_extract_frames_rows(*args),
        "roundtrip_rows_plain":
            lambda: sk.embed_and_extract_frames_rows_plain(*args),
        "kron_embed": lambda: kk.embed_frames_kron(*args),
        "kron_embed_plain": lambda: kk.embed_frames_kron_plain(*args),
        "kron_extract": lambda: kk.extract_frames_kron(frames, DELTA, NUM_AC),
        "kron_extract_plain": lambda: kk.extract_frames_kron_plain(
            frames, DELTA, NUM_AC),
    }
    times = {k: _time_ms(fn) for k, fn in calls.items()}
    queued = {k: _queued_ms(fn) for k, fn in calls.items()}
    _set_counts(counts)  # timing is not a path's run
    print(f"phase 4 times 1920x1080 B=8 (median of 20 CUDA-event runs, {gpu}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)
    print(f"phase 4 device times 1920x1080 B=8 (mean of 20 calls queued "
          f"behind a sleep kernel, {gpu}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in queued.items()), flush=True)

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

    stripe = ("stegotpu_torch/csrc/qim_stripe.cu", "stegotpu/ops/pallas_kernel.py")
    kron = ("stegotpu_torch/csrc/qim_kron.cu",
            "stegotpu/ops/experimental/pallas_kron.py")
    replaces = {"embed": (stripe, 529), "extract_packed": (stripe, 577),
                "embed_check": (stripe, 906), "roundtrip_packed": (stripe, 804),
                "extract_rows": (stripe, 545), "roundtrip_rows": (stripe, 785),
                "kron_embed": (kron, 58), "kron_extract": (kron, 80)}
    errs.update(embed=embed_err, extract_packed=extract_err)
    kernels = [
        {"name": k, "route": "cuda", "source": source,
         "replaces": f"{tpu_file}:{line}",
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k], "plain_ms": times[f"{k}_plain"],
         "device_ms": queued[k], "plain_device_ms": queued[f"{k}_plain"]}
        for k, ((source, tpu_file), line) in replaces.items()]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was not launched on its path: {launches}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


class _StageTimer:
    """Host-clock seconds per pipeline stage (the pipeline's `timer`
    protocol: a `stage(name)` context manager)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t)

    def __str__(self) -> str:
        return " ".join(f"{k} {v:.3f} s" for k, v in sorted(self.totals.items()))


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
        _set_counts()
        embed_stages, extract_stages = _StageTimer(), _StageTimer()
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
        counts = _counts()
        check(out.success and out.hash_ok, f"file extract failed: {out.error}")
        check(np.array_equal(out.pixels, secret),
              "file extract: secret not pixel-identical")
        print(f"{label}: {res.total_payload_bits} bits in {res.frames_used} "
              f"frames, residual {res.residual_bits}, secret "
              f"{secret_hw[1]}x{secret_hw[0]} pixel-identical, SHA3 ok; host "
              f"clock: embed {t1 - t0:.3f} s ({embed_stages}), extract "
              f"{t2 - t1:.3f} s ({extract_stages}); launches "
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


def _identities_and_harness(dev, rng, with_cv2: bool) -> dict[str, int]:
    """Phase 7: the zero-tolerance identities kernel against kernel, then
    the exactness harness (ops/exactness.py), the path that runs K4 and K5.
    Returns the K4 and K5 launches of the harness's run."""
    import numpy as np
    import torch

    from stegotpu_torch.ops import exactness
    from stegotpu_torch.ops import stripe_kernel as sk

    spread = torch.arange(8, dtype=torch.uint8, device=dev)
    for (h, w) in ((1080, 1920), (768, 1360)):
        for cover in ("mid", "uniform"):
            frames, payload, total = _covers(dev, rng, 8, h, w, cover)
            args = (frames, payload, total, DELTA, NUM_AC)
            s1, _ = sk.embed_frames(*args)
            s3, _, err3 = sk.embed_and_check_frames(*args)
            s4, _, p4 = sk.embed_and_extract_frames_packed(*args)
            check(torch.equal(s3, s1), f"K3 stego != K1 stego at {h}x{w}")
            check(torch.equal(s4, s1), f"K4 stego != K1 stego at {h}x{w}")
            check(torch.equal(p4, sk.extract_frames_packed(s4, DELTA, NUM_AC)),
                  f"K4 bits != K2 of K4's stego at {h}x{w}")
            for x in (frames, s1):
                r5 = sk.extract_frames_rows(x, DELTA, NUM_AC)
                p2 = sk.extract_frames_packed(x, DELTA, NUM_AC)
                check(torch.equal(r5, ((p2[..., None] >> spread) & 1)
                                  .reshape(r5.shape)),
                      f"K5 lanes != K2 bytes at {h}x{w}")
            count = sk.count_wrong_bits(sk.extract_frames(s3, DELTA, NUM_AC),
                                        payload, total)
            check(torch.equal(err3, count),
                  f"K3 count {err3.tolist()} != K2 count {count.tolist()}")
            print(f"phase 7 identities {h}x{w} B=8 {cover}: K3 stego == K4 "
                  "stego == K1 stego; K4 bits == K2(K4 stego) byte for byte; "
                  "K5 == K2 lane for lane; K3 count == K2 count "
                  f"({int(count.sum())})", flush=True)

    _set_counts()
    rows = [exactness.quick_exactness_check(device=dev)]
    for content in ("noise", "compressed") if with_cv2 else ("noise",):
        rows += exactness.check_config(4, 1080, 1920, 10, [DELTA],
                                       np.random.default_rng(42),
                                       verbose=False, content=content,
                                       device=dev)
    launches = {"roundtrip_packed": sk.ROUNDTRIP_LAUNCHES,
                "extract_rows": sk.EXTRACT_ROWS_LAUNCHES}
    for row in rows:
        check(exactness.row_ok(row), f"exactness row failed: {row}")
        print(f"phase 7 exactness {row['w']}x{row['h']} B={row['batch']} "
              f"delta {row['delta']} {row['content']}: row_ok; "
              + " ".join(f"{k}={row[k]}" for k in exactness.EXACT_KEYS)
              + f" roundtrip_errors {row['roundtrip_errors_pallas']}/"
              f"{row['roundtrip_errors_xla']} cover boundary flips "
              f"{row['extract_mismatch_cover']}", flush=True)
    check(all(v > 0 for v in launches.values()),
          f"the exactness harness did not launch K4 and K5: {launches}")
    print(f"phase 7 harness launches: ROUNDTRIP_LAUNCHES="
          f"{launches['roundtrip_packed']} EXTRACT_ROWS_LAUNCHES="
          f"{launches['extract_rows']}", flush=True)
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


def _letterboxed(rng, b: int, bar: int = 136):
    """(b, 1080, 1920) u8: black bars of `bar` rows above and below a
    picture of luma 60..195 (136 rows = 17 block rows: no block straddles
    the edge)."""
    import numpy as np

    frames = np.zeros((b, 1080, 1920), np.uint8)
    frames[:, bar:-bar] = rng.integers(60, 196, (b, 1080 - 2 * bar, 1920),
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

    _set_counts()
    t0 = time.perf_counter()
    s_mid, bpf_mid, r_mid = embed_frames_verified_fast(mid, payload, total,
                                                       DELTA, NUM_AC)
    after_mid = sk.CHECK_LAUNCHES
    s_box, bpf_box, r_box = embed_frames_verified_fast(boxed, payload, total,
                                                       DELTA, NUM_AC)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"embed_check": sk.CHECK_LAUNCHES}
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
          f"recovers all {total} bits; CHECK_LAUNCHES={launches['embed_check']}"
          f"; {seconds:.3f} s host clock", flush=True)
    if files:
        from stegotpu_torch.config import StegoConfig

        n = _file_to_file(
            dev, rng, "phase 9 verified file-to-file 1080p letterboxed",
            [np.repeat(_letterboxed(rng, 6)[..., None], 3, axis=-1)],
            (240, 320), StegoConfig(verified_embed=True))["CHECK_LAUNCHES"]
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
    Returns each kernel's max_abs_err (largest stego pixel difference for
    K6 and K7; 1 if a K8 bit differed outside the envelope) and its
    launches on the path."""
    import numpy as np
    import torch

    from stegotpu_torch.metrics import psnr_batch, psnr_np, ssim_batch, ssim_np
    from stegotpu_torch.ops import qim
    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.ops.experimental import kron_kernel as kk
    from stegotpu_torch.ops.experimental.qim_fast import build_state_plane

    errs = {"roundtrip_rows": 0, "kron_embed": 0, "kron_extract": 0}
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
            torch.cuda.synchronize()
            check(torch.equal(bpf7, bpf7p), f"K7 bpf differ at {h}x{w}")
            d = (s7.to(torch.int32) - s7p.to(torch.int32)).abs()
            flips = (d > 1).double().mean().item()
            errs["kron_embed"] = max(errs["kron_embed"], int(d.max()))
            check(flips < STEGO_FLIP_BUDGET,
                  f"K7 vs plain: {flips:.4%} of pixels differ by >1 at {h}x{w}")
            never = build_state_plane(payload, total, h, w, NUM_AC,
                                      offset) == 3
            check(bool(never.any()) and torch.equal(s7[never], frames[never]),
                  f"K7: blocks never entered not passed through at {h}x{w}")
            counts = []
            for x in (frames, s7):
                b8 = kk.extract_frames_kron(x, DELTA, NUM_AC)
                diff = b8 != kk.extract_frames_kron_plain(x, DELTA, NUM_AC)
                outside = int((diff & ~_near_boundary_t(x, DELTA, NUM_AC)).sum())
                errs["kron_extract"] = max(errs["kron_extract"], int(outside > 0))
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
    _set_counts()
    t0 = time.perf_counter()
    s6, _, ex6 = sk.embed_and_extract_frames_fused(*args)
    m6 = qim.roundtrip_metrics(frames, s6, ex6, payload, total)
    s7, _, ex7 = kk.embed_and_extract_frames_kron(*args)
    m7 = qim.roundtrip_metrics(frames, s7, ex7, payload, total)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"roundtrip_rows": sk.ROUNDTRIP_ROWS_LAUNCHES,
                "kron_embed": kk.KRON_EMBED_LAUNCHES,
                "kron_extract": kk.KRON_EXTRACT_LAUNCHES}
    check(all(v > 0 for v in launches.values()),
          f"the round trips did not launch K6, K7 and K8: {launches}")
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
          f"ROUNDTRIP_ROWS_LAUNCHES={launches['roundtrip_rows']} "
          f"KRON_EMBED_LAUNCHES={launches['kron_embed']} "
          f"KRON_EXTRACT_LAUNCHES={launches['kron_extract']}; {seconds:.3f} s "
          "host clock", flush=True)
    return errs, launches


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (stegotpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the two CUDA stripe kernels from stegotpu_torch/csrc, checks
each against its plain PyTorch version on the card, drives the port's
default embed -> extract round trip at 1920x1080 through the pipeline's
entry points, times the kernels and their plain versions with CUDA
events, and — where cryptography, Pillow and a video backend are
installed — runs the file-to-file embed and extract. Every phase prints
one line; any failure exits non-zero. The line before the last is a JSON
object with each kernel's route, source, launches on the main path, error
and times; the last line is {"ok": true, "device": {...}}.

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
    """'embed<2>:128r/0s ...' from nvcc's -Xptxas=-v report."""
    out, name, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"qim_(embed|extract_packed)_kernelILi(\d)E", line)
        if m and "Compiling entry" in line:
            name = f"{m.group(1)}<{m.group(2)}>"
        m2 = re.search(r"(\d+) bytes spill stores", line)
        if m2 and name:
            spill = m2.group(1)
        m3 = re.search(r"Used (\d+) registers", line)
        if m3 and name:
            out.append(f"{name}:{m3.group(1)}r/{spill}s")
            name = None
    return " ".join(sorted(out))


def _time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, over `runs` calls after warm-up."""
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


def _near_boundary(frames, delta: float, num_ac: int):
    """Per wire-order slot bit: True where the float64 coefficient lies
    within the exactness envelope of a rounding boundary."""
    import torch

    from stegotpu_torch.ops.dct import blockify, kron_dct_tensor

    k = kron_dct_tensor(frames.device, torch.float64)[1 : 1 + num_ac]
    y = blockify(frames.to(torch.float64)) @ k.T      # (B, nb, num_ac)
    r = y / delta
    dist = (r - torch.floor(r) - 0.5).abs() * delta
    near = dist <= TOL_ABS + TOL_REL * y.abs()
    return near.reshape(frames.shape[0], -1).cpu().numpy()


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
    sk.EMBED_LAUNCHES = sk.EXTRACT_LAUNCHES = 0
    t0 = time.perf_counter()
    stego, bpf = embed_payload_into_gray_frames(cover, bits, cfg, device=dev)
    out = extract_bits_from_gray_frames(stego, cfg, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"embed": sk.EMBED_LAUNCHES, "extract": sk.EXTRACT_LAUNCHES}
    check(int(bpf.sum()) == bits.size, "main path: not every bit embedded")
    got, _consumed = payload_mod.parse_payload_bits(out, cfg.dims_bits)
    check(got == parts, "main path: payload did not round-trip")
    tail = np.flatnonzero(bpf == 0)
    check(tail.size > 0 and np.array_equal(stego[tail], cover[tail]),
          "main path: frames past the payload differ from the cover")
    check(launches["embed"] > 0 and launches["extract"] > 0,
          f"main path did not launch both kernels: {launches}")
    print(f"phase 3 main path 1080p: {bits.size} payload bits over "
          f"{int((bpf > 0).sum())} of {len(cover)} frames round-trip exactly "
          f"(parse_payload_bits); frames {tail[0]}..{tail[-1]} byte-identical "
          f"to the cover; EMBED_LAUNCHES={launches['embed']} "
          f"EXTRACT_LAUNCHES={launches['extract']}; {seconds:.2f} s host clock",
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
    counts = (sk.EMBED_LAUNCHES, sk.EXTRACT_LAUNCHES)
    times = {
        "embed": _time_ms(lambda: sk.embed_frames(
            frames, payload, total, DELTA, NUM_AC)),
        "embed_plain": _time_ms(lambda: sk.embed_frames_plain(
            frames, payload, total, DELTA, NUM_AC)),
        "extract": _time_ms(lambda: sk.extract_frames_packed(
            frames, DELTA, NUM_AC)),
        "extract_plain": _time_ms(lambda: sk.extract_frames_packed_plain(
            frames, DELTA, NUM_AC)),
    }
    sk.EMBED_LAUNCHES, sk.EXTRACT_LAUNCHES = counts  # timing is not the main path
    print(f"phase 4 times 1920x1080 B=8 (median of 20 CUDA-event runs, {gpu}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)

    # phase 5: file to file, where the host libraries are installed
    libs = {m: importlib.util.find_spec(m) is not None
            for m in ("cryptography", "PIL", "cv2")}
    from stegotpu_torch.video import _use_native

    backend = "native" if _use_native("auto") else (
        "cv2" if libs["cv2"] else None)
    if all(libs.values()) and backend:
        print(f"phase 5 file-to-file: runs (video backend {backend})",
              flush=True)
        _file_to_file(dev, rng)
    else:
        print(f"phase 5 file-to-file: skipped, missing {libs} video backend "
              f"{backend}", flush=True)

    kernels = [
        {"name": "embed", "route": "cuda",
         "source": "stegotpu_torch/csrc/qim_stripe.cu",
         "replaces": "stegotpu/ops/pallas_kernel.py:529",
         "launches": launches["embed"], "max_abs_err": embed_err,
         "ms": times["embed"], "plain_ms": times["embed_plain"]},
        {"name": "extract_packed", "route": "cuda",
         "source": "stegotpu_torch/csrc/qim_stripe.cu",
         "replaces": "stegotpu/ops/pallas_kernel.py:577",
         "launches": launches["extract"], "max_abs_err": extract_err,
         "ms": times["extract"], "plain_ms": times["extract_plain"]},
    ]
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


def _file_to_file(dev, rng) -> None:
    """embed_image_in_video -> extract_image_from_video at 1080p on `dev`."""
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
        secret = rng.integers(0, 256, (480, 640), dtype=np.uint8)
        save_image_gray(secret, tmp / "secret.png")
        with VideoWriter(tmp / "cover.avi", 30.0, 1920, 1080) as writer:
            for _ in range(4):
                writer.write_bgr_batch(rng.integers(
                    16, 240, (6, 1080, 1920, 3), dtype=np.uint8))
        priv, pub = crypto.generate_keypair(rng)
        crypto.save_keypair_pem(priv, tmp / "priv.pem", tmp / "pub.pem")
        cfg = StegoConfig()
        sk.EMBED_LAUNCHES = sk.EXTRACT_LAUNCHES = 0
        embed_stages, extract_stages = _StageTimer(), _StageTimer()
        t0 = time.perf_counter()
        res = embed_image_in_video(
            tmp / "cover.avi", tmp / "secret.png", tmp / "stego.avi",
            crypto.serialize_public_compressed(pub), cfg, batch_frames=8,
            timer=embed_stages, device=dev)
        t1 = time.perf_counter()
        check(res.success, f"file embed failed: {res.error}")
        out = extract_image_from_video(
            tmp / "stego.avi", crypto.load_private_pem(tmp / "priv.pem"), cfg,
            tmp / "extracted.png", batch_frames=8, timer=extract_stages,
            device=dev)
        t2 = time.perf_counter()
        check(out.success and out.hash_ok, f"file extract failed: {out.error}")
        check(np.array_equal(out.pixels, secret),
              "file extract: secret not pixel-identical")
        print(f"phase 5 file-to-file 1080p: {res.total_payload_bits} bits in "
              f"{res.frames_used} frames, secret 640x480 pixel-identical, "
              f"SHA3 ok; host clock: embed {t1 - t0:.3f} s ({embed_stages}), "
              f"extract {t2 - t1:.3f} s ({extract_stages}); launches embed "
              f"{sk.EMBED_LAUNCHES} extract {sk.EXTRACT_LAUNCHES}", flush=True)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)

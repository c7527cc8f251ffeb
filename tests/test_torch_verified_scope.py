"""The port's verified embed on letterboxed film covers, at full capacity,
against the benchmark's plain reference (stegobench/reference_verified.py,
which imports nothing of the program), on the CPU.

Two 96x256 frames: 2 block rows of bars at 0 above and below, and in the
picture a flat highlight patch at 255, a flat shadow patch at 0 and
textured mid-tones, as the uhd2160p24scope cell's covers hold them at 4K.
The plain embed loses payload bits there; the verified embed, its fast
path (K3's plain version, then the repair loop) and the loop alone, gives
the reference's stego where that is certain, no residual, and every
payload bit back. The loop runs inside one stegotpu_torch.verified.repair
span, the fast path's wait for K3's count inside one
stegotpu_torch.host_wait, and ops/verified.REPAIRS counts both.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from stegobench import reference, reference_verified
from stegotpu_torch.ops import stripe_kernel, verified

H, W, FRAMES, NUM_AC, DELTA, ROUNDS = 96, 256, 2, 10, 20.0, 3
BARS = 16
CAP = (H // 8) * (W // 8) * NUM_AC
TOTAL = FRAMES * CAP
SEED = 2**31 + 22


def _cover(kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(frames, payload bits at full capacity): "scope", the letterboxed
    cover, or "midtone", textured mid-tones alone (nothing clips)."""
    rng = np.random.default_rng(SEED)
    base = rng.integers(44, 212, (FRAMES, H // 8, W // 8))
    frames = (np.repeat(np.repeat(base, 8, 1), 8, 2)
              + rng.integers(-20, 21, (FRAMES, H, W)))
    if kind == "scope":
        frames[:, :BARS] = 0
        frames[:, H - BARS:] = 0
        frames[:, 24:40, 0:64] = 255       # clipped highlights
        frames[:, 40:56, 64:128] = 0       # crushed shadows
    bits = rng.integers(0, 2, (FRAMES, CAP))
    return (torch.from_numpy(frames.astype(np.uint8)),
            torch.from_numpy(bits.astype(np.uint8)))


EMBEDS = {
    "fast": lambda f, b: verified.embed_frames_verified_fast(
        f, b, TOTAL, DELTA, NUM_AC, repair_rounds=ROUNDS),
    "loop": lambda f, b: verified.embed_frames_verified(
        f, b, TOTAL, DELTA, NUM_AC, repair_rounds=ROUNDS),
}


@pytest.mark.parametrize("path", list(EMBEDS))
def test_verified_embed_matches_the_reference_on_scope_covers(path):
    frames, bits = _cover("scope")
    stego, bpf, residual = EMBEDS[path](frames, bits)
    ref = reference_verified.embed_verified(frames, bits, TOTAL, DELTA,
                                            NUM_AC, ROUNDS)
    assert ref.sure.float().mean() > 0.9
    assert torch.equal(stego[ref.sure], ref.stego[ref.sure])
    assert int(residual) == ref.residual == 0
    assert torch.equal(bpf.to(torch.int64), ref.bpf)
    for precision in ("f32", "f64"):
        assert torch.equal(reference.extract(stego, DELTA, NUM_AC, precision),
                           bits)


def test_the_plain_embed_loses_bits_on_the_same_cover():
    frames, bits = _cover("scope")
    stego, _ = stripe_kernel.embed_frames(frames, bits, TOTAL, DELTA, NUM_AC)
    lost = int((reference.extract(stego, DELTA, NUM_AC, "f64") != bits).sum())
    assert lost > 100


def test_the_reference_control_moves_stego_pixels():
    frames, bits = _cover("scope")
    ref = reference_verified.embed_verified(frames, bits, TOTAL, DELTA,
                                            NUM_AC, ROUNDS)
    tf32 = reference_verified.embed_verified(frames, bits, TOTAL, DELTA,
                                             NUM_AC, ROUNDS, "tf32")
    assert int(((tf32.stego != ref.stego) & ref.sure).sum()) > 0


def _spans(tmp_path, body) -> list[str]:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e["name"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("kind, kernel, counts, repairs, waits", [
    ("scope", "auto", (1, 1, ROUNDS), 1, 1),
    ("midtone", "auto", (1, 0, 0), 0, 1),
    ("scope", "xla", (1, 1, ROUNDS), 1, 0),
])
def test_repair_span_host_wait_and_counts(tmp_path, kind, kernel, counts,
                                          repairs, waits):
    frames, bits = _cover(kind)
    before = dict(verified.REPAIRS)

    def body():
        verified.embed_frames_verified_fast(
            frames, bits, TOTAL, DELTA, NUM_AC, repair_rounds=ROUNDS,
            kernel=kernel)

    names = _spans(tmp_path, body)
    assert names.count("stegotpu_torch.verified.repair") == repairs
    assert names.count("stegotpu_torch.host_wait") == waits
    got = tuple(verified.REPAIRS[k] - before.get(k, 0)
                for k in ("checked", "repaired", "rounds"))
    assert got == counts

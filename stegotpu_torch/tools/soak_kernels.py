"""Randomized deep soak: the kernels against the scalar scipy oracle.

Counterpart of ``tools/soak_kernels.py``: the same random (H, W, num_ac,
delta, payload fraction, cover style) configurations from the same
``rng`` calls, and the same four checks for every arm:

  - bits per frame: the kernel's count equals the payload length, which
    the oracle embeds;
  - extraction of the kernel's stego by the ORACLE (scipy, scalar loop —
    the reference's arithmetic) recovers the payload exactly: wire-level
    robustness, not just self-consistency;
  - extraction of the ORACLE's stego by the kernel recovers it too;
  - the kernel's own round trip is exact.

The arms: ``xla`` (the Kronecker-matmul oracle, ops/qim.py) and
``pallas`` (ops/stripe_kernel.py: K1 and K2 on the card, their plain
versions on the CPU); on the card a third arm, ``plain``, runs the plain
versions there.

Run: python -m stegotpu_torch.tools.soak_kernels [N] [SEED] [--device D]
Prints one line per failure and a summary; exit 1 on any failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from stegotpu_torch.device import resolve_device
from stegotpu_torch.ops import qim
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.tools.reference_model import (embed_frame_oracle,
                                                  extract_frame_oracle)


@dataclasses.dataclass
class Draw:
    """One configuration: an (h, w) frame of a cover style, and a payload
    whose first `total` bits (a drawn share of the frame's capacity) are
    embedded."""

    h: int
    w: int
    num_ac: int
    delta: int
    style: str
    frame: np.ndarray
    payload: np.ndarray
    total: int

    @property
    def tag(self) -> str:
        return (f"h={self.h} w={self.w} N={self.num_ac} d={self.delta} "
                f"total={self.total}/{self.payload.size} {self.style}")


def draw(rng: np.random.Generator) -> Draw:
    """The next configuration, from tools/soak_kernels.py's rng calls in
    their order."""
    h = 8 * int(rng.integers(2, 13))
    # any 8-multiple width: non-128 multiples exercise the pad/mask path
    w = 8 * int(rng.integers(4, 61))
    num_ac = int(rng.integers(1, 33))
    delta = int(rng.integers(9, 49))
    frac = float(rng.uniform(0.05, 1.0))
    style = str(rng.choice(["midluma", "textured"]))
    lo, hi = (48, 208) if style == "midluma" else (64, 192)
    frame = rng.integers(lo, hi, (h, w), dtype=np.uint8)

    cap = (h // 8) * (w // 8) * num_ac
    total = max(1, int(cap * frac))
    payload = np.zeros(cap, np.uint8)
    payload[:total] = rng.integers(0, 2, total)
    return Draw(h, w, num_ac, delta, style, frame, payload, total)


def _extract_plain(frames: torch.Tensor, delta: float,
                   num_ac: int) -> torch.Tensor:
    """K2's plain version then the wire-order unpack, on the frames'
    device."""
    _, h, w = frames.shape
    return sk.packed_rows_to_bits_plain(
        sk.extract_frames_packed_plain(frames, delta, num_ac), h, w, num_ac,
        sk.pick_stripe(h))


def arms(device: torch.device) -> list[tuple]:
    """(name, embed, extract) of every arm on `device`."""
    out = [("xla", qim.embed_frames, qim.extract_frames),
           ("pallas", sk.embed_frames, sk.extract_frames)]
    if device.type == "cuda":
        out.append(("plain", sk.embed_frames_plain, _extract_plain))
    return out


def one_config(rng: np.random.Generator, device: torch.device
               ) -> dict[str, list[str]]:
    """Draw one configuration and run every arm's four checks: the
    failures of each arm, by arm name ('oracle': the oracle's own embed
    count)."""
    d = draw(rng)
    bitstr = "".join(map(str, d.payload[: d.total]))
    errs: dict[str, list[str]] = {"oracle": []}
    errs.update((name, []) for name, _, _ in arms(device))

    stego_o, n_o = embed_frame_oracle(d.frame, bitstr, d.delta, d.num_ac)
    if n_o != d.total:
        errs["oracle"].append(f"{d.tag}: oracle embedded {n_o} != {d.total}")

    frame = torch.from_numpy(d.frame[None]).to(device)
    payload = torch.from_numpy(d.payload[None]).to(device)
    oracle_stego = torch.from_numpy(stego_o[None]).to(device)
    want = d.payload[: d.total]
    for name, embed, extract in arms(device):
        stego_k, bpf = embed(frame, payload, d.total, float(d.delta),
                             d.num_ac)
        bpf = int(bpf.cpu()[0])
        if bpf != d.total:
            errs[name].append(f"{d.tag} [{name}]: bpf {bpf} != {d.total}")
        # kernel stego -> oracle extract (the reference's arithmetic)
        stego_np = stego_k.cpu().numpy()[0]
        got = extract_frame_oracle(stego_np, d.delta, d.num_ac)[: d.total]
        if got != bitstr:
            bad = sum(a != b for a, b in zip(got, bitstr))
            errs[name].append(f"{d.tag} [{name}]: oracle misreads kernel "
                              f"stego ({bad}/{d.total} bits)")
        # oracle stego -> kernel extract
        ex = extract(oracle_stego, float(d.delta), d.num_ac).cpu().numpy()
        ex = ex.reshape(-1)[: d.total]
        if not np.array_equal(ex, want):
            errs[name].append(f"{d.tag} [{name}]: kernel misreads oracle "
                              f"stego ({int((ex != want).sum())}/{d.total} "
                              "bits)")
        # self round trip
        ex2 = extract(stego_k, float(d.delta), d.num_ac).cpu().numpy()
        ex2 = ex2.reshape(-1)[: d.total]
        if not np.array_equal(ex2, want):
            errs[name].append(f"{d.tag} [{name}]: self round trip "
                              f"({int((ex2 != want).sum())}/{d.total} bits)")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m stegotpu_torch.tools.soak_kernels",
        description="the QIM kernels against the scalar scipy oracle on "
                    "random configurations")
    ap.add_argument("n", nargs="?", type=int, default=60,
                    help="configurations (default 60)")
    ap.add_argument("seed", nargs="?", type=int, default=0,
                    help="rng seed (default 0)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    failures = dict.fromkeys(["oracle"] + [n for n, _, _ in arms(device)], 0)
    for i in range(args.n):
        for name, errs in one_config(rng, device).items():
            for e in errs:
                print(f"FAIL {e}")
            failures[name] += len(errs)
        if (i + 1) % 10 == 0:
            print(f"... {i + 1}/{args.n} configs, "
                  f"{sum(failures.values())} failures", flush=True)
    per_arm = ", ".join(f"{k} {v}" for k, v in failures.items())
    print(f"soak done: {args.n} configs, {sum(failures.values())} failures "
          f"(arms on {device}: {per_arm})", flush=True)
    return 1 if any(failures.values()) else 0


if __name__ == "__main__":
    sys.exit(main())

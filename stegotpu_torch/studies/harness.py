"""What every study's ``main`` shares: the card check, the card's name and
power limit, device-side inputs, queued CUDA-event timing and the row
printer."""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys

import torch


def require_cuda(prog: str) -> torch.device | None:
    """The first CUDA device, or None after a message on stderr: the
    studies time the card and have no CPU mode."""
    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA device; this study runs only on an NVIDIA GPU",
              file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# the JAX scripts' constants: every study embeds at these
NUM_AC = 10
DELTA = 20.0
SEED = 0

# readings queued_ms took again because the host fell behind the sleep, and
# readings it kept although the host fell behind in every try
RETAKES = 0
BEHIND = 0


def parser(description: str, batch: int) -> argparse.ArgumentParser:
    """The options every study takes; the defaults are the JAX scripts'
    shapes (1080x1920)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--iters", type=int, default=10,
                    help="calls timed per measurement")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    return ap


def inputs(dev: torch.device, b: int, h: int,
           w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform random (B, H, W) u8 frames and (B, C) payload bits at
    NUM_AC slots, made on the card from SEED."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames = torch.randint(0, 256, (b, h, w), generator=gen, device=dev,
                           dtype=torch.uint8)
    cap = (h // 8) * (w // 8) * NUM_AC
    payload = torch.randint(0, 2, (b, cap), generator=gen, device=dev,
                            dtype=torch.uint8)
    return frames, payload


def queued_ms(fns, runs: int = 10, warmup: int = 2, tries: int = 3) -> float:
    """Device time of one call: the mean over `runs` calls that the host
    queued while the stream was held by a sleep kernel, so they run back to
    back (a wrapper's small torch ops count, the host's time does not).

    `fns` is one no-argument callable or a list of them, called in turn:
    one per input set, so that a list whose sets together exceed the L2
    times each call with its inputs in HBM. The results of the last
    len(fns) calls are kept, so that their outputs do not share memory.

    Where the sleep had ended before the host queued the last call (the
    host stalled, e.g. in the allocator's synchronizing cudaFree), the
    device sat idle between calls and the mean counts it; the measurement
    is then taken again, up to `tries` times. A call that holds the host
    every time (one that synchronizes) keeps its last reading. RETAKES
    counts the readings taken again, BEHIND the readings kept so."""
    global RETAKES, BEHIND
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    keep = collections.deque(maxlen=len(fns))
    for i in range(warmup):
        keep.append(fns[i % len(fns)]())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for attempt in range(tries):
        RETAKES += attempt > 0
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)  # about 0.1 s: the host queues every call
        start.record()
        for i in range(runs):
            keep.append(fns[i % len(fns)]())
        end.record()
        behind = start.query()  # the stream passed the sleep before the host was done
        end.synchronize()
        if not behind:
            break
    else:
        BEHIND += 1
    return start.elapsed_time(end) / runs


def emit(row: dict) -> None:
    """One result row: a JSON object on a line of its own."""
    print(json.dumps(row), flush=True)


def header(study: str, dev: torch.device, args) -> None:
    """The first row of every study: the card, its power limit and the
    run's shapes."""
    emit({"study": study, "device": torch.cuda.get_device_name(dev),
          "gpu": gpu_line(), "num_ac": NUM_AC, "delta": DELTA, "seed": SEED,
          **{k: v for k, v in vars(args).items()
             if isinstance(v, (int, float, str))}})

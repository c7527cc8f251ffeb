"""Capture a profiler trace of K4, the fused round-trip kernel.

Counterpart of ``tools/profile_roundtrip.py``: records
``stripe_kernel.embed_and_extract_frames_packed`` (K4) at 1920x1080
(``FRAME_HW``), num_ac 10, delta 20, on uniform random frames and payload
from seed 0, with ``utils/profiling.device_trace`` (torch.profiler; CPU
and CUDA activity) after one warm-up call outside the trace. ``--chain N``
feeds each call the last call's stego, N data-dependent calls a step, in
one Python loop (where the JAX tool chains them inside one jit).

Writes ``trace.json`` (Chrome trace format; open in Perfetto) under
``--out`` (default ``traces/roundtrip`` under the working directory; at
the root of a checkout, a directory that .gitignore lists) and prints one
JSON line: backend (the device), trace_dir, files, ``k4_launches``, the
K4 launches of the traced calls
(``stripe_kernel.LAUNCHES["stegotpu_qim_roundtrip_packed"]``), and
``k4_events``, the count of trace events of the CUDA kernel
``qim_roundtrip_packed_kernel`` (both 0 on the CPU, where the plain
version runs). Exits 1, with one line on stderr, when the trace holds
fewer K4 events than the traced calls launched: the profiler lost device
events, and the trace is incomplete.

Usage: python -m stegotpu_torch.tools.profile_roundtrip [--batch 128]
    [--iters 3] [--chain N] [--out DIR] [--device D]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from stegotpu_torch.device import resolve_device

DEFAULT_OUT = Path("traces") / "roundtrip"
K4_KERNEL = "qim_roundtrip_packed_kernel"
FRAME_HW = (1080, 1920)


def k4_events(trace: Path) -> int:
    """Events of the K4 CUDA kernel in a Chrome trace written by
    device_trace."""
    events = json.loads(trace.read_text()).get("traceEvents", [])
    return sum(1 for e in events
               if e.get("cat") == "kernel" and K4_KERNEL in e.get("name", ""))


def main(argv=None) -> int:
    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.utils.profiling import device_trace

    ap = argparse.ArgumentParser(
        prog="python -m stegotpu_torch.tools.profile_roundtrip",
        description="torch.profiler trace of the fused round-trip kernel")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--chain", type=int, default=0,
                    help="chain N data-dependent round trips a step, each "
                         "fed the last one's stego, instead of one call")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain version)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    b, (h, w), n_ac = args.batch, FRAME_HW, 10
    cap = (h // 8) * (w // 8) * n_ac
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.integers(0, 256, (b, h, w), dtype=np.uint8)).to(device)
    payload = torch.from_numpy(
        rng.integers(0, 2, (b, cap), dtype=np.uint8)).to(device)
    total = b * cap

    def step() -> int:
        if args.chain:
            f = frames
            for _ in range(args.chain):
                f, _bpf, _e = sk.embed_and_extract_frames_packed(
                    f, payload, total, 20.0, n_ac)
            return int(f.sum(dtype=torch.int64))
        s, _, e = sk.embed_and_extract_frames_packed(frames, payload, total,
                                                     20.0, n_ac)
        return int(s.sum(dtype=torch.int64) + e.sum(dtype=torch.int64))

    step()  # build, load and warm outside the trace

    out = Path(args.out)
    k4 = "stegotpu_qim_roundtrip_packed"
    before = sk.LAUNCHES[k4]
    with device_trace(out):
        for _ in range(args.iters):
            step()
    launches = sk.LAUNCHES[k4] - before

    produced = sorted(str(p.relative_to(out)) for p in out.rglob("*")
                      if p.is_file())
    events = k4_events(out / "trace.json")
    print(json.dumps({
        "backend": str(device),
        "trace_dir": str(out),
        "files": produced[:20],
        "n_files": len(produced),
        "k4_launches": launches,
        "k4_events": events,
    }))
    if events < launches:
        print(f"profile_roundtrip: the trace lost device events: {events} "
              f"{K4_KERNEL} events for {launches} launches", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Kernel exactness artifact on an NVIDIA GPU: the counterpart of
``tools/tpucheck.py``.

Runs the exactness sweep of ops/exactness.py with the hand-written CUDA
kernels on the card against the port's f32 oracle, and writes one row per
(shape, num_ac, delta, precision, content) plus a summary that names the
card and its power limit (``nvidia-smi``). Every row must pass
``row_ok``: the EXACT_KEYS identities at zero, and the BER bound on robust
parameter pairs. Exits non-zero, and writes ``"ok": false``, otherwise;
the summary then tells rows that break an identity (a kernel fault) from
rows past the BER bound alone, with the kernels' and the oracle's error
counts side by side.

    python -m stegotpu_torch.gpucheck [--quick] [--out GPUCHECK.json]

Needs a CUDA device; without one it exits non-zero and writes nothing.
TF32 stays off: the oracle is the f32 wire contract.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from stegotpu_torch.ops.exactness import EXACT_KEYS, check_config, row_ok

# (batch, h, w, num_ac, deltas, precision, content): the JAX tool's shapes
# and deltas, plus 1360x768 (a width off the 128 grid), num_ac=30 (the
# robust ceiling) and both content classes at the robust deltas
SWEEP = [
    *[(4, 480, 720, n, [1.0, 20.0, 100.0], "wire", "noise") for n in (1, 10, 63)],
    (4, 480, 720, 10, [12.0, 20.0], "fast", "noise"),
    *[(4, 1080, 1920, n, [1.0, 20.0, 100.0], "wire", "noise") for n in (1, 63)],
    (4, 1080, 1920, 10, [1.0, 8.0, 20.0, 30.0, 40.0, 50.0, 100.0], "wire",
     "noise"),
    (4, 1080, 1920, 30, [8.0, 20.0, 30.0], "wire", "noise"),
    *[(4, 768, 1360, n, [8.0, 20.0, 30.0], "wire", "noise") for n in (10, 30)],
    *[(2, 2160, 3840, n, [1.0, 20.0, 100.0], "wire", "noise") for n in (1, 10, 63)],
    (4, 1080, 1920, 10, [8.0, 12.0, 20.0, 30.0, 40.0, 50.0], "fast", "noise"),
    (2, 2160, 3840, 10, [12.0, 20.0], "fast", "noise"),
    *[(4, h, w, n, [8.0, 20.0, 30.0], "wire", "compressed")
      for (h, w) in ((1080, 1920), (768, 1360)) for n in (10, 30)],
    (4, 1080, 1920, 10, [12.0, 20.0], "fast", "compressed"),
]
QUICK = [(4, 240, 384, 10, [20.0], "wire", "noise"),
         (4, 240, 384, 10, [20.0], "fast", "noise")]


def gpu_name_and_power_limit() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m stegotpu_torch.gpucheck")
    ap.add_argument("--quick", action="store_true",
                    help="one small config (selftest-sized)")
    ap.add_argument("--out", default="GPUCHECK.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpucheck: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_name_and_power_limit()
    rng = np.random.default_rng(42)
    rows = []
    for b, h, w, num_ac, deltas, precision, content in (
            QUICK if args.quick else SWEEP):
        print(f"# b={b} {w}x{h} num_ac={num_ac} precision={precision} "
              f"content={content}", file=sys.stderr, flush=True)
        for r in check_config(b, h, w, num_ac, deltas, rng, verbose=False,
                              precision=precision, content=content,
                              device=dev):
            r["ok"] = row_ok(r)
            rows.append(r)
            print(json.dumps(r), flush=True)
    bad = [r for r in rows if not r["ok"]]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": gpu,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "rows": len(rows), "violations": len(bad),
        # a kernel fault breaks an identity; a row past the robust BER bound
        # with kernel and oracle counts alike is the algorithm's clipping loss
        "exact_key_violations": sum(
            1 for r in rows if any(r[k] for k in EXACT_KEYS)),
        "ber_violations": [
            {k: r[k] for k in ("h", "w", "num_ac", "delta", "content",
                               "precision", "total_bits",
                               "roundtrip_errors_pallas",
                               "roundtrip_errors_xla")}
            for r in bad if not any(r[k] for k in EXACT_KEYS)],
        "robust_rows": sum(1 for r in rows if r["robust"]),
        "ok": not bad,
    }
    Path(args.out).write_text(
        json.dumps({"summary": summary, "rows": rows}, indent=1) + "\n")
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

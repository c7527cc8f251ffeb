"""Run one cell of the benchmark once, on the card, and print its result.

    python3 stegobench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic, driver and
metric readers are found by name (stegobench/manifest.py). Set-up (imports,
the card, the kernel library, the inputs made from --seed, a warm-up on the
cell's shapes) is timed as setup_s; then the window runs for --seconds.
With --trace 1 the profiler records the part of the window that the
traffic names and the result holds the per-layer metrics, the device's
busy and window seconds and a breakdown; otherwise it holds the end-to-end
metrics. After the window the cell's Driver holds the outputs against the
plain reference (stegobench/reference.py); each number compared is printed
with its limit as the last lines of standard error and, under "checks", as
the last key of the result, which is the last line of standard output.

Exits 2, printing no result, without a CUDA card (or with fewer than the
cell asks for), and 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "stegotpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, control: bool = False,
             overrides: dict | None = None):
    """Set up, run and check one cell; (result dict, checks).
    `overrides` replaces keys of the cell's "config" and "traffic" (the
    CPU tests' small sizes); `control` puts the reference in the program's
    place (stegobench/control.py)."""
    import torch

    from stegobench import manifest, tracing

    cell = manifest.cell(root, workload)
    for part, new in (overrides or {}).items():
        getattr(cell, part).update(new)
    Driver = manifest.driver(root, cell.traffic["driver"])
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="stegobench-") as tmp:
        drv = Driver(cell.config, cell.traffic, seed, device, Path(tmp),
                     control)
        drv.setup()
        if cuda:
            torch.cuda.synchronize()
        part = cell.traffic.get("trace", {})
        tracer = tracing.Tracer(trace, part.get("offset_s", 0.0),
                                part.get("length_s"), Path(tmp))
        timer = tracing.StageTimer(span=tracer.span)
        tracer.prepare()
        setup_s = time.perf_counter() - t_start
        rec = drv.window(seconds, tracer, timer)
        rec.setup_s = setup_s
        rec.stages = dict(timer.totals)
        rec.timeline = tracer.timeline
        mem = torch.cuda.max_memory_allocated() if cuda else 0
        metrics = {}
        for m in cell.per_layer if trace else cell.end_to_end:
            v = manifest.reader(root, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        checks = drv.check(rec)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(mem)}
    tl = rec.timeline
    if trace and tl is not None:
        dev["busy_s"], dev["window_s"] = tl.busy_s, tl.window_s
    result = {"correct": all(c.ok for c in checks),
              "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": dev}
    if trace and tl is not None:
        result["breakdown"] = {"device_ops": tl.top_ops(10),
                               "idle_gaps": tl.idle_by_span(10)}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from stegobench import manifest

    chips = manifest.cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"stegobench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"stegobench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    result["device"]["gpu"] = power_limit()
    checks_line = result.pop("checks")
    result["checks"] = checks_line
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K12's variants read from the card's own timeline.

Counterpart of ``tools/device_roofline.py``. For each roofline variant
(``copy``, ``dmaspec``, ``embed``, ``fused``; ``name:stripe`` sets the
stripe, which is otherwise ``pick_stripe`` of the height; one that does
not divide the height gives an error row and exit code 1) it queues ``--iters`` calls behind a sleep kernel under
``torch.profiler`` with CUDA activity, exports the trace and reads the
device events: kernels, memcpys and memsets. ``parse_device_timeline``
reports the fields of the JAX tool's summary: the variant's kernel time
(the median of its launches), the period between the kernel's starts,
and the top non-kernel device ops per iteration (the wrapper's small
torch ops), plus the mean CUDA-event time per call as a cross-check.

``python -m stegotpu_torch.studies.device_roofline`` runs it on the card
(defaults: B=128 at 1080x1920); ``--keep-traces DIR`` keeps the Chrome
traces.
"""

from __future__ import annotations

import collections
import json
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch

from stegotpu_torch.studies import harness, roofline_r4

# trace categories of device activity in torch.profiler's Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the sleep kernel that holds the stream while the host queues the calls
SLEEP_KERNEL = "spin_kernel"


def device_events(trace: dict) -> list[dict]:
    """The device's complete events of a Chrome trace, by start time."""
    evs = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(evs, key=lambda e: float(e["ts"]))


def parse_device_timeline(events: list[dict], iters: int,
                          exclude: tuple[str, ...] = (SLEEP_KERNEL,)) -> dict:
    """Summarize the device events of `iters` queued calls. The variant's
    kernel is the kernel launched at least twice with the largest median
    duration (names containing an `exclude` entry are the harness's and
    are left out); everything else on the device is glue."""
    dev = [e for e in events if not any(x in e["name"] for x in exclude)]
    if not dev:
        return {"error": "no device events (host-only trace)"}
    groups: dict[str, list[dict]] = collections.defaultdict(list)
    for e in dev:
        if e.get("cat") == "kernel" and float(e["dur"]) > 0:
            groups[e["name"]].append(e)
    repeated = {n: es for n, es in groups.items() if len(es) >= 2}
    out: dict = {"n_device_events": len(dev)}
    kerns: list[dict] = []
    if repeated:
        kname = max(repeated, key=lambda n: statistics.median(
            float(e["dur"]) for e in repeated[n]))
        kerns = repeated[kname]
        out["kernel_name"] = kname[:60]
        durs = [float(k["dur"]) / 1e3 for k in kerns]
        out["kernel_ms_each"] = statistics.median(durs)
        out["kernel_count"] = len(durs)
        starts = sorted(float(k["ts"]) for k in kerns)
        if len(starts) > 1:
            out["iter_period_ms"] = statistics.median(
                (b - a) / 1e3 for a, b in zip(starts, starts[1:]))
    chosen = {id(k) for k in kerns}
    glue: collections.Counter = collections.Counter()
    cats: collections.Counter = collections.Counter()
    for e in dev:
        if id(e) not in chosen and float(e["dur"]) > 0:
            glue[e["name"]] += float(e["dur"])
            cats[e["cat"]] += 1
    out["glue_top"] = [{"name": n[:60], "total_ms": v / 1e3,
                        "per_iter_ms": v / 1e3 / max(iters, 1)}
                       for n, v in glue.most_common(6)]
    # the glue's device ops a call, by trace category (kernel, memset, memcpy)
    out["glue_per_iter"] = {c: k / max(iters, 1) for c, k in sorted(cats.items())}
    return out


def _trace(fn, iters: int, path: Path) -> list[dict]:
    """Queue `iters` calls of fn behind a sleep kernel under the profiler;
    the device events of the exported trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(200_000_000)  # about 0.1 s: the host queues every call
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    return device_events(json.loads(path.read_text()))


def main(argv=None) -> int:
    ap = harness.parser("Read K12's roofline variants from the device "
                        "timeline of torch.profiler.", 128)
    ap.add_argument("--variants", default="copy,dmaspec,embed,fused",
                    help="comma list; 'name:stripe' overrides the stripe "
                         "(e.g. fused:216)")
    ap.add_argument("--keep-traces", default=None, metavar="DIR",
                    help="keep each variant's Chrome trace in DIR")
    args = ap.parse_args(argv)
    dev = harness.require_cuda("device_roofline")
    if dev is None:
        return 2
    b, h, w, n = args.batch, args.height, args.width, harness.NUM_AC
    kernels = {label: kernel for label, _, kernel in roofline_r4.GRID}
    frames, payload = harness.inputs(dev, b, h, w)
    harness.header("device_roofline", dev, args)
    ok = True
    tmp = Path(tempfile.mkdtemp(prefix="device_roofline_"))
    try:
        for spec in args.variants.split(","):
            name, _, sstr = spec.partition(":")
            if kernels.get(name) is None:
                print(f"device_roofline: no variant {name!r}", file=sys.stderr)
                return 2
            stripe = roofline_r4.stripe_row(spec, int(sstr) if sstr else None,
                                            h)
            if isinstance(stripe, dict):
                harness.emit(stripe)
                ok = False
                continue
            fn, bytes_per_frame = roofline_r4.variant_call(
                kernels[name], stripe, frames, payload, harness.DELTA, n)
            path = tmp / f"devroof_{name}_{stripe}.json"
            summ = parse_device_timeline(_trace(fn, args.iters, path),
                                         args.iters)
            if args.keep_traces:
                Path(args.keep_traces).mkdir(parents=True, exist_ok=True)
                shutil.copy(path, Path(args.keep_traces) / path.name)
            summ.update({"variant": spec, "stripe": stripe, "batch": b,
                         "iters": args.iters,
                         "bytes_per_frame": bytes_per_frame,
                         "event_ms_per_iter": harness.queued_ms(
                             fn, runs=args.iters)})
            if "kernel_ms_each" in summ:
                summ["device_gbps"] = (b * bytes_per_frame
                                       / summ["kernel_ms_each"] / 1e6)
            if "iter_period_ms" in summ:
                summ["device_fps"] = b / summ["iter_period_ms"] * 1e3
            ok = ok and "error" not in summ
            harness.emit(summ)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

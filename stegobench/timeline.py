"""The device timeline of a traced window, read from torch.profiler's trace.

``DEVICE_CATS`` and ``device_events`` are frozen from
``stegotpu_torch/studies/device_roofline.py``. ``Timeline`` reads one
window of the trace: the window is the benchmark's own range
``WINDOW_SPAN`` (a ``record_function`` opened after the profiler starts and
closed, after a synchronise, before it stops), the device's operations
inside it, the benchmark's host spans, and the launch calls that tie each
device operation to the host span it was launched from (the trace's
``correlation`` ids). Times are seconds.
"""

from __future__ import annotations

import bisect
import collections

# trace categories of device activity in torch.profiler's Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host calls that enqueue device work, tied to it by args.correlation
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "stegobench.window"


def device_events(trace: dict) -> list[dict]:
    """The device's complete events of a Chrome trace, by start time."""
    evs = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(evs, key=lambda e: float(e["ts"]))


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Timeline:
    def __init__(self, trace: dict):
        evs = trace.get("traceEvents", [])
        wins = [e for e in evs if e.get("ph") == "X"
                and e.get("name") == WINDOW_SPAN]
        if not wins:
            raise ValueError(f"the trace holds no {WINDOW_SPAN} range")
        self.t0 = float(wins[0]["ts"])
        self.t1 = self.t0 + float(wins[0]["dur"])
        self.ops = []     # (start, end, name, correlation), microseconds
        for e in device_events(trace):
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if b > a:
                self.ops.append((a, b, e["name"],
                                 e.get("args", {}).get("correlation")))
        self.spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"], e.get("tid"))
                      for e in evs if e.get("ph") == "X"
                      and e.get("cat") == "user_annotation"
                      and e.get("name") != WINDOW_SPAN]
        self.launches = [(float(e["ts"]), e.get("tid"),
                          e.get("args", {}).get("correlation"))
                         for e in evs if e.get("ph") == "X"
                         and e.get("cat") in LAUNCH_CATS]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy(self) -> list[tuple[float, float]]:
        return _union([(a, b) for a, b, _, _ in self.ops])

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(b - a for a, b in self.busy()) / 1e6

    def device_s(self) -> float:
        """Seconds of device operations, summed (not their union)."""
        return sum(b - a for a, b, _, _ in self.ops) / 1e6

    def under(self, span: str) -> float:
        """Device seconds of the operations launched inside host spans
        named `span` (on the thread that opened the span)."""
        by_tid: dict = collections.defaultdict(list)
        for a, b, name, tid in self.spans:
            if name == span:
                by_tid[tid].append((a, b))
        for r in by_tid.values():
            r.sort()
        starts = {tid: [a for a, _ in r] for tid, r in by_tid.items()}
        corr = set()
        for ts, tid, c in self.launches:
            i = bisect.bisect_right(starts.get(tid, []), ts) - 1
            if c is not None and i >= 0 and ts <= by_tid[tid][i][1]:
                corr.add(c)
        return sum(b - a for a, b, _, c in self.ops if c in corr) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        """[name, seconds] of the device operations that took most time."""
        tot: collections.Counter = collections.Counter()
        for a, b, name, _ in self.ops:
            tot[name[:120]] += (b - a) / 1e6
        return [[k, v] for k, v in tot.most_common(n)]

    def idle_by_span(self, n: int = 10) -> list[list]:
        """[host span, seconds]: the window's idle device time, each gap
        split by the benchmark's host spans that overlap it (the rest is
        "no_span"), summed by span name, largest first. The spans are the
        benchmark's stages, which follow one another and do not nest."""
        gaps, prev = [], self.t0
        for a, b in self.busy():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        tot: collections.Counter = collections.Counter()
        spans = sorted(self.spans)
        first = 0
        for ga, gb in gaps:
            covered = 0.0
            while first < len(spans) and spans[first][1] <= ga:
                first += 1
            for k in range(first, len(spans)):
                a, b, name, _ = spans[k]
                if a >= gb:
                    break
                o = min(b, gb) - max(a, ga)
                if o > 0:
                    tot[name] += o / 1e6
                    covered += o
            if gb - ga > covered:
                tot["no_span"] += (gb - ga - covered) / 1e6
        return [[k, v] for k, v in tot.most_common(n)]

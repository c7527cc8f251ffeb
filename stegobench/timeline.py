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

    def idle_by_span(self, n: int | None = 10) -> list[list]:
        """[host span, seconds]: the window's idle device time by the host
        span it fell in, summed by span name, largest first (`n` of them;
        None: all). Each gap is split at the spans' edges and each piece
        goes to the innermost span that covers it, the one that started
        last (spans on one thread nest: stage > stegotpu_torch.* >
        launch.*), or to "no_span"; so the values sum to window_s - busy_s."""
        gaps, prev = [], self.t0
        for a, b in self.busy():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        # (start, end, innermost span) from t0 on: the spans' edges in time
        # order, a close before an open at the same time
        edges = sorted(e for i, (a, b, _, _) in enumerate(self.spans)
                       if b > a for e in ((a, 1, i), (b, 0, i)))
        pieces, active, at = [], [], self.t0   # active: (start, -end, i)
        for t, opens, i in edges:
            if t > at:
                pieces.append((at, t, self.spans[active[-1][2]][2]
                               if active else "no_span"))
                at = t
            a, b = self.spans[i][:2]
            if opens:
                bisect.insort(active, (a, -b, i))
            else:
                del active[bisect.bisect_left(active, (a, -b, i))]
        pieces.append((at, max(at, self.t1), "no_span"))
        tot: collections.Counter = collections.Counter()
        j = 0
        for ga, gb in gaps:
            while pieces[j][1] <= ga:
                j += 1
            for k in range(j, len(pieces)):
                a, b, name = pieces[k]
                if a >= gb:
                    break
                tot[name] += (min(b, gb) - max(a, ga)) / 1e6
        return [[k, v] for k, v in tot.most_common(n)]

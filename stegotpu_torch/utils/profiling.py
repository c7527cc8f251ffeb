"""Profiling and tracing: torch.profiler traces and lightweight stage timers.

Counterpart of ``stegotpu/utils/profiling.py``. ``StageTimer`` is a copy:
a host-clock timer for named pipeline stages (the pipelines' ``timer``
argument). ``device_trace`` records the CPU and CUDA activity of a block
with ``torch.profiler`` and writes a Chrome trace (open in Perfetto or
chrome://tracing), where the JAX package writes a ``jax.profiler`` trace;
``annotate`` is ``torch.profiler.record_function``, a named range on that
timeline, while a profiler records, and a shared no-op otherwise: the
program's spans (names that start with ``stegotpu_torch.``) cost one flag
test when nothing traces. ``StageTimer.stage`` opens one too, so a stage
timed inside a trace sits on the trace's clock.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

# read as a module attribute at call time: the profiler sets the flag on
# start and clears it on stop
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def device_trace(logdir: str | Path = "stegotpu-trace"):
    """Record a torch.profiler trace of the block (CPU, and CUDA where a
    card is present) and write it to `logdir`/trace.json; yields the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


class StageTimer:
    """Accumulating wall-clock timer for named pipeline stages.

    with timer.stage("decode"): ...
    print(timer.report())
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {n} calls, {t / n * 1e3:.2f} ms/call")
        return "\n".join(lines)


def annotate(name: str):
    """A named range on the profiler's timeline
    (torch.profiler.record_function) while a profiler records; otherwise
    a shared nullcontext, and no record_function is made."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    import torch

    return torch.profiler.record_function(name)

"""The benchmark's host clock and its traced window.

``StageTimer`` is frozen from ``stegotpu_torch/utils/profiling.py``: the
shape the pipelines' ``timer=`` argument takes (``stage(name)``), totals
in host seconds. Here each stage is also a span on the profiler's timeline
while a window is traced, so that the trace can name what the host did
while the device was idle.

``Tracer`` runs ``torch.profiler`` (host and CUDA activity) from before
the window opens and reads one part of the window: from ``offset_s`` after
the window opens, for ``length_s`` seconds (None: to the window's end).
Before that part opens and before it closes it lets the loop drain the
device (``quiesce``), so that every device operation in it belongs to work
launched there.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

from stegobench.timeline import WINDOW_SPAN, Timeline


class StageTimer:
    """Accumulating wall-clock timer for named pipeline stages."""

    def __init__(self, span=None) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self._span = span

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            if self._span is None:
                yield
            else:
                with self._span(name):
                    yield
        finally:
            self.totals[name] += time.perf_counter() - t0


class Tracer:
    def __init__(self, enabled: bool, offset_s: float = 0.0,
                 length_s: float | None = None, out: Path | None = None):
        self.enabled = enabled
        self.offset_s = offset_s
        self.length_s = length_s
        self.out = out
        self._prof = None
        self._window = None
        self._t_start = 0.0
        self.done = False
        self.timeline: Timeline | None = None

    @property
    def active(self) -> bool:
        """True while the traced part of the window is open."""
        return self._window is not None

    def span(self, name: str):
        """A named host range on the timeline while tracing, else nothing."""
        if self._prof is None:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def prepare(self) -> None:
        """Start the profiler before the window opens: its start-up (some
        seconds on the card the first time) is set-up, not window."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def tick(self, t_window: float, now: float, quiesce) -> None:
        """Open or close the traced part at a step boundary of the loop."""
        if self._prof is None or self.done:
            return
        if self._window is None and now - t_window >= self.offset_s:
            quiesce()
            import torch

            self._window = torch.profiler.record_function(WINDOW_SPAN)
            self._window.__enter__()
            self._t_start = time.perf_counter()
        elif (self._window is not None and self.length_s is not None
              and now - self._t_start >= self.length_s):
            self.close(quiesce)

    def close(self, quiesce) -> None:
        """Close the traced part (after quiesce), stop the profiler and read
        the trace."""
        if self._prof is None or self.done:
            return
        self.done = True
        if self._window is not None:
            quiesce()
            self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        if self._window is None:
            return
        path = self.out / "trace.json"
        prof.export_chrome_trace(str(path))
        self.timeline = Timeline(json.loads(path.read_text()))
        self._window = None
        path.unlink()

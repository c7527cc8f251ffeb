"""What the metric readers (stegobench/metrics/) share: each reads one
number from a run's ``core.Record``, or None where there is nothing to
read (no trace, no device time, no such stage), and the harness then
leaves that metric out of the result."""

from __future__ import annotations

from stegobench import work


def job_seconds(rec) -> float:
    return sum(j.t1 - j.t0 for j in rec.jobs)


def fps(rec) -> float | None:
    """Frames of whole jobs over the time from the window's start to the
    end of the last job."""
    if not rec.jobs or rec.t_end <= rec.t0:
        return None
    return sum(j.frames for j in rec.jobs) / (rec.t_end - rec.t0)


def stage_share_pct(rec, stage: str) -> float | None:
    """A stage's host seconds as a share of all jobs' time."""
    total = job_seconds(rec)
    if stage not in rec.stages or total <= 0:
        return None
    return 100.0 * rec.stages[stage] / total


def idle_pct(rec) -> float | None:
    """Share of the traced window in which no device operation ran."""
    tl = rec.timeline
    if tl is None or tl.window_s <= 0 or not tl.ops:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)


def roofline_pct(rec) -> float | None:
    """The least time of the traced frames' work (work.py) over the device
    time of every operation the traced steps ran."""
    tl = rec.timeline
    if tl is None or rec.traced_frames == 0 or tl.device_s() <= 0:
        return None
    nbytes, flops = work.work(rec.step, rec.h, rec.w, rec.num_ac)
    least, _ = work.bound_s(nbytes * rec.traced_frames,
                            flops * rec.traced_frames)
    return 100.0 * least / tl.device_s()


def span_share_pct(rec, span: str) -> float | None:
    """Device time launched under the benchmark's host span `span`, as a
    share of the traced window's device time."""
    tl = rec.timeline
    if tl is None or tl.device_s() <= 0:
        return None
    under = tl.under(span)
    return 100.0 * under / tl.device_s() if under > 0 else None

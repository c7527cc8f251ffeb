"""The readers of the program's own spans and stages (unpack_share_pct,
host_wait_share_pct, decode_share_pct) on canned traces and records:
nested spans, spans across the window's edges, a program without spans,
no trace."""

from __future__ import annotations

from pathlib import Path

import pytest

from stegobench import manifest
from stegobench.core import Job, Record
from stegobench.timeline import WINDOW_SPAN, Timeline

ROOT = Path(__file__).resolve().parents[2]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _span(name, ts, dur, tid=1):
    return _x("user_annotation", name, ts, dur, tid)


def program_trace(waits=True) -> dict:
    """A 1000 us window (1000-2000). A host_wait from 900 crosses its start
    (100 us inside); dispatch launches K4 (200 us) under a launch span and
    two unpack kernels (300 + 100 us) under the unpack span; eval holds
    stegotpu_torch.eval, which holds a host_wait of 580 us with another
    nested in it; a last host_wait crosses the window's end (50 us inside).
    Host waits inside: 730 us of 1000. Unpack: 400 us of 600."""
    evs = [
        _span(WINDOW_SPAN, 1000, 1000),
        _span("dispatch", 1100, 100),
        _span("stegotpu_torch.launch.stegotpu_qim_roundtrip_packed", 1105, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 1106, 2, correlation=1),
        _x("kernel", "qim_roundtrip_packed_kernel", 1150, 200, correlation=1),
        _span("stegotpu_torch.unpack", 1120, 70),
        _x("cuda_runtime", "cudaLaunchKernel", 1125, 2, correlation=2),
        _x("kernel", "CatArrayBatchedCopy", 1350, 300, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 1130, 2, correlation=3),
        _x("kernel", "elementwise_kernel", 1650, 100, correlation=3),
        _span("eval", 1200, 700),
        _span("stegotpu_torch.eval", 1210, 680),
    ]
    if waits:
        evs += [_span("stegotpu_torch.host_wait", 900, 200),
                _span("stegotpu_torch.host_wait", 1300, 580),
                _span("stegotpu_torch.host_wait", 1400, 100),
                _span("stegotpu_torch.host_wait", 1950, 150)]
    return {"traceEvents": evs}


def parent_trace() -> dict:
    """The same steps from a program that records no spans of its own."""
    return {"traceEvents": [e for e in program_trace()["traceEvents"]
                            if not e["name"].startswith("stegotpu_torch.")]}


def _record(trace=None, stages=None) -> Record:
    rec = Record("roundtrip", 2160, 3840, 10, t0=10.0, t_end=12.0)
    rec.jobs = [Job(10.0 + 0.5 * i, 10.5 + 0.5 * i, 48) for i in range(4)]
    rec.stages = dict(stages or {})
    rec.timeline = None if trace is None else Timeline(trace)
    return rec


def _read(name, rec):
    return manifest.reader(ROOT, name)(rec)


def test_host_wait_share_clips_to_the_window_and_counts_nesting_once():
    got = _read("host_wait_share_pct.stream", _record(program_trace()))
    assert got == pytest.approx(73.0)


def test_host_wait_share_is_zero_where_the_program_never_waits():
    rec = _record(program_trace(waits=False))
    assert _read("host_wait_share_pct.stream", rec) == 0.0


def test_host_wait_share_only_counts_spans_of_the_window():
    trace = program_trace(waits=False)
    trace["traceEvents"] = [
        e for e in trace["traceEvents"]
        if not e["name"].startswith("stegotpu_torch.")]
    trace["traceEvents"].append(_span("stegotpu_torch.host_wait", 2100, 50))
    assert _read("host_wait_share_pct.stream", _record(trace)) is None


def test_unpack_share_reads_what_the_unpack_span_launched():
    got = _read("unpack_share_pct.stream", _record(program_trace()))
    assert got == pytest.approx(100 * 400 / 600)


def test_unpack_share_ignores_a_span_of_another_thread():
    trace = program_trace()
    for e in trace["traceEvents"]:
        if e["name"] == "stegotpu_torch.unpack":
            e["tid"] = 2
    assert _read("unpack_share_pct.stream", _record(trace)) is None


@pytest.mark.parametrize("name", ["unpack_share_pct.stream",
                                  "host_wait_share_pct.stream"])
def test_span_readers_read_nothing_from_a_program_without_spans(name):
    assert _read(name, _record(parent_trace())) is None


@pytest.mark.parametrize("name", ["unpack_share_pct.stream",
                                  "host_wait_share_pct.stream",
                                  "decode_share_pct.embed"])
def test_readers_read_nothing_without_a_trace_or_stage(name):
    assert _read(name, _record()) is None


def test_decode_share_over_job_time():
    rec = _record(stages={"decode": 0.3, "decode_wait": 0.5})
    assert _read("decode_share_pct.embed", rec) == pytest.approx(15.0)

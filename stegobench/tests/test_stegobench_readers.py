"""The timeline reader and every metric reader on a canned trace and a
canned stage record."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from stegobench import manifest, work
from stegobench.core import Job, Record
from stegobench.timeline import WINDOW_SPAN, Timeline

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "pid": 1, "args": args}


def canned_trace() -> dict:
    """A 1000 us window: a dispatch span launching a 200 us kernel, an eval
    span launching a 300 us kernel and a 100 us copy, then a 400 us sync
    with the device idle for its last 300 us."""
    return {"traceEvents": [
        _x("user_annotation", WINDOW_SPAN, 1000, 1000),
        _x("user_annotation", "dispatch", 1000, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 1010, 5, correlation=1),
        _x("kernel", "qim_roundtrip_packed_kernel", 1020, 200, correlation=1),
        _x("user_annotation", "eval", 1100, 500),
        _x("cuda_runtime", "cudaLaunchKernel", 1110, 5, correlation=2),
        _x("kernel", "reduce_kernel", 1220, 300, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 1130, 5, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 1520, 100, correlation=3),
        _x("user_annotation", "sync", 1600, 400),
        _x("kernel", "outside_the_window", 2500, 50, correlation=9),
    ]}


def test_timeline_reads_the_window():
    tl = Timeline(canned_trace())
    assert tl.window_s == pytest.approx(1e-3)
    assert tl.busy_s == pytest.approx(600e-6)
    assert tl.device_s() == pytest.approx(600e-6)
    assert tl.under("eval") == pytest.approx(400e-6)
    assert tl.under("dispatch") == pytest.approx(200e-6)
    assert tl.under("absent") == 0
    assert tl.top_ops(2) == [["reduce_kernel", pytest.approx(300e-6)],
                             ["qim_roundtrip_packed_kernel",
                              pytest.approx(200e-6)]]
    idle = dict(tl.idle_by_span())
    # idle: 1000-1020 (dispatch), 1620-2000 (sync)
    assert idle == {"dispatch": pytest.approx(20e-6),
                    "sync": pytest.approx(380e-6)}


def test_timeline_needs_its_window():
    with pytest.raises(ValueError):
        Timeline({"traceEvents": []})


def _record(step="roundtrip", traced=True) -> Record:
    rec = Record(step, 2160, 3840, 10, t0=10.0, t_end=12.0)
    rec.jobs = [Job(10.0 + 0.2 * i, 10.1 + 0.2 * i + 0.01 * i, 8)
                for i in range(10)]
    rec.stages = {"encode": 0.6, "decode_wait": 0.3}
    rec.setup_s = 7.5
    if traced:
        rec.timeline = Timeline(canned_trace())
        rec.traced_frames = 16
    return rec


def expected(name: str, rec: Record):
    durations = sorted(j.t1 - j.t0 for j in rec.jobs)
    job_s = sum(durations)
    least = 16 * work.work(rec.step, 2160, 3840, 10)[0] / work.H100_HBM_BYTES_PER_S
    return {
        "embed_fps": 80 / 2.0, "stream_fps": 80 / 2.0, "setup_s": 7.5,
        "encode_share_pct.embed": 100 * 0.6 / job_s,
        "device_idle_pct.embed": 40.0,
        "device_idle_pct.stream": 40.0,
        "kernels_roofline_pct.stream": 100 * least / 600e-6,
        "eval_share_pct.stream": 100 * 400 / 600,
    }[name]


METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_on_a_canned_record(name):
    rec = _record()
    assert manifest.reader(ROOT, name)(rec) == pytest.approx(expected(name, rec))


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]
                                  if m["source"] == "device_trace"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert manifest.reader(ROOT, name)(_record(traced=False)) is None

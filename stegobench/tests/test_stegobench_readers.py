"""The timeline reader and every metric reader on a canned trace and a
canned stage record.

A metric's expected reading is `expected()`'s where that names it, else in
a file of its own, stegobench/tests/expected/<metric>.py, which defines
``expected(record)`` and may define ``record()``, a canned record of its
own; so a metric is added as files and entries alone."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from stegobench import manifest, work
from stegobench.core import Job, Record
from stegobench.timeline import WINDOW_SPAN, Timeline

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
EXPECTED = Path("stegobench") / "tests" / "expected"


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


def nested_trace() -> dict:
    """A 1000 us window whose spans nest: dispatch (from before the window)
    launches a 170 us kernel; the eval stage holds stegotpu_torch.eval,
    which holds the launch span of a 100 us kernel; then sync, then no
    span for the last 100 us."""
    return {"traceEvents": [
        _x("user_annotation", WINDOW_SPAN, 1000, 1000),
        _x("user_annotation", "dispatch", 950, 150),
        _x("cuda_runtime", "cudaLaunchKernel", 1010, 5, correlation=1),
        _x("kernel", "qim_roundtrip_packed_kernel", 1050, 170, correlation=1),
        _x("user_annotation", "eval", 1100, 600),
        _x("user_annotation", "stegotpu_torch.eval", 1150, 500),
        _x("user_annotation", "stegotpu_torch.launch.stegotpu_qim_eval",
           1200, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 1210, 5, correlation=2),
        _x("kernel", "qim_eval_kernel", 1500, 100, correlation=2),
        _x("user_annotation", "sync", 1700, 200),
    ]}


def test_idle_by_span_counts_each_gap_once_at_the_innermost_span():
    tl = Timeline(nested_trace())
    idle = tl.idle_by_span(None)
    assert sum(v for _, v in idle) == pytest.approx(tl.window_s - tl.busy_s)
    # idle: 1000-1050 dispatch; 1220-1250 the launch span; 1250-1500 and
    # 1600-1650 stegotpu_torch.eval; 1650-1700 eval; 1700-1900 sync
    assert dict(idle) == {"dispatch": pytest.approx(50e-6),
                          "stegotpu_torch.launch.stegotpu_qim_eval":
                              pytest.approx(30e-6),
                          "stegotpu_torch.eval": pytest.approx(300e-6),
                          "eval": pytest.approx(50e-6),
                          "sync": pytest.approx(200e-6),
                          "no_span": pytest.approx(100e-6)}
    assert [k for k, _ in tl.idle_by_span(2)] == ["stegotpu_torch.eval",
                                                   "sync"]


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


def expected(rec: Record) -> dict:
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
    }


def check_reader(root: Path, name: str) -> None:
    """Metric `name`'s reader in the benchmark at `root` reads what its
    canned record should give: `expected()`'s value where that names the
    metric, else root/stegobench/tests/expected/<name>.py's."""
    rec = _record()
    table = expected(rec)
    if name in table:
        want = table[name]
    else:
        path = root / EXPECTED / f"{name}.py"
        if not path.exists():
            pytest.fail(f"no expected reading for {name}: add "
                        f"{(EXPECTED / f'{name}.py').as_posix()} defining "
                        "expected(record)")
        mod = manifest.load_module(
            path, "stegobench_expected_" + name.replace(".", "_"))
        if hasattr(mod, "record"):
            rec = mod.record()
        want = mod.expected(rec)
    assert manifest.reader(root, name)(rec) == pytest.approx(want)


METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_on_a_canned_record(name):
    check_reader(ROOT, name)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]
                                  if m["source"] == "device_trace"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert manifest.reader(ROOT, name)(_record(traced=False)) is None

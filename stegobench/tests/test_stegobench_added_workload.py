"""A cell, a per-layer metric and a step's work count added as files
alone are found and used: a copy of the benchmark gains BENCHMARK.json
entries and new files, and no file that was there changes."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from stegobench import run
from stegobench.tests.test_stegobench_readers import check_reader

ROOT = Path(__file__).resolve().parents[2]


def _copy(tmp_path: Path) -> dict:
    """The benchmark copied to tmp_path; the bytes of each file of its own."""
    shutil.copytree(ROOT / "stegobench", tmp_path / "stegobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return {p: p.read_bytes() for p in (tmp_path / "stegobench").rglob("*")
            if p.is_file()}


def _add_metric(root: Path, name: str, reader: str) -> None:
    """A per-layer metric of the 4K round trip: a reader file and its entry."""
    (root / "stegobench" / "metrics" / f"{name}.py").write_text(reader)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": name, "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "a toy layer",
        "moves": "stream_fps", "workloads": ["uhd2160p60.roundtrip-device"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def test_a_new_traffic_file_is_found_and_run(tmp_path):
    before = _copy(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "uhd2160p60.toy-stream", "config": "uhd2160p60",
        "traffic": "toy-stream", "chips": 1,
        "why": "a toy: one batch in flight, no evaluation"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "uhd2160p60.roundtrip-device" in m.get("workloads", []):
            m["workloads"].append("uhd2160p60.toy-stream")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "stegobench" / "traffic" / "toy-stream.json").write_text(
        json.dumps({"driver": "device_stream", "evaluate": False,
                    "in_flight": 1, "pool_bytes_min": 100_000,
                    "sample_batches": 1,
                    "trace": {"offset_s": 0.0, "length_s": None},
                    "limits": {}}))

    res, _ = run.run_cell(tmp_path, "uhd2160p60.toy-stream", 7, 0.3, False,
                          "cpu", time.perf_counter(),
                          overrides={"config": {"width": 64, "height": 32}})
    assert res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == {"stream_fps", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


TOY_STEP = """def work(h, w, num_ac):
    return 3 * h * w, 5 * h * w
"""
TOY_READER = """from stegobench.readings import roofline_pct


def read(rec):
    return roofline_pct(rec)
"""
# the canned trace's 16 frames of toy_step: 3 bytes a pixel at 3.35 TB/s
# over its 600 us of device time
TOY_EXPECTED = """from stegobench.tests.test_stegobench_readers import _record


def record():
    rec = _record()
    rec.step = "toy_step"
    return rec


def expected(rec):
    return 100 * 16 * 3 * 2160 * 3840 / 3.35e12 / 600e-6
"""


def test_a_new_metric_and_step_are_found_as_files(tmp_path):
    before = _copy(tmp_path)
    bench = tmp_path / "stegobench"
    (bench / "steps").mkdir(exist_ok=True)
    (bench / "steps" / "toy_step.py").write_text(TOY_STEP)
    _add_metric(tmp_path, "toy_roofline_pct.stream", TOY_READER)
    (bench / "tests" / "expected" / "toy_roofline_pct.stream.py").write_text(
        TOY_EXPECTED)

    # a fresh interpreter whose stegobench is the copy's
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from pathlib import Path\n"
            "import stegobench\n"
            "from stegobench import manifest, work\n"
            "from stegobench.tests.test_stegobench_readers import check_reader\n"
            "assert Path(stegobench.__file__).resolve().parent == "
            "Path('stegobench').resolve()\n"
            "check_reader(Path('.'), 'toy_roofline_pct.stream')\n"
            "cell = manifest.cell(Path('.'), 'uhd2160p60.roundtrip-device')\n"
            "assert 'toy_roofline_pct.stream' in "
            "[m['name'] for m in cell.per_layer]\n"
            "n = work.work('toy_step', 2160, 3840, 10)\n"
            "print(*n, *work.bound_s(*n))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    nbytes, flops, least, by = out.stdout.split()
    assert (int(nbytes), int(flops)) == (3 * 2160 * 3840, 5 * 2160 * 3840)
    assert float(least) == pytest.approx(3 * 2160 * 3840 / 3.35e12)
    assert by == "bytes"
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_listed_metric_without_an_expectation_names_the_file_to_add(
        tmp_path):
    _copy(tmp_path)
    _add_metric(tmp_path, "toy_roofline_pct.stream", TOY_READER)
    with pytest.raises(pytest.fail.Exception,
                       match="add stegobench/tests/expected/"
                             r"toy_roofline_pct\.stream\.py"):
        check_reader(tmp_path, "toy_roofline_pct.stream")

"""A cell added as files alone is found and run: a copy of the benchmark
gains a BENCHMARK.json entry and a traffic file, and no file that was
there changes."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from stegobench import run

ROOT = Path(__file__).resolve().parents[2]


def test_a_new_traffic_file_is_found_and_run(tmp_path):
    shutil.copytree(ROOT / "stegobench", tmp_path / "stegobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "stegobench").rglob("*")
              if p.is_file()}
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

"""The manifest (BENCHMARK.json) and the files it names, and the work counts."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from stegobench import manifest, work

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "stegobench/run.py"]
    assert BENCH["paths"] == ["stegobench"]
    assert isinstance(BENCH["run_seconds"], int) and 10 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("stegobench/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS), (m, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    c = manifest.cell(ROOT, cell)
    assert manifest.driver(ROOT, c.traffic["driver"]) is not None
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(ROOT, m["name"]))


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_config_files_state_what_was_cut():
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert {"width", "height", "delta", "num_ac", "precision"} <= set(conf)


def test_work_counts_of_a_4k_frame():
    nbytes, flops = work.work("roundtrip", 2160, 3840, 10)
    assert nbytes == 19_180_800
    assert flops == 199_065_600
    least, by = work.bound_s(nbytes, flops)
    assert by == "bytes" and least == pytest.approx(5.7256e-6, rel=1e-4)
    assert work.work("roundtrip_eval", 2160, 3840, 10)[0] == nbytes
    assert work.work("file_embed", 720, 1280, 3) == (2 * 921_600 + 43_200,
                                                     2 * 14_400 * 256)


def test_a_step_without_a_file_names_the_file_to_add():
    with pytest.raises(KeyError, match="add stegobench/steps/no_such_step.py"):
        work.work("no_such_step", 2160, 3840, 10)

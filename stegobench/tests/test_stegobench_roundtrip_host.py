"""The array-API round trip (uhd2160p60.roundtrip-host) at a small size:
256x128 numpy frames in batches of 4.

BENCHMARK.json does not list the cell: its stream_fps spread over six runs
on the card, 5.7%, is above the 0.035 bound (PERF.md §7), so it waits for
a bound of its own. Its traffic and driver are here; these tests run it
from a copy of the benchmark that lists it, as that change would.

On the CPU (the program's plain versions): a sound run comes out correct
and its trace names the program's host waits (the pageable copies); the
control (the reference in TF32 in the program's place) and each fault
planted in the program under a whole run (a stego pixel flipped, an
extracted bit flipped) come out not correct. The `cuda` twins run the same
on the card:

    python -m pytest stegobench/tests/test_stegobench_roundtrip_host.py -m cuda -q
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest

from stegobench import run

ROOT = Path(__file__).resolve().parents[2]
CELL = "uhd2160p60.roundtrip-host"
SEED = 2**31 + 22
SMALL = {"config": {"width": 256, "height": 128, "batch_frames": 4},
         "traffic": {}}
ENTRY = {"name": CELL, "config": "uhd2160p60", "traffic": "roundtrip-host",
         "chips": 1,
         "why": "library users who decode 4K themselves and call the array "
                "API on numpy frames: pageable copies around K1 and K2"}
METRICS = ("stream_fps", "device_idle_pct.stream",
           "kernels_roofline_pct.stream", "host_wait_share_pct.stream")


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """A copy of the benchmark that lists the cell and its metrics."""
    r = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "stegobench", r / "stegobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(ENTRY)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(CELL)
    (r / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return r


def run_small(root, device="cpu", control=False, trace=False, seconds=0.4):
    over = {k: dict(v) for k, v in SMALL.items()}
    if trace:
        over["traffic"]["trace"] = {"offset_s": 0.0, "length_s": None}
    return run.run_cell(root, CELL, SEED, seconds, trace, device,
                        time.perf_counter(), control=control, overrides=over)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return "cuda:0"


def _sound(root, device):
    res, _ = run_small(root, device)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"stream_fps", "setup_s"}
    assert list(res["checks"]) == ["stego_px_wrong", "bits_wrong", "bpf_wrong"]


def _control(root, device):
    res, checks = run_small(root, device, control=True)
    assert not res["correct"]
    assert not {c.name: c for c in checks}["stego_px_wrong"].ok


def test_sound_run_is_correct(root):
    _sound(root, "cpu")


def test_traced_run_names_the_host_waits(root):
    res, _ = run_small(root, trace=True)
    assert res["correct"], res["checks"]
    assert "stegotpu_torch.host_wait" in {
        name for name, _ in res["breakdown"]["idle_gaps"]}


def test_control_is_not_correct(root):
    _control(root, "cpu")


# --- faults planted in the program under a whole run -------------------------

def _plant(monkeypatch, kind):
    from stegotpu_torch import pipeline

    if kind == "pixel":
        real = pipeline.embed_payload_into_gray_frames

        def faulty(frames, bits, config, device=None):
            stego, bpf = real(frames, bits, config, device=device)
            stego = stego.copy()
            stego[1, 40, 21] ^= 0x40
            return stego, bpf
        monkeypatch.setattr(pipeline, "embed_payload_into_gray_frames", faulty)
        return
    real_x = pipeline.extract_bits_from_gray_frames

    def flipped(frames, config, device=None):
        bits = real_x(frames, config, device=device).copy()
        bits[123] ^= 1
        return bits
    monkeypatch.setattr(pipeline, "extract_bits_from_gray_frames", flipped)


FAULTS = {"pixel": "stego_px_wrong", "bit": "bits_wrong"}


def _fault(monkeypatch, root, device, kind):
    _plant(monkeypatch, kind)
    res, checks = run_small(root, device)
    assert not res["correct"], res["checks"]
    assert not {c.name: c for c in checks}[FAULTS[kind]].ok, res["checks"]


@pytest.mark.parametrize("kind", list(FAULTS))
def test_planted_faults_are_not_correct(monkeypatch, root, kind):
    _fault(monkeypatch, root, "cpu", kind)


# --- the same on the card -----------------------------------------------------

@pytest.mark.cuda
def test_sound_run_on_the_card(root, card):
    _sound(root, card)


@pytest.mark.cuda
def test_traced_run_on_the_card(root, card):
    res, _ = run_small(root, card, trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    m = res["metrics"]
    assert {"device_idle_pct.stream", "kernels_roofline_pct.stream",
            "host_wait_share_pct.stream"} <= set(m)
    assert "repair_share_pct.stream" not in m
    assert 0 < m["host_wait_share_pct.stream"]["value"] < 100


@pytest.mark.cuda
def test_control_on_the_card(root, card):
    _control(root, card)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(FAULTS))
def test_planted_faults_on_the_card(monkeypatch, root, card, kind):
    _fault(monkeypatch, root, card, kind)

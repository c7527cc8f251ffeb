"""The verified cell (uhd2160p24scope.verified-device) at a small size:
256x96 scope covers with 2 block rows of bars above and below, batches of
4 frames at full capacity.

On the CPU (the program's plain versions): a sound run comes out correct
and its trace names the repair loop's span and the fast path's host wait;
the control (the reference in TF32 in the program's place) and each fault
planted in the program under a whole run (a stego pixel flipped, a payload
bit of a bar block altered, a residual reported) come out not correct. The
`cuda` twins run the same on the card, where the trace has device time and
the new metrics read it:

    python -m pytest stegobench/tests/test_stegobench_verified.py -m cuda -q
"""

from __future__ import annotations

import time
from pathlib import Path

import pytest

from stegobench import run

ROOT = Path(__file__).resolve().parents[2]
CELL = "uhd2160p24scope.verified-device"
SEED = 2**31 + 22
SMALL = {"config": {"width": 256, "height": 96, "batch_frames": 4,
                    "letterbox_rows": 16},
         "traffic": {"pool_bytes_min": 100_000}}
CHECKS = ["stego_px_wrong", "payload_bits_wrong", "bits_wrong", "bpf_wrong",
          "residual_wrong", "batches_failed"]
SPANS = {"stegotpu_torch.verified.repair", "stegotpu_torch.host_wait"}


def run_small(device="cpu", control=False, trace=False, seconds=0.4):
    over = {k: dict(v) for k, v in SMALL.items()}
    if trace:
        over["traffic"]["trace"] = {"offset_s": 0.0, "length_s": None}
    return run.run_cell(ROOT, CELL, SEED, seconds, trace, device,
                        time.perf_counter(), control=control, overrides=over)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return "cuda:0"


def _sound(device):
    res, _ = run_small(device)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"stream_fps", "setup_s"}
    assert list(res["checks"]) == CHECKS


def _traced(device):
    res, _ = run_small(device, trace=True)
    assert res["correct"], res["checks"]
    assert SPANS <= {name for name, _ in res["breakdown"]["idle_gaps"]} \
        or res["device"]["busy_s"] > 0
    return res


def _control(device):
    res, checks = run_small(device, control=True)
    assert not res["correct"]
    assert not {c.name: c for c in checks}["stego_px_wrong"].ok


def test_sound_run_is_correct():
    _sound("cpu")


def test_traced_run_names_the_repair_and_the_wait():
    res = _traced("cpu")
    assert SPANS <= {name for name, _ in res["breakdown"]["idle_gaps"]}


def test_control_is_not_correct():
    _control("cpu")


# --- faults planted in the program under a whole run -------------------------

def _plant(monkeypatch, kind):
    from stegotpu_torch.ops import verified

    real = verified.embed_frames_verified_fast

    def faulty(frames, payload, total, delta, num_ac, repair_rounds=3):
        if kind == "bar_bit":            # a payload bit of block 0, a bar
            payload = payload.clone()
            payload[0, 7] ^= 1
        stego, bpf, residual = real(frames, payload, total, delta, num_ac,
                                    repair_rounds=repair_rounds)
        if kind == "pixel":              # one picture pixel flipped
            stego = stego.clone()
            stego[1, 40, 21] ^= 0x40
        if kind == "residual":           # a residual the stego does not have
            residual = residual + 1
        return stego, bpf, residual
    monkeypatch.setattr(verified, "embed_frames_verified_fast", faulty)


FAULTS = {"pixel": "stego_px_wrong", "bar_bit": "payload_bits_wrong",
          "residual": "batches_failed"}


def _fault(monkeypatch, device, kind):
    _plant(monkeypatch, kind)
    res, checks = run_small(device)
    assert not res["correct"], res["checks"]
    assert not {c.name: c for c in checks}[FAULTS[kind]].ok, res["checks"]
    if kind == "residual":
        assert res["failed"] == res["attempted"]


@pytest.mark.parametrize("kind", list(FAULTS))
def test_planted_faults_are_not_correct(monkeypatch, kind):
    _fault(monkeypatch, "cpu", kind)


def test_the_verified_reference_loads_nothing_of_the_program():
    from stegobench.tests.test_stegobench_imports import _top_level_after

    mods = _top_level_after("import sys; sys.path.insert(0, '.')\n"
                            "import stegobench.reference_verified")
    assert not mods & {"stegotpu_torch", "stegotpu", "jax", "jaxlib"}


# --- the same on the card -----------------------------------------------------

@pytest.mark.cuda
def test_sound_run_on_the_card(card):
    _sound(card)


@pytest.mark.cuda
def test_traced_run_on_the_card(card):
    res = _traced(card)
    assert res["device"]["busy_s"] > 0
    m = res["metrics"]
    assert {"device_idle_pct.stream", "kernels_roofline_pct.stream",
            "repair_share_pct.stream", "host_wait_share_pct.stream"} <= set(m)
    assert 0 < m["repair_share_pct.stream"]["value"] <= 100


@pytest.mark.cuda
def test_control_on_the_card(card):
    _control(card)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(FAULTS))
def test_planted_faults_on_the_card(monkeypatch, card, kind):
    _fault(monkeypatch, card, kind)

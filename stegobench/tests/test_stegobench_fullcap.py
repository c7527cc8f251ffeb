"""The full-capacity data embed cell (fhd1080p30.embed-fullcap) at a small
size: 64x96 covers of 6 frames, num_ac 10, batches of 2, so 3 batches a job
and 598 plaintext bytes, which seal to exactly the 5,760 slots of the cover.

On the CPU (the program's plain versions): a sound run comes out correct;
the control (the reference in TF32 in the program's place) and each fault
planted in the program under a whole run (a stego pixel flipped, a frame
dropped, a payload bit altered) come out not correct; a traced run reads
the data path's stages. The `cuda` twins run the same on the card:

    python -m pytest stegobench/tests/test_stegobench_fullcap.py -m cuda -q
"""

from __future__ import annotations

import time
from pathlib import Path

import pytest

from stegobench import run

ROOT = Path(__file__).resolve().parents[2]
CELL = "fhd1080p30.embed-fullcap"
SEED = 2**31 + 11
SMALL = {"config": {"width": 96, "height": 64, "frames": 6,
                    "batch_frames": 2, "payload_bytes": 598}}
STAGE_METRICS = {"dispatch_share_pct.embed", "readback_share_pct.embed",
                 "seal_share_pct.embed"}


def run_small(device="cpu", control=False, trace=False, seconds=0.4):
    over = {"config": dict(SMALL["config"]), "traffic": {}}
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
    res, checks = run_small(device)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"embed_fps", "setup_s"}
    assert list(res["checks"]) == ["stego_px_wrong", "frames_px_wrong",
                                   "payload_bits_wrong", "data_bytes_wrong",
                                   "jobs_failed"]


def _traced(device):
    res, _ = run_small(device, trace=True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) >= STAGE_METRICS | {"encode_share_pct.embed",
                                                   "decode_share_pct.embed"}
    assert all(0 < res["metrics"][m]["value"] < 100 for m in STAGE_METRICS)
    return res


def _control(device):
    res, checks = run_small(device, control=True)
    assert not res["correct"]
    assert not {c.name: c for c in checks}["stego_px_wrong"].ok


def test_sound_run_is_correct():
    _sound("cpu")


def test_traced_run_reads_the_data_path_stages():
    _traced("cpu")


def test_control_is_not_correct():
    _control("cpu")


def test_a_payload_that_does_not_fill_the_cover_is_refused():
    over = {"config": {**SMALL["config"], "payload_bytes": 597}}
    with pytest.raises(ValueError, match="must fill the cover exactly"):
        run.run_cell(ROOT, CELL, SEED, 0.1, False, "cpu", time.perf_counter(),
                     overrides=over)


# --- faults planted in the program under a whole run -------------------------

def _plant(monkeypatch, kind):
    from stegotpu_torch import video
    from stegotpu_torch.ops import stripe_kernel

    if kind == "frame":                  # each job's first batch loses a frame
        real_write = video.VideoWriter.write_gray_batch
        seen = []

        def drop(self, frames):          # one call a batch, 3 batches a job
            seen.append(1)
            return real_write(self, frames[:-1] if len(seen) % 3 == 1
                              else frames)
        monkeypatch.setattr(video.VideoWriter, "write_gray_batch", drop)
        return
    real = stripe_kernel.embed_frames

    def faulty(frames, payload, total, delta, num_ac, bit_offset=0):
        if kind == "bit":                # one payload bit altered
            payload = payload.clone()
            payload[0, 7] ^= 1
            return real(frames, payload, total, delta, num_ac, bit_offset)
        stego, bpf = real(frames, payload, total, delta, num_ac, bit_offset)
        stego = stego.clone()            # one stego pixel flipped
        stego[1, 13, 21] ^= 0x40
        return stego, bpf
    monkeypatch.setattr(stripe_kernel, "embed_frames", faulty)


FAULTS = {"pixel": "stego_px_wrong", "frame": "frames_px_wrong",
          "bit": "payload_bits_wrong"}


def _fault(monkeypatch, device, kind):
    _plant(monkeypatch, kind)
    res, checks = run_small(device)
    assert not res["correct"], res["checks"]
    assert not {c.name: c for c in checks}[FAULTS[kind]].ok, res["checks"]
    if kind != "pixel":                  # the bits, so the tag, are wrong
        assert res["checks"]["data_bytes_wrong"]["value"] > 0


@pytest.mark.parametrize("kind", list(FAULTS))
def test_planted_faults_are_not_correct(monkeypatch, kind):
    _fault(monkeypatch, "cpu", kind)


# --- the same on the card -----------------------------------------------------

@pytest.mark.cuda
def test_sound_run_on_the_card(card):
    _sound(card)


@pytest.mark.cuda
def test_traced_run_on_the_card(card):
    res = _traced(card)
    assert res["device"]["busy_s"] > 0
    assert "device_idle_pct.embed" in res["metrics"]


@pytest.mark.cuda
def test_control_on_the_card(card):
    _control(card)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(FAULTS))
def test_planted_faults_on_the_card(monkeypatch, card, kind):
    _fault(monkeypatch, card, kind)


def test_the_data_reference_loads_nothing_of_the_program():
    from stegobench.tests.test_stegobench_imports import _top_level_after

    mods = _top_level_after("import sys; sys.path.insert(0, '.')\n"
                            "import stegobench.reference_data")
    assert not mods & {"stegotpu_torch", "stegotpu", "jax", "jaxlib"}

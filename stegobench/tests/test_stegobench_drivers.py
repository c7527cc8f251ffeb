"""Each driver at a small size on the CPU (the program's plain versions)
against the reference: sound runs come out correct; the control (the
reference in TF32 in the program's place) and each fault the cell can have,
planted in the program underneath a whole run, come out not correct.

These runs skip the harness's look for a card (run.run_cell with
device="cpu"); the same runs at the cells' own sizes are made on the card
by stegobench/control.py.
"""

from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

from stegobench import run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11

SMALL = {
    "ref720p24.embed-image64": {"config": {"width": 320, "height": 240,
                                           "frames": 12},
                                "traffic": {"secret_size": 16}},
    "uhd2160p60.roundtrip-device": {"config": {"width": 256, "height": 128,
                                               "batch_frames": 16},
                                    "traffic": {"pool_bytes_min": 1_000_000}},
    "uhd2160p60.eval-device": {"config": {"width": 256, "height": 128,
                                          "batch_frames": 16},
                               "traffic": {"pool_bytes_min": 1_000_000}},
}


def run_small(cell: str, control: bool = False, seconds: float = 0.4,
              trace: bool = False, root: Path = ROOT):
    over = {k: dict(v) for k, v in SMALL[cell].items()}
    if trace:
        over["traffic"]["trace"] = {"offset_s": 0.0, "length_s": None}
    return run.run_cell(root, cell, SEED, seconds, trace, "cpu",
                        time.perf_counter(), control=control, overrides=over)


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    res, checks = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}
    assert list(res)[-1] == "checks"
    assert [c.name for c in checks] == list(res["checks"])


@pytest.mark.parametrize("cell", list(SMALL))
def test_traced_run_reads_spans(cell):
    res, _ = run_small(cell, trace=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert res["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_not_correct(cell):
    res, checks = run_small(cell, control=True)
    assert not res["correct"]
    assert any(c.name.startswith("stego_px") and not c.ok for c in checks)


# --- faults planted in the program under a whole run -------------------------

def _stream_fault(kind):
    from stegotpu_torch.ops import stripe_kernel

    real = stripe_kernel.embed_and_extract_frames

    def faulty(frames, payload, total, delta, num_ac):
        if kind == "unchanged":          # returns its state unchanged
            stego, bpf, bits = real(frames, payload, total, delta, num_ac)
            return frames.clone(), bpf, payload.clone()
        if kind == "half":               # half of the batch left out
            h = frames.shape[0] // 2
            stego, bpf, bits = real(frames[:h].contiguous(),
                                    payload[:h].contiguous(),
                                    min(total, h * payload.shape[1]), delta,
                                    num_ac)
            return (torch.cat([stego, frames[h:]]), torch.cat([bpf, bpf]),
                    torch.cat([bits, payload[h:]]))
        stego, bpf, bits = real(frames, payload, total, delta, num_ac)
        bits = bits.clone()
        bits[0, 0] ^= 1                  # an answer altered where produced
        return stego, bpf, bits
    return stripe_kernel, "embed_and_extract_frames", faulty


@pytest.mark.parametrize("cell", ["uhd2160p60.roundtrip-device",
                                  "uhd2160p60.eval-device"])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_stream_faults_are_not_correct(monkeypatch, cell, kind):
    mod, name, fn = _stream_fault(kind)
    monkeypatch.setattr(mod, name, fn)
    res, _ = run_small(cell)
    assert not res["correct"], res["checks"]


def test_eval_over_half_the_batch_is_not_correct(monkeypatch):
    """The PSNR's mean taken over half of the batch."""
    from stegotpu_torch.ops import qim

    real = qim.roundtrip_metrics

    def half(frames, stego, extracted, payload, total):
        m = real(frames, stego, extracted, payload, total)
        h = frames.shape[0] // 2
        m["psnr_db"] = real(frames[:h], stego[:h], extracted[:h],
                            payload[:h], total)["psnr_db"]
        return m
    monkeypatch.setattr(qim, "roundtrip_metrics", half)
    res, _ = run_small("uhd2160p60.eval-device")
    assert not res["correct"], res["checks"]
    assert res["checks"]["psnr_gap_db"]["value"] > res["checks"]["psnr_gap_db"]["limit"]


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_file_embed_faults_are_not_correct(monkeypatch, kind):
    from stegotpu_torch.ops import stripe_kernel

    real = stripe_kernel.embed_frames

    def faulty(frames, payload, total, delta, num_ac, bit_offset=0):
        if kind == "unchanged":
            _, bpf = real(frames, payload, total, delta, num_ac, bit_offset)
            return frames.clone(), bpf
        payload = payload.clone()
        payload[0, 5] ^= 1               # a payload bit altered
        return real(frames, payload, total, delta, num_ac, bit_offset)
    monkeypatch.setattr(stripe_kernel, "embed_frames", faulty)
    res, _ = run_small("ref720p24.embed-image64")
    assert not res["correct"], res["checks"]

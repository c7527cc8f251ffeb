"""The port's headline benchmark (stegotpu_torch.benchmark) on the CPU:
its byte count, and that it refuses to run without a card (it measures
the card; chip_smoke.py runs it there)."""

import pytest
import torch

from stegotpu_torch import benchmark
from stegotpu_torch.studies import bounds


def test_bytes_per_frame_is_k4_plus_the_unpack():
    """At 1080p, B=512, num_ac=10 (stripe 120, 32 packed rows per stripe):
    K4 reads the frame and its 324,000 payload bytes and writes the stego
    and 69,120 packed bytes (plus its share of the DCT matrix and the bits
    per frame); the unpack reads the packed bytes and writes 324,000
    wire-order bits. The TPU's u8 ceiling appears nowhere."""
    h, w, cap, packed = 1080, 1920, 324_000, 9 * 32 * 240
    want = (2 * h * w + cap + packed + 4 + 256 / 512) + (packed + cap)
    assert benchmark.bytes_per_frame(h, w, 10) == pytest.approx(want)
    k4, _ = bounds.work("roundtrip_packed", 512, h, w, 10, 120)
    assert benchmark.bytes_per_frame(h, w, 10) * 512 == pytest.approx(
        k4 + 512 * (packed + cap))
    assert not hasattr(benchmark, "U8_CEILING_GBPS")
    assert benchmark.NORTH_STAR_FPS == 2000.0


def test_main_raises_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark.main()
    assert capsys.readouterr().out == ""

"""The evaluation of a round trip (ops/qim.roundtrip_metrics) on the CPU.

Its plain version against float64 numpy at the edges to which
tests/test_torch_cuda.py holds the card's kernel (ops/stripe_kernel.
roundtrip_eval): payload ends at 0, below 0, mid-frame, inside a 16-byte
vector and past the batch; identical stacks; bytes other than 0/1 in the
bits. And the kernel wrapper's refusals (wrong dtype, shape, layout,
alignment or device), which come before any launch, so they run here. No
JAX, no card.
"""

import numpy as np
import pytest
import torch

from stegotpu_torch.ops import qim
from stegotpu_torch.ops import stripe_kernel as sk

B, H, W, CAP = 3, 24, 40, 150


def _inputs(kind, seed=11):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (B, H, W), np.uint8)
    stego = frames.copy() if kind == "identical" else \
        rng.integers(0, 256, (B, H, W), np.uint8)
    hi = 256 if kind == "bytes" else 2
    extracted = rng.integers(0, hi, (B, CAP), np.uint8)
    payload = rng.integers(0, hi, (B, CAP), np.uint8)
    return frames, stego, extracted, payload


def _float64(frames, stego, extracted, payload, total):
    """(PSNR, bit errors, payload bits) in float64 and flat indices."""
    d = frames.astype(np.float64) - stego.astype(np.float64)
    mse = float((d * d).mean())
    psnr = np.inf if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    n = min(total, payload.size)
    wrong = (extracted != payload).reshape(-1)[:max(n, 0)]
    return psnr, int(wrong.sum()), n


@pytest.mark.parametrize("kind", ["random", "identical", "bytes"])
@pytest.mark.parametrize("total", [0, -5, CAP + CAP // 2, 16 * 3 + 7,
                                   B * CAP + 10 ** 6])
def test_plain_metrics_match_float64(kind, total):
    arrays = _inputs(kind)
    m = qim.roundtrip_metrics(*map(torch.from_numpy, arrays), total)
    psnr, errors, n = _float64(*arrays, total)
    assert [(v.dim(), v.dtype) for v in m.values()] == [
        (0, torch.float32), (0, torch.int64), (0, torch.int64)]
    assert int(m["bit_errors"]) == errors and int(m["payload_bits"]) == n
    if np.isinf(psnr):
        assert float(m["psnr_db"]) == np.inf
    else:
        assert abs(float(m["psnr_db"]) - psnr) < 1e-4


def _bad(case):
    frames, stego, extracted, payload = map(torch.from_numpy,
                                            _inputs("random"))
    if case == "stego dtype":
        stego = stego.float()
    elif case == "stego shape":
        stego = stego[:, :-1].contiguous()
    elif case == "bits shape":
        extracted = extracted[:, :-1].contiguous()
    elif case == "frames 2-dim":
        frames, stego = frames[0], stego[0]
    elif case == "batch":
        extracted, payload = extracted[:-1], payload[:-1]
    elif case == "strided":
        frames, stego = frames[:, ::2], stego[:, ::2]
    elif case == "stego misaligned":
        stego = _misaligned(stego, 8)
    elif case == "bits misaligned":
        extracted, payload = _misaligned(extracted, 3), _misaligned(payload, 3)
    return frames, stego, extracted, payload


def _misaligned(x, offset):
    """A contiguous copy of x whose storage starts `offset` bytes past a
    16-byte boundary."""
    flat = torch.empty(x.numel() + 16 + offset, dtype=x.dtype)
    start = -flat.data_ptr() % 16 + offset
    out = flat[start:start + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("case,match", [
    ("stego dtype", "uint8"), ("stego shape", "one shape"),
    ("bits shape", "one shape"), ("frames 2-dim", "3-dim"),
    ("batch", "rows of bits"), ("strided", "contiguous"),
    ("stego misaligned", "16-byte"), ("bits misaligned", "16-byte"),
    ("on the CPU", "CUDA device")])
def test_eval_kernel_wrapper_refuses_before_launching(monkeypatch, case,
                                                      match):
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(sk._build, "load_library", no_library)
    before = sk.LAUNCHES["stegotpu_qim_eval"]
    with pytest.raises(ValueError, match=match):
        sk.roundtrip_eval(*_bad(case), 10)
    assert sk.LAUNCHES["stegotpu_qim_eval"] == before


def test_eval_kernel_bound_is_its_inputs_read_once():
    """The 4K evaluation of 128 frames at num_ac 10 reads 2,455,142,400 B:
    0.733 ms at 3.35 TB/s (studies/bounds.py, the kernels line of
    chip_smoke.py)."""
    from stegotpu_torch.studies import bounds

    nbytes, flops = bounds.work("roundtrip_eval", 128, 2160, 3840, 10, 120)
    assert (nbytes, flops) == (2_455_142_400 + 36, 0)
    ms, by = bounds.bound_ms(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(0.73288, abs=1e-5)

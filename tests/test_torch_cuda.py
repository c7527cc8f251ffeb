"""The CUDA stripe kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one:
a CUDA kernel has no CPU mode. This file imports neither JAX nor stegotpu,
so it runs on a machine with only PyTorch for CUDA and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from stegotpu_torch.config import StegoConfig
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.pipeline import (embed_payload_into_gray_frames,
                                     extract_bits_from_gray_frames)

pytestmark = pytest.mark.cuda

OFFSET = 13
# Stego pixels off by >1 between two f32 embeds: a coefficient at a rounding
# boundary may snap to the other lattice point (same parity, same decoded
# bit); budget of tests/test_pallas_kernel.py:22-32, and never below one
# 8x8 block, which one such flip moves as a whole.
FLIP_BUDGET = 0.01


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, b, h, w, num_ac, frac, seed=5):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(16, 240, (b, h, w), np.uint8))
    cap = (h // 8) * (w // 8) * num_ac
    payload = torch.from_numpy(rng.integers(0, 2, (b, cap), np.uint8))
    return frames.to(dev), payload.to(dev), OFFSET + int(frac * b * cap)


def _near_boundary(frames, delta, num_ac):
    """Per wire-order slot bit: is the float64 coefficient within the JAX
    package's exactness envelope (stegotpu/ops/exactness.py TOL_ABS 1e-2,
    TOL_REL 2e-5) of a rounding boundary? Only there may two f32
    implementations disagree."""
    from stegotpu_torch.ops.dct import blockify, kron_dct_tensor

    k = kron_dct_tensor(frames.device, torch.float64)[1 : 1 + num_ac]
    y = blockify(frames.to(torch.float64)) @ k.T
    r = y / delta
    dist = (r - torch.floor(r) - 0.5).abs() * delta
    return (dist <= 1e-2 + 2e-5 * y.abs()).reshape(frames.shape[0], -1)


@pytest.mark.parametrize("b,h,w,num_ac", [(2, 48, 240, 10), (2, 64, 64, 1),
                                          (3, 1080, 1920, 10),
                                          (2, 768, 1360, 15)])
def test_kernels_match_plain(dev, b, h, w, num_ac):
    frames, payload, total = _inputs(dev, b, h, w, num_ac, 0.6)
    before = (sk.EMBED_LAUNCHES, sk.EXTRACT_LAUNCHES)
    s_k, bpf_k = sk.embed_frames(frames, payload, total, 20.0, num_ac, OFFSET)
    s_p, bpf_p = sk.embed_frames_plain(frames, payload, total, 20.0, num_ac,
                                       OFFSET)
    torch.cuda.synchronize()
    assert torch.equal(bpf_k, bpf_p)
    off = (s_k.int() - s_p.int()).abs() > 1
    assert off.double().mean().item() < max(FLIP_BUDGET, 64 / off.numel())
    stripe = sk.pick_stripe(h)
    for x in (frames, s_k):  # slots past the payload keep cover values
        bits_k = sk.packed_rows_to_bits(sk.extract_frames_packed(
            x, 20.0, num_ac), h, w, num_ac, stripe)
        bits_p = sk.packed_rows_to_bits(sk.extract_frames_packed_plain(
            x, 20.0, num_ac), h, w, num_ac, stripe)
        assert not ((bits_k != bits_p) & ~_near_boundary(x, 20.0, num_ac)).any()
    n = total - OFFSET
    got = sk.extract_frames(s_k, 20.0, num_ac).reshape(-1)[:n]
    assert torch.equal(got, payload.reshape(-1)[:n])
    assert (sk.EMBED_LAUNCHES, sk.EXTRACT_LAUNCHES) == (before[0] + 1,
                                                        before[1] + 3)


def test_passthrough_and_nonpositive_delta(dev):
    frames, payload, _ = _inputs(dev, 1, 48, 128, 10, 1.0)
    stego, _ = sk.embed_frames(frames, payload, 23, 20.0, 10)  # stops in block 2
    assert torch.equal(stego[0, 8:], frames[0, 8:])
    assert torch.equal(stego[0, :, 24:], frames[0, :, 24:])
    for delta in (0.0, -4.0):
        stego, _ = sk.embed_frames(frames, payload, 10**6, delta, 10)
        assert torch.equal(stego, frames)
        assert not sk.extract_frames_packed(frames, delta, 10).any()


def test_pipeline_round_trip_launches_kernels(dev):
    rng = np.random.default_rng(6)
    cover = rng.integers(16, 240, (4, 120, 160), np.uint8)
    bits = rng.integers(0, 2, 5000, np.uint8)
    cfg = StegoConfig()
    sk.EMBED_LAUNCHES = sk.EXTRACT_LAUNCHES = 0
    stego, bpf = embed_payload_into_gray_frames(cover, bits, cfg, device=dev)
    got = extract_bits_from_gray_frames(stego, cfg, device=dev)
    assert (sk.EMBED_LAUNCHES, sk.EXTRACT_LAUNCHES) == (1, 1)
    assert bpf.tolist() == [3000, 2000, 0, 0]
    np.testing.assert_array_equal(got[:5000], bits)
    np.testing.assert_array_equal(stego[2:], cover[2:])


def test_wrapper_rejects_what_the_kernel_cannot_take(dev):
    frames, payload, total = _inputs(dev, 2, 48, 128, 10, 1.0)
    with pytest.raises(ValueError):  # not contiguous
        sk.extract_frames_packed(frames.transpose(1, 2), 20.0, 10)
    with pytest.raises(ValueError):  # payload on another device
        sk.embed_frames(frames, payload.cpu(), total, 20.0, 10)

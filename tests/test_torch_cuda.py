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


def _wire(packed, h, w, num_ac):
    return sk.packed_rows_to_bits(packed, h, w, num_ac, sk.pick_stripe(h))


def _cover(dev, kind, b, h, w, num_ac, seed=8):
    """(frames, payload, total): a mid-range or near-black cover and a
    payload ending mid-block, with no bit offset (K3 and K4 take none)."""
    rng = np.random.default_rng(seed)
    lo, hi = (16, 240) if kind == "mid" else (0, 6)
    frames = torch.from_numpy(rng.integers(lo, hi, (b, h, w), np.uint8))
    cap = (h // 8) * (w // 8) * num_ac
    payload = torch.from_numpy(rng.integers(0, 2, (b, cap), np.uint8))
    return frames.to(dev), payload.to(dev), b * cap - OFFSET


@pytest.mark.parametrize("kind", ["mid", "dark"])
@pytest.mark.parametrize("b,h,w,num_ac", [(2, 48, 240, 10), (2, 64, 64, 1),
                                          (3, 1080, 1920, 10),
                                          (2, 768, 1360, 15)])
def test_fused_kernels_match_plain(dev, b, h, w, num_ac, kind):
    """K3, K4 and K5 against their plain versions: bits per frame
    identical, wire-order bits identical outside the exactness envelope,
    K3's count equal to the count the plain extract takes of K3's stego
    up to the valid slots inside the envelope (where the two f32 reads may
    legitimately differ)."""
    frames, payload, total = _cover(dev, kind, b, h, w, num_ac)
    s3, bpf3, err3 = sk.embed_and_check_frames(frames, payload, total, 20.0,
                                               num_ac)
    s3p, bpf3p, _ = sk.embed_and_check_frames_plain(frames, payload, total,
                                                    20.0, num_ac)
    s4, bpf4, p4 = sk.embed_and_extract_frames_packed(frames, payload, total,
                                                      20.0, num_ac)
    _, bpf4p, _ = sk.embed_and_extract_frames_packed_plain(
        frames, payload, total, 20.0, num_ac)
    torch.cuda.synchronize()
    assert torch.equal(bpf3, bpf3p) and torch.equal(bpf4, bpf4p)
    assert torch.equal(bpf3, bpf4)
    off = (s3.int() - s3p.int()).abs() > 1
    assert off.double().mean().item() < max(FLIP_BUDGET, 64 / off.numel())
    count_p = sk.count_wrong_bits(
        _wire(sk.extract_frames_packed_plain(s3, 20.0, num_ac), h, w, num_ac),
        payload, total)
    valid = torch.arange(payload.numel(), device=dev).reshape(
        payload.shape) < total
    slack = (_near_boundary(s3, 20.0, num_ac) & valid).sum(1)
    assert ((err3 - count_p).abs() <= slack).all()
    if kind == "mid":
        assert not err3.any()
    stripe = sk.pick_stripe(h)
    for x in (frames, s4):
        bits5 = sk.rows_to_bits(sk.extract_frames_rows(x, 20.0, num_ac), h, w,
                                num_ac, stripe)
        bits5p = sk.rows_to_bits(sk.extract_frames_rows_plain(x, 20.0, num_ac),
                                 h, w, num_ac, stripe)
        assert not ((bits5 != bits5p) & ~_near_boundary(x, 20.0, num_ac)).any()
    near4 = _near_boundary(s4, 20.0, num_ac)
    assert not ((_wire(p4, h, w, num_ac) != _wire(
        sk.extract_frames_packed_plain(s4, 20.0, num_ac), h, w, num_ac))
        & ~near4).any()


@pytest.mark.parametrize("kind", ["mid", "dark"])
@pytest.mark.parametrize("delta", [20.0, 8.0, 0.0])
@pytest.mark.parametrize("b,h,w,num_ac", [(2, 48, 240, 10), (2, 64, 64, 63),
                                          (2, 1080, 1920, 10),
                                          (2, 768, 1360, 30)])
def test_zero_tolerance_identities(dev, b, h, w, num_ac, delta, kind):
    """Kernel against kernel, same device code: K3's and K4's stego are
    K1's byte for byte, K4's packed bits are K2's of K4's stego byte for
    byte, K5 is K2 lane for lane, and K3's per-frame count equals a count
    from K2 on K3's stego."""
    frames, payload, total = _cover(dev, kind, b, h, w, num_ac)
    s1, bpf1 = sk.embed_frames(frames, payload, total, delta, num_ac)
    s3, bpf3, err3 = sk.embed_and_check_frames(frames, payload, total, delta,
                                               num_ac)
    s4, bpf4, p4 = sk.embed_and_extract_frames_packed(frames, payload, total,
                                                      delta, num_ac)
    assert torch.equal(s3, s1) and torch.equal(s4, s1)
    assert torch.equal(bpf3, bpf1) and torch.equal(bpf4, bpf1)
    assert torch.equal(p4, sk.extract_frames_packed(s4, delta, num_ac))
    for x in (frames, s1):
        rows = sk.extract_frames_rows(x, delta, num_ac)
        packed = sk.extract_frames_packed(x, delta, num_ac)
        spread = (packed[..., None] >> torch.arange(8, dtype=torch.uint8,
                                                    device=dev)) & 1
        assert torch.equal(rows, spread.reshape(rows.shape))
    count = sk.count_wrong_bits(sk.extract_frames(s3, delta, num_ac),
                                payload, total)
    assert torch.equal(err3, count)
    if delta == 0.0:  # every valid slot reads 0 and the stego is the cover
        assert torch.equal(s3, frames)
        assert int(err3.sum()) == int(payload.reshape(-1)[:total].sum())


def test_fused_kernels_launch_once_each(dev):
    frames, payload, total = _cover(dev, "mid", 2, 48, 128, 10)
    before = (sk.CHECK_LAUNCHES, sk.ROUNDTRIP_LAUNCHES,
              sk.EXTRACT_ROWS_LAUNCHES)
    sk.embed_and_check_frames(frames, payload, total, 20.0, 10)
    sk.embed_and_extract_frames(frames, payload, total, 20.0, 10)
    sk.extract_frames_rows(frames, 20.0, 10)
    assert (sk.CHECK_LAUNCHES, sk.ROUNDTRIP_LAUNCHES,
            sk.EXTRACT_ROWS_LAUNCHES) == tuple(n + 1 for n in before)


def test_verified_fast_path_on_card(dev):
    """embed_frames_verified_fast launches K3; on a clean cover it keeps
    K3's stego, on a flat-black cover it repairs to residual 0, and K2
    reads the payload back exactly from both."""
    from stegotpu_torch.ops.verified import (embed_frames_verified,
                                             embed_frames_verified_fast)

    rng = np.random.default_rng(9)
    h, w, num_ac = 64, 128, 10
    cap = (h // 8) * (w // 8) * num_ac
    payload = torch.from_numpy(rng.integers(0, 2, (2, cap), np.uint8)).to(dev)
    for frames in (torch.from_numpy(rng.integers(60, 196, (2, h, w), np.uint8)),
                   torch.zeros((2, h, w), dtype=torch.uint8)):
        frames = frames.to(dev)
        before = sk.CHECK_LAUNCHES
        stego, bpf, residual = embed_frames_verified_fast(
            frames, payload, 2 * cap, 20.0, num_ac)
        assert sk.CHECK_LAUNCHES == before + 1
        assert int(residual) == 0 and bpf.tolist() == [cap, cap]
        assert torch.equal(sk.extract_frames(stego, 20.0, num_ac), payload)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full-precision"):
            embed_frames_verified(frames, payload, 2 * cap, 20.0, num_ac)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_exactness_harness_on_card(dev):
    from stegotpu_torch.ops.exactness import EXACT_KEYS, quick_exactness_check

    row = quick_exactness_check(device=dev)
    assert row["ok"], row
    assert all(row[k] == 0 for k in EXACT_KEYS)


@pytest.mark.parametrize("kind", ["mid", "dark"])
@pytest.mark.parametrize("delta", [20.0, 8.0, 0.0])
@pytest.mark.parametrize("b,h,w,num_ac", [(2, 48, 240, 10), (2, 64, 64, 63),
                                          (2, 1080, 1920, 10),
                                          (2, 768, 1360, 15)])
def test_roundtrip_rows_identities(dev, b, h, w, num_ac, delta, kind):
    """K6 against K1, K5 and K4, zero tolerance (same device code): its
    stego is K1's, its rows are K5's reading of that stego, its wire-order
    bits are K4's unpacked; and against its plain version under the
    envelope."""
    frames, payload, total = _cover(dev, kind, b, h, w, num_ac)
    args = (frames, payload, total, delta, num_ac)
    before = sk.ROUNDTRIP_ROWS_LAUNCHES
    s6, bpf6, rows6 = sk.embed_and_extract_frames_rows(*args)
    assert sk.ROUNDTRIP_ROWS_LAUNCHES == before + 1
    s1, bpf1 = sk.embed_frames(*args)
    assert torch.equal(s6, s1) and torch.equal(bpf6, bpf1)
    assert torch.equal(rows6, sk.extract_frames_rows(s6, delta, num_ac))
    stripe = sk.pick_stripe(h)
    _, _, p4 = sk.embed_and_extract_frames_packed(*args)
    bits6 = sk.rows_to_bits(rows6, h, w, num_ac, stripe)
    assert torch.equal(bits6, _wire(p4, h, w, num_ac))
    _, _, ex = sk.embed_and_extract_frames_fused(*args)
    assert torch.equal(ex, bits6)
    s6p, bpf6p, _ = sk.embed_and_extract_frames_rows_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bpf6, bpf6p)
    # a pixel off by >1 only in a block with a slot whose cover coefficient
    # lies in the envelope (a lattice flip); the 1% budget is the JAX
    # package's at delta=20, which a few flips of 64 px exceed at delta=8
    # on a 48x240 frame
    off = (s6.int() - s6p.int()).abs() > 1
    if delta == 20.0:
        assert off.double().mean().item() < max(FLIP_BUDGET, 64 / off.numel())
    if delta > 0:
        from stegotpu_torch.ops.dct import blockify

        near = _near_boundary(frames, delta, num_ac).reshape(b, -1, num_ac)
        assert not (blockify(off).any(-1) & ~near.any(-1)).any()
    bits6p = sk.rows_to_bits(sk.extract_frames_rows_plain(s6, delta, num_ac),
                             h, w, num_ac, stripe)
    if delta > 0:
        assert not ((bits6 != bits6p) & ~_near_boundary(s6, delta, num_ac)).any()
    else:
        assert not bits6.any() and torch.equal(s6, frames)
    if kind == "mid" and delta > 0:
        valid = torch.arange(payload.numel(), device=dev).reshape(
            payload.shape) < total
        assert torch.equal(bits6[valid], payload[valid])


def _kron_inputs(dev, b, h, w, num_ac, frac, lo=32, hi=224, seed=11):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(lo, hi, (b, h, w), np.uint8))
    cap = (h // 8) * (w // 8) * num_ac
    payload = torch.from_numpy(rng.integers(0, 2, (b, cap), np.uint8))
    return frames.to(dev), payload.to(dev), OFFSET + int(frac * b * cap) - 3


@pytest.mark.parametrize("frac", [1.0, 0.35])
@pytest.mark.parametrize("b,h,w,num_ac", [(2, 48, 128, 1), (2, 48, 128, 63),
                                          (1, 240, 384, 10),
                                          (2, 720, 1280, 10),
                                          (2, 1080, 1920, 10)])
def test_kron_kernels_match_plain(dev, b, h, w, num_ac, frac):
    """K7 and K8 against their plain versions (which build the state plane,
    so this also holds the kernel's in-kernel state logic against the
    plane): bits per frame identical, stego within the flip budget, blocks
    never entered byte for byte, slot bits identical outside the envelope,
    and the payload back exactly on a mid-range cover."""
    from stegotpu_torch.ops.experimental import kron_kernel as kk
    from stegotpu_torch.ops.experimental.qim_fast import build_state_plane

    frames, payload, total = _kron_inputs(dev, b, h, w, num_ac, frac)
    before = (kk.KRON_EMBED_LAUNCHES, kk.KRON_EXTRACT_LAUNCHES)
    s7, bpf7 = kk.embed_frames_kron(frames, payload, total, 20.0, num_ac,
                                    OFFSET)
    s7p, bpf7p = kk.embed_frames_kron_plain(frames, payload, total, 20.0,
                                            num_ac, OFFSET)
    torch.cuda.synchronize()
    assert torch.equal(bpf7, bpf7p)
    off = (s7.int() - s7p.int()).abs() > 1
    assert off.double().mean().item() < max(FLIP_BUDGET, 64 / off.numel())
    never = build_state_plane(payload, total, h, w, num_ac, OFFSET) == 3
    assert torch.equal(s7[never], frames[never])
    for x in (frames, s7):
        bits8 = kk.extract_frames_kron(x, 20.0, num_ac)
        bits8p = kk.extract_frames_kron_plain(x, 20.0, num_ac)
        torch.cuda.synchronize()
        assert bits8.shape == (b, (h // 8) * (w // 8) * num_ac)
        assert not ((bits8 != bits8p) & ~_near_boundary(x, 20.0, num_ac)).any()
    n = total - OFFSET
    assert torch.equal(bits8.reshape(-1)[:n], payload.reshape(-1)[:n])
    assert (kk.KRON_EMBED_LAUNCHES, kk.KRON_EXTRACT_LAUNCHES) == (
        before[0] + 1, before[1] + 2)


def test_kron_wrappers_keep_the_domain(dev):
    """W % 128 != 0 and delta <= 0 raise ValueError on the card too; no
    launch is counted."""
    from stegotpu_torch.ops.experimental import kron_kernel as kk

    frames, payload, total = _kron_inputs(dev, 1, 48, 120, 10, 1.0)
    before = (kk.KRON_EMBED_LAUNCHES, kk.KRON_EXTRACT_LAUNCHES)
    with pytest.raises(ValueError, match="128"):
        kk.embed_frames_kron(frames, payload, total, 20.0, 10)
    with pytest.raises(ValueError, match="128"):
        kk.extract_frames_kron(frames, 20.0, 10)
    frames, payload, total = _kron_inputs(dev, 1, 48, 128, 10, 1.0)
    for delta in (0.0, -4.0):
        with pytest.raises(ValueError, match="delta"):
            kk.embed_frames_kron(frames, payload, total, delta, 10)
        with pytest.raises(ValueError, match="delta"):
            kk.extract_frames_kron(frames, delta, 10)
    assert (kk.KRON_EMBED_LAUNCHES, kk.KRON_EXTRACT_LAUNCHES) == before


def test_metrics_on_card(dev):
    """roundtrip_metrics reads 0 bit errors on the K6 and kron round trips
    of a mid-range cover; embed_extract_evaluate runs on the card; the
    device PSNR/SSIM of a frame pair agree with the host's float64 ones
    (1e-3 dB and 1e-4: f32 sums on the card)."""
    from stegotpu_torch.metrics import psnr_batch, psnr_np, ssim_batch, ssim_np
    from stegotpu_torch.ops import qim
    from stegotpu_torch.ops.experimental import kron_kernel as kk

    frames, payload, total = _kron_inputs(dev, 2, 720, 1280, 10, 1.0)
    total -= OFFSET  # the round trips take no bit offset
    for fn in (sk.embed_and_extract_frames_fused,
               kk.embed_and_extract_frames_kron):
        stego, _, ex = fn(frames, payload, total, 20.0, 10)
        m = qim.roundtrip_metrics(frames, stego, ex, payload, total)
        assert m["bit_errors"].device == frames.device
        assert int(m["bit_errors"]) == 0 and int(m["payload_bits"]) == total
        assert 30 < float(m["psnr_db"]) < 60
    stego, bpf, ex, m = qim.embed_extract_evaluate(frames, payload, total,
                                                   20.0, 10)
    assert int(m["bit_errors"]) == 0 and int(bpf.sum()) == total
    a, s = frames[:1], stego[:1]
    assert abs(float(psnr_batch(a, s)[0]) - psnr_np(a[0].cpu().numpy(),
                                                    s[0].cpu().numpy())) < 1e-3
    assert abs(float(ssim_batch(a, s)[0]) - ssim_np(a[0].cpu().numpy(),
                                                    s[0].cpu().numpy())) < 1e-4

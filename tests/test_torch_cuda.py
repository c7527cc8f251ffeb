"""The CUDA stripe kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one:
a CUDA kernel has no CPU mode. This file imports neither JAX nor stegotpu,
so it runs on a machine with only PyTorch for CUDA and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import functools
import math

import numpy as np
import pytest
import torch

from stegotpu_torch.config import StegoConfig
from stegotpu_torch.ops import qim
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


def _launches(*entries):
    """The launch counts of `entries` in stripe_kernel.LAUNCHES."""
    return tuple(sk.LAUNCHES[e] for e in entries)


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
    before = _launches("stegotpu_qim_embed", "stegotpu_qim_extract_packed")
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
    assert _launches("stegotpu_qim_embed", "stegotpu_qim_extract_packed") == (
        before[0] + 1, before[1] + 3)


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
    sk.LAUNCHES.clear()
    stego, bpf = embed_payload_into_gray_frames(cover, bits, cfg, device=dev)
    got = extract_bits_from_gray_frames(stego, cfg, device=dev)
    assert _launches("stegotpu_qim_embed",
                     "stegotpu_qim_extract_packed") == (1, 1)
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


# K1-K4's arithmetic switches at delta 2^-10 (ArithHopper above,
# rintf/floorf below, csrc/qim_common.cuh); at 1e-4 a mid-range
# block's coefficients give |y / delta| > 2^22, where the add-and-round
# spelling would be wrong, so a fast path taken there by mistake fails.
IDENTITY_DELTAS = [20.0, 8.0, 0.0, 1.0, 0.5, 100.0, 2.0**-10, 2.0**-11, 1e-4,
                   -4.0]


@pytest.mark.parametrize("kind", ["mid", "dark"])
@pytest.mark.parametrize("delta", IDENTITY_DELTAS)
@pytest.mark.parametrize("b,h,w,num_ac,frac", [
    (2, 48, 240, 10, 1.0), (2, 64, 64, 63, 1.0), (2, 1080, 1920, 10, 1.0),
    (2, 768, 1360, 30, 1.0), (3, 40, 136, 1, 1.4), (3, 48, 1048, 63, 1.6),
    (2, 48, 1048, 7, 1.6)])
def test_zero_tolerance_identities(dev, b, h, w, num_ac, frac, delta, kind):
    """Kernel against kernel: K3's, K4's and K6's stego and bits per frame
    are K1's byte for byte, K4's packed bits are K2's of K4's stego and
    K6's rows K5's of K6's stego byte for byte, K5 is K2 lane for lane,
    K3's per-frame count equals a count from K2 on K3's stego, K9 full is
    K5 byte for byte, and K13 (a ring of 2) and, at an even B, K11 are K4
    (stego, bits per frame, packed bits). K1-K6, K11 and K13 spell the
    arithmetic for Hopper (ArithHopperSmallDelta below delta 2^-10), K9
    with conversion instructions: K9 full == K5 is the witness across the
    two spellings, which give the same bytes at every delta. The last
    three shapes have W % 16 == 8 and a payload that ends mid-frame."""
    from stegotpu_torch.studies import dualchain_r5, emitpipe_r4
    from stegotpu_torch.studies import extract_ablation as ea

    frames, payload, total = _cover(dev, kind, b, h, w, num_ac)
    if frac != 1.0:  # ends inside frame 1
        total = int(frac * payload.shape[1])
    args = (frames, payload, total, delta, num_ac)
    s1, bpf1 = sk.embed_frames(*args)
    s3, bpf3, err3 = sk.embed_and_check_frames(*args)
    k4 = sk.embed_and_extract_frames_packed(*args)
    s4, bpf4, p4 = k4
    s6, bpf6, r6 = sk.embed_and_extract_frames_rows(*args)
    assert torch.equal(s3, s1) and torch.equal(s4, s1) and torch.equal(s6, s1)
    assert torch.equal(bpf3, bpf1) and torch.equal(bpf4, bpf1)
    assert torch.equal(bpf6, bpf1)
    assert torch.equal(p4, sk.extract_frames_packed(s4, delta, num_ac))
    assert torch.equal(r6, sk.extract_frames_rows(s6, delta, num_ac))
    others = [emitpipe_r4.roundtrip_pipelined_packed(*args, bufs=2)]
    if b % 2 == 0:  # dual_roundtrip_packed takes two frames a thread
        others.append(dualchain_r5.dual_roundtrip_packed(*args))
    for got in others:
        assert all(torch.equal(a, c) for a, c in zip(got, k4))
    for x in (frames, s1):
        rows = sk.extract_frames_rows(x, delta, num_ac)
        packed = sk.extract_frames_packed(x, delta, num_ac)
        spread = (packed[..., None] >> torch.arange(8, dtype=torch.uint8,
                                                    device=dev)) & 1
        assert torch.equal(rows, spread.reshape(rows.shape))
        assert torch.equal(ea.ablate(x, delta, num_ac, "full"), rows)
    count = sk.count_wrong_bits(sk.extract_frames(s3, delta, num_ac),
                                payload, total)
    assert torch.equal(err3, count)
    if delta <= 0.0:  # every valid slot reads 0 and the stego is the cover
        assert torch.equal(s3, frames)
        assert int(err3.sum()) == int(payload.reshape(-1)[:total].sum())


@functools.cache
def _uncapped():
    """The kernel library built without the register caps of K1, K3, K4,
    K6, K11 and K13 (-DSTEGOTPU_K1_MINB=1 and so on, studies/stripe_cap.py),
    built once."""
    from stegotpu_torch.studies import stripe_cap

    how = {"defines": {stripe_cap.KERNELS[k][3]: 1 for k in stripe_cap.CAPPED}}
    return stripe_cap.build_variants([("uncapped", how)])["uncapped"][0]


@pytest.mark.parametrize("delta", [20.0, 0.5, 2.0**-11])
@pytest.mark.parametrize("num_ac", [10, 15, 1, 30])
def test_capped_and_uncapped_builds_agree(dev, num_ac, delta):
    """The register-capped builds of K1, K3, K4, K6, K11 and K13 (num_ac
    <= 15, with the pixel re-derive) and the builds without a cap give the
    same bytes, and K5 (no cap) the same rows in both libraries."""
    from stegotpu_torch.studies import stripe_cap

    frames, payload, total = _cover(dev, "mid", 2, 1080, 1920, num_ac)
    args = (frames, payload, total, delta, num_ac)
    fns = [fn for _, _, fn, _ in stripe_cap.KERNELS.values()]
    capped = [fn(*args) for fn in fns]
    with stripe_cap.using(_uncapped()):
        uncapped = [fn(*args) for fn in fns]
    for c, u in zip(capped, uncapped):
        assert all(torch.equal(a, b) for a, b in zip(c, u))


@pytest.mark.parametrize("b,h,w,num_ac", [(3, 48, 240, 10), (4, 40, 136, 63)])
def test_embed_writes_bits_per_frame(dev, b, h, w, num_ac):
    """The bits per frame that K1 writes beside the stego equal
    _bits_per_frame, with a bit offset, a payload that ends mid-frame,
    one that runs past the batch, one that ends before the offset, and an
    offset past 2^32."""
    frames, payload, _ = _cover(dev, "mid", b, h, w, num_ac)
    cap = payload.shape[1]
    for bit_offset, total in ((0, 10**9), (4321, 4321 + int(1.6 * cap)),
                              (cap + 5, 3 * cap), (100, 50),
                              (2**33, 2**33 + 2 * cap + 7)):
        _, bpf = sk.embed_frames(frames, payload, total, 20.0, num_ac,
                                 bit_offset)
        assert bpf.dtype == torch.int32 and bpf.device == frames.device
        assert torch.equal(bpf, sk._bits_per_frame(b, cap, total, bit_offset,
                                                   dev)), (bit_offset, total)


@pytest.mark.parametrize("b,h,w,num_ac", [(3, 48, 240, 10), (4, 40, 136, 63)])
def test_fused_kernels_write_bits_per_frame(dev, b, h, w, num_ac):
    """The bits per frame that K3, K4 and K6 write beside their outputs
    equal _bits_per_frame (no bit offset), with a payload that ends
    mid-frame, one that ends at a frame's end, one that runs past the
    batch, an empty one and one past 2^32."""
    frames, payload, _ = _cover(dev, "mid", b, h, w, num_ac)
    cap = payload.shape[1]
    for total in (int(1.6 * cap), 2 * cap, 10**9, 0, 2**33 + 7):
        want = sk._bits_per_frame(b, cap, total, 0, dev)
        for fn in (sk.embed_and_check_frames,
                   sk.embed_and_extract_frames_packed,
                   sk.embed_and_extract_frames_rows):
            _, bpf, _ = fn(frames, payload, total, 20.0, num_ac)
            assert bpf.dtype == torch.int32 and bpf.device == frames.device
            assert torch.equal(bpf, want), (fn.__name__, total)


def test_embed_and_extract_are_one_device_kernel_each(dev, tmp_path):
    """One K1, K2, K4, K5 or K6 call is one device kernel and nothing
    else: the device timeline of torch.profiler holds no glue; so is one
    call of the wire-order unpack. One K3 call is its kernel behind one
    memset of its counts, and so is one call of the evaluation kernel."""
    from stegotpu_torch.studies import device_roofline as dr

    frames, payload, total = _cover(dev, "mid", 2, 48, 240, 10)
    args = (frames, payload, total, 20.0, 10)
    stego, bits = frames.flip(0), payload.flip(0)
    packed = sk.extract_frames_packed(frames, 20.0, 10)
    for name, fn, glue in (
            ("qim_embed_kernel", lambda: sk.embed_frames(*args), {}),
            ("qim_extract_packed_kernel",
             lambda: sk.extract_frames_packed(frames, 20.0, 10), {}),
            ("qim_roundtrip_packed_kernel",
             lambda: sk.embed_and_extract_frames_packed(*args), {}),
            ("qim_extract_rows_kernel",
             lambda: sk.extract_frames_rows(frames, 20.0, 10), {}),
            ("qim_roundtrip_rows_kernel",
             lambda: sk.embed_and_extract_frames_rows(*args), {}),
            ("qim_embed_check_kernel",
             lambda: sk.embed_and_check_frames(*args), {"gpu_memset": 1.0}),
            ("qim_eval_kernel",
             lambda: sk.roundtrip_eval(frames, stego, payload, bits, total),
             {"gpu_memset": 1.0}),
            ("qim_unpack_kernel",
             lambda: sk.packed_rows_to_bits(packed, 48, 240, 10, 48), {})):
        summ = dr.parse_device_timeline(
            dr._trace(fn, 4, tmp_path / f"{name}.json"), 4)
        assert name in summ["kernel_name"], summ
        assert summ["kernel_count"] == 4, summ
        assert summ["glue_per_iter"] == glue, summ


def test_fused_kernels_launch_once_each(dev, tmp_path):
    """One call of K3, K4, K5 or K6 counts one launch (and the round trip's
    wire-order unpack one launch of its kernel); a K6 call (rows and
    bits per frame from the kernel) is one device kernel on the timeline
    and nothing else."""
    from stegotpu_torch.studies import device_roofline as dr

    frames, payload, total = _cover(dev, "mid", 2, 48, 128, 10)
    entries = ("stegotpu_qim_embed_check", "stegotpu_qim_roundtrip_packed",
               "stegotpu_qim_extract_rows", "stegotpu_qim_roundtrip_rows",
               "stegotpu_qim_unpack_packed")
    before = _launches(*entries)
    sk.embed_and_check_frames(frames, payload, total, 20.0, 10)
    sk.embed_and_extract_frames(frames, payload, total, 20.0, 10)
    sk.extract_frames_rows(frames, 20.0, 10)
    sk.embed_and_extract_frames_rows(frames, payload, total, 20.0, 10)
    assert _launches(*entries) == tuple(n + 1 for n in before)
    summ = dr.parse_device_timeline(dr._trace(
        lambda: sk.embed_and_extract_frames_rows(frames, payload, total, 20.0,
                                                 10), 4, tmp_path / "k6.json"), 4)
    assert "qim_roundtrip_rows_kernel" in summ["kernel_name"], summ
    assert summ["kernel_count"] == 4 and summ["glue_per_iter"] == {}, summ


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
        before = sk.LAUNCHES["stegotpu_qim_embed_check"]
        stego, bpf, residual = embed_frames_verified_fast(
            frames, payload, 2 * cap, 20.0, num_ac)
        assert sk.LAUNCHES["stegotpu_qim_embed_check"] == before + 1
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
@pytest.mark.parametrize("delta", [20.0, 8.0, 0.0, 2.0**-11, -4.0])
@pytest.mark.parametrize("b,h,w,num_ac", [(2, 48, 240, 10), (2, 64, 64, 63),
                                          (2, 1080, 1920, 10),
                                          (2, 768, 1360, 15)])
def test_roundtrip_rows_identities(dev, b, h, w, num_ac, delta, kind):
    """K6 against K1, K5 and K4, zero tolerance (same device code): its
    stego and bits per frame are K1's, its rows are K5's reading of that
    stego, its wire-order bits are K4's unpacked; and against its plain
    version under the envelope. At delta 2^-11 (ArithHopperSmallDelta)
    the u8 stego cannot hold the lattice, so the payload comes back only
    at delta 8 and 20."""
    frames, payload, total = _cover(dev, kind, b, h, w, num_ac)
    args = (frames, payload, total, delta, num_ac)
    before = sk.LAUNCHES["stegotpu_qim_roundtrip_rows"]
    s6, bpf6, rows6 = sk.embed_and_extract_frames_rows(*args)
    assert sk.LAUNCHES["stegotpu_qim_roundtrip_rows"] == before + 1
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
    if kind == "mid" and delta >= 8.0:
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
    before = _launches("stegotpu_kron_embed", "stegotpu_kron_extract")
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
    assert _launches("stegotpu_kron_embed", "stegotpu_kron_extract") == (
        before[0] + 1, before[1] + 2)


def test_kron_wrappers_keep_the_domain(dev):
    """W % 128 != 0 and delta <= 0 raise ValueError on the card too; no
    launch is counted."""
    from stegotpu_torch.ops.experimental import kron_kernel as kk

    frames, payload, total = _kron_inputs(dev, 1, 48, 120, 10, 1.0)
    before = _launches("stegotpu_kron_embed", "stegotpu_kron_extract")
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
    assert _launches("stegotpu_kron_embed", "stegotpu_kron_extract") == before


@pytest.mark.parametrize("delta", [20.0, 2.0**-11])
@pytest.mark.parametrize("num_ac", [1, 10, 63])
@pytest.mark.parametrize("b,h,w", [(1, 1080, 1920), (1, 720, 1280),
                                   (1, 8, 128), (3, 40, 384)])
def test_kron_kernels_match_witness(dev, b, h, w, num_ac, delta):
    """K7 and K8 against their witness (studies/kron_ab.py, their first
    CUDA version) with zero tolerance: stego, bits per frame and K8's bits
    of the cover and of the stego, for payloads filling every slot and
    ending mid-block and mid-frame, at a bit offset. B=1 at 1080p is
    126.6 tiles of 256 blocks; 3x40x384 is 720 blocks, frames straddling
    tiles."""
    from stegotpu_torch.ops.experimental import kron_kernel as kk
    from stegotpu_torch.studies import kron_ab

    rng = np.random.default_rng(17)
    frames = torch.from_numpy(rng.integers(16, 240, (b, h, w), np.uint8)).to(dev)
    cap = (h // 8) * (w // 8) * num_ac
    payload = torch.from_numpy(rng.integers(0, 2, (b, cap), np.uint8)).to(dev)
    before = _launches("stegotpu_kron_embed_smem",
                       "stegotpu_kron_extract_smem")
    for n in (b * cap, b * cap - num_ac // 2 - 1, cap // 2 + 3):
        total = OFFSET + n
        s7, bpf7 = kk.embed_frames_kron(frames, payload, total, delta, num_ac,
                                        OFFSET)
        sw, bpfw = kron_ab.embed_frames_kron_smem(frames, payload, total,
                                                  delta, num_ac, OFFSET)
        torch.cuda.synchronize()
        assert torch.equal(s7, sw) and torch.equal(bpf7, bpfw)
        for x in (frames, s7):
            assert torch.equal(kk.extract_frames_kron(x, delta, num_ac),
                               kron_ab.extract_frames_kron_smem(x, delta,
                                                                num_ac))
    assert _launches("stegotpu_kron_embed_smem",
                     "stegotpu_kron_extract_smem") == (before[0] + 3,
                                                       before[1] + 6)


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


def _f64_psnr(frames, stego) -> float:
    """PSNR of the exact squared error: float64 sums on the card, 8 frames
    at a time (every partial sum an integer under 2^53)."""
    sse = 0.0
    for f in range(0, frames.shape[0], 8):
        d = frames[f:f + 8].double() - stego[f:f + 8].double()
        sse += float((d * d).sum())
    return math.inf if sse == 0 else 10.0 * math.log10(
        65025.0 * frames.numel() / sse)


# where the payload ends, from one frame's bit count `cap` and the batch's
# B*cap: at 0, below 0, mid-frame, inside a 16-byte vector, past the batch
EVAL_TOTALS = {"zero": lambda cap, n: 0, "negative": lambda cap, n: -5,
               "mid-frame": lambda cap, n: cap + cap // 2 + 3,
               "in a vector": lambda cap, n: 16 * 5 + 7,
               "beyond": lambda cap, n: n + 10 ** 6}


def _eval_inputs(dev, kind, b, h, w, cap):
    """(frames, stego, extracted, payload): K4's round trip of mid-range 4K
    frames (`roundtrip`), random stacks and bytes 0..255 in the bits
    (`bytes`), or identical stacks (`identical`)."""
    rng = np.random.default_rng(17)
    frames = torch.from_numpy(rng.integers(16, 240, (b, h, w), np.uint8))
    payload = torch.from_numpy(rng.integers(0, 256 if kind == "bytes" else 2,
                                            (b, cap), np.uint8)).to(dev)
    frames = frames.to(dev)
    if kind == "roundtrip":
        stego, _, extracted = sk.embed_and_extract_frames(
            frames, payload, b * cap, 20.0, 10)
    elif kind == "identical":
        stego, extracted = frames.clone(), payload.clone()
    else:
        stego = torch.from_numpy(rng.integers(0, 256, (b, h, w),
                                              np.uint8)).to(dev)
        extracted = torch.from_numpy(rng.integers(0, 256, (b, cap),
                                                  np.uint8)).to(dev)
    return frames, stego, extracted, payload


@pytest.mark.parametrize("total", list(EVAL_TOTALS))
@pytest.mark.parametrize("kind,b,h,w,cap", [
    ("roundtrip", 8, 2160, 3840, 1_296_000),
    ("bytes", 3, 17, 29, 37),       # no stack or bit array a whole vector
    ("bytes", 5, 9, 7, 41),
    ("identical", 2, 48, 240, 1800)])
def test_eval_kernel_matches_plain_and_float64(dev, kind, b, h, w, cap,
                                               total):
    """The evaluation kernel (ops/stripe_kernel.roundtrip_eval, through
    ops/qim.roundtrip_metrics) against the plain version: bit errors and
    payload bits equal, the PSNR one float32 rounding of float64's exact
    one at most (inf for identical stacks); one launch a call; 0-dim
    results on the card."""
    frames, stego, extracted, payload = _eval_inputs(dev, kind, b, h, w, cap)
    t = EVAL_TOTALS[total](cap, b * cap)
    before = sk.LAUNCHES["stegotpu_qim_eval"]
    m = qim.roundtrip_metrics(frames, stego, extracted, payload, t)
    assert sk.LAUNCHES["stegotpu_qim_eval"] == before + 1
    want = qim.roundtrip_metrics_plain(frames, stego, extracted, payload, t)
    assert [(v.dim(), v.dtype, v.device) for v in m.values()] == [
        (0, torch.float32, dev), (0, torch.int64, dev), (0, torch.int64, dev)]
    assert int(m["bit_errors"]) == int(want["bit_errors"])
    assert int(m["payload_bits"]) == int(want["payload_bits"]) == min(
        t, b * cap)
    ref = _f64_psnr(frames, stego)
    if math.isinf(ref):
        assert float(m["psnr_db"]) == math.inf == float(want["psnr_db"])
    else:
        assert abs(float(m["psnr_db"]) - ref) <= np.spacing(np.float32(ref))


@pytest.mark.parametrize("b", [8, 1152])
def test_eval_kernel_sums_in_64_bits(dev, b):
    """All-0 against all-255 4K frames, 65,025 a pixel: the squared error
    passes 2^32 at 8 frames (in a CTA and in all), and at 1,152 frames
    (9.55 GB a stack, past 2^31 bytes) it would pass 2^32 in each thread of
    the kernel's grid (132 SMs x 4 CTAs x 256 threads: 70,650 B, 4.6e9 a
    thread). The PSNR is 0 dB exactly, the bit errors every slot."""
    h, w, cap = 2160, 3840, 16
    zeros = torch.zeros((b, h, w), dtype=torch.uint8, device=dev)
    full = torch.full_like(zeros, 255)
    bits = torch.zeros((b, cap), dtype=torch.uint8, device=dev)
    for a, s in ((zeros, full), (full, zeros)):
        m = qim.roundtrip_metrics(a, s, bits, bits + 1, b * cap)
        assert float(m["psnr_db"]) == 0.0
        assert int(m["bit_errors"]) == b * cap
    del zeros, full
    torch.cuda.empty_cache()


# --- the wire-order unpack (csrc/qim_unpack.cu) --------------------------------

# (B, H, W, num_ac, stripe; None picks it from H): the 4K and 1080p cells'
# shapes, 720p at num_ac 3 (rn 1), num_ac across the slot rows' edges at a
# width whose rows take 16-byte stores (W/8 = 16) and at one whose W/8 is
# odd (9: single-byte stores), the explicit stripes 8, 216 and 360, B = 1
UNPACK_CASES = [(2, 2160, 3840, 10, None), (8, 1080, 1920, 10, None),
                (2, 720, 1280, 3, None),
                *[(2, 48, w, n, None) for n in (1, 7, 8, 9, 15, 63)
                  for w in (128, 72)],
                (2, 64, 128, 10, 8), (1, 2160, 3840, 10, 216),
                (1, 2160, 3840, 63, 360), (1, 48, 72, 10, None),
                (1, 40, 136, 1, 40)]


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("b,h,w,num_ac,stripe", UNPACK_CASES)
def test_unpack_kernel_matches_plain(dev, b, h, w, num_ac, stripe, offset):
    """packed_rows_to_bits on the card (one launch of the unpack kernel) is
    packed_rows_to_bits_plain byte for byte on random packed bytes, the
    non-slot bits and the padding rows random too, with the packed rows'
    storage aligned or 3 bytes past a 16-byte boundary; the store width
    follows (W/8)*num_ac."""
    stripe = stripe or sk.pick_stripe(h)
    rp = sk._rows_pad(stripe, sk.rows_per_block(num_ac))
    shape = (b, (h // stripe) * rp, w // 8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(b * h * w + num_ac)
    n = math.prod(shape)
    flat = torch.randint(0, 256, (n + offset,), generator=gen, device=dev,
                         dtype=torch.uint8)
    packed = flat[offset:].view(shape)
    before = sk.LAUNCHES["stegotpu_qim_unpack_packed"]
    got = sk.packed_rows_to_bits(packed, h, w, num_ac, stripe)
    assert sk.LAUNCHES["stegotpu_qim_unpack_packed"] == before + 1
    want = sk.packed_rows_to_bits_plain(packed, h, w, num_ac, stripe)
    torch.cuda.synchronize()
    assert got.device == packed.device and got.dtype == torch.uint8
    assert torch.equal(got, want)
    wide = (w // 8 * num_ac) % 16 == 0
    assert sk.unpack_store_width(got, w, num_ac) == (16 if wide else 1)


def test_round_trips_unpack_through_the_kernel(dev):
    """The round trips' bits are the unpack kernel's: embed_and_extract_
    frames and extract_frames at 1080p each launch it once, and give the
    plain version's unpack of K4's packed rows and of K2's reading of the
    stego (the same rows: K4's bits are K2's)."""
    frames, payload, total = _cover(dev, "mid", 2, 1080, 1920, 10)
    stego, _, packed = sk.embed_and_extract_frames_packed(frames, payload,
                                                          total, 20.0, 10)
    want = sk.packed_rows_to_bits_plain(packed, 1080, 1920, 10, 120)
    before = sk.LAUNCHES["stegotpu_qim_unpack_packed"]
    _, _, bits = sk.embed_and_extract_frames(frames, payload, total, 20.0, 10)
    assert torch.equal(bits, want)
    assert torch.equal(sk.extract_frames(stego, 20.0, 10), want)
    assert sk.LAUNCHES["stegotpu_qim_unpack_packed"] == before + 2


# --- the study kernels K9-K12 (stegotpu_torch/studies) -------------------------

ABLATIONS = ("full", "no_qim", "no_horiz", "io_only", "io_f4", "full_notrunc")


@pytest.mark.parametrize("kind", ["mid", "dark"])
@pytest.mark.parametrize("b,h,w,num_ac", [(4, 48, 240, 10), (4, 64, 64, 63),
                                          (4, 1080, 1920, 10),
                                          (4, 768, 1360, 30)])
def test_ablation_kernel(dev, b, h, w, num_ac, kind):
    """K9: full and full_notrunc are K5 byte for byte; io_only and io_f4
    equal their plain versions; no_qim equals its plain version or is off
    by 1 (mod 256), never more (the f32 sums of two implementations round
    apart only next to an integer, where the truncating cast steps);
    no_horiz's bits and full's agree with the plain version outside the
    exactness envelope. Each launch counts once."""
    from stegotpu_torch.studies import extract_ablation as ea

    frames, _, _ = _cover(dev, kind, b, h, w, num_ac)
    r5 = sk.extract_frames_rows(frames, 20.0, num_ac)
    entries = [f"stegotpu_qim_ablation:{v}" for v in ABLATIONS]
    before = _launches(*entries)
    out = {v: ea.ablate(frames.float() if v == "full_notrunc" else frames,
                        20.0, num_ac, v) for v in ABLATIONS}
    assert _launches(*entries) == tuple(n + 1 for n in before)
    assert torch.equal(out["full"], r5)
    assert torch.equal(out["full_notrunc"], r5)
    for v in ("io_only", "io_f4"):
        assert torch.equal(out[v], ea.ablate_plain(frames, 20.0, num_ac, v))
    step = (out["no_qim"].int() - ea.ablate_plain(frames, 20.0, num_ac,
                                                  "no_qim").int()) % 256
    assert bool(((step == 0) | (step == 1) | (step == 255)).all())
    assert (step != 0).double().mean().item() < 0.01
    stripe = sk.pick_stripe(h)
    bits = sk.rows_to_bits(out["full"], h, w, num_ac, stripe)
    bits_p = sk.rows_to_bits(ea.ablate_plain(frames, 20.0, num_ac, "full"),
                             h, w, num_ac, stripe)
    assert not ((bits != bits_p) & ~_near_boundary(frames, 20.0, num_ac)).any()
    nh = out["no_horiz"] != ea.ablate_plain(frames, 20.0, num_ac, "no_horiz")
    assert nh.double().mean().item() < 0.01


def test_packedin_and_dual_kernels(dev):
    """K10 is K1 and K11 is K4, byte for byte, at 1080p and at num_ac=63;
    garbage in the packed payload's non-slot bits and padding rows does not
    reach K10's stego."""
    from stegotpu_torch.studies import ab_packed_payload as ab
    from stegotpu_torch.studies import dualchain_r5 as dc

    for b, h, w, num_ac in ((4, 1080, 1920, 10), (2, 64, 64, 63),
                            (2, 768, 1360, 30)):
        frames, payload, total = _cover(dev, "mid", b, h, w, num_ac)
        args = (frames, payload, total, 20.0, num_ac)
        stripe = sk.pick_stripe(h)
        packed = sk.payload_to_rows_packed(payload, h, w, num_ac, stripe)
        assert torch.equal(sk.packed_rows_to_bits(packed, h, w, num_ac, stripe),
                           payload)
        s1, bpf1 = sk.embed_frames(*args)
        s10, bpf10 = ab.embed_frames_packedin(frames, packed, total, 20.0,
                                              num_ac)
        assert torch.equal(s10, s1) and torch.equal(bpf10, bpf1)
        dirty = packed | ~sk.payload_to_rows_packed(
            torch.ones_like(payload), h, w, num_ac, stripe)
        s10d, _ = ab.embed_frames_packedin(frames, dirty, total, 20.0, num_ac)
        assert torch.equal(s10d, s1)
        ref = sk.embed_and_extract_frames_packed(*args)
        got = dc.dual_roundtrip_packed(*args)
        for a, c in zip(got, ref):
            assert torch.equal(a, c)
    with pytest.raises(ValueError, match="odd"):
        dc.dual_roundtrip_packed(*_cover(dev, "mid", 3, 48, 64, 10)[:2], 10,
                                 20.0, 10)


def test_copy_and_dmaspec_kernels(dev):
    """K12: copy is the frames, dmaspec is (frames, payload_to_rows_packed
    of the payload), also with the stripe passed explicitly; each launch
    counts once."""
    from stegotpu_torch.studies import roofline_r4 as rr

    frames, payload, _ = _cover(dev, "mid", 4, 1080, 1920, 10)
    before = _launches("stegotpu_copy:copy", "stegotpu_copy:dmaspec")
    assert torch.equal(rr.copy_frames(frames), frames)
    for stripe in (None, 216, 360):
        s, p = rr.dmaspec(frames, payload, 10, stripe)
        assert torch.equal(s, frames)
        assert torch.equal(p, sk.payload_to_rows_packed(
            payload, 1080, 1920, 10, stripe or 120))
    assert _launches("stegotpu_copy:copy", "stegotpu_copy:dmaspec") == (
        before[0] + 1, before[1] + 3)
    with pytest.raises(ValueError, match="16-byte"):
        rr.copy_frames(frames.reshape(-1)[8:8 + 4 * 48 * 64].reshape(4, 48, 64))


def test_study_mains_on_card(dev, capsys):
    """Each study's main runs at a small shape on the card and prints JSON
    rows, the first naming the card. At H=144 the default stripe is 72, and
    roofline_r4's 216 and 360 do not divide it: error rows, exit 1."""
    import json

    from stegotpu_torch.studies import (ab_packed_payload, device_roofline,
                                        dualchain_r5, extract_ablation,
                                        kron_ab, roofline_r4)

    argv = ["--batch", "4", "--iters", "2", "--height", "144", "--width",
            "256"]
    for mod in (extract_ablation, ab_packed_payload, dualchain_r5,
                roofline_r4, device_roofline, kron_ab):
        rc = mod.main(argv)
        rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
        assert rows[0]["device"] == torch.cuda.get_device_name(0)
        assert len(rows) >= 2
        errors = {r["variant"] for r in rows if "error" in r}
        if mod is roofline_r4:
            assert rc == 1 and errors == {"fused_s216", "fused_s360"}
            assert all(r["stripe"] == 72 for r in rows if "ms_per_batch" in r)
        else:
            assert rc == 0 and not errors, mod.__name__


def test_entry_points_default_to_the_card(dev):
    """Called without `device`, the entry points run on the card: the array
    API launches K1 and K2, and the exactness harness K4 and K5."""
    from stegotpu_torch.device import resolve_device
    from stegotpu_torch.ops.exactness import quick_exactness_check

    assert resolve_device().type == "cuda"
    rng = np.random.default_rng(9)
    cover = rng.integers(16, 240, (2, 120, 160), np.uint8)
    bits = rng.integers(0, 2, 3000, np.uint8)
    cfg = StegoConfig()
    entries = ("stegotpu_qim_embed", "stegotpu_qim_extract_packed",
               "stegotpu_qim_roundtrip_packed", "stegotpu_qim_extract_rows")
    before = _launches(*entries)
    stego, _ = embed_payload_into_gray_frames(cover, bits, cfg)
    got = extract_bits_from_gray_frames(stego, cfg)
    np.testing.assert_array_equal(got[:3000], bits)
    assert quick_exactness_check()["ok"]
    after = _launches(*entries)
    assert all(a > b for a, b in zip(after, before)), (before, after)


def _misaligned(x, offset):
    """A contiguous copy of x whose storage starts `offset` bytes past an
    allocation's start, so its rows (or its payload) lose 16-byte
    alignment."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = flat[offset:].view(x.shape)
    out.copy_(x)
    return out


# the odd shapes of K13's ring: W % 16 != 0 (1048, 136), block columns that
# are no multiple of the 128-block chunk (131, 17), odd num_ac (the payload
# chunks lose 4-byte alignment), a payload that ends mid-block and
# mid-frame. At the small batches each CTA walks at most one tile; at the
# large ones (and at the 1080p B=128 of the study) the tiles outnumber the
# resident CTAs many times over, so every ring slot is refilled again and
# again.
PIPE_SHAPES = [(3, 48, 1048, 10, 0.7), (2, 40, 136, 1, 1.0),
               (2, 64, 64, 63, 0.5), (4, 96, 1360, 7, 0.3),
               (2, 1080, 1920, 10, 1.0), (512, 96, 1360, 7, 0.3),
               (512, 48, 1048, 10, 0.7), (2048, 40, 136, 1, 1.0),
               (2048, 64, 64, 63, 0.5), (128, 1080, 1920, 10, 1.0),
               (2, 48, 1048, 7, 0.6), (128, 96, 1360, 10, 0.9)]


@pytest.mark.parametrize("capped", [True, False])
@pytest.mark.parametrize("bufs", [2, 3, 4])
@pytest.mark.parametrize("b,h,w,num_ac,frac", PIPE_SHAPES)
def test_pipe_kernel_is_k4(dev, b, h, w, num_ac, frac, bufs, capped):
    """K13 (the cp.async ring) is K4 byte for byte: stego, bits per frame
    and packed bits, at every ring depth, with and without its register
    cap, on the odd shapes, with frames 8 bytes and a payload 1-3 bytes off
    16-byte alignment, at delta 2^-11 (ArithHopperSmallDelta) and at delta
    <= 0 (every block passes through, every bit reads 0); so is K11 where B
    is even (once a shape)."""
    from stegotpu_torch.studies import dualchain_r5 as dc
    from stegotpu_torch.studies import emitpipe_r4 as ep

    frames, payload, _ = _cover(dev, "mid", b, h, w, num_ac, seed=num_ac)
    cap = payload.shape[1]
    total = int(frac * b * cap) - 5
    for f_off, p_off, delta in ((0, 0, 20.0), (8, 3, 20.0), (8, 1, 8.0),
                                (0, 0, 2.0**-11), (0, 2, 0.0), (0, 0, -4.0)):
        fr = _misaligned(frames, f_off) if f_off else frames
        pl = _misaligned(payload, p_off) if p_off else payload
        args = (fr, pl, total, delta, num_ac)
        entry = f"stegotpu_qim_roundtrip_pipe:buf{bufs}"
        before = sk.LAUNCHES[entry]
        got = ep.roundtrip_pipelined_packed(*args, bufs=bufs, capped=capped)
        assert sk.LAUNCHES[entry] == before + 1
        ref = sk.embed_and_extract_frames_packed(*args)
        others = [got]
        if b % 2 == 0 and bufs == 2 and capped:  # two frames a thread
            others.append(dc.dual_roundtrip_packed(*args))
        torch.cuda.synchronize()
        for g in others:
            for a, c in zip(g, ref):
                assert torch.equal(a, c), (f_off, p_off, delta, len(g))
        if delta <= 0:
            assert torch.equal(got[0], frames) and not got[2].any()


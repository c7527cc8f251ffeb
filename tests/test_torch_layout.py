"""The port's packed-rows layout helpers are identical to the JAX package's.

stegotpu_torch.ops.stripe_kernel mirrors pick_stripe, rows_per_block,
_rows_pad, _slot_span and packed_rows_to_bits_host of
stegotpu/ops/pallas_kernel.py, so that the pipeline's _PackedBitBuf and its
sliced prefix readback carry over unchanged.
"""

import logging

import numpy as np
import pytest
import torch

from stegotpu.ops import pallas_kernel as jpk
from stegotpu_torch.ops import stripe_kernel as sk


def test_pick_stripe_matches():
    for h in range(8, 2168, 8):
        assert sk.pick_stripe(h) == jpk.pick_stripe(h)
    for h in (0, 100, 1081):
        if h % 8:
            with pytest.raises(ValueError):
                sk.pick_stripe(h)
    assert sk.pick_stripe(1080) == 120 and sk.pick_stripe(64) == 8


@pytest.mark.parametrize("override", ["48", "40", "abc", "-8"])
def test_pick_stripe_override_matches(monkeypatch, caplog, override):
    """STEGOTPU_PALLAS_STRIPE: honoured when it is a positive multiple of 8
    dividing the height, warned about and ignored otherwise — in both."""
    monkeypatch.setenv("STEGOTPU_PALLAS_STRIPE", override)
    with caplog.at_level(logging.WARNING):
        for h in (480, 1080, 96):
            assert sk.pick_stripe(h) == jpk.pick_stripe(h)


def test_rows_pad_and_slot_span_match():
    for num_ac in range(64):
        assert sk.rows_per_block(num_ac) == jpk.rows_per_block(num_ac)
        for g in range(sk.rows_per_block(num_ac)):
            assert sk._slot_span(g, num_ac) == jpk._slot_span(g, num_ac)
        for stripe in (8, 24, 48, 72, 96, 120):
            rn = sk.rows_per_block(num_ac)
            assert sk._rows_pad(stripe, rn) == jpk._rows_pad(stripe, rn)


@pytest.mark.parametrize("h,w,num_ac", [(1080, 64, 10), (48, 240, 3),
                                        (64, 64, 63), (96, 128, 1),
                                        (240, 72, 15)])
def test_packed_rows_to_bits_matches(h, w, num_ac):
    """Full frames and every stripe-group prefix unpack to identical wire
    bits, on the host (numpy) and on a tensor (the device unpack's wrapper
    and its plain version)."""
    rng = np.random.default_rng(h * w + num_ac)
    stripe = sk.pick_stripe(h)
    rp = sk._rows_pad(stripe, sk.rows_per_block(num_ac))
    groups = h // stripe
    packed = rng.integers(0, 256, (2, groups * rp, w // 8), dtype=np.uint8)
    full = sk.packed_rows_to_bits_host(packed, h, w, num_ac, stripe)
    np.testing.assert_array_equal(
        full, jpk.packed_rows_to_bits_host(packed, h, w, num_ac, stripe))
    assert full.shape == (2, (h // 8) * (w // 8) * num_ac)
    np.testing.assert_array_equal(
        sk.packed_rows_to_bits(torch.from_numpy(packed), h, w, num_ac,
                               stripe).numpy(), full)
    np.testing.assert_array_equal(
        sk.packed_rows_to_bits_plain(torch.from_numpy(packed), h, w, num_ac,
                                     stripe).numpy(), full)
    spg = full.shape[1] // groups  # wire bits per stripe group
    for g in range(1, groups + 1):
        pre = packed[:1, : g * rp]
        got = sk.packed_rows_to_bits_host(pre, h, w, num_ac, stripe)
        np.testing.assert_array_equal(
            got, jpk.packed_rows_to_bits_host(pre, h, w, num_ac, stripe))
        np.testing.assert_array_equal(got[0], full[0, : g * spg])
    with pytest.raises(ValueError):
        sk.packed_rows_to_bits_host(packed[:, : rp - 1], h, w, num_ac, stripe)


def _bad_packed(case):
    """(packed, h, w, num_ac, stripe) that the wire-order unpack refuses."""
    h, w, num_ac, stripe = 48, 64, 10, 48
    rp = sk._rows_pad(stripe, sk.rows_per_block(num_ac))
    packed = torch.zeros((2, rp, w // 8), dtype=torch.uint8)
    if case == "dtype":
        packed = packed.to(torch.int16)
    elif case == "2-dim":
        packed = packed[0]
    elif case == "rows":       # one stripe group's chunk short: a prefix
        packed = packed[:, :-1].contiguous()
    elif case == "width":      # rows of another width
        w = 72
    elif case == "num_ac":     # rows of another num_ac (rn 3, not 2)
        num_ac = 17
    elif case == "stripe":     # rows laid out by another stripe
        stripe = 16
    elif case == "bad stripe":
        stripe = 20
    elif case == "no slot":
        num_ac = 0
    elif case == "strided":
        packed = torch.zeros((2, rp, 2 * (w // 8)),
                             dtype=torch.uint8)[:, :, ::2]
    return packed, h, w, num_ac, stripe


@pytest.mark.parametrize("case,match", [
    ("dtype", "uint8"), ("2-dim", "packed rows must be"),
    ("rows", "packed rows must be"), ("width", "packed rows must be"),
    ("num_ac", "packed rows must be"), ("stripe", "packed rows must be"),
    ("bad stripe", "stripe 20"), ("no slot", "1..63"),
    ("strided", "contiguous")])
def test_unpack_wrapper_refuses_what_the_kernel_cannot_take(monkeypatch,
                                                            case, match):
    """packed_rows_to_bits checks dtype, shape (full frames of h x w at
    num_ac and stripe), the stripe and contiguity before it picks a path,
    so these refusals run here, and no library is loaded."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(sk._build, "load_library", no_library)
    before = sk.LAUNCHES["stegotpu_qim_unpack_packed"]
    with pytest.raises(ValueError, match=match):
        sk.packed_rows_to_bits(*_bad_packed(case))
    assert sk.LAUNCHES["stegotpu_qim_unpack_packed"] == before


@pytest.mark.parametrize("w,num_ac,offset,want", [
    (3840, 10, 0, 16), (1920, 10, 0, 16), (1280, 3, 0, 16), (128, 1, 0, 16),
    (72, 10, 0, 1), (56, 10, 0, 1), (72, 16, 0, 16), (3840, 10, 3, 1)])
def test_unpack_store_width_follows_the_output_rows(w, num_ac, offset, want):
    """16-byte stores where every output block row ((W/8)*num_ac bytes)
    and the base start on a 16-byte boundary: 4K and 1080p at num_ac 10,
    720p at num_ac 3; single bytes where W/8 * num_ac is no multiple of 16
    or the output starts off a boundary."""
    flat = torch.empty(64 + offset, dtype=torch.uint8)
    start = -flat.data_ptr() % 16 + offset
    bits = flat[start:start + 16]
    assert sk.unpack_store_width(bits, w, num_ac) == want


@pytest.mark.parametrize("stripe", [120, 216, 360])
def test_unpack_bound_is_slot_rows_read_and_wire_bits_written(stripe):
    """The unpack of 128 4K frames at num_ac 10 reads 259,200 slot-row bytes
    a frame (never the padding rows, so whatever the stripe) and writes
    1,296,000 wire bytes: 199,065,600 B, 0.0594 ms at 3.35 TB/s
    (studies/bounds.py, chip_smoke.py phase 4)."""
    from stegotpu_torch.studies import bounds

    nbytes, flops = bounds.work("unpack_packed", 128, 2160, 3840, 10, stripe)
    assert (nbytes, flops) == (128 * (259_200 + 1_296_000), 0)
    ms, by = bounds.bound_ms(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(0.0594226, abs=1e-6)

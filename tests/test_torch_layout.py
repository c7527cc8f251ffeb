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
    bits, on the host (numpy) and on a tensor (the device unpack)."""
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
    spg = full.shape[1] // groups  # wire bits per stripe group
    for g in range(1, groups + 1):
        pre = packed[:1, : g * rp]
        got = sk.packed_rows_to_bits_host(pre, h, w, num_ac, stripe)
        np.testing.assert_array_equal(
            got, jpk.packed_rows_to_bits_host(pre, h, w, num_ac, stripe))
        np.testing.assert_array_equal(got[0], full[0, : g * spg])
    with pytest.raises(ValueError):
        sk.packed_rows_to_bits_host(packed[:, : rp - 1], h, w, num_ac, stripe)

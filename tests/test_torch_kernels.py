"""The port's QIM stripe kernels against the JAX package.

On the CPU the port's wrappers (stegotpu_torch.ops.stripe_kernel) run their
plain PyTorch versions; the JAX side runs the Pallas kernels interpreted,
as tests/test_pallas_kernel.py runs them, and the XLA oracle
stegotpu.ops.qim. Inputs are made with numpy from a seed and handed to
both. The CUDA kernels themselves are compared with their plain versions
in tests/test_torch_cuda.py, which skips without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stegotpu.ops import pallas_kernel as jpk
from stegotpu.ops import qim as jqim
from stegotpu.ops.exactness import TOL_ABS, TOL_REL
from stegotpu_torch.ops import qim as tqim
from stegotpu_torch.ops import stripe_kernel as sk

SHAPES = [(2, 48, 128), (2, 48, 240), (1, 64, 64)]  # 64 rows: stripe 8
OFFSET = 13  # nonzero global bit offset of the batch's first slot

# Allowed fraction of stego pixels differing by >1 between two f32 embeds:
# a coefficient at a rounding boundary of round(y/delta) may snap to the
# other lattice point (same parity, same decoded bit); the JAX package's own
# CPU budget for Pallas vs XLA (tests/test_pallas_kernel.py:22-32). One such
# flip moves a whole 8x8 block, 1/64 of a 64x64 frame, so the fraction is
# held only from MIN_BUDGET_BLOCKS blocks up; at every size each block with
# a pixel off by >1 must hold a slot whose cover coefficient lies in the
# exactness envelope of a rounding boundary.
FLIP_BUDGET = 0.01
MIN_BUDGET_BLOCKS = 128


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, b, h, w, num_ac, frac):
    rng = np.random.default_rng(seed)
    # mid-range covers: the payload must come back exactly (no clipping
    # loss, which is the algorithm's and not a kernel's)
    frames = rng.integers(16, 240, (b, h, w), dtype=np.uint8)
    cap = (h // 8) * (w // 8) * num_ac
    payload = rng.integers(0, 2, (b, cap), dtype=np.uint8)
    total = OFFSET + int(frac * b * cap)
    return frames, payload, total


def _near_boundary(frames: np.ndarray, delta: float, num_ac: int) -> np.ndarray:
    """Per wire-order slot bit: is the float64 coefficient within the JAX
    package's exactness envelope (TOL_ABS + TOL_REL*|y|) of a rounding
    boundary? Only there may two f32 implementations disagree."""
    from stegotpu.ops.dct import blockify, kron_dct_matrix

    k = kron_dct_matrix(8, np.float64)[1 : 1 + num_ac]
    y = blockify(frames.astype(np.float64)) @ k.T
    r = y / delta
    dist = np.abs(r - np.floor(r) - 0.5) * delta
    return (dist <= TOL_ABS + TOL_REL * np.abs(y)).reshape(frames.shape[0], -1)


def _assert_stego_close(a: np.ndarray, b: np.ndarray, cover: np.ndarray,
                        delta: float, num_ac: int) -> None:
    """Two embeds of `cover` agree up to lattice flips at rounding
    boundaries (see FLIP_BUDGET) and the u8 truncation of f32 noise (1)."""
    from stegotpu.ops.dct import blockify

    off = np.abs(a.astype(int) - b.astype(int)) > 1
    nb = off.shape[0] * (off.shape[1] // 8) * (off.shape[2] // 8)
    if nb >= MIN_BUDGET_BLOCKS:
        assert off.mean() < FLIP_BUDGET
    near = _near_boundary(cover, delta, num_ac).reshape(
        cover.shape[0], -1, num_ac).any(-1)
    assert not (blockify(off).any(-1) & ~near).any()


def _slot_lanes(h: int, w: int, num_ac: int) -> np.ndarray:
    """(rows, W/8, 8) mask of the payload-slot lanes of the packed layout,
    unpacked little-endian (lane s of a byte is its bit s)."""
    stripe = sk.pick_stripe(h)
    rn = sk.rows_per_block(num_ac)
    rp = sk._rows_pad(stripe, rn)
    k = np.arange((h // stripe) * rp) % rp
    c = 8 * (k % rn)[:, None] + np.arange(8)[None, :]
    lanes = (k < (stripe // 8) * rn)[:, None] & (c >= 1) & (c <= num_ac)
    return np.broadcast_to(lanes[:, None, :], (k.size, w // 8, 8))


@pytest.mark.parametrize("delta", [8, 20])
@pytest.mark.parametrize("num_ac", [1, 8, 10, 15])
@pytest.mark.parametrize("frac", [1.0, 0.4, 0.0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stripe_kernels_match_jax(shape, frac, num_ac, delta):
    b, h, w = shape
    frames, payload, total = _inputs(1234, b, h, w, num_ac, frac)
    jargs = (jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
             jnp.float32(delta), num_ac)
    s_j, bpf_j = jpk.embed_frames_pallas(*jargs, bit_offset=OFFSET)
    s_x, bpf_x = jqim.embed_frames(*jargs, bit_offset=OFFSET)
    s_j, s_x = np.asarray(s_j), np.asarray(s_x)

    # K1 (plain) against the interpreted Pallas kernel and the XLA oracle
    s_t, bpf_t = sk.embed_frames(_t(frames), _t(payload), total, delta,
                                 num_ac, OFFSET)
    s_t = s_t.numpy()
    np.testing.assert_array_equal(bpf_t.numpy(), np.asarray(bpf_j))
    np.testing.assert_array_equal(bpf_t.numpy(), np.asarray(bpf_x))
    for other in (s_j, s_x):
        _assert_stego_close(s_t, other, frames, delta, num_ac)

    # the port's oracle (kernel='xla') against the JAX one
    s_o, bpf_o = tqim.embed_frames(_t(frames), _t(payload), total, delta,
                                   num_ac, OFFSET)
    np.testing.assert_array_equal(bpf_o.numpy(), np.asarray(bpf_x))
    _assert_stego_close(s_o.numpy(), s_x, frames, delta, num_ac)

    # payload exact, read back by K2 (plain) and by the port's oracle
    n = total - OFFSET
    for got in (sk.extract_frames(_t(s_t), delta, num_ac),
                tqim.extract_frames(_t(s_t), delta, num_ac)):
        np.testing.assert_array_equal(got.numpy().reshape(-1)[:n],
                                      payload.reshape(-1)[:n])
    if frac == 0.0:  # nothing entered: exact passthrough
        np.testing.assert_array_equal(s_t, frames)

    # K2 (plain) against the interpreted Pallas kernel and the XLA oracle,
    # on the stego and on the raw cover: same layout, zero padding rows,
    # and wire-order bits identical outside the exactness envelope (at
    # delta=8 the u8 truncation can leave a stego coefficient near a
    # boundary too)
    stripe = sk.pick_stripe(h)
    lanes = _slot_lanes(h, w, num_ac)
    for x in (s_t, frames):
        p_t = sk.extract_frames_packed(_t(x), delta, num_ac).numpy()
        p_j = np.asarray(jpk.extract_frames_pallas_packed(
            jnp.asarray(x), jnp.float32(delta), num_ac))
        assert p_t.shape == p_j.shape and p_t.dtype == np.uint8
        pad = np.arange(p_t.shape[1]) % sk._rows_pad(
            stripe, sk.rows_per_block(num_ac)) >= (stripe // 8) * \
            sk.rows_per_block(num_ac)
        assert not p_t[:, pad].any()
        near = _near_boundary(x, delta, num_ac)
        bits_t = sk.packed_rows_to_bits_host(p_t, h, w, num_ac, stripe)
        for bits_j in (
                jpk.packed_rows_to_bits_host(p_j, h, w, num_ac, stripe),
                np.asarray(jqim.extract_frames(jnp.asarray(x),
                                               jnp.float32(delta), num_ac))):
            assert not ((bits_t != bits_j) & ~near).any()
        if not near.any():  # then the packed slot lanes agree bit for bit
            unpack = lambda p: np.unpackbits(p[..., None], axis=-1,
                                             bitorder="little")
            np.testing.assert_array_equal(unpack(p_t)[:, lanes],
                                          unpack(p_j)[:, lanes])


@pytest.mark.parametrize("delta", [0.0, -5.0])
def test_nonpositive_delta_embeds_and_reads_nothing(delta):
    """delta <= 0: embed changes nothing, extract reads zeros, no NaN
    (reference config_and_setup.py:143-145), as in the JAX kernels."""
    frames, payload, total = _inputs(7, 2, 48, 240, 10, 1.0)
    s_t, _ = sk.embed_frames(_t(frames), _t(payload), total, delta, 10, OFFSET)
    s_j, _ = jpk.embed_frames_pallas(
        jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
        jnp.float32(delta), 10, bit_offset=OFFSET)
    np.testing.assert_array_equal(s_t.numpy(), frames)
    np.testing.assert_array_equal(np.asarray(s_j), frames)
    p_t = sk.extract_frames_packed(_t(frames), delta, 10).numpy()
    p_j = np.asarray(jpk.extract_frames_pallas_packed(
        jnp.asarray(frames), jnp.float32(delta), 10))
    assert not p_t.any() and not p_j.any()
    assert not tqim.extract_frames(_t(frames), delta, 10).any()


def test_mid_block_stop_and_passthrough():
    """The payload ends inside block 2: later blocks pass through byte for
    byte, and the first total bits come back (JAX:
    tests/test_pallas_kernel.py::test_pallas_passthrough_and_boundary)."""
    frames, payload, _ = _inputs(11, 1, 48, 128, 10, 1.0)
    total = 2 * 10 + 3
    for embed in (sk.embed_frames, sk.embed_frames_plain, tqim.embed_frames):
        stego, bpf = embed(_t(frames), _t(payload), total, 20.0, 10)
        stego = stego.numpy()
        assert bpf.tolist() == [total]
        np.testing.assert_array_equal(stego[0, 8:], frames[0, 8:])
        np.testing.assert_array_equal(stego[0, :, 24:], frames[0, :, 24:])
        got = sk.extract_frames(_t(stego), 20.0, 10).numpy().reshape(-1)
        np.testing.assert_array_equal(got[:total], payload.reshape(-1)[:total])


def test_negative_coefficient_parity():
    """Floor-mod parity (torch.remainder, not torch.fmod) on negative q:
    a dark-to-bright edge gives negative AC coefficients; the port reads
    the same bits as the JAX oracle."""
    frames = np.zeros((1, 8, 16), np.uint8)
    frames[0, :, :4] = 200
    frames[0, :, 8:12] = 40
    frames[0, :, 12:] = 230
    for delta in (7.0, 20.0):
        got = tqim.extract_frames(_t(frames), delta, 10).numpy()
        ref = np.asarray(jqim.extract_frames(jnp.asarray(frames),
                                             jnp.float32(delta), 10))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            sk.extract_frames(_t(frames), delta, 10).numpy(), ref)


def test_wrappers_reject_bad_inputs():
    frames, payload, total = _inputs(3, 1, 48, 128, 10, 1.0)
    with pytest.raises(ValueError):
        sk.embed_frames(_t(frames[:, :, :124]), _t(payload), total, 20.0, 10)
    with pytest.raises(ValueError):
        sk.embed_frames(_t(frames), _t(payload[:, :-1]), total, 20.0, 10)
    with pytest.raises(ValueError):
        sk.extract_frames_packed(_t(frames).to(torch.int32), 20.0, 10)


def _fused_inputs(seed, b, h, w, num_ac, frac, lo=16, hi=240):
    """Covers and a payload whose end falls mid-block, with no bit offset
    (the fused kernels K3/K4 take none: global bit 0 is the payload's)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(lo, hi, (b, h, w), dtype=np.uint8)
    cap = (h // 8) * (w // 8) * num_ac
    payload = rng.integers(0, 2, (b, cap), dtype=np.uint8)
    return frames, payload, max(1, int(frac * b * cap) - OFFSET)


def _valid(payload: np.ndarray, total: int) -> np.ndarray:
    return np.arange(payload.size).reshape(payload.shape) < total


@pytest.mark.parametrize("num_ac", [1, 10, 15])
@pytest.mark.parametrize("frac", [1.0, 0.4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_kernels_match_jax(shape, frac, num_ac):
    """K3 (embed + check) and K4 (embed + packed re-extract), plain, against
    the interpreted Pallas kernels _embed_and_check_frames_pallas and
    embed_and_extract_frames_pallas_packed: bits per frame identical, stego
    within the cross-variant budget, the payload back exactly, zero errors
    counted on a mid-range cover. And the identities the exactness harness
    holds at zero tolerance: K3's and K4's stego are K1's, K4's bits and
    K3's count are K2's reading of that stego."""
    b, h, w = shape
    delta = 20.0
    frames, payload, total = _fused_inputs(4321, b, h, w, num_ac, frac)
    jargs = (jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
             jnp.float32(delta), num_ac)
    s_jc, bpf_jc, err_j = (np.asarray(a) for a in
                           jpk._embed_and_check_frames_pallas(*jargs, True))
    s_jr, bpf_jr, ex_j = (np.asarray(a) for a in
                          jpk.embed_and_extract_frames_pallas_packed(*jargs))
    targs = (_t(frames), _t(payload), total, delta, num_ac)
    s_tc, bpf_tc, err_t = (a.numpy() for a in sk.embed_and_check_frames(*targs))
    s_tr, bpf_tr, ex_t = (a.numpy() for a in sk.embed_and_extract_frames(*targs))
    s_1, bpf_1 = (a.numpy() for a in sk.embed_frames(*targs))

    for bpf in (bpf_jc, bpf_jr, bpf_tc, bpf_tr):
        np.testing.assert_array_equal(bpf, bpf_1)
    _assert_stego_close(s_tc, s_jc, frames, delta, num_ac)
    _assert_stego_close(s_tr, s_jr, frames, delta, num_ac)
    np.testing.assert_array_equal(s_tc, s_1)
    np.testing.assert_array_equal(s_tr, s_1)
    assert err_t.dtype == np.int32 and err_t.shape == (b,)
    assert not err_t.any() and not err_j.any()
    np.testing.assert_array_equal(
        ex_t, sk.extract_frames(_t(s_tr), delta, num_ac).numpy())
    valid = _valid(payload, total)
    for ex in (ex_t, ex_j):
        np.testing.assert_array_equal(ex[valid], payload[valid])


def test_check_counts_clipping_losses_like_jax():
    """On a flat-black cover the embed loses bits to clipping: K3's plain
    version counts exactly the valid slots that K2 reads back wrong from
    its stego, per frame, and the JAX oracle reads that stego the same way
    outside the exactness envelope. Past the payload end nothing counts."""
    b, h, w, num_ac, delta = 2, 48, 128, 10, 20.0
    frames, payload, _ = _fused_inputs(77, b, h, w, num_ac, 1.0, 0, 1)
    cap = payload.shape[1]
    for total in (b * cap - OFFSET, cap + 37):
        stego, bpf, err = sk.embed_and_check_frames(
            _t(frames), _t(payload), total, delta, num_ac)
        got = sk.extract_frames(stego, delta, num_ac).numpy()
        wrong = (got != payload) & _valid(payload, total)
        np.testing.assert_array_equal(err.numpy(), wrong.sum(1))
        assert err.sum() > 0  # test premise: clipping flips bits here
        ref = np.asarray(jqim.extract_frames(jnp.asarray(stego.numpy()),
                                             jnp.float32(delta), num_ac))
        near = _near_boundary(stego.numpy(), delta, num_ac)
        assert not ((ref != got) & ~near).any()
        _, _, err_j = jpk._embed_and_check_frames_pallas(
            jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
            jnp.float32(delta), num_ac, True)
        assert np.asarray(err_j).sum() > 0
        assert bpf.tolist() == np.clip(total - np.arange(b) * cap, 0,
                                       cap).tolist()


@pytest.mark.parametrize("delta", [8, 20])
@pytest.mark.parametrize("num_ac", [1, 10, 15])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_extract_rows_matches_jax(shape, num_ac, delta):
    """K5 (plain) against the interpreted Pallas _extract_frames_pallas_rows:
    the same unpacked compact-rows layout with zero padding rows, wire-order
    bits identical outside the exactness envelope (via the port's and the
    JAX package's rows_to_bits, which agree on any rows), and identical to
    K2's bits lane for lane (packed vs unpacked, zero tolerance)."""
    b, h, w = shape
    frames, _, _ = _inputs(99, b, h, w, num_ac, 1.0)
    stripe = sk.pick_stripe(h)
    rows_t = sk.extract_frames_rows(_t(frames), delta, num_ac).numpy()
    rows_j = np.asarray(jpk._extract_frames_pallas_rows(
        jnp.asarray(frames), jnp.float32(delta), num_ac, True))
    assert rows_t.shape == rows_j.shape and rows_t.dtype == np.uint8
    assert set(np.unique(rows_t)) <= {0, 1}
    rp = sk._rows_pad(stripe, sk.rows_per_block(num_ac))
    pad = np.arange(rows_t.shape[1]) % rp >= (stripe // 8) * \
        sk.rows_per_block(num_ac)
    assert not rows_t[:, pad].any() and not rows_j[:, pad].any()
    bits_t = sk.rows_to_bits(_t(rows_t), h, w, num_ac, stripe).numpy()
    for rows in (rows_t, rows_j):
        np.testing.assert_array_equal(
            sk.rows_to_bits(torch.tensor(rows), h, w, num_ac, stripe).numpy(),
            np.asarray(jpk.rows_to_bits(jnp.asarray(rows), h, w, num_ac,
                                        stripe)))
    bits_j = np.asarray(jpk.rows_to_bits(jnp.asarray(rows_j), h, w, num_ac,
                                         stripe))
    assert not ((bits_t != bits_j) & ~_near_boundary(frames, delta, num_ac)).any()
    packed = sk.extract_frames_packed(_t(frames), delta, num_ac).numpy()
    np.testing.assert_array_equal(
        np.packbits(rows_t.reshape(b, rows_t.shape[1], w // 8, 8), axis=-1,
                    bitorder="little")[..., 0], packed)

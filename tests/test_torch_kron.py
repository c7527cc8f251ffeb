"""The port's state plane, image-layout path and Kronecker kernels (K7, K8)
against the JAX package.

On the CPU the kron wrappers run their plain PyTorch versions; the JAX
side runs stegotpu.ops.experimental.pallas_kron interpreted, as
tests/test_pallas_kron.py runs it, and qim_fast under XLA. Inputs are made
with numpy from a seed and handed to both. The CUDA kernels are compared
with their plain versions in tests/test_torch_cuda.py, which skips without
a card.

Tolerances (the JAX package's own, stegotpu/ops/exactness.py and
tests/test_pallas_kron.py:18-28):
- bits per frame, the state plane and the passthrough: identical;
- stego pixels: off by more than 1 on under FLIP_BUDGET of pixels (held
  from MIN_BUDGET_BLOCKS blocks up, since one lattice flip moves a whole
  block), and every block with such a pixel holds a slot whose cover
  coefficient lies in the exactness envelope;
- slot bits: identical outside the envelope TOL_ABS + TOL_REL*|y| of a
  rounding boundary of round(y/delta);
- the payload: back exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stegotpu.ops.dct import blockify as jblockify
from stegotpu.ops.exactness import TOL_ABS, TOL_REL
from stegotpu.ops.experimental import pallas_kron as jkron
from stegotpu.ops.experimental import qim_fast as jfast
from stegotpu_torch.ops import qim as tqim
from stegotpu_torch.ops.dct import kron_dct_matrix
from stegotpu_torch.ops.experimental import kron_kernel as kk
from stegotpu_torch.ops.experimental import qim_fast as tfast

DELTA = 20.0
OFFSET = 13  # nonzero global bit offset of the batch's first slot
FLIP_BUDGET = 0.01
MIN_BUDGET_BLOCKS = 128


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, b, h, w, num_ac, frac, offset=0, lo=32, hi=224):
    """Mid-range covers (the payload must come back exactly: no clipping
    loss, which is the algorithm's and not a kernel's) and a payload whose
    end falls inside a block."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(lo, hi, (b, h, w), dtype=np.uint8)
    cap = (h // 8) * (w // 8) * num_ac
    payload = rng.integers(0, 2, (b, cap), dtype=np.uint8)
    n = int(frac * b * cap)
    if 0 < n == b * cap:
        n -= num_ac // 2 + 1  # stop mid-block in the last block
    return frames, payload, offset + n


def _near_boundary(frames: np.ndarray, num_ac: int) -> np.ndarray:
    """(B, C) wire-order: is the float64 slot coefficient within the
    exactness envelope of a rounding boundary of round(y/DELTA)?"""
    k = kron_dct_matrix(8, np.float64)[1 : 1 + num_ac]
    y = jblockify(frames.astype(np.float64)) @ k.T
    r = y / DELTA
    dist = np.abs(r - np.floor(r) - 0.5) * DELTA
    return (dist <= TOL_ABS + TOL_REL * np.abs(y)).reshape(frames.shape[0], -1)


def _assert_stego_close(a, b, cover, num_ac):
    off = np.abs(a.astype(int) - b.astype(int)) > 1
    blocks_off = jblockify(off).any(-1)
    if blocks_off.size >= MIN_BUDGET_BLOCKS:
        assert off.mean() < FLIP_BUDGET
    near = _near_boundary(cover, num_ac).reshape(cover.shape[0], -1,
                                                 num_ac).any(-1)
    assert not (blocks_off & ~near).any()


# --- the state plane ----------------------------------------------------------

@pytest.mark.parametrize("offset", [0, OFFSET])
@pytest.mark.parametrize("frac", [1.0, 0.35, 0.0])
@pytest.mark.parametrize("num_ac", [1, 10, 63])
def test_state_plane_byte_identical(num_ac, frac, offset):
    b, h, w = 2, 16, 128
    _, payload, total = _inputs(3, b, h, w, num_ac, frac, offset)
    nb = (h // 8) * (w // 8)
    want = np.asarray(jfast.build_plane_blocks(
        jnp.asarray(payload), jnp.int32(total), nb, num_ac, offset))
    got = tfast.build_plane_blocks(_t(payload), total, nb, num_ac, offset)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tfast.build_state_plane(_t(payload), total, h, w, num_ac,
                                offset).numpy(),
        np.asarray(jfast.build_state_plane(jnp.asarray(payload),
                                           jnp.int32(total), h, w, num_ac,
                                           offset)))


# --- the image-layout path (qim_fast) -----------------------------------------

@pytest.mark.parametrize("frac", [1.0, 0.4, 0.0])
def test_fast_embed_matches_jax(frac):
    """tests/test_qim_fast.py::test_fast_embed_matches_baseline's cases:
    the port's image-layout embed against the JAX package's and against
    the port's oracle."""
    n_ac = 10
    frames, payload, total = _inputs(5, 2, 32, 128, n_ac, frac)
    s_j, bpf_j = jfast.embed_frames_fast(
        jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
        jnp.float32(DELTA), n_ac)
    s_t, bpf_t = tfast.embed_frames_fast(_t(frames), _t(payload), total,
                                         DELTA, n_ac)
    s_o, _ = tqim.embed_frames(_t(frames), _t(payload), total, DELTA, n_ac)
    np.testing.assert_array_equal(bpf_t.numpy(), np.asarray(bpf_j))
    for other in (np.asarray(s_j), s_o.numpy()):
        _assert_stego_close(s_t.numpy(), other, frames, n_ac)
    ex_t = tfast.extract_frames_fast(s_t, DELTA, n_ac).numpy().reshape(-1)
    np.testing.assert_array_equal(ex_t[:total], payload.reshape(-1)[:total])
    ex_j = np.asarray(jfast.extract_frames_fast(
        jnp.asarray(s_t.numpy()), jnp.float32(DELTA), n_ac)).reshape(-1)
    np.testing.assert_array_equal(ex_j, ex_t)  # same stego: slot bits agree
    if frac == 0.0:
        np.testing.assert_array_equal(s_t.numpy(), frames)


def test_fast_extract_matches_jax_exactly():
    """On lattice-snapped content the extractors agree bit for bit (JAX:
    test_fast_extract_matches_baseline_exactly)."""
    n_ac = 10
    frames, payload, total = _inputs(6, 2, 32, 128, n_ac, 1.0)
    stego, _ = tqim.embed_frames(_t(frames), _t(payload), total, DELTA, n_ac)
    ex_o = tqim.extract_frames(stego, DELTA, n_ac).numpy()
    ex_t = tfast.extract_frames_fast(stego, DELTA, n_ac).numpy()
    ex_j = np.asarray(jfast.extract_frames_fast(
        jnp.asarray(stego.numpy()), jnp.float32(DELTA), n_ac))
    np.testing.assert_array_equal(ex_t, ex_o)
    np.testing.assert_array_equal(ex_t, ex_j)


def test_fast_passthrough_and_mid_block_stop():
    """Blocks past the payload end pass through byte for byte; a payload
    ending mid-block still round-trips (JAX: test_fast_passthrough_blocks_
    identical, test_fast_mid_block_boundary)."""
    n_ac = 10
    frames, payload, _ = _inputs(7, 1, 32, 128, n_ac, 1.0)
    for total in (payload.size // 4, 3 * n_ac + 4):
        stego, bpf = tfast.embed_frames_fast(_t(frames), _t(payload), total,
                                             DELTA, n_ac)
        first_clean_row = 8 * (-(-(-(-total // n_ac)) // 16))
        np.testing.assert_array_equal(stego.numpy()[0, first_clean_row:],
                                      frames[0, first_clean_row:])
        ex = tfast.extract_frames_fast(stego, DELTA, n_ac).numpy().reshape(-1)
        np.testing.assert_array_equal(ex[:total], payload.reshape(-1)[:total])
        assert bpf.tolist() == [total]
        s_f, _, ex_f = tfast.embed_and_extract_frames_fast(
            _t(frames), _t(payload), total, DELTA, n_ac)
        assert torch.equal(s_f, stego) and np.array_equal(ex_f.numpy()
                                                          .reshape(-1), ex)


def test_auto_takes_the_oracle_off_the_128_lane_grid():
    n_ac = 10
    frames, payload, total = _inputs(8, 1, 16, 120, n_ac, 0.5)
    args = (_t(frames), _t(payload), total, DELTA, n_ac)
    s_a, bpf_a = tfast.embed_frames_auto(*args)
    s_o, bpf_o = tqim.embed_frames(*args)
    assert torch.equal(s_a, s_o) and torch.equal(bpf_a, bpf_o)
    assert torch.equal(tfast.extract_frames_auto(s_a, DELTA, n_ac),
                       tqim.extract_frames(s_a, DELTA, n_ac))
    frames, payload, total = _inputs(8, 1, 16, 128, n_ac, 0.5)
    s_a, _ = tfast.embed_frames_auto(_t(frames), _t(payload), total, DELTA,
                                     n_ac)
    s_f, _ = tfast.embed_frames_fast(_t(frames), _t(payload), total, DELTA,
                                     n_ac)
    assert torch.equal(s_a, s_f)


# --- K7 and K8 ----------------------------------------------------------------

@pytest.mark.parametrize("num_ac", [1, 10, 63])
@pytest.mark.parametrize("frac", [1.0, 0.35, 0.0])
@pytest.mark.parametrize("shape", [(2, 48, 128), (1, 240, 384)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kron_plain_matches_jax(shape, frac, num_ac):
    """K7 and K8 (plain) against the interpreted Pallas kernels, with a
    nonzero bit offset."""
    b, h, w = shape
    frames, payload, total = _inputs(1234, b, h, w, num_ac, frac, OFFSET)
    s_j, bpf_j = jkron.embed_frames_kron(
        jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
        jnp.float32(DELTA), num_ac, bit_offset=OFFSET)
    s_j = np.asarray(s_j)
    s_t, bpf_t = kk.embed_frames_kron(_t(frames), _t(payload), total, DELTA,
                                      num_ac, OFFSET)
    s_t = s_t.numpy()
    np.testing.assert_array_equal(bpf_t, np.asarray(bpf_j))
    _assert_stego_close(s_t, s_j, frames, num_ac)

    # blocks never entered pass through byte for byte
    nb = (h // 8) * (w // 8)
    never = tfast.build_state_plane(_t(payload), total, h, w, num_ac,
                                    OFFSET).numpy() == 3
    np.testing.assert_array_equal(s_t[never], frames[never])
    assert never.all() == (frac == 0.0)
    assert never.sum() == 64 * max(0, b * nb - -(-(total - OFFSET) // num_ac))

    # slot bits identical outside the envelope, on the cover and the stego
    for x in (frames, s_t):
        bits_t = kk.extract_frames_kron(_t(x), DELTA, num_ac).numpy()
        bits_j = np.asarray(jkron.extract_frames_kron(
            jnp.asarray(x), jnp.float32(DELTA), num_ac))
        assert bits_t.shape == bits_j.shape == (b, nb * num_ac)
        assert not ((bits_t != bits_j) & ~_near_boundary(x, num_ac)).any()
        if x is s_t:  # the payload comes back exactly
            n = total - OFFSET
            np.testing.assert_array_equal(bits_t.reshape(-1)[:n],
                                          payload.reshape(-1)[:n])


def test_kron_round_trip_multi_stripe():
    """tests/test_pallas_kron.py::test_kron_roundtrip_multi_stripe on the
    port: K7 then K8 (plain) against the JAX package's round trip and the
    oracle's extract."""
    n_ac = 10
    frames, payload, total = _inputs(9, 1, 240, 384, n_ac, 0.9)
    s_t, bpf_t, ex_t = kk.embed_and_extract_frames_kron(
        _t(frames), _t(payload), total, DELTA, n_ac)
    s_j, bpf_j, ex_j = jkron.embed_and_extract_frames_kron(
        jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
        jnp.float32(DELTA), n_ac)
    assert int(bpf_t.sum()) == total == int(np.asarray(bpf_j).sum())
    for ex in (ex_t.numpy(), np.asarray(ex_j),
               tqim.extract_frames(s_t, DELTA, n_ac).numpy()):
        np.testing.assert_array_equal(ex.reshape(-1)[:total],
                                      payload.reshape(-1)[:total])
    first_clean_row = 8 * (-(-(-(-total // n_ac)) // (384 // 8)))
    np.testing.assert_array_equal(s_t.numpy()[0, first_clean_row:],
                                  frames[0, first_clean_row:])
    s_p, _, ex_p = kk.embed_and_extract_frames_kron_plain(
        _t(frames), _t(payload), total, DELTA, n_ac)
    assert torch.equal(s_p, s_t) and torch.equal(ex_p, ex_t)


def test_kron_domain():
    """W % 128 != 0 raises ValueError in both packages; delta <= 0 raises
    ValueError in the port's wrappers and plain versions (the JAX kernel
    has no guard there)."""
    frames, payload, total = _inputs(10, 1, 16, 120, 10, 1.0)
    with pytest.raises(ValueError, match="128"):
        jkron.embed_frames_kron(jnp.asarray(frames), jnp.asarray(payload),
                                jnp.int32(total), jnp.float32(DELTA), 10)
    with pytest.raises(ValueError, match="128"):
        jkron.extract_frames_kron(jnp.asarray(frames), jnp.float32(DELTA), 10)
    for fn in (kk.embed_frames_kron, kk.embed_frames_kron_plain):
        with pytest.raises(ValueError, match="128"):
            fn(_t(frames), _t(payload), total, DELTA, 10)
    for fn in (kk.extract_frames_kron, kk.extract_frames_kron_plain):
        with pytest.raises(ValueError, match="128"):
            fn(_t(frames), DELTA, 10)
    frames, payload, total = _inputs(10, 1, 16, 128, 10, 1.0)
    for delta in (0.0, -4.0):
        for fn in (kk.embed_frames_kron, kk.embed_frames_kron_plain):
            with pytest.raises(ValueError, match="delta"):
                fn(_t(frames), _t(payload), total, delta, 10)
        for fn in (kk.extract_frames_kron, kk.extract_frames_kron_plain):
            with pytest.raises(ValueError, match="delta"):
                fn(_t(frames), delta, 10)
    with pytest.raises(ValueError):  # payload of another capacity
        kk.embed_frames_kron(_t(frames), _t(payload[:, :-1]), total, DELTA, 10)

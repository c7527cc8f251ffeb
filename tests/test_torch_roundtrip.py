"""The round-trip variants (K6 fused, two-kernel, K4) and the oracle's
round trip and quality metrics, against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels interpreted (as tests/test_num_ac_sweep.py and
tests/test_pallas_roundtrip.py run them) and its XLA oracle. Inputs are
made with numpy from a seed and handed to both. K6 on the card is held
against its plain version and against K1 and K5 in tests/test_torch_cuda.py.

Tolerances: bits per frame, bit_errors and payload_bits identical; the
payload back exactly; slot bits identical outside the exactness envelope
TOL_ABS + TOL_REL*|y| of a rounding boundary; stego pixels off by more
than 1 only in blocks that hold a slot inside that envelope (lattice
flips); psnr_db within 1e-4 dB (f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stegotpu.ops import pallas_kernel as jpk
from stegotpu.ops import qim as jqim
from stegotpu.ops.dct import blockify as jblockify
from stegotpu.ops.dct import kron_dct_matrix
from stegotpu.ops.exactness import TOL_ABS, TOL_REL
from stegotpu_torch.ops import qim as tqim
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.ops.experimental import kron_kernel as kk

DELTA = 20.0
PSNR_TOL_DB = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


def _near_boundary(frames: np.ndarray, num_ac: int) -> np.ndarray:
    k = kron_dct_matrix(8, np.float64)[1 : 1 + num_ac]
    y = jblockify(frames.astype(np.float64)) @ k.T
    r = y / DELTA
    dist = np.abs(r - np.floor(r) - 0.5) * DELTA
    return (dist <= TOL_ABS + TOL_REL * np.abs(y)).reshape(frames.shape[0], -1)


def _sweep_inputs(seed, n_ac, b=2, h=48, w=128):
    """tests/test_num_ac_sweep.py's inputs: a mid-block stop in the last
    block, covers of luma 32..223."""
    rng = np.random.default_rng(seed)
    cap = (h // 8) * (w // 8) * n_ac
    total = b * cap - (n_ac // 2 + 1)
    payload = np.zeros(b * cap, np.uint8)
    payload[:total] = rng.integers(0, 2, total)
    frames = rng.integers(32, 224, (b, h, w), dtype=np.uint8)
    return frames, payload.reshape(b, cap), total


@pytest.mark.parametrize("n_ac", [1, 7, 8, 9, 15, 16, 63])
def test_fused_plain_matches_jax_across_rn_boundaries(n_ac):
    """K6 (plain) against the interpreted embed_and_extract_frames_pallas_
    fused at every rn boundary, and its identities: stego == K1's, rows ==
    K5's reading of that stego, bits == K4's unpacked."""
    frames, payload, total = _sweep_inputs(1234 + n_ac, n_ac)
    b, h, w = frames.shape
    s_j, bpf_j, ex_j = (np.asarray(a) for a in
                        jpk.embed_and_extract_frames_pallas_fused(
                            jnp.asarray(frames), jnp.asarray(payload),
                            jnp.int32(total), jnp.float32(DELTA), n_ac))
    args = (_t(frames), _t(payload), total, DELTA, n_ac)
    s_t, bpf_t, ex_t = sk.embed_and_extract_frames_fused(*args)
    np.testing.assert_array_equal(bpf_t.numpy(), bpf_j)
    off = np.abs(s_t.numpy().astype(int) - s_j.astype(int)) > 1
    near = _near_boundary(frames, n_ac).reshape(b, -1, n_ac).any(-1)
    assert not (jblockify(off).any(-1) & ~near).any()
    valid = np.arange(payload.size).reshape(payload.shape) < total
    for ex in (ex_t.numpy(), ex_j):
        np.testing.assert_array_equal(ex[valid], payload[valid])
    # every slot of the port's stego, read by K6 and by the JAX extract
    ex_jt = np.asarray(jpk.extract_frames_pallas(
        jnp.asarray(s_t.numpy()), jnp.float32(DELTA), n_ac))
    assert not ((ex_t.numpy() != ex_jt) & ~_near_boundary(s_t.numpy(),
                                                         n_ac)).any()

    s6, bpf6, rows6 = sk.embed_and_extract_frames_rows(*args)
    assert torch.equal(s6, s_t) and torch.equal(bpf6, bpf_t)
    assert torch.equal(s6, sk.embed_frames(*args)[0])
    assert torch.equal(rows6, sk.extract_frames_rows(s6, DELTA, n_ac))
    stripe = sk.pick_stripe(h)
    rp = sk._rows_pad(stripe, sk.rows_per_block(n_ac))
    pad = np.arange(rows6.shape[1]) % rp >= (stripe // 8) * \
        sk.rows_per_block(n_ac)
    assert rows6.shape == (b, (h // stripe) * rp, w)
    assert not rows6[:, pad].any()
    _, _, packed4 = sk.embed_and_extract_frames_packed(*args)
    assert torch.equal(ex_t, sk.packed_rows_to_bits(packed4, h, w, n_ac,
                                                    stripe))


def test_fused_twokernel_and_packed_round_trips_agree():
    """tests/test_pallas_roundtrip.py on the port: the fused (K6),
    two-kernel (K1 + K2) and packed (K4) round trips give the same stego,
    bits per frame and extracted bits, and the payload round-trips; the
    JAX package's three agree with each other and, on the slots, with
    the port."""
    rng = np.random.default_rng(1234)
    n_ac = 10
    frames = rng.integers(0, 256, (2, 48, 128), dtype=np.uint8)
    cap = (48 // 8) * (128 // 8) * n_ac
    total = 2 * cap - 9
    payload = np.zeros((2, cap), np.uint8)
    payload.reshape(-1)[:total] = rng.integers(0, 2, total)
    args = (_t(frames), _t(payload), total, DELTA, n_ac)
    results = [fn(*args) for fn in (sk.embed_and_extract_frames_fused,
                                    sk.embed_and_extract_frames_twokernel,
                                    sk.embed_and_extract_frames,
                                    sk.embed_and_extract_frames_fused_plain)]
    for other in results[1:]:
        for a, b in zip(results[0], other):
            assert torch.equal(a, b)
    stego, bpf, ex = results[0]
    np.testing.assert_array_equal(ex.numpy().reshape(-1)[:total],
                                  payload.reshape(-1)[:total])
    jargs = (jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
             jnp.float32(DELTA), n_ac)
    for fn in (jpk.embed_and_extract_frames_pallas_fused,
               jpk.embed_and_extract_frames_pallas_twokernel):
        _, bpf_j, ex_j = fn(*jargs)
        np.testing.assert_array_equal(bpf.numpy(), np.asarray(bpf_j))
        np.testing.assert_array_equal(np.asarray(ex_j).reshape(-1)[:total],
                                      ex.numpy().reshape(-1)[:total])


def _metric_inputs(seed, b, h, w, n_ac, total_of_cap, lo=32, hi=224):
    rng = np.random.default_rng(seed)
    cap = (h // 8) * (w // 8) * n_ac
    total = total_of_cap(cap)
    frames = rng.integers(lo, hi, (b, h, w), dtype=np.uint8)
    payload = np.zeros((b, cap), np.uint8)
    n = min(total, payload.size)
    payload.reshape(-1)[:n] = rng.integers(0, 2, n)
    return frames, payload, total


def _assert_metrics_equal(m_t, m_j):
    assert int(m_t["bit_errors"]) == int(m_j["bit_errors"])
    assert int(m_t["payload_bits"]) == int(m_j["payload_bits"])
    p_t, p_j = float(m_t["psnr_db"]), float(m_j["psnr_db"])
    assert p_t == p_j or abs(p_t - p_j) <= PSNR_TOL_DB


@pytest.mark.parametrize("case", ["evaluate_step", "valid_slots_only"])
def test_embed_extract_evaluate_matches_jax(case):
    """tests/test_evaluate_step.py's two cases: the port's oracle round
    trip and metrics against stegotpu.ops.qim's."""
    if case == "evaluate_step":
        frames, payload, total = _metric_inputs(2, 2, 48, 64, 10,
                                                lambda cap: 2 * cap - 5)
    else:  # garbage bits past the payload end must not count as errors
        frames, payload, total = _metric_inputs(3, 1, 16, 16, 10,
                                                lambda cap: 7)
        payload.reshape(-1)[:total] = 1
    n_ac = 10
    s_t, bpf_t, ex_t, m_t = tqim.embed_extract_evaluate(
        _t(frames), _t(payload), total, DELTA, n_ac)
    s_j, bpf_j, ex_j, m_j = jqim.embed_extract_evaluate(
        jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
        jnp.float32(DELTA), n_ac)
    _assert_metrics_equal(m_t, m_j)
    assert int(m_t["bit_errors"]) == 0 and int(m_t["payload_bits"]) == total
    assert 25 < float(m_t["psnr_db"]) < 60 or case == "valid_slots_only"
    np.testing.assert_array_equal(bpf_t.numpy(), np.asarray(bpf_j))
    np.testing.assert_array_equal(ex_t.numpy().reshape(-1)[:total],
                                  payload.reshape(-1)[:total])
    s_r, bpf_r, ex_r = tqim.embed_and_extract_frames(
        _t(frames), _t(payload), total, DELTA, n_ac)
    assert torch.equal(s_r, s_t) and torch.equal(bpf_r, bpf_t) \
        and torch.equal(ex_r, ex_t)
    # the metrics of the JAX package's own round trip, computed by the port
    _assert_metrics_equal(
        tqim.roundtrip_metrics(_t(frames), _t(np.asarray(s_j)),
                               _t(np.asarray(ex_j)), _t(payload), total), m_j)


@pytest.mark.parametrize("total_of_cap", [lambda cap: 2 * cap - 13,
                                          lambda cap: cap + 37,
                                          lambda cap: 5 * cap],
                         ids=["mid_block", "one_frame_and_a_bit", "past_end"])
def test_roundtrip_metrics_count_lost_bits_like_jax(total_of_cap):
    """On a near-black cover the embed loses bits to clipping: on the same
    frames, stego, extracted bits and payload the two packages count the
    same bit_errors and payload_bits, and the same PSNR."""
    frames, payload, total = _metric_inputs(4, 2, 48, 128, 10, total_of_cap,
                                            0, 3)
    payload.reshape(-1)[:] = np.random.default_rng(5).integers(
        0, 2, payload.size)  # don't-care bits past the end as well
    stego, _ = tqim.embed_frames(_t(frames), _t(payload), total, DELTA, 10)
    ex = tqim.extract_frames(stego, DELTA, 10)
    m_t = tqim.roundtrip_metrics(_t(frames), stego, ex, _t(payload), total)
    m_j = jqim.roundtrip_metrics(
        jnp.asarray(frames), jnp.asarray(stego.numpy()),
        jnp.asarray(ex.numpy()), jnp.asarray(payload), jnp.int32(total))
    _assert_metrics_equal(m_t, m_j)
    assert int(m_t["bit_errors"]) > 0  # test premise: clipping loses bits
    assert m_t["bit_errors"].dtype == torch.int64


def test_metrics_of_the_kernel_round_trips():
    """roundtrip_metrics reads 0 bit errors on the K6 and kron round trips
    of a mid-range cover (plain versions here), and the PSNR of each is
    the oracle's to within the stego flip budget."""
    frames, payload, total = _metric_inputs(6, 2, 48, 128, 10,
                                            lambda cap: 2 * cap - 3)
    args = (_t(frames), _t(payload), total, DELTA, 10)
    _, _, _, m_o = tqim.embed_extract_evaluate(*args)
    for fn in (sk.embed_and_extract_frames_fused,
               kk.embed_and_extract_frames_kron):
        stego, _, ex = fn(*args)
        m = tqim.roundtrip_metrics(_t(frames), stego, ex, _t(payload), total)
        assert int(m["bit_errors"]) == 0 and int(m["payload_bits"]) == total
        assert abs(float(m["psnr_db"]) - float(m_o["psnr_db"])) < 0.5

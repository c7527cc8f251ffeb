"""The port's QIM implementations against the independent scalar scipy oracle
of the reference semantics (tests/reference_model.py).

The cases of tests/test_kernel_golden.py, run on both of the port's CPU
implementations: the Kronecker-matmul oracle (ops/qim.py, kernel='xla')
and the stripe kernel's plain version (ops/stripe_kernel.py, what
kernel='auto' runs on a CPU tensor). scipy's FFT DCT and a float32 matmul
are not float-identical, so the assertions are behavioural: bits at
lattice points are equal, stego pixels match within 1 LSB, and every
embed -> extract loop is BER 0 in the robust envelope.
"""

import numpy as np
import pytest
import torch

from stegotpu_torch.bitstream import bits_to_string, pad_bits, string_to_bits
from stegotpu_torch.ops import qim, stripe_kernel
from stegotpu_torch.ops.dct import blockify
from tests.reference_model import embed_frame_oracle, extract_frame_oracle

DELTA = 20
N_AC = 10

IMPLS = {
    "oracle": (qim.embed_frames, qim.extract_frames),
    "stripe_plain": (stripe_kernel.embed_frames, stripe_kernel.extract_frames),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _embed(impl, frames_u8, payload_str, delta=DELTA, n_ac=N_AC):
    b, h, w = frames_u8.shape
    cap = (h // 8) * (w // 8) * n_ac
    bits = pad_bits(string_to_bits(payload_str), b * cap).reshape(b, cap)
    stego, bpf = impl[0](torch.from_numpy(frames_u8), torch.from_numpy(bits),
                         len(payload_str), delta, n_ac)
    return stego.numpy(), bpf.numpy()


def _extract(impl, frames_u8, delta=DELTA, n_ac=N_AC):
    return impl[1](torch.from_numpy(np.ascontiguousarray(frames_u8)), delta,
                   n_ac).numpy()


def test_embed_full_frame_matches_oracle(impl):
    rng = np.random.default_rng(101)
    frame = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    cap = (24 // 8) * (32 // 8) * N_AC
    payload = "".join(rng.integers(0, 2, cap).astype(str))
    oracle_stego, oracle_n = embed_frame_oracle(frame, payload, DELTA, N_AC)
    stego, bpf = _embed(impl, frame[None], payload)
    assert bpf[0] == oracle_n == cap
    # float32 FFT-vs-matmul divergence across the truncating u8 cast: <=1 LSB
    diff = np.abs(stego[0].astype(int) - oracle_stego.astype(int))
    assert diff.max() <= 1


def test_embed_partial_payload_stops_midblock(impl):
    rng = np.random.default_rng(102)
    frame = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    payload_len = 3 * N_AC + 4  # 3 full blocks + 4 bits into block 4
    payload = "".join(rng.integers(0, 2, payload_len).astype(str))
    oracle_stego, oracle_n = embed_frame_oracle(frame, payload, DELTA, N_AC)
    stego, bpf = _embed(impl, frame[None], payload)
    assert bpf[0] == oracle_n == payload_len
    assert np.abs(stego[0].astype(int) - oracle_stego.astype(int)).max() <= 1
    np.testing.assert_array_equal(stego[0][8:, :], frame[8:, :])
    touched = blockify(torch.from_numpy(stego[0][:8, :])).numpy()
    orig = blockify(torch.from_numpy(frame[:8, :])).numpy()
    assert not np.array_equal(touched[:4], orig[:4])
    np.testing.assert_array_equal(touched[4:], orig[4:])


def test_extract_matches_oracle_on_stego(impl):
    rng = np.random.default_rng(103)
    frame = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    cap = (24 // 8) * (32 // 8) * N_AC
    payload = "".join(rng.integers(0, 2, cap).astype(str))
    stego, _ = _embed(impl, frame[None], payload)
    assert bits_to_string(_extract(impl, stego)[0]) == \
        extract_frame_oracle(stego[0], DELTA, N_AC)


def test_roundtrip_against_oracle_cross(impl):
    """Oracle embeds -> port extracts, and port embeds -> oracle extracts."""
    rng = np.random.default_rng(104)
    frame = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    payload = "".join(rng.integers(0, 2, 4 * N_AC).astype(str))
    oracle_stego, _ = embed_frame_oracle(frame, payload, DELTA, N_AC)
    assert bits_to_string(_extract(impl, oracle_stego[None])[0]) == payload
    stego, _ = _embed(impl, frame[None], payload)
    assert extract_frame_oracle(stego[0], DELTA, N_AC) == payload


# the robust envelope of tests/test_kernel_golden.py (n_ac=63 is not robust
# for this algorithm at any delta: clipping loses bits in the oracle too)
@pytest.mark.parametrize(
    "n_ac,delta",
    [(1, 8), (1, 20), (3, 12), (3, 20), (10, 12), (10, 20), (10, 100), (30, 20)],
)
def test_param_sweep_ber_zero(impl, n_ac, delta):
    rng = np.random.default_rng(105 + n_ac + delta)
    frames = rng.integers(0, 256, (2, 16, 16), dtype=np.uint8)
    cap = 4 * n_ac
    payload = rng.integers(0, 2, 2 * cap).astype(np.uint8)
    stego, bpf = impl[0](torch.from_numpy(frames),
                         torch.from_numpy(payload.reshape(2, cap)), 2 * cap,
                         delta, n_ac)
    assert bpf.tolist() == [cap, cap]
    np.testing.assert_array_equal(
        impl[1](stego, delta, n_ac).numpy().reshape(-1), payload)


def test_negative_coefficient_parity(impl):
    """Directional moves on negative quantizer indices round-trip
    (floor-mod parity: torch.remainder, not torch.fmod)."""
    frame = np.tile(np.linspace(180, 60, 8, dtype=np.uint8), (8, 1))
    payload = "1" * N_AC
    stego, _ = _embed(impl, frame[None], payload)
    assert bits_to_string(_extract(impl, stego)[0][:N_AC]) == payload


def test_clipping_data_loss_matches_oracle(impl):
    """Saturated frames clip the inverse DCT and lose embedded bits, in the
    reference algorithm too: the port must fail the same way."""
    frame = np.zeros((8, 8), np.uint8)
    frame[:, :4] = 255
    payload = "1" * N_AC
    stego, _ = _embed(impl, frame[None], payload)
    oracle_stego, _ = embed_frame_oracle(frame, payload, DELTA, N_AC)
    assert bits_to_string(_extract(impl, stego)[0][:N_AC]) == \
        extract_frame_oracle(oracle_stego, DELTA, N_AC)[:N_AC]


def test_nonlane_width_matches_oracle(impl):
    """A width that is no multiple of 128 (80): bits agree with the scalar
    oracle in both directions, block numbering by the real width."""
    rng = np.random.default_rng(106)
    frame = rng.integers(0, 256, (24, 80), dtype=np.uint8)
    cap = (24 // 8) * (80 // 8) * N_AC
    payload = "".join(rng.integers(0, 2, cap).astype(str))
    oracle_stego, _ = embed_frame_oracle(frame, payload, DELTA, N_AC)
    assert bits_to_string(_extract(impl, oracle_stego[None])[0]) == payload
    stego, bpf = _embed(impl, frame[None], payload)
    assert int(bpf[0]) == cap
    assert extract_frame_oracle(stego[0], DELTA, N_AC) == payload

"""The port's device mesh (stegotpu_torch.parallel.mesh) on the CPU, case
for case against tests/test_sharding.py.

The JAX side runs stegotpu.parallel.mesh on the 8 virtual CPU devices that
tests/conftest.py provides; the port's side runs meshes that repeat the
CPU device, with the f32 oracle ('xla') and the stripe kernels' plain
versions ('pallas'). Within the port, sharded and unsharded calls agree
byte for byte (stego, bits per frame, bits, error count); against the JAX
package the bits per frame and error counts are identical, stego pixels
agree within the exactness policy (stegotpu/ops/exactness.py: under 1% off
by more than 1), and bits agree outside its envelope of a rounding
boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stegotpu.ops.exactness import TOL_ABS, TOL_REL
from stegotpu.parallel import mesh as jmesh
from stegotpu_torch.ops import qim as tqim
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.parallel.mesh import (make_mesh, sharded_embed_frames,
                                          sharded_extract_frames,
                                          sharded_roundtrip_step)

DELTA = 20
N_AC = 10
CPU8 = [torch.device("cpu")] * 8
GRIDS = [(8, 1), (4, 2), (2, 4), (1, 8)]
UNSHARDED = {"xla": (tqim.embed_frames, tqim.extract_frames),
             "pallas": (sk.embed_frames, sk.extract_frames)}
FLIP_BUDGET = 0.01  # tests/test_pallas_kernel.py:22-32


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual CPU devices"
    return devs


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _mk_inputs(rng, b=8, h=64, w=64, fill_fraction=0.8):
    # h=64 -> 8 block-rows, divisible by every 'space' size used below
    frames = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    cap = (h // 8) * (w // 8) * N_AC
    total = int(b * cap * fill_fraction)
    payload = np.zeros(b * cap, np.uint8)
    payload[:total] = rng.integers(0, 2, total)
    return frames, payload.reshape(b, cap), total, cap


def _near_boundary(frames: np.ndarray) -> np.ndarray:
    """(B, C): the float64 slot coefficient lies within the exactness
    envelope of a rounding boundary (only there may two f32 versions
    read a different bit)."""
    from stegotpu.ops.dct import blockify, kron_dct_matrix

    k = kron_dct_matrix(8, np.float64)[1 : 1 + N_AC]
    y = blockify(frames.astype(np.float64)) @ k.T
    r = y / DELTA
    dist = np.abs(r - np.floor(r) - 0.5) * DELTA
    return (dist <= TOL_ABS + TOL_REL * np.abs(y)).reshape(frames.shape[0], -1)


def _jax_step(devices, n_data, n_space, frames, payload, total,
              kernel="xla"):
    step = jmesh.sharded_roundtrip_step(
        jmesh.make_mesh(n_data, n_space, devices), N_AC, kernel=kernel)
    return [np.asarray(x) for x in step(
        jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
        jnp.float32(DELTA))]


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("n_data,n_space", GRIDS)
def test_sharded_embed_matches_single_device(rng, devices, n_data, n_space,
                                             kernel):
    frames, payload, total, cap = _mk_inputs(rng)
    embed, extract = UNSHARDED[kernel]
    stego_sh, bpf_sh = sharded_embed_frames(
        make_mesh(n_data, n_space, CPU8), N_AC, kernel=kernel)(
        _t(frames), _t(payload), total, DELTA)
    stego_1, bpf_1 = embed(_t(frames), _t(payload), total, DELTA, N_AC)
    assert torch.equal(stego_sh, stego_1) and torch.equal(bpf_sh, bpf_1)

    j_embed = jmesh.sharded_embed_frames(
        jmesh.make_mesh(n_data, n_space, devices), N_AC)
    j_stego, j_bpf = (np.asarray(x) for x in j_embed(
        jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
        jnp.float32(DELTA)))
    np.testing.assert_array_equal(bpf_sh.numpy(), j_bpf)
    diff = np.abs(stego_sh.numpy().astype(int) - j_stego.astype(int))
    assert (diff > 1).mean() < FLIP_BUDGET
    extracted = extract(stego_sh, DELTA, N_AC).numpy().reshape(-1)[:total]
    np.testing.assert_array_equal(extracted, payload.reshape(-1)[:total])


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("n_data,n_space", [(4, 2), (2, 4)])
def test_sharded_extract_matches_single_device(rng, devices, n_data, n_space,
                                               kernel):
    frames, payload, total, cap = _mk_inputs(rng)
    embed, extract = UNSHARDED[kernel]
    stego, _ = embed(_t(frames), _t(payload), total, DELTA, N_AC)
    bits_sh = sharded_extract_frames(make_mesh(n_data, n_space, CPU8), N_AC,
                                     kernel=kernel)(stego, DELTA)
    assert torch.equal(bits_sh, extract(stego, DELTA, N_AC))

    j_extract = jmesh.sharded_extract_frames(
        jmesh.make_mesh(n_data, n_space, devices), N_AC)
    j_bits = np.asarray(j_extract(jnp.asarray(stego.numpy()),
                                  jnp.float32(DELTA)))
    near = _near_boundary(stego.numpy())
    assert not ((bits_sh.numpy() != j_bits) & ~near).any()


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_sharded_roundtrip_step_ber_zero(rng, devices, kernel):
    frames, payload, total, cap = _mk_inputs(rng)
    stego, bpf, extracted, errors = sharded_roundtrip_step(
        make_mesh(4, 2, CPU8), N_AC, kernel=kernel)(
        _t(frames), _t(payload), total, DELTA)
    assert int(errors) == 0
    assert int(bpf.sum()) == total
    ex = extracted.numpy().reshape(-1)[:total]
    np.testing.assert_array_equal(ex, payload.reshape(-1)[:total])
    _, j_bpf, _, j_errors = _jax_step(devices, 4, 2, frames, payload, total)
    assert int(j_errors) == int(errors)
    np.testing.assert_array_equal(bpf.numpy(), j_bpf)


def test_sharded_roundtrip_with_pallas_kernel(rng, devices):
    """The per-shard stripe kernel ('pallas') against the per-shard oracle
    ('xla') in the port, and against the JAX package's 'xla' step: the
    same bits per frame and extracted bits, no error, stego within the
    flip budget."""
    b, h, w = 8, 96, 128  # h_l=48 per space-shard -> stripe 48; w=128 ok
    frames = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    cap = (h // 8) * (w // 8) * N_AC
    total = b * cap - 11
    payload = np.zeros(b * cap, np.uint8)
    payload[:total] = rng.integers(0, 2, total)
    payload = payload.reshape(b, cap)
    mesh = make_mesh(4, 2, CPU8)
    args = (_t(frames), _t(payload), total, DELTA)
    sx, bx, ex, errx = sharded_roundtrip_step(mesh, N_AC, kernel="xla")(*args)
    sp, bp, ep, errp = sharded_roundtrip_step(mesh, N_AC,
                                              kernel="pallas")(*args)
    assert int(errx) == 0 and int(errp) == 0
    assert torch.equal(bx, bp) and torch.equal(ex, ep)
    diff = (sx.to(torch.int32) - sp.to(torch.int32)).abs()
    assert (diff > 1).double().mean().item() < FLIP_BUDGET
    js, jb, je, jerr = _jax_step(devices, 4, 2, frames, payload, total)
    assert int(jerr) == 0
    np.testing.assert_array_equal(bp.numpy(), jb)
    np.testing.assert_array_equal(ep.numpy(), je)
    assert (np.abs(sp.numpy().astype(int) - js.astype(int)) > 1).mean() \
        < FLIP_BUDGET


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_partial_payload_stripe_boundaries(rng, devices, kernel):
    """Payload ending inside a middle stripe of a middle frame: the offset
    arithmetic across (data, space) shards must place the boundary exactly."""
    frames, payload, _, cap = _mk_inputs(rng, fill_fraction=1.0)
    # end 13 bits into frame 3's second stripe (of 2): stripe cap = cap//2
    total = 3 * cap + cap // 2 + 13
    payload = payload.reshape(-1).copy()
    payload[total:] = 0
    payload = payload.reshape(8, cap)
    stego, bpf, extracted, errors = sharded_roundtrip_step(
        make_mesh(4, 2, CPU8), N_AC, kernel=kernel)(
        _t(frames), _t(payload), total, DELTA)
    assert int(errors) == 0
    bpf = bpf.numpy()
    assert bpf[3] == cap // 2 + 13
    assert bpf[4] == 0 and bpf[2] == cap
    # frames past the payload must be bit-identical passthrough
    np.testing.assert_array_equal(stego.numpy()[4:], frames[4:])
    _, j_bpf, _, j_errors = _jax_step(devices, 4, 2, frames, payload, total)
    np.testing.assert_array_equal(bpf, j_bpf)
    assert int(j_errors) == 0


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("n_data,n_space", GRIDS)
def test_sharded_error_count_on_a_saturated_cover(rng, devices, n_data,
                                                  n_space, kernel):
    """On a cover with black and white bands, clipping loses bits: the
    step's error count is non-zero, equals the unsharded count
    (stripe_kernel.count_wrong_bits of the unsharded embed's bits) and the
    JAX package's step's, and the unsharded stego, bits per frame and
    extracted bits are the step's byte for byte."""
    frames, payload, total, cap = _mk_inputs(rng, fill_fraction=0.9)
    frames[:, :16] = 0
    frames[:, -16:] = 255
    embed, extract = UNSHARDED[kernel]
    stego, bpf, extracted, errors = sharded_roundtrip_step(
        make_mesh(n_data, n_space, CPU8), N_AC, kernel=kernel)(
        _t(frames), _t(payload), total, DELTA)
    stego_1, bpf_1 = embed(_t(frames), _t(payload), total, DELTA, N_AC)
    bits_1 = extract(stego_1, DELTA, N_AC)
    assert torch.equal(stego, stego_1) and torch.equal(bpf, bpf_1)
    assert torch.equal(extracted, bits_1)
    want = int(sk.count_wrong_bits(bits_1, _t(payload), total).sum())
    assert int(errors) == want > 0
    _, j_bpf, _, j_errors = _jax_step(devices, n_data, n_space, frames,
                                      payload, total)
    np.testing.assert_array_equal(bpf.numpy(), j_bpf)
    assert int(j_errors) == int(errors)


def test_mesh_shards_are_contiguous_buffers():
    """Each shard is its own contiguous tensor (the CUDA wrappers refuse a
    strided block-row view), and gather inverts shard."""
    mesh = make_mesh(2, 3, [torch.device("cpu")] * 6)
    x = torch.arange(4 * 48 * 16, dtype=torch.int32).reshape(4, 48, 16)
    shards = mesh.shard(x, ("data", "space", None))
    assert sorted(shards) == [(d, s) for d in range(2) for s in range(3)]
    assert all(v.is_contiguous() and v.shape == (2, 16, 16)
               for v in shards.values())
    assert torch.equal(shards[1, 2], x[2:, 32:])
    assert torch.equal(mesh.gather(shards, ("data", "space", None)), x)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard(x[:3], ("data", "space", None))

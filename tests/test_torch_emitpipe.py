"""K13 (stegotpu_torch.studies.emitpipe_r4) against the JAX package.

K13's function is K4's: the CUDA kernel runs K4's block code through a ring
of shared-memory tiles (tests/test_torch_cuda.py holds it to K4 byte for
byte on the card). On the CPU its wrapper runs its plain version, K4's,
which is held here to two JAX kernels, interpreted, on the same seeded
inputs: the JAX K4 (``_rows_roundtrip_pallas_packed``, its rows built by
``payload_to_rows``) and the script's own ``outer``/``inner``
(benchmarks/emitpipe_r4.py). ``pltpu.emit_pipeline`` has no CPU path
(the script's ``build`` raises ``ValueError: Unsupported TPU device kind:
cpu`` there), so a stand-in walks its grid in Python and hands ``inner``
each step's block views; the outer ``pallas_call`` runs interpreted.

Tolerances, each with its reason:

- ENVELOPE (TOL_ABS + TOL_REL*|y|, the JAX package's exactness envelope):
  two f32 implementations may decode a QIM bit differently only where its
  coefficient y lies that close to a rounding boundary of round(y/delta),
  and each side's bits read its own stego, so bits are compared on the
  blocks where both stegos agree;
- FLIP_BUDGET: stego pixels off by more than 1 between two f32 embeds, where
  a coefficient at a rounding boundary snapped to the other lattice point
  (tests/test_pallas_kernel.py:22-32).
"""

import ast
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stegotpu.ops import dct as jdct
from stegotpu.ops import pallas_kernel as jpk
from stegotpu.ops.exactness import TOL_ABS, TOL_REL
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.studies import bounds, emitpipe_r4

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "benchmarks" / "emitpipe_r4.py"
DELTA = 20.0
FLIP_BUDGET = 0.01
SHAPES = [(2, 240, 256), (2, 144, 128)]  # stripes 120 and 72, two groups


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _script():
    spec = importlib.util.spec_from_file_location("_jax_emitpipe_r4", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # defines build and main, runs nothing
    return mod


def _emit_pipeline_standin(inner, grid, in_specs, out_specs):
    """pltpu.emit_pipeline walked in Python: step s hands `inner` the block
    of each operand that its BlockSpec's index map names (no buffering)."""
    specs = [*in_specs, *out_specs]

    def run(*refs):
        for s in range(grid[0]):
            inner(*(ref.at[tuple(pl.ds(i * n, n) for i, n in
                                 zip(spec.index_map(s), spec.block_shape))]
                    for ref, spec in zip(refs, specs)))
    return run


def _inputs(seed: int, b: int, h: int, w: int, num_ac: int):
    rng = np.random.default_rng(seed)
    frames = rng.integers(16, 240, (b, h, w), dtype=np.uint8)
    cap = (h // 8) * (w // 8) * num_ac
    payload = rng.integers(0, 2, (b, cap), dtype=np.uint8)
    return frames, payload, b * cap - 13  # ends mid-block in the last frame


def _near_boundary(frames: np.ndarray, num_ac: int) -> np.ndarray:
    k = jdct.kron_dct_matrix(8, np.float64)[1 : 1 + num_ac]
    y = jdct.blockify(frames.astype(np.float64)) @ k.T
    r = y / DELTA
    return np.abs(r - np.floor(r) - 0.5) * DELTA <= TOL_ABS + TOL_REL * np.abs(y)


def _assert_like(stego, bits, s_j, bits_j, frames, payload, total, num_ac):
    """stego within the flip budget; bits equal outside the envelope where
    both stegos agree on the block; the valid payload back exactly."""
    b = frames.shape[0]
    off = np.abs(stego.astype(int) - s_j.astype(int)) > 1
    assert off.mean() < FLIP_BUDGET, off.mean()
    same_block = (jdct.blockify(stego) == jdct.blockify(s_j)).all(-1)
    near = _near_boundary(stego, num_ac)
    diff = (bits != bits_j).reshape(b, -1, num_ac)
    assert not (diff & same_block[..., None] & ~near).any()
    valid = np.arange(payload.size).reshape(payload.shape) < total
    np.testing.assert_array_equal(bits[valid], payload[valid])
    np.testing.assert_array_equal(bits_j[valid], payload[valid])


@pytest.mark.parametrize("num_ac", [1, 10, 30])
@pytest.mark.parametrize("b,h,w", SHAPES)
def test_plain_k13_against_jax_k4_and_the_script(b, h, w, num_ac,
                                                 monkeypatch):
    frames, payload, total = _inputs(num_ac, b, h, w, num_ac)
    cap = payload.shape[1]
    stripe = sk.pick_stripe(h)
    args = (_t(frames), _t(payload), total, DELTA, num_ac)
    stego_t, bpf_t, packed_t = emitpipe_r4.roundtrip_pipelined_packed(
        *args, bufs=3)
    for got, want in zip((stego_t, bpf_t, packed_t),
                         sk.embed_and_extract_frames_packed_plain(*args)):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(
        bpf_t.numpy(), np.clip(total - np.arange(b) * cap, 0, cap))
    stego = stego_t.numpy()
    bits = sk.packed_rows_to_bits(packed_t, h, w, num_ac, stripe).numpy()

    # the JAX K4, interpreted, on rows built by payload_to_rows
    rows = jpk.payload_to_rows(jnp.asarray(payload), h, w, num_ac, stripe)
    s_j, p_j = jpk._rows_roundtrip_pallas_packed(
        jnp.asarray(frames), rows, jnp.int32(total), jnp.float32(DELTA),
        num_ac, True)
    bits_j = np.asarray(jpk.packed_rows_to_bits(p_j, h, w, num_ac, stripe))
    _assert_like(stego, bits, np.asarray(s_j), bits_j, frames, payload, total,
                 num_ac)

    # the script's own kernel at this shape: its pallas_call interpreted,
    # its emit_pipeline walked by the stand-in
    ep = _script()
    for name, value in (("H", h), ("W", w), ("N_AC", num_ac),
                        ("STRIPE", stripe)):
        monkeypatch.setattr(ep, name, value)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(pltpu, "emit_pipeline", _emit_pipeline_standin)
    run, rp, cap_s = ep.build(b, bufs=2)
    assert (rp, cap_s) == (sk._rows_pad(stripe, sk.rows_per_block(num_ac)),
                           cap)
    s_s, p_s = run(jnp.asarray(frames), rows, jnp.float32(DELTA).reshape(1),
                   jnp.asarray([total, 0], jnp.int32))
    p_s = np.asarray(p_s)
    assert p_s.shape == (b, (h // stripe) * rp, 256)
    assert not p_s[..., w // 8:].any()  # the dead lanes of Mosaic's padding
    bits_s = np.asarray(jpk.packed_rows_to_bits(
        jnp.asarray(p_s[..., : w // 8]), h, w, num_ac, stripe))
    _assert_like(stego, bits, np.asarray(s_s), bits_s, frames, payload, total,
                 num_ac)


def _valid_mask_rule(h: int, w: int, num_ac: int, stripe: int):
    """The script's valid_mask (nested in build, :62-69), compiled alone
    with build's constants at this shape."""
    build = next(n for n in ast.parse(SCRIPT.read_text()).body
                 if isinstance(n, ast.FunctionDef) and n.name == "build")
    fn = next(n for n in build.body
              if isinstance(n, ast.FunctionDef) and n.name == "valid_mask")
    rn = jpk.rows_per_block(num_ac)
    ns = {"jax": jax, "jnp": jnp, "BLOCK": 8, "W": w, "N_AC": num_ac,
          "rn": rn, "rp": jpk._rows_pad(stripe, rn), "bw": w // 8,
          "bh_s": stripe // 8, "cap": (h // 8) * (w // 8) * num_ac}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(SCRIPT), "exec"),
         ns)
    return ns["valid_mask"]


@pytest.mark.parametrize("num_ac", [1, 10, 30])
def test_script_valid_mask_is_k4s_rem_rule(num_ac):
    """For every frame and stripe group, the script's mask over its rows
    (rp, W) marks exactly the wire-order slots stripe_kernel.slot_valid
    (K4's rem rule, no bit offset) marks, and no coefficient outside slots
    1..num_ac."""
    b, h, w, stripe = 3, 144, 128, 72
    rn = jpk.rows_per_block(num_ac)
    bh_s, bw = stripe // 8, w // 8
    nb = (h // 8) * bw
    cap = nb * num_ac
    valid_mask = _valid_mask_rule(h, w, num_ac, stripe)
    for total in (b * cap, cap + 5 * num_ac + 3, 1, 0, 2 * cap - 1):
        want = sk.slot_valid(b, nb, num_ac, total, 0, "cpu").numpy()
        got = np.zeros_like(want)
        for f in range(b):
            for jg in range(h // stripe):
                m = np.asarray(valid_mask(total, f, jg))[: bh_s * rn]
                coef = m.reshape(bh_s, rn, bw, 8).transpose(0, 2, 1, 3)
                coef = coef.reshape(bh_s, bw, rn * 8)
                assert not coef[..., 0].any() and not coef[..., 1 + num_ac:].any()
                got[f, jg * bh_s * bw:(jg + 1) * bh_s * bw] = coef[
                    ..., 1 : 1 + num_ac].reshape(-1, num_ac)
        np.testing.assert_array_equal(got, want, err_msg=f"total={total}")


def test_k13_does_k4s_work():
    """bounds.work gives each ring depth K4's bytes and operations: at
    1080p, B=8, 36.32 MB, bound 0.01084 ms by bytes."""
    args = (8, 1080, 1920, 10, 120)
    k4 = bounds.work("roundtrip_packed", *args)
    for bufs in emitpipe_r4.BUFS:
        assert bounds.work(f"roundtrip_pipe_buf{bufs}", *args) == k4
    ms, by = bounds.bound_ms(*k4)
    assert by == "bytes" and round(k4[0] / 1e6, 2) == 36.32
    assert ms == pytest.approx(0.01084, abs=5e-6)


def test_ring_depth_is_2_3_or_4():
    frames, payload, total = _inputs(7, 1, 48, 64, 10)
    args = (_t(frames), _t(payload), total, DELTA, 10)
    for fn in (emitpipe_r4.roundtrip_pipelined_packed,
               emitpipe_r4.roundtrip_pipelined_packed_plain):
        for bufs in (1, 5):
            with pytest.raises(ValueError, match="2, 3 or 4"):
                fn(*args, bufs=bufs)
    keys = [f"stegotpu_qim_roundtrip_pipe:buf{n}" for n in emitpipe_r4.BUFS]
    before = [sk.LAUNCHES[k] for k in keys]
    for bufs in emitpipe_r4.BUFS:  # the plain version launches nothing
        emitpipe_r4.roundtrip_pipelined_packed(*args, bufs=bufs)
    assert [sk.LAUNCHES[k] for k in keys] == before


def test_main_exits_nonzero_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert emitpipe_r4.main(["--batch", "2", "--iters", "1", "--bufs", "3"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_main_rows_with_the_timing_stubbed(monkeypatch, capsys):
    """main at a small shape on the CPU, the card check and the timing
    stubbed so the plain version runs: the check row counts no error on
    the uniform cover beyond the BER bound, then the variant row."""
    import json

    from stegotpu_torch.studies import harness

    monkeypatch.setattr(harness, "require_cuda",
                        lambda prog: torch.device("cpu"))
    monkeypatch.setattr(harness, "queued_ms",
                        lambda fn, runs=10, warmup=2: (fn(), 2.0)[1])
    monkeypatch.setattr(harness, "header",
                        lambda study, dev, args: harness.emit({"study": study}))
    assert emitpipe_r4.main(["--batch", "2", "--iters", "1", "--bufs", "4",
                             "--height", "144", "--width", "128"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rows[0] == {"study": "emitpipe_r4"}
    check, variant = rows[1], rows[2]
    assert check["check"] == "roundtrip_errors_vs_xla_extract"
    assert check["ok"] and check["total"] == 2 * 18 * 16 * 10
    assert check["errors"] <= emitpipe_r4.BER_BOUND * check["total"]
    assert variant["variant"] == "emitpipe_buf4" and variant["stripe"] == 72
    assert variant["ms_per_128"] == pytest.approx(2.0 * 64)

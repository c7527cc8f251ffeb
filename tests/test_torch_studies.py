"""The A/B study kernels K9-K12 (stegotpu_torch.studies) against the JAX
package's study scripts.

On the CPU the study wrappers run their plain PyTorch versions; the JAX
side runs the scripts' Pallas kernels interpreted, as the JAX package's own
tests run Pallas on the CPU. Inputs are made with numpy from a seed and
handed to both. benchmarks/extract_ablation.py times B=128 at 1080p when it
is imported, so its ``def``s alone are loaded (ast) and run at a small
shape, with ``pl.pallas_call`` wrapped to interpret. The CUDA kernels
themselves are compared with their plain versions in
tests/test_torch_cuda.py, which skips without a card.

Tolerances, each with its reason:

- ENVELOPE (TOL_ABS + TOL_REL*|y|, the JAX package's exactness envelope):
  two f32 implementations may decode a QIM bit differently only where its
  coefficient y lies that close to a rounding boundary of round(y/delta);
- FLIP_BUDGET: stego pixels off by more than 1 between two f32 embeds, where
  a coefficient at a rounding boundary snapped to the other lattice point
  (tests/test_pallas_kernel.py:22-32);
- no_qim: the truncating u8 cast of a coefficient may differ by 1 (mod
  256) between two f32 sums only where the coefficient lies within the
  envelope of an integer, where truncation toward zero steps.
"""

import ast
import functools
import importlib.util
import re
import types
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
from stegotpu_torch.studies import (ab_packed_payload, device_roofline,
                                    dualchain_r5, extract_ablation,
                                    roofline_r4, stripe_cap)

REPO = Path(__file__).resolve().parents[1]
DELTA = 20.0
NUM_AC = 10
FLIP_BUDGET = 0.01


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _load(relpath: str, name: str):
    """Import a study script of the JAX package by path (benchmarks/ is not
    a package); its imports put the repo root on sys.path themselves."""
    spec = importlib.util.spec_from_file_location(name, REPO / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _jax_ab():
    return _load("benchmarks/ab_packed_payload.py", "_jax_ab_packed_payload")


@functools.lru_cache(maxsize=None)
def _jax_dual():
    return _load("benchmarks/dualchain_r5.py", "_jax_dualchain_r5")


def _ablation_defs(b: int, h: int, w: int, num_ac: int, delta: float) -> dict:
    """The function definitions of benchmarks/extract_ablation.py, run in a
    namespace with the script's module constants at (b, h, w) and its
    pallas_call interpreted. Nothing else of the script runs."""
    path = REPO / "benchmarks" / "extract_ablation.py"
    tree = ast.parse(path.read_text())
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    stripe = jpk.pick_stripe(h)
    rn = jpk.rows_per_block(num_ac)
    interp = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    ns = {"functools": functools, "jax": jax, "jnp": jnp, "np": np,
          "pl": interp, "pltpu": pltpu, "pk": jpk, "B": b, "H": h, "W": w,
          "N_AC": num_ac, "STRIPE": stripe, "RN": rn,
          "RP": jpk._rows_pad(stripe, rn), "dlt": jnp.float32(delta)}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(path), "exec"), ns)
    return ns


def _rows_to_lanes(rows: np.ndarray, h: int, w: int, num_ac: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """K5's layout (B, (H/stripe)*rp, W) -> ((B, nb, rn, 8) lanes per block,
    the padding rows), in numpy, independently of the port."""
    b = rows.shape[0]
    stripe = jpk.pick_stripe(h)
    rn = jpk.rows_per_block(num_ac)
    rp = jpk._rows_pad(stripe, rn)
    bh_s, bw = stripe // 8, w // 8
    r = rows.reshape(b, h // stripe, rp, w)
    lanes = r[:, :, : bh_s * rn].reshape(b, h // stripe, bh_s, rn, bw, 8)
    lanes = lanes.transpose(0, 1, 2, 4, 3, 5).reshape(b, -1, rn, 8)
    return lanes, r[:, :, bh_s * rn:]


def _envelope(y: np.ndarray) -> np.ndarray:
    return TOL_ABS + TOL_REL * np.abs(y)


def _near_rounding(y: np.ndarray, delta: float) -> np.ndarray:
    """Is the float64 coefficient y within the envelope of a rounding
    boundary of round(y / delta)?"""
    r = y / delta
    return np.abs(r - np.floor(r) - 0.5) * delta <= _envelope(y)


def _near_boundary(frames: np.ndarray, delta: float, num_ac: int
                   ) -> np.ndarray:
    """Per wire-order slot bit, _near_rounding of its float64 coefficient."""
    k = jdct.kron_dct_matrix(8, np.float64)[1 : 1 + num_ac]
    y = jdct.blockify(frames.astype(np.float64)) @ k.T
    return _near_rounding(y, delta).reshape(frames.shape[0], -1)


def _assert_stego_close(a: np.ndarray, b: np.ndarray) -> None:
    off = np.abs(a.astype(int) - b.astype(int)) > 1
    assert off.mean() < FLIP_BUDGET, off.mean()


def _frames(seed: int, b: int, h: int, w: int, lo: int = 0, hi: int = 256):
    return np.random.default_rng(seed).integers(lo, hi, (b, h, w),
                                                dtype=np.uint8)


def _payload(seed: int, b: int, h: int, w: int, num_ac: int = NUM_AC):
    cap = (h // 8) * (w // 8) * num_ac
    return np.random.default_rng(seed + 1).integers(0, 2, (b, cap),
                                                    dtype=np.uint8)


# --- K9: extract_ablation ------------------------------------------------------

ABL_SHAPES = [(4, 144, 128), (4, 240, 256)]  # stripes 72 and 120, 2 groups


@pytest.mark.parametrize("b,h,w", ABL_SHAPES)
@pytest.mark.parametrize("variant", ["io_only", "io_f4"])
def test_ablation_io_equals_the_script(b, h, w, variant):
    frames = _frames(3, b, h, w)
    ns = _ablation_defs(b, h, w, NUM_AC, DELTA)
    run = ns["build_f4"]() if variant == "io_f4" else ns["build"](
        ns["kern_io_only"])
    want = np.asarray(run(jnp.asarray(frames)))
    got = extract_ablation.ablate(_t(frames), DELTA, NUM_AC, variant)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,h,w", ABL_SHAPES)
def test_ablation_full_is_k5(b, h, w):
    """full is the port's K5 (plain) byte for byte; against the JAX wire K5
    it agrees on the slot lanes up to the envelope; against the script's
    kern_full (single-pass bf16) only the layout and the zero padding rows
    are held, since that kernel computes other coefficients."""
    frames = _frames(4, b, h, w)
    got = extract_ablation.ablate(_t(frames), DELTA, NUM_AC, "full").numpy()
    np.testing.assert_array_equal(
        got, sk.extract_frames_rows_plain(_t(frames), DELTA, NUM_AC).numpy())
    wire = np.asarray(jpk._extract_frames_pallas_rows(
        jnp.asarray(frames), DELTA, NUM_AC, True, False))
    stripe = sk.pick_stripe(h)
    bits_t = sk.rows_to_bits(_t(got), h, w, NUM_AC, stripe).numpy()
    bits_j = np.asarray(jpk.rows_to_bits(jnp.asarray(wire), h, w, NUM_AC,
                                         stripe))
    assert not ((bits_t != bits_j) & ~_near_boundary(frames, DELTA,
                                                     NUM_AC)).any()
    ns = _ablation_defs(b, h, w, NUM_AC, DELTA)
    script = np.asarray(ns["build"](ns["kern_full"])(jnp.asarray(frames)))
    assert script.shape == got.shape
    lanes_t, pad_t = _rows_to_lanes(got, h, w, NUM_AC)
    lanes_s, pad_s = _rows_to_lanes(script, h, w, NUM_AC)
    assert not pad_t.any() and not pad_s.any()
    assert set(np.unique(got)) <= {0, 1}
    # the same layout: a misplaced row or lane would agree on about half
    assert (lanes_t == lanes_s).mean() > 0.9


@pytest.mark.parametrize("b,h,w", ABL_SHAPES)
def test_ablation_no_horiz_within_envelope(b, h, w):
    frames = _frames(5, b, h, w)
    ns = _ablation_defs(b, h, w, NUM_AC, DELTA)
    want = np.asarray(ns["build"](ns["kern_no_horiz"])(jnp.asarray(frames)))
    got = extract_ablation.ablate(_t(frames), DELTA, NUM_AC,
                                  "no_horiz").numpy()
    assert got.shape == want.shape
    lanes_t, pad_t = _rows_to_lanes(got, h, w, NUM_AC)
    lanes_j, pad_j = _rows_to_lanes(want, h, w, NUM_AC)
    assert not pad_t.any() and not pad_j.any()
    rn = jpk.rows_per_block(NUM_AC)
    m = jdct.dct_matrix(8, np.float64)
    t = m[:rn] @ jdct.blockify(frames.astype(np.float64)).reshape(
        b, -1, 8, 8)                                       # (b, nb, rn, 8)
    diff = lanes_t != lanes_j
    assert not (diff & ~_near_rounding(t, DELTA)).any()
    assert diff.mean() < 0.01


@pytest.mark.parametrize("b,h,w", ABL_SHAPES)
def test_ablation_no_qim_wraps_like_the_f32_dct(b, h, w):
    """no_qim against the JAX package's f32 DCT coefficients, cast through
    int32 to u8 as _f32_to_u8 does: equal, or off by 1 (mod 256) where the
    coefficient lies within the envelope of an integer."""
    frames = _frames(6, b, h, w)
    rn = jpk.rows_per_block(NUM_AC)
    got = extract_ablation.ablate(_t(frames), DELTA, NUM_AC, "no_qim").numpy()
    lanes_t, pad_t = _rows_to_lanes(got, h, w, NUM_AC)
    assert not pad_t.any()
    k = jnp.asarray(jdct.kron_dct_matrix(8, np.float32))
    xb = jnp.asarray(jdct.blockify(frames.astype(np.float32)))
    y32 = (xb @ k.T)[..., : rn * 8]
    want = np.asarray(jpk._f32_to_u8(y32)).reshape(b, -1, rn, 8)
    y = (jdct.blockify(frames.astype(np.float64))
         @ jdct.kron_dct_matrix(8, np.float64).T)[..., : rn * 8]
    y = y.reshape(b, -1, rn, 8)
    step = (lanes_t.astype(int) - want.astype(int)) % 256
    off = step != 0
    assert np.isin(step[off], (1, 255)).all()
    near_int = np.abs(y - np.round(y)) <= _envelope(y)
    assert not (off & ~near_int).any()
    # the wrap-around is exercised: negative and > 255 coefficients
    assert (y < -1).any() and (y > 256).any()


def test_ablation_full_notrunc_equals_full():
    frames = _frames(7, 2, 240, 256)
    full = extract_ablation.ablate(_t(frames), DELTA, NUM_AC, "full")
    notrunc = extract_ablation.ablate(_t(frames).to(torch.float32), DELTA,
                                      NUM_AC, "full_notrunc")
    assert torch.equal(full, notrunc)


def test_ablation_refuses_what_the_kernel_cannot_take():
    frames = _t(_frames(8, 3, 48, 64))
    with pytest.raises(ValueError, match="unknown K9 variant"):
        extract_ablation.ablate(frames, DELTA, NUM_AC, "fast")
    with pytest.raises(ValueError, match="multiple of 4"):
        extract_ablation.ablate(frames, DELTA, NUM_AC, "io_f4")
    with pytest.raises(ValueError, match="float32"):
        extract_ablation.ablate(frames, DELTA, NUM_AC, "full_notrunc")
    with pytest.raises(ValueError, match="uint8"):
        extract_ablation.ablate(frames.to(torch.float32), DELTA, NUM_AC,
                                "full")


# --- K10: ab_packed_payload ----------------------------------------------------

@pytest.mark.parametrize("b,h,w,num_ac", [(2, 48, 256, 10), (2, 64, 128, 3),
                                          (1, 240, 128, 17)])
def test_payload_to_rows_packed_equals_jax(b, h, w, num_ac):
    payload = _payload(9, b, h, w, num_ac)
    stripe = jpk.pick_stripe(h)
    want = np.asarray(_jax_ab().payload_to_rows_packed(
        jnp.asarray(payload), h, w, num_ac, stripe))
    got = sk.payload_to_rows_packed(_t(payload), h, w, num_ac, stripe)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sk.packed_rows_to_bits(got, h, w, num_ac, stripe).numpy(), payload)


@pytest.mark.parametrize("b,h,w", [(2, 48, 256), (3, 144, 128)])
def test_packedin_is_k1(b, h, w):
    """K10's plain version is K1's plain version byte for byte on the same
    bits, whatever the packed payload's non-slot bits and padding rows
    hold; against the JAX wire embed it is within the flip budget with the
    same bits per frame."""
    frames = _frames(10, b, h, w, 16, 240)
    payload = _payload(10, b, h, w)
    total = b * payload.shape[1] - 7
    stripe = sk.pick_stripe(h)
    packed = sk.payload_to_rows_packed(_t(payload), h, w, NUM_AC, stripe)
    s1, bpf1 = sk.embed_frames_plain(_t(frames), _t(payload), total, DELTA,
                                     NUM_AC)
    s10, bpf10 = ab_packed_payload.embed_frames_packedin(
        _t(frames), packed, total, DELTA, NUM_AC)
    assert torch.equal(s10, s1) and torch.equal(bpf10, bpf1)
    # garbage in the non-slot bits (bit 0 of slot row 0, bits past num_ac
    # of the last slot row) and in the padding rows must not leak
    rn = sk.rows_per_block(NUM_AC)
    rp = sk._rows_pad(stripe, rn)
    noise = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, packed.shape, dtype=np.uint8))
    row = torch.arange(packed.shape[1]) % rp
    slot_mask = torch.zeros(rp, dtype=torch.uint8)
    for g in range(rn):
        s0, s1_ = sk._slot_span(g, NUM_AC)
        slot_mask[g::rn][: stripe // 8] = sum(1 << s for s in range(s0, s1_))
    slot_mask[(stripe // 8) * rn:] = 0
    dirty = (packed & slot_mask[row][:, None]) | (noise & ~slot_mask[row][:, None])
    assert not torch.equal(dirty, packed)
    s10d, _ = ab_packed_payload.embed_frames_packedin(
        _t(frames), dirty.contiguous(), total, DELTA, NUM_AC)
    assert torch.equal(s10d, s1)
    want, bpf_j = jpk._embed_frames_pallas(
        jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
        jnp.float32(DELTA), NUM_AC, jnp.int32(0), True, False)
    _assert_stego_close(s10.numpy(), np.asarray(want))
    np.testing.assert_array_equal(bpf10.numpy(), np.asarray(bpf_j))


def test_packedin_refuses_a_wrong_layout():
    frames = _t(_frames(12, 2, 48, 64))
    packed = torch.zeros((2, 12, 8), dtype=torch.uint8)  # rows_pad is 16
    with pytest.raises(ValueError, match="packed payload"):
        ab_packed_payload.embed_frames_packedin(frames, packed, 10, DELTA,
                                                NUM_AC)


# --- K11: dualchain_r5 ---------------------------------------------------------

@pytest.mark.parametrize("b,h,w", [(2, 120, 256), (4, 48, 128)])
def test_dual_is_k4_and_the_script(b, h, w):
    frames = _frames(13, b, h, w, 16, 240)
    payload = _payload(13, b, h, w)
    total = b * payload.shape[1] - 13
    args = (_t(frames), _t(payload), total, DELTA, NUM_AC)
    got = dualchain_r5.dual_roundtrip_packed(*args)
    ref = sk.embed_and_extract_frames_packed_plain(*args)
    for a, c in zip(got, ref):
        assert torch.equal(a, c)
    stego, bpf, bits = dualchain_r5.dual_roundtrip(*args)
    s_j, bpf_j, bits_j = _jax_dual().dual_roundtrip(
        jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
        jnp.float32(DELTA), NUM_AC, interpret=True)
    _assert_stego_close(stego.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(bpf.numpy(), np.asarray(bpf_j))
    # each side's bits read its own stego: compare where both stegos agree
    same_block = (jdct.blockify(stego.numpy()) == jdct.blockify(
        np.asarray(s_j))).all(-1)                         # (b, nb)
    near = _near_boundary(stego.numpy(), DELTA, NUM_AC).reshape(
        b, -1, NUM_AC)
    diff = (bits.numpy() != np.asarray(bits_j)).reshape(b, -1, NUM_AC)
    assert not (diff & same_block[..., None] & ~near).any()
    valid = np.arange(b * payload.shape[1]).reshape(payload.shape) < total
    np.testing.assert_array_equal(bits.numpy()[valid], payload[valid])


def test_dual_refuses_an_odd_batch():
    frames = _t(_frames(14, 3, 48, 64))
    payload = _t(_payload(14, 3, 48, 64))
    with pytest.raises(ValueError, match="odd"):
        dualchain_r5.dual_roundtrip_packed(frames, payload, 100, DELTA, NUM_AC)
    with pytest.raises(ValueError, match="odd"):
        dualchain_r5.dual_roundtrip_packed_plain(frames, payload, 100, DELTA,
                                                 NUM_AC)


# --- K12: roofline_r4 ----------------------------------------------------------

@pytest.mark.parametrize("h,w,stripe", [(48, 128, 48), (96, 256, 48)])
def test_copy_and_dmaspec_against_the_script(monkeypatch, h, w, stripe):
    jroof = _load("benchmarks/roofline_r4.py", "_jax_roofline_r4")
    monkeypatch.setattr(jroof, "H", h)
    monkeypatch.setattr(jroof, "W", w)
    b = 2
    frames = _frames(15, b, h, w)
    payload = _payload(15, b, h, w)
    cap = payload.shape[1]
    rows = jpk.payload_to_rows(jnp.asarray(payload), h, w, NUM_AC, stripe)
    args = (jnp.asarray(frames), rows, jnp.float32(DELTA).reshape(1),
            jnp.asarray([b * cap, 0], jnp.int32))
    copy_run, _ = jroof.build_variant("copy", stripe, ("parallel",
                                                       "arbitrary"), False)
    dma_run, _ = jroof.build_variant("dmaspec", stripe, ("parallel",
                                                         "arbitrary"), False)
    np.testing.assert_array_equal(np.asarray(copy_run(*args)[0]), frames)
    np.testing.assert_array_equal(np.asarray(dma_run(*args)[0]), frames)

    got = roofline_r4.copy_frames(_t(frames))
    np.testing.assert_array_equal(got.numpy(), frames)
    stego, packed = roofline_r4.dmaspec(_t(frames), _t(payload), NUM_AC,
                                        stripe)
    np.testing.assert_array_equal(stego.numpy(), frames)
    want = np.asarray(_jax_ab().payload_to_rows_packed(
        jnp.asarray(payload), h, w, NUM_AC, stripe))
    np.testing.assert_array_equal(packed.numpy(), want)


def test_explicit_stripe_reaches_k4_layout():
    """The s216/s360 variants pass K4 its stripe explicitly: the packed
    layout follows it and unpacks to the same bits as the default's."""
    b, h, w = 2, 720, 64
    frames = _t(_frames(16, b, h, w, 16, 240))
    payload = _t(_payload(16, b, h, w))
    total = b * payload.shape[1]
    s0, _, p0 = sk.embed_and_extract_frames_packed(frames, payload, total,
                                                   DELTA, NUM_AC)
    for stripe in (240, 360):
        s, _, p = sk.embed_and_extract_frames_packed(
            frames, payload, total, DELTA, NUM_AC, stripe=stripe)
        assert torch.equal(s, s0)
        rp = sk._rows_pad(stripe, sk.rows_per_block(NUM_AC))
        assert p.shape == (b, (h // stripe) * rp, w // 8)
        assert torch.equal(sk.packed_rows_to_bits(p, h, w, NUM_AC, stripe),
                           sk.packed_rows_to_bits(p0, h, w, NUM_AC, 120))
    with pytest.raises(ValueError, match="stripe 100"):
        sk.embed_and_extract_frames_packed(frames, payload, total, DELTA,
                                           NUM_AC, stripe=100)


def test_roofline_grid_names_every_jax_variant():
    jroof_src = (REPO / "benchmarks" / "roofline_r4.py").read_text()
    labels = {label for label, _, _ in roofline_r4.GRID}
    for label in labels:
        assert f'"{label}"' in jroof_src, label
    no_counterpart = {label for label, _, k in roofline_r4.GRID if k is None}
    assert no_counterpart == set(roofline_r4.NO_COUNTERPART)


@pytest.mark.parametrize("h,default", [(1080, 120), (768, 96), (144, 72)])
def test_roofline_stripe_follows_the_height(h, default):
    """A variant without a stripe of its own runs at pick_stripe(h); one
    whose stripe does not divide h is an error row, never skipped."""
    for label, stripe, kernel in roofline_r4.GRID:
        got = roofline_r4.stripe_row(label, stripe, h)
        if stripe is None:
            assert got == default, label
        elif h % stripe == 0:
            assert got == stripe, label
        else:
            assert got["variant"] == label and got["stripe"] == stripe
            assert f"dividing height {h}" in got["error"]


def test_roofline_main_rows_at_a_height_120_does_not_divide(monkeypatch,
                                                            capsys):
    """roofline_r4.main at H=144 (pick_stripe 72), its timing stubbed so
    that the wrappers' plain versions run on the CPU: every variant with a
    counterpart runs at stripe 72 but fused_s216 and fused_s360, which are
    error rows, and the study exits 1."""
    import json

    from stegotpu_torch.studies import harness

    monkeypatch.setattr(harness, "require_cuda",
                        lambda prog: torch.device("cpu"))
    monkeypatch.setattr(harness, "queued_ms",
                        lambda fn, runs=10, warmup=2: (fn(), 1.0)[1])
    monkeypatch.setattr(harness, "header",
                        lambda study, dev, args: harness.emit({"study": study}))
    assert roofline_r4.main(["--batch", "1", "--iters", "1", "--height",
                             "144", "--width", "64"]) == 1
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    timed = {r["variant"]: r["stripe"] for r in rows if "ms_per_batch" in r}
    assert timed == dict.fromkeys(("copy", "dmaspec", "fused", "embed",
                                   "fused_buf3", "fused_buf4"), 72)
    assert {r["variant"] for r in rows if "error" in r} == {"fused_s216",
                                                            "fused_s360"}
    assert {r["variant"] for r in rows if r.get("counterpart", 0) is None} \
        == set(roofline_r4.NO_COUNTERPART)


# --- device_roofline -----------------------------------------------------------

def _events():
    """A sleep kernel, three launches of the variant's kernel (4 ms each at
    a 6 ms period), a small kernel of the wrapper's glue per call, a
    memset, and a host event that must be ignored."""
    evs = [{"ph": "X", "cat": "kernel", "name": "void spin_kernel(long)",
            "ts": 0, "dur": 100_000},
           {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 10,
            "dur": 50_000},
           {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
            "ts": 100_500, "dur": 30}]
    for i in range(3):
        base = 101_000 + i * 6_000
        evs.append({"ph": "X", "cat": "kernel", "ts": base, "dur": 4_000,
                    "name": "void copy_kernel<0>(unsigned char const*)"})
        evs.append({"ph": "X", "cat": "kernel", "ts": base + 4_100,
                    "dur": 500, "name": "elementwise_kernel clamp"})
    return evs


def test_device_timeline_summary():
    evs = _events()
    trace = {"traceEvents": list(reversed(evs))}
    dev = device_roofline.device_events(trace)
    assert [e["ts"] for e in dev] == sorted(e["ts"] for e in dev)
    assert all(e["cat"] != "cpu_op" for e in dev)
    s = device_roofline.parse_device_timeline(dev, iters=3)
    assert s["kernel_name"].startswith("void copy_kernel<0>")
    assert s["kernel_ms_each"] == pytest.approx(4.0)
    assert s["kernel_count"] == 3
    assert s["iter_period_ms"] == pytest.approx(6.0)
    assert s["n_device_events"] == 7  # the sleep kernel is the harness's
    glue = {g["name"]: g for g in s["glue_top"]}
    assert glue["elementwise_kernel clamp"]["per_iter_ms"] == pytest.approx(0.5)
    assert glue["Memset (Device)"]["total_ms"] == pytest.approx(0.03)
    assert "void spin_kernel(long)" not in glue
    assert s["glue_per_iter"] == {"gpu_memset": pytest.approx(1 / 3),
                                  "kernel": pytest.approx(1.0)}


def test_device_timeline_without_device_events():
    host = [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
             "dur": 5}]
    assert device_roofline.device_events({"traceEvents": host}) == []
    assert "error" in device_roofline.parse_device_timeline([], iters=1)


@pytest.mark.parametrize("behind,readings", [([False], 1), ([True, False], 2),
                                             ([True, True, True], 3)])
def test_queued_ms_retakes_a_reading_the_host_fell_behind_on(
        monkeypatch, behind, readings):
    """harness.queued_ms: where the stream had passed the sleep before the
    host queued the last call (the start event done), the reading counts
    the device's idle time and is taken again, at most `tries` times."""
    from stegotpu_torch.studies import harness

    behind, sleeps, calls = list(behind), [], []

    class Event:  # elapsed time: 10 ms a reading so far
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            pass

        def query(self):
            return behind.pop(0)

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 10.0 * len(sleeps)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", sleeps.append)
    monkeypatch.setattr(harness, "RETAKES", 0)
    monkeypatch.setattr(harness, "BEHIND", 0)
    ms = harness.queued_ms([lambda: calls.append(0), lambda: calls.append(1)],
                           runs=5, warmup=1)
    assert len(sleeps) == readings and behind == []
    assert harness.RETAKES == readings - 1
    assert harness.BEHIND == (readings == 3)  # behind in all three tries
    assert len(calls) == 1 + 5 * readings
    assert ms == pytest.approx(10.0 * readings / 5)


# --- stripe_cap's kernels ----------------------------------------------------------

STRIPE_CAP_PLAIN = {
    "k1": sk.embed_frames_plain,
    "k3": sk.embed_and_check_frames_plain,
    "k4": sk.embed_and_extract_frames_packed_plain,
    "k5": lambda f, p, t, d, n: (sk.extract_frames_rows_plain(f, d, n),),
    "k6": sk.embed_and_extract_frames_rows_plain,
    # K11 and K13 compute K4's function
    **{k: sk.embed_and_extract_frames_packed_plain
       for k in ("k11", "k13_2", "k13_3", "k13_4")},
}


@pytest.mark.parametrize("key", sorted(stripe_cap.KERNELS))
def test_stripe_cap_kernels_name_the_library(key):
    """Each kernel that stripe_cap builds, holds and times: its template is
    a kernel of its csrc/ source (K1-K6 of qim_stripe.cu, each a default
    row of studies/sass.py; K11 of qim_study.cu, K13 of qim_pipe.cu), its
    cap's -D a default of that source (one per ring depth for K13; K5 has
    none, so --minb cannot name it), its name a kernel of studies/bounds.py,
    and its wrapper, called as stripe_cap calls it, gives its plain
    version's tuple on the CPU."""
    from stegotpu_torch.studies import bounds, sass

    name, template, fn, define = stripe_cap.KERNELS[key]
    source = stripe_cap.SOURCES[key]
    src = (REPO / "stegotpu_torch" / "csrc" / source).read_text()
    assert f"\n{template}(" in src
    assert (template in sass.DEFAULT_KERNELS) == (source == "qim_stripe.cu")
    if define is None:
        assert key == "k5"
        assert key not in stripe_cap.CAPPED
    else:
        assert re.search(rf"#ifndef {define}\n#define {define} \d+\n", src)
        assert key in stripe_cap.CAPPED
    nbytes, flops = bounds.work(name, 2, 48, 240, NUM_AC, 48)
    assert nbytes > 0 and flops > 0
    b, h, w = 2, 48, 240
    frames, payload = _t(_frames(12, b, h, w, 16, 240)), _t(_payload(12, b, h, w))
    total = b * payload.shape[1] - 13
    for delta in (DELTA, 2.0**-11):
        got = fn(frames, payload, total, delta, NUM_AC)
        want = STRIPE_CAP_PLAIN[key](frames, payload, total, delta, NUM_AC)
        assert isinstance(got, tuple) and len(got) == len(want)
        assert all(torch.equal(a, c) for a, c in zip(got, want))


# --- the studies' entry points ---------------------------------------------------

@pytest.mark.parametrize("mod", [extract_ablation, ab_packed_payload,
                                 dualchain_r5, roofline_r4, device_roofline,
                                 stripe_cap],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_study_main_exits_nonzero_without_cuda(mod, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(["--batch", "2", "--iters", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA device" in out.err


def test_serve_warmup_exits_nonzero_without_cuda(monkeypatch, capsys):
    from stegotpu_torch.studies import serve_warmup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_warmup.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA device" in out.err


def test_serve_warmup_splits_each_request(tmp_path):
    """Two identical /embed calls at a small size on the CPU: each row's
    stages add up to its total, and the second imports nothing."""
    from stegotpu_torch.studies import serve_warmup

    body = serve_warmup.make_request(tmp_path, 48, 64)
    rows = serve_warmup.split_requests(body, "cpu", 2)
    assert [r["request"] for r in rows] == [1, 2]
    for r in rows:
        assert r["success"]
        assert set(r["stages_s"]) == {
            "imports", "video_probe", "key", "seal", "files_open",
            "decode_wait", "device_dispatch", "device_readback", "encode",
            "files_close", "other"}
        assert sum(r["stages_s"].values()) == pytest.approx(r["total_s"])
        assert r["decode_thread_s"] > 0
    assert rows[1]["imported"] == []


def test_study_bounds_count_each_byte_once():
    from stegotpu_torch.studies import bounds

    b, h, w = 8, 1080, 1920
    nbytes, flops = bounds.work("copy", b, h, w, NUM_AC, 120)
    assert (nbytes, flops) == (2 * b * h * w, 0)
    ms, by = bounds.bound_ms(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(2 * b * h * w / 3.35e9)
    nbytes, _ = bounds.work("embed", b, h, w, NUM_AC, 120)
    cap = (h // 8) * (w // 8) * NUM_AC
    assert nbytes == 2 * b * h * w + b * cap + 64 * 4 + 4 * b
    blocks = b * (h // 8) * (w // 8)
    nbytes, flops = bounds.work("kron_embed", b, h, w, NUM_AC, 120)
    assert flops == blocks * 2 * (2 * 8 * 64) * 2  # separable fwd + inverse
    ms, by = bounds.bound_ms(nbytes, flops)
    assert by == "operations" and ms == pytest.approx(flops / 67e9)

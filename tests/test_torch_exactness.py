"""The port's exactness harness (stegotpu_torch.ops.exactness) against the
JAX package's (stegotpu/ops/exactness.py), on the CPU.

Here the harness holds the stripe kernels' plain versions against the
port's f32 oracle; ``python -m stegotpu_torch.gpucheck`` runs the same code
with the CUDA kernels on the card and commits GPUCHECK.json.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from stegotpu.ops import exactness as jex
from stegotpu_torch.ops import exactness as tex

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("precision", ["wire", "fast"])
def test_quick_exactness_check_passes_on_cpu(precision):
    row = tex.quick_exactness_check(precision=precision, device="cpu")
    assert row["ok"], row
    assert row["precision"] == precision
    for k in tex.EXACT_KEYS:
        assert row[k] == 0, (k, row)
    assert row["roundtrip_errors_pallas"] == row["roundtrip_errors_xla"] == 0


def test_constants_keys_and_policy_match_jax():
    for name in ("TOL_ABS", "TOL_REL", "FAST_TOL_ABS", "FAST_TOL_REL",
                 "ROBUST_BER_BOUND", "EXACT_KEYS"):
        assert getattr(tex, name) == getattr(jex, name), name
    for prec in ("wire", "fast"):
        for delta in (1, 8, 11, 12, 20, 30, 31, 40, 100):
            for num_ac in (1, 10, 30, 31, 63):
                assert tex.is_robust(delta, num_ac, prec) == \
                    jex.is_robust(delta, num_ac, prec)
    # same rows, same keys; row_ok judges a row the same way in both
    t = tex.quick_exactness_check(device="cpu")
    j = jex.quick_exactness_check()
    assert set(t) == set(j)
    for k in ("h", "w", "batch", "num_ac", "delta", "content", "precision",
              "total_bits", "robust", "roundtrip_errors_pallas",
              "roundtrip_errors_xla", "ok"):
        assert t[k] == j[k], k
    for row in (t, dict(t, verified_errcount_delta=1),
                dict(t, roundtrip_errors_xla=10**6)):
        assert tex.row_ok(row) == jex.row_ok(row)


def test_compressed_content_row_passes():
    """The sweep's 'compressed' content (an mpeg4-coded moving cover, made
    by the port's own fixtures copy) passes at the delta=8 robust edge, as
    tests/test_exactness.py holds for JAX, on the same frames as the JAX
    harness draws from the same seed."""
    from stegotpu import fixtures as jfixtures
    from stegotpu.video import VideoReader as JReader

    rows = tex.check_config(4, 480, 720, 10, [8.0],
                            np.random.default_rng(42), content="compressed",
                            verbose=False, device="cpu")
    assert rows[0]["content"] == "compressed"
    assert rows[0]["roundtrip_errors_pallas"] == 0, rows[0]
    assert tex.row_ok(rows[0])
    for k in tex.EXACT_KEYS:
        assert rows[0][k] == 0, (k, rows[0])

    seed = int(np.random.default_rng(42).integers(1 << 30))
    ours = tex._compressed_cover(4, 480, 720, seed)
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        jfixtures.make_cover_video(Path(td) / "c.mp4", 720, 480, frames=4,
                                   kind="moving", seed=seed)
        with JReader(Path(td) / "c.mp4") as r:
            theirs = np.concatenate(list(r.batches(4, mode="gray")))[:4]
    np.testing.assert_array_equal(ours, theirs)


def test_tf32_sentinel_fails_the_row():
    """Sensitivity sentinel, the port's counterpart of
    tests/test_exactness.py::test_compressed_gate_catches_single_pass_inverse:
    with the oracle's matmul inputs rounded to TF32 (10-bit mantissa, what
    torch.backends.cuda.matmul.allow_tf32 lets cuBLAS do on the card), the
    harness must fail the row. The uniform-random row catches it: cover
    coefficients then sit everywhere, and TF32's error (~3e-2 here) moves
    some bits outside the 1e-2 envelope. (The 'compressed' delta=8 row
    does not: its coefficients sit far from boundaries, so TF32 flips no
    bit there at 480x720 or at 1080p.) Runs in a subprocess so the patched
    oracle never reaches another test."""
    code = """
import numpy as np, torch
from torch.overrides import TorchFunctionMode
import stegotpu_torch.ops.qim as qim
from stegotpu_torch.ops.exactness import check_config, row_ok

def tf32(t):
    if t.dtype != torch.float32:
        return t
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)  # round to nearest

class TF32Matmul(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__):
            args = tuple(tf32(a) for a in args)
        return func(*args, **(kwargs or {}))

def under_tf32(fn):
    def call(*a, **k):
        with TF32Matmul():
            return fn(*a, **k)
    return call

rows = check_config(4, 240, 384, 10, [20.0], np.random.default_rng(42),
                    verbose=False, device="cpu")
assert row_ok(rows[0]), rows[0]
qim.embed_frames = under_tf32(qim.embed_frames)
qim.extract_frames = under_tf32(qim.extract_frames)
rows = check_config(4, 240, 384, 10, [20.0], np.random.default_rng(42),
                    verbose=False, device="cpu")
assert rows[0]["extract_mismatch_cover_nonboundary"] > 0, rows[0]
assert not row_ok(rows[0])
print("SENTINEL-CATCHES-TF32")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert "SENTINEL-CATCHES-TF32" in out.stdout, (out.stdout, out.stderr)


def test_num_ac_30_noise_row_is_past_the_ber_bound_in_both_packages():
    """is_robust declares num_ac <= 30 robust, but on uniform-random covers
    num_ac=30 loses bits to clipping beyond BER 1e-5 (30 of 86,387 here,
    3.5e-4): the JAX package's own harness fails the row, its Pallas
    kernel and its XLA oracle losing as many bits, and the port's harness
    counts as many losses with every identity at zero. The algorithm's
    loss, not a kernel's: GPUCHECK.json's num_ac=30 noise rows show it on
    the card."""
    j = jex.check_config(2, 240, 384, 30, [20.0], np.random.default_rng(42),
                         verbose=False)[0]
    t = tex.check_config(2, 240, 384, 30, [20.0], np.random.default_rng(42),
                         verbose=False, device="cpu")[0]
    assert j["robust"] and t["robust"]
    assert not jex.row_ok(j) and not tex.row_ok(t)
    assert t["roundtrip_errors_xla"] == j["roundtrip_errors_xla"] > \
        jex.ROBUST_BER_BOUND * t["total_bits"]
    assert t["roundtrip_errors_pallas"] == t["roundtrip_errors_xla"] == \
        j["roundtrip_errors_pallas"]
    for k in tex.EXACT_KEYS:
        assert t[k] == 0, (k, t)

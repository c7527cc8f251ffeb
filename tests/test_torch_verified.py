"""The port's verified embed (stegotpu_torch.ops.verified and the verified
branch of its pipeline) against the JAX package's, on the CPU.

Covers of tests/test_verified.py and tests/test_verified_pipeline.py, made
with numpy from a seed and handed to both packages: residuals and bits per
frame equal, stego within the cross-variant budget of
tests/test_torch_kernels.py, and the payload recovered exactly by the JAX
package's extractor. On the CPU the fast path runs K3's plain version; the
CUDA kernel itself is held to it in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stegotpu import crypto as jcrypto
from stegotpu.config import StegoConfig as JConfig
from stegotpu.ops import qim as jqim
from stegotpu.ops import verified as jver
from stegotpu.pipeline import extract_image_from_video as j_extract
from stegotpu_torch import crypto, fixtures
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.image import load_image_gray, save_image_gray
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.ops import verified as tver
from stegotpu_torch.pipeline import embed_image_in_video
from test_torch_kernels import _assert_stego_close

DELTA = 20.0
N_AC = 10


def _cover(kind: str, rng: np.random.Generator):
    """(frames, payload, total, repair_rounds): the covers of
    tests/test_verified.py:19-119."""
    if kind == "mid":            # no clipping: no repair triggers
        frames = rng.integers(60, 196, (2, 32, 64), dtype=np.uint8)
        total_of, rounds = (lambda cap: 2 * cap), 3
    elif kind == "near_black":   # the plain embed loses bits here
        frames = rng.integers(0, 12, (1, 32, 64), dtype=np.uint8)
        total_of, rounds = (lambda cap: cap), 4
    elif kind == "partial":      # payload ends 7 bits into frame 2
        frames = rng.integers(0, 256, (2, 32, 64), dtype=np.uint8)
        total_of, rounds = (lambda cap: cap + 7), 3
    else:                        # flat black: every block needs repair
        frames = np.zeros((2, 64, 128), np.uint8)
        total_of, rounds = (lambda cap: 2 * cap), 3
    b, h, w = frames.shape
    cap = (h // 8) * (w // 8) * N_AC
    total = total_of(cap)
    payload = np.zeros((b, cap), np.uint8)
    payload.reshape(-1)[:total] = rng.integers(0, 2, total)
    return frames, payload, total, rounds


def _jax_bits(stego: np.ndarray) -> np.ndarray:
    return np.asarray(jqim.extract_frames(jnp.asarray(stego),
                                          jnp.float32(DELTA), N_AC))


@pytest.mark.parametrize("kind", ["mid", "near_black", "partial", "flat_black"])
def test_verified_matches_jax(kind):
    frames, payload, total, rounds = _cover(kind, np.random.default_rng(1234))
    s_j, bpf_j, res_j = (np.asarray(a) for a in jver.embed_frames_verified(
        jnp.asarray(frames), jnp.asarray(payload), jnp.int32(total),
        jnp.float32(DELTA), N_AC, repair_rounds=rounds))
    targs = (torch.from_numpy(frames), torch.from_numpy(payload), total,
             DELTA, N_AC)
    s_t, bpf_t, res_t = tver.embed_frames_verified(*targs,
                                                   repair_rounds=rounds)
    assert res_t.dtype == torch.int32 and res_t.dim() == 0
    assert int(res_t) == int(res_j) == 0
    np.testing.assert_array_equal(bpf_t.numpy(), bpf_j)
    _assert_stego_close(s_t.numpy(), s_j, frames, DELTA, N_AC)
    valid = np.arange(payload.size).reshape(payload.shape) < total
    np.testing.assert_array_equal(_jax_bits(s_t.numpy())[valid],
                                  payload[valid])

    # the fast path: K3 (plain here); the repair loop only where K3
    # counted a wrong bit, the same loop for kernel='xla'
    _, _, errors = sk.embed_and_check_frames(*targs)
    s_k1, _ = sk.embed_frames(*targs)
    for kernel in ("auto", "pallas", "xla"):
        s_f, bpf_f, res_f = tver.embed_frames_verified_fast(
            *targs, repair_rounds=rounds, kernel=kernel)
        assert int(res_f) == 0
        np.testing.assert_array_equal(bpf_f.numpy(), bpf_j)
        repaired = kernel == "xla" or int(errors.sum()) > 0
        np.testing.assert_array_equal(s_f.numpy(),
                                      (s_t if repaired else s_k1).numpy())
    assert (int(errors.sum()) > 0) == (kind in ("near_black", "flat_black"))
    if kind == "mid":  # with no clipping no repair triggers: the oracle's embed
        from stegotpu_torch.ops import qim as tqim

        np.testing.assert_array_equal(s_t.numpy(),
                                      tqim.embed_frames(*targs)[0].numpy())
    if kind == "partial":  # untouched blocks pass through exactly
        np.testing.assert_array_equal(s_t.numpy()[1, 8:], frames[1, 8:])


@pytest.mark.parametrize("kind", ["mid", "flat_black"])
def test_fast_and_wire_precision_agree(kind):
    """The port's 'fast' reader is the wire arithmetic, so 'fast' gives the
    same stego and residual as 'wire', on the fast branch and on the
    repair branch."""
    frames, payload, total, rounds = _cover(kind, np.random.default_rng(7))
    args = (torch.from_numpy(frames), torch.from_numpy(payload), total,
            DELTA, N_AC)
    s_w, b_w, r_w = tver.embed_frames_verified_fast(*args, repair_rounds=rounds,
                                                    precision="wire")
    s_f, b_f, r_f = tver.embed_frames_verified_fast(*args, repair_rounds=rounds,
                                                    precision="fast")
    assert torch.equal(s_w, s_f) and torch.equal(b_w, b_f)
    assert int(r_w) == int(r_f) == 0


def test_repair_loop_refuses_reduced_precision_matmuls():
    frames, payload, total, _ = _cover("mid", np.random.default_rng(3))
    args = (torch.from_numpy(frames), torch.from_numpy(payload), total,
            DELTA, N_AC)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full-precision"):
            tver.embed_frames_verified(*args)
    finally:
        torch.set_float32_matmul_precision(before)
    assert int(tver.embed_frames_verified(*args)[2]) == 0


@pytest.fixture
def black_cover(tmp_path):
    """A mostly-black cover video (tests/test_verified_pipeline.py:13-25)."""
    import cv2

    path = tmp_path / "black.mp4"
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 24.0,
                          (320, 240))
    for i in range(8):
        frame = np.zeros((240, 320, 3), np.uint8)
        frame[100:140, 100 + i * 4 : 140 + i * 4] = 90  # a small moving patch
        out.write(frame)
    out.release()
    return path


def test_black_cover_plain_fails_verified_succeeds(tmp_path, black_cover):
    """The port's plain embed loses bits on a black cover; its verified
    embed round-trips through the JAX package's standard extractor,
    pixel-identical with SHA3 OK."""
    secret = tmp_path / "s.png"
    save_image_gray(np.random.default_rng(8).integers(0, 256, (24, 24),
                                                      dtype=np.uint8), secret)
    priv, pub = jcrypto.setup_receiver_keys(tmp_path / "k.pem",
                                            tmp_path / "p.pem")
    res_p = embed_image_in_video(black_cover, secret, tmp_path / "plain", pub,
                                 StegoConfig(), device="cpu")
    assert res_p.success  # embeds fine; the loss shows at extraction
    ext_p = j_extract(res_p.output_path, priv, JConfig())
    assert not (ext_p.success and np.array_equal(
        ext_p.pixels, load_image_gray(secret))), \
        "test premise: plain embed must fail on a black cover"

    res_v = embed_image_in_video(
        black_cover, secret, tmp_path / "ver", pub,
        StegoConfig(verified_embed=True, repair_rounds=4), device="cpu")
    assert res_v.success and res_v.residual_bits == 0
    ext_v = j_extract(res_v.output_path, priv, JConfig())  # std extract
    assert ext_v.success, ext_v.error
    assert ext_v.hash_ok
    np.testing.assert_array_equal(ext_v.pixels, load_image_gray(secret))


def test_residual_fails_embed_unless_allowed(tmp_path):
    """An unrepairable cover (checkerboard at max dynamic range: no DC
    shift can help) fails the verified embed with the residual surfaced,
    unless allow_residual is set — as in the JAX package, whose embed of
    the same cover and crypto stream reports the same residual."""
    from stegotpu import fixtures as jfixtures
    from stegotpu.pipeline import embed_image_in_video as j_embed
    from stegotpu_torch.video import VideoWriter

    h, w = 64, 128
    yy, xx = np.mgrid[0:h, 0:w]
    checker = ((yy + xx) % 2 * 255).astype(np.uint8)
    with VideoWriter(tmp_path / "c.avi", 24.0, w, h) as vw:
        vw.write_bgr_batch(np.repeat(checker[None, ..., None], 3, axis=-1)
                           .repeat(60, axis=0))
    jfixtures.make_secret_image(tmp_path / "s.png", 24, 24, kind="noise",
                                seed=5)
    _, pub = crypto.setup_receiver_keys(tmp_path / "k.pem", tmp_path / "p.pem")

    def embed(out, allow, jax=False):
        cfg = dict(delta=20, num_ac_coeffs=10, verified_embed=True,
                   allow_residual=allow)
        fn, config = ((j_embed, JConfig(**cfg)) if jax
                      else (embed_image_in_video, StegoConfig(**cfg)))
        kw = {} if jax else {"device": "cpu"}
        return fn(tmp_path / "c.avi", tmp_path / "s.png", tmp_path / out, pub,
                  config, rng=np.random.default_rng(11), **kw)

    res = embed("st", False)
    assert not res.success and "unrepairable" in res.error
    assert res.residual_bits > 0
    res2 = embed("st2", True)
    assert res2.success
    assert res2.residual_bits == res.residual_bits > 0
    assert embed("st3", False, jax=True).residual_bits == res.residual_bits


def test_fixture_cover_round_trips_verified(tmp_path):
    """A fixtures.make_cover_video cover through the port's verified embed
    and the JAX extractor."""
    fixtures.make_cover_video(tmp_path / "c.mp4", 64, 48, frames=6, seed=3)
    fixtures.make_secret_image(tmp_path / "s.png", 10, 11, kind="noise",
                               seed=4)
    priv, pub = jcrypto.setup_receiver_keys(tmp_path / "k.pem",
                                            tmp_path / "p.pem")
    res = embed_image_in_video(tmp_path / "c.mp4", tmp_path / "s.png",
                               tmp_path / "st", pub,
                               StegoConfig(verified_embed=True),
                               batch_frames=2, device="cpu")
    assert res.success and res.residual_bits == 0
    out = j_extract(res.output_path, priv, JConfig(), batch_frames=2)
    assert out.success and out.hash_ok, out.error
    np.testing.assert_array_equal(out.pixels, load_image_gray(tmp_path / "s.png"))

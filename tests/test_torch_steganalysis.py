"""The port's steganalysis (stegotpu_torch.steganalysis) against the JAX
package's, on the same frames.

Stego videos are embedded by the port on the CPU (the kernels' plain
versions), and each video's frames are read once and handed to both
packages' detectors, so any difference is the detectors'. The cases are
those of tests/test_steganalysis.py; each must give the JAX package's
verdict, best delta and num_ac estimate.

Tolerance of the raw scores: both compute the 64 block coefficients in
f32 (XLA at Precision.HIGHEST, torch.matmul without TF32), summed in
another order, so a coefficient may land on the other side of a
threshold, |y| > 0.75*delta or |y - q*delta| < eps*delta, only where its
float64 value lies within NEAR (a few f32 ulps of |y| <= 2040) of it.
Counts and lattice hits may differ by at most the number of such
coefficients; on these inputs they are equal.
"""

import numpy as np
import pytest
import torch

from stegotpu import steganalysis as jsa
from stegotpu_torch import crypto, fixtures
from stegotpu_torch import steganalysis as tsa
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.ops.dct import kron_dct_matrix
from stegotpu_torch.pipeline import (embed_image_in_video,
                                     extract_image_from_video)

CPU = torch.device("cpu")
NEAR = 1e-3


def _embed(d, cover, secret, cfg, name="st", **kw):
    _, pub_c = crypto.setup_receiver_keys(d / f"{name}k.pem",
                                          d / f"{name}p.pem")
    res = embed_image_in_video(cover, secret, d / name, pub_c, cfg,
                               device=CPU, **kw)
    assert res.success
    return res.output_path


@pytest.fixture(scope="module")
def stego_and_clean(tmp_path_factory):
    d = tmp_path_factory.mktemp("steg")
    fixtures.make_secret_image(d / "s.png", 48, 48, kind="noise", seed=5)
    fixtures.make_cover_video(d / "clean.mp4", 320, 240, frames=6,
                              kind="noise", seed=11)
    stego = _embed(d, d / "clean.mp4", d / "s.png",
                   StegoConfig(delta=20, num_ac_coeffs=10))
    return d / "clean.mp4", stego


def _both(frames, **kw):
    """(port report, JAX report) of analyze_frames on the same frames; the
    verdict, the best delta and the candidate grid must agree."""
    t = tsa.analyze_frames(frames, device=CPU, **kw)
    j = jsa.analyze_frames(frames, **kw)
    assert (t.verdict, t.best_delta) == (j.verdict, j.best_delta)
    np.testing.assert_array_equal(t.deltas, j.deltas)
    np.testing.assert_allclose(t.scores, j.scores, atol=1e-6)
    assert t.background == pytest.approx(j.background, abs=1e-6)
    assert t.detection_ratio == pytest.approx(j.detection_ratio, rel=1e-5)
    return t, j


def _near_thresholds(frames, delta, eps, slots):
    """Per frame, the float64 coefficients of `slots` that lie within NEAR
    of the informative threshold or of the eps lattice band."""
    b = frames.shape[0]
    x = frames.astype(np.float64).reshape(b, frames.shape[1] // 8, 8,
                                          frames.shape[2] // 8, 8)
    xb = x.transpose(0, 1, 3, 2, 4).reshape(b, -1, 64)
    y = (xb @ kron_dct_matrix(8, np.float64).T)[..., slots]
    dist = np.abs(y - np.round(y / delta) * delta) / delta
    near = (np.abs(np.abs(y) - 0.75 * delta) <= NEAR) | (
        np.abs(dist - eps) * delta <= NEAR)
    return near.reshape(b, -1)


@pytest.mark.parametrize("which", ["stego", "clean"])
@pytest.mark.parametrize("eps", [0.08, 0.02])
def test_lattice_scores_match_jax(stego_and_clean, which, eps):
    clean, stego = stego_and_clean
    frames = tsa.read_gray_frames(stego if which == "stego" else clean, 3)
    deltas = np.array([6, 10, 19, 20, 21, 40, 80, 100], np.float32)
    s_t, c_t = tsa.lattice_scores(torch.from_numpy(frames),
                                  torch.from_numpy(deltas), 10, eps=eps)
    s_j, c_j = jsa.lattice_scores(frames, deltas, 10, eps=eps)
    s_t, c_t = s_t.numpy(), c_t.numpy()
    s_j, c_j = np.asarray(s_j), np.asarray(c_j)
    assert s_t.shape == c_t.shape == (deltas.size, frames.shape[0])
    for k, delta in enumerate(deltas):
        slack = _near_thresholds(frames, delta, eps, slice(1, 11)).sum(-1)
        assert (np.abs(c_t[k] - c_j[k]) <= slack).all()
        hits_t, hits_j = s_t[k] * np.maximum(c_t[k], 1), s_j[k] * np.maximum(
            c_j[k], 1)
        assert (np.abs(hits_t - hits_j) <= slack + 1e-3).all()
    np.testing.assert_array_equal(c_t, c_j)  # on these inputs: equal
    np.testing.assert_allclose(s_t, s_j, atol=1e-6)


def test_lattice_scores_in_chunks_equal_one_pass(stego_and_clean, monkeypatch):
    """Candidates taken 3 at a time (the last chunk short) give exactly the
    scores and counts of one pass over the whole grid."""
    _, stego = stego_and_clean
    frames = torch.from_numpy(tsa.read_gray_frames(stego, 2))
    deltas = torch.arange(6, 101, dtype=torch.float32)
    whole = tsa.lattice_scores(frames, deltas, 10)
    slots = frames.shape[0] * (frames[0].numel() // 64) * 10
    monkeypatch.setattr(tsa, "_CHUNK_ELEMS", 3 * slots)
    for got, want in zip(tsa.lattice_scores(frames, deltas, 10), whole):
        assert torch.equal(got, want)


@pytest.mark.parametrize("delta", [20.0, 13.0])
def test_per_slot_scores_match_jax(stego_and_clean, delta):
    _, stego = stego_and_clean
    frames = tsa.read_gray_frames(stego, 3)
    s_t, c_t = tsa._per_slot_scores(torch.from_numpy(frames), delta)
    s_j, c_j = jsa._per_slot_scores(frames, np.float32(delta))
    assert s_t.shape == (frames.shape[0], 64)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)


def test_detects_stego_at_true_delta(stego_and_clean):
    _, stego = stego_and_clean
    t, _ = _both(tsa.read_gray_frames(stego, 2))
    assert t.detected and t.best_delta == 20 and t.detection_ratio > 3.0


def test_clean_video_not_flagged(stego_and_clean):
    clean, _ = stego_and_clean
    t, _ = _both(tsa.read_gray_frames(clean, 2))
    assert not t.detected and t.detection_ratio < 3.0


def test_detects_high_delta_stego(tmp_path):
    fixtures.make_secret_image(tmp_path / "s.png", 32, 32, kind="noise", seed=7)
    fixtures.make_cover_video(tmp_path / "c.mp4", 320, 240, frames=4,
                              kind="noise", seed=13)
    stego = _embed(tmp_path, tmp_path / "c.mp4", tmp_path / "s.png",
                   StegoConfig(delta=80, num_ac_coeffs=10))
    t, _ = _both(tsa.read_gray_frames(stego, 2))
    assert t.detected and t.best_delta == 80


def test_analyze_frames_direct():
    frames = np.random.default_rng(0).integers(40, 216, (2, 64, 64),
                                               dtype=np.uint8)
    t, _ = _both(frames)
    assert t.scores.shape == t.deltas.shape and not t.detected


@pytest.mark.parametrize("n_true", [3, 10])
def test_estimate_num_ac_recovers_parameter(tmp_path, n_true):
    fixtures.make_secret_image(tmp_path / "s.png", 40, 40, kind="noise", seed=2)
    fixtures.make_cover_video(tmp_path / "c.mp4", 320, 240, frames=8,
                              kind="noise", seed=3)
    stego = _embed(tmp_path, tmp_path / "c.mp4", tmp_path / "s.png",
                   StegoConfig(delta=20, num_ac_coeffs=n_true))
    frames = tsa.read_gray_frames(stego, 2)
    got = tsa.estimate_num_ac(frames, 20.0, device=CPU)
    assert got == jsa.estimate_num_ac(frames, 20.0) == n_true
    clean = tsa.read_gray_frames(tmp_path / "c.mp4", 2)
    assert tsa.estimate_num_ac(clean, 20.0, device=CPU) == \
        jsa.estimate_num_ac(clean, 20.0) == 0


@pytest.mark.parametrize("kind,seed", [("noise", 1), ("noise", 2),
                                       ("moving", 1), ("moving", 2)])
def test_clean_covers_not_flagged_across_content(tmp_path, kind, seed):
    fixtures.make_cover_video(tmp_path / "c.mp4", 320, 240, frames=6,
                              kind=kind, seed=seed)
    t, _ = _both(tsa.read_gray_frames(tmp_path / "c.mp4"))
    assert not t.detected, (kind, seed, t.detection_ratio, t.best_score)


def test_detection_robust_to_payload_randomness(tmp_path):
    fixtures.make_secret_image(tmp_path / "s.png", 48, 48, kind="noise", seed=2)
    fixtures.make_cover_video(tmp_path / "c.mp4", 320, 240, frames=6,
                              kind="moving", seed=3)
    for seed in (1, 2):
        stego = _embed(tmp_path, tmp_path / "c.mp4", tmp_path / "s.png",
                       StegoConfig(), name=f"st{seed}",
                       rng=np.random.default_rng(seed))
        t, _ = _both(tsa.read_gray_frames(stego))
        assert t.detected and t.detection_ratio > 4.5, t.detection_ratio


def test_recover_params_with_smaller_true_num_ac(tmp_path):
    """A stego embedded with fewer coefficients than configured: the port's
    recover_params finds delta 20 and num_ac 3, as the JAX package's does on
    the same file, and the retried extract succeeds."""
    fixtures.make_cover_video(tmp_path / "c.mp4", 320, 240, frames=6,
                              kind="noise", seed=11)
    fixtures.make_secret_image(tmp_path / "s.png", 24, 24, kind="noise",
                               seed=12)
    priv, pub_c = crypto.setup_receiver_keys(tmp_path / "k.pem",
                                             tmp_path / "p.pem")
    res = embed_image_in_video(tmp_path / "c.mp4", tmp_path / "s.png",
                               tmp_path / "st", pub_c,
                               StegoConfig(delta=20, num_ac_coeffs=3),
                               batch_frames=4, device=CPU)
    assert res.success
    from stegotpu.config import StegoConfig as JConfig

    new_cfg, msg = tsa.recover_params(res.output_path,
                                      StegoConfig(delta=20, num_ac_coeffs=10),
                                      device=CPU)
    j_cfg, _ = jsa.recover_params(res.output_path,
                                  JConfig(delta=20, num_ac_coeffs=10))
    assert new_cfg is not None, msg
    assert (new_cfg.delta, new_cfg.num_ac_coeffs) == (
        j_cfg.delta, j_cfg.num_ac_coeffs) == (20, 3), msg
    ext = extract_image_from_video(res.output_path, priv, new_cfg, device=CPU)
    assert ext.success and ext.hash_ok
    same, why = tsa.recover_params(res.output_path, new_cfg, device=CPU)
    assert same is None and "SAME parameters" in why

"""The port's evaluation suite (stegotpu_torch.evaluation) against the JAX
package's (stegotpu.evaluation), on fixture videos as in
tests/test_evaluation_video.py.

Per-frame PSNR/SSIM run in f32 on the device in both packages; the
means agree to rtol 1e-5 (sums in another order). Everything computed on
the host (frame counts, first-frame comparisons, capacity) is identical.
"""

import dataclasses

import numpy as np
import pytest

from stegotpu import config as jconfig
from stegotpu import evaluation as jev
from stegotpu import fixtures
from stegotpu_torch import config as tconfig
from stegotpu_torch import evaluation as tev

RTOL = 1e-5


def _assert_video_cmp_equal(t, j):
    assert t.frames == j.frames
    for key in ("mean_psnr", "min_psnr", "mean_ssim"):
        a, b = getattr(t, key), getattr(j, key)
        assert a == b or np.isclose(a, b, rtol=RTOL), (key, a, b)
    assert t.verdict == j.verdict


@pytest.fixture
def videos(tmp_path):
    fixtures.make_cover_video(tmp_path / "a.mp4", 128, 96, frames=7)
    fixtures.make_cover_video(tmp_path / "m.mp4", 128, 96, frames=7,
                              kind="moving")
    fixtures.make_cover_video(tmp_path / "n.mp4", 128, 96, frames=6,
                              kind="noise")
    return tmp_path


@pytest.mark.parametrize("pair,kw", [
    (("a", "a"), {}),
    (("m", "n"), {}),
    (("a", "a"), {"max_frames": 4}),
    (("a", "m"), {"batch_frames": 3}),   # a short tail batch
    (("m", "n"), {"batch_frames": 4, "max_frames": 5}),
], ids=["identical", "different", "max_frames", "tail_batch", "tail_and_max"])
def test_compare_videos_matches_jax(videos, pair, kw):
    a, b = (videos / f"{p}.mp4" for p in pair)
    t = tev.compare_videos(a, b, device="cpu", **kw)
    _assert_video_cmp_equal(t, jev.compare_videos(a, b, **kw))
    if pair == ("a", "a"):
        assert t.mean_ssim > 0.999
    if pair == ("m", "n"):
        assert t.frames == kw.get("max_frames", 6) and t.verdict == "POOR"


def test_compare_videos_refuses_an_empty_comparison(videos):
    with pytest.raises(IOError):
        tev.compare_videos(videos / "a.mp4", videos / "a.mp4", max_frames=-1,
                           device="cpu")


@pytest.mark.parametrize("kw", [{}, {"num_ac_coeffs": 3},
                                {"dims_bits": 12, "delta": 8}])
def test_capacity_report_matches_jax(videos, kw):
    t = tev.capacity_report(videos / "m.mp4", tconfig.StegoConfig(**kw))
    j = jev.capacity_report(videos / "m.mp4", jconfig.StegoConfig(**kw))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.qim_bits_per_frame == (96 // 8) * (128 // 8) * \
        kw.get("num_ac_coeffs", 10)


def test_evaluate_stego_result_matches_jax(videos, tmp_path):
    fixtures.make_secret_image(tmp_path / "s.png", 40, 24, "pattern", 1)
    fixtures.make_secret_image(tmp_path / "x.png", 40, 24, "noise", 2)
    fixtures.make_secret_image(tmp_path / "small.png", 20, 12, "pattern", 1)
    for img in ("s.png", "x.png", "small.png"):
        t = tev.evaluate_stego_result(videos / "a.mp4", videos / "m.mp4",
                                      tmp_path / "s.png", tmp_path / img,
                                      dump_frames_dir=tmp_path / "dump")
        j = jev.evaluate_stego_result(videos / "a.mp4", videos / "m.mp4",
                                      tmp_path / "s.png", tmp_path / img)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (tmp_path / "dump" / "frame_stego.png").is_file()
    t = tev.evaluate_stego_result(videos / "a.mp4", videos / "a.mp4")
    assert t.image is None and t.video.ssim == 1.0 and t.video.verdict == "GOOD"
    assert t.frames_per_video == (7, 7)


@pytest.mark.parametrize("psnr_db", [float("inf"), 45.0, 30.0001, 30.0, 20.5,
                                     20.0, 3.0])
def test_quality_verdict_matches_jax(psnr_db):
    assert tev.quality_verdict(psnr_db) == jev.quality_verdict(psnr_db)
    assert tev.FrameComparison(psnr_db, 0.5).verdict == \
        jev.FrameComparison(psnr_db, 0.5).verdict


def test_host_helpers_match_jax():
    assert tev.security_summary() == jev.security_summary()
    t = tev.measure_crypto_timings(payload_bytes=64, repeats=1)
    assert t.payload_bytes == 64 and t.keygen_ms > 0

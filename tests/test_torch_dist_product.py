"""The port's multi-process PRODUCT path, case for case against
tests/test_dist_product.py: cooperative dist-embed / dist-extract through
the port's CLI across 2 processes (torch.distributed + Gloo, `--device
cpu`), segment stitch by native packet concat. The payload deliberately
spans the segment boundary, and the stitched stego must be the
single-process embed's frame for frame with the same deterministic crypto
stream, and decode pixel-identically in the port and in the JAX package.
segment_bounds is held to the JAX package's over a grid.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from stegotpu import crypto as jcrypto
from stegotpu.config import StegoConfig as JConfig
from stegotpu.parallel.dist_pipeline import segment_bounds as j_bounds
from stegotpu.pipeline import extract_image_from_video as j_extract
from stegotpu_torch import crypto, fixtures
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.image import load_image_gray
from stegotpu_torch.native import videoio
from stegotpu_torch.parallel.dist_pipeline import segment_bounds
from stegotpu_torch.pipeline import embed_image_in_video, extract_image_from_video

REPO = Path(__file__).resolve().parent.parent

needs_concat = pytest.mark.skipif(
    not videoio.available(), reason="native concat needs the native lib")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(cmd_args, pid, nproc, port, host_devices):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    extra = ["--host-devices", str(host_devices)] if host_devices else []
    return subprocess.Popen(
        [sys.executable, "-m", "stegotpu_torch.cli", "--device", "cpu",
         *extra, *cmd_args, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(nproc), "--process-id", str(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _run_all(cmd_args, nproc=2, host_devices=None):
    port = _free_port()
    procs = [_spawn(cmd_args, pid, nproc, port, host_devices)
             for pid in range(nproc)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
    return outs


def _decode_all(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


def _jax_reads(path, key, secret):
    ext = j_extract(path, jcrypto.load_private_pem(key), JConfig())
    assert ext.success and ext.hash_ok, ext.error
    np.testing.assert_array_equal(ext.pixels, load_image_gray(secret))


@needs_concat
def test_dist_embed_extract_two_processes(tmp_path):
    d = tmp_path
    # payload spans the segment boundary: 12 frames, batch 4 -> rank 0 owns
    # [0, 8), rank 1 [8, 12); a 56x56 secret needs ~9 frames at 128x160
    fixtures.make_secret_image(d / "s.png", 56, 56, kind="noise", seed=3)
    fixtures.make_cover_video(d / "c.mp4", 160, 128, frames=12,
                              kind="moving", seed=4)
    priv, pub_c = crypto.setup_receiver_keys(d / "k.pem", d / "p.pem")

    outs = _run_all([
        "dist-embed", str(d / "c.mp4"), str(d / "s.png"), str(d / "st"),
        "--public-key", str(d / "p.pem"), "--seed", "5", "--batch", "4",
    ])
    assert any("embedded" in o and "2 hosts" in o for o in outs), outs
    stego = d / "st.avi"
    assert stego.exists()
    assert not list(d.glob("*.seg*.avi"))  # segments cleaned up

    # frame for frame the single-process embed with the same crypto seed
    res1 = embed_image_in_video(d / "c.mp4", d / "s.png", d / "st_one", pub_c,
                                StegoConfig(), batch_frames=4,
                                rng=np.random.default_rng(5), device="cpu")
    assert res1.success
    np.testing.assert_array_equal(_decode_all(stego),
                                  _decode_all(res1.output_path))

    # single-process extract of the stitched file, in the port and in JAX
    ext = extract_image_from_video(stego, priv, StegoConfig(), device="cpu")
    assert ext.success and ext.hash_ok
    np.testing.assert_array_equal(ext.pixels, load_image_gray(d / "s.png"))
    _jax_reads(stego, d / "k.pem", d / "s.png")

    # cooperative 2-process extract: both ranks agree, rank 0 writes
    outs = _run_all([
        "dist-extract", str(stego), str(d / "out.png"),
        "--private-key", str(d / "k.pem"), "--batch", "4",
    ])
    assert "SHA3-256 integrity: OK" in outs[0], outs
    assert "SHA3-256" not in outs[1], outs
    np.testing.assert_array_equal(load_image_gray(d / "out.png"),
                                  load_image_gray(d / "s.png"))


def test_segment_bounds():
    assert segment_bounds(12, 2, 4) == [(0, 8), (8, None)]
    assert segment_bounds(64, 4, 8) == [(0, 16), (16, 32), (32, 48), (48, None)]
    # more processes than batches: trailing processes idle (lo == frame_count)
    assert segment_bounds(4, 3, 4) == [(0, 4), (4, 4), (4, None)]
    with pytest.raises(ValueError) as got:
        segment_bounds(0, 2, 4)
    with pytest.raises(ValueError) as want:
        j_bounds(0, 2, 4)
    assert str(got.value) == str(want.value)


@needs_concat
def test_dist_embed_with_per_host_mesh_and_hfyu(tmp_path):
    """The full hierarchy: frame-range segments across 2 processes x a
    ('data','space') mesh over each process's 4 CPU devices — with the HFYU
    codec exercising the packet concat on a second codec. Output must
    extract single-process, pixel-identically."""
    d = tmp_path
    fixtures.make_secret_image(d / "s.png", 56, 56, kind="noise", seed=3)
    fixtures.make_cover_video(d / "c.mp4", 160, 128, frames=12,
                              kind="moving", seed=4)
    priv, pub_c = crypto.setup_receiver_keys(d / "k.pem", d / "p.pem")

    _run_all([
        "dist-embed", str(d / "c.mp4"), str(d / "s.png"), str(d / "st"),
        "--public-key", str(d / "p.pem"), "--seed", "5", "--batch", "4",
        "--codec", "HFYU", "--mesh", "data=2,space=2",
    ], host_devices=4)

    ext = extract_image_from_video(d / "st.avi", priv, StegoConfig(),
                                   device="cpu")
    assert ext.success and ext.hash_ok, ext.error
    np.testing.assert_array_equal(ext.pixels, load_image_gray(d / "s.png"))
    _jax_reads(d / "st.avi", d / "k.pem", d / "s.png")

    # and the cooperative extract with its own per-process mesh
    _run_all([
        "dist-extract", str(d / "st.avi"), str(d / "out.png"),
        "--private-key", str(d / "k.pem"), "--batch", "4",
        "--mesh", "data=2,space=2",
    ], host_devices=4)
    np.testing.assert_array_equal(load_image_gray(d / "out.png"),
                                  load_image_gray(d / "s.png"))


@needs_concat
def test_dist_embed_mesh_batch_rounding(tmp_path):
    """Regression: a mesh data axis that does not divide --batch rounds the
    batch UP inside the pipeline; segment bounds must be computed with the
    ROUNDED batch or batches straddle segment boundaries and frames
    duplicate in the stitched output (extraction garbage)."""
    d = tmp_path
    fixtures.make_secret_image(d / "s.png", 64, 64, kind="noise", seed=3)
    fixtures.make_cover_video(d / "c.mp4", 160, 128, frames=20,
                              kind="moving", seed=4)
    priv, pub_c = crypto.setup_receiver_keys(d / "k.pem", d / "p.pem")

    _run_all([
        "dist-embed", str(d / "c.mp4"), str(d / "s.png"), str(d / "st"),
        "--public-key", str(d / "p.pem"), "--seed", "5", "--batch", "8",
        "--mesh", "data=3",  # 3 does not divide 8 -> batch rounds to 9
    ], host_devices=4)

    frames = _decode_all(d / "st.avi")
    assert frames.shape[0] == 20  # no duplicated boundary frames
    ext = extract_image_from_video(d / "st.avi", priv, StegoConfig(),
                                   device="cpu")
    assert ext.success and ext.hash_ok, ext.error
    np.testing.assert_array_equal(ext.pixels, load_image_gray(d / "s.png"))


@needs_concat
def test_dist_extract_payload_spans_both_segments(tmp_path):
    """Tiny-capacity cover (64x64, 640 bits/frame): the payload needs ~5 of
    8 frames, so the demand-driven extract rounds must pull bits from BOTH
    processes' segments ((0,4) and (4,EOF) at batch 2) before the parse
    completes."""
    d = tmp_path
    fixtures.make_secret_image(d / "s.png", 16, 16, kind="noise", seed=7)
    fixtures.make_cover_video(d / "c.mp4", 64, 64, frames=8,
                              kind="moving", seed=8)
    priv, pub_c = crypto.setup_receiver_keys(d / "k.pem", d / "p.pem")

    outs = _run_all([
        "dist-embed", str(d / "c.mp4"), str(d / "s.png"), str(d / "st"),
        "--public-key", str(d / "p.pem"), "--seed", "9", "--batch", "2",
    ])
    assert any("embedded" in o for o in outs), outs

    outs = _run_all([
        "dist-extract", str(d / "st.avi"), str(d / "out.png"),
        "--private-key", str(d / "k.pem"), "--batch", "2",
    ])
    assert any("SHA3-256 integrity: OK" in o for o in outs), outs
    np.testing.assert_array_equal(load_image_gray(d / "out.png"),
                                  load_image_gray(d / "s.png"))


def test_segment_bounds_properties_exhaustive():
    """Invariants over the whole small parameter space, and the JAX
    package's bounds at every point: segments are disjoint, ordered, cover
    [0, frame_count), interior cuts align to batch_frames, and only the
    last segment is open-ended."""
    for frame_count in range(1, 41):
        for nproc in range(1, 5):
            for batch in range(1, 9):
                bounds = segment_bounds(frame_count, nproc, batch)
                assert bounds == j_bounds(frame_count, nproc, batch)
                assert len(bounds) == nproc
                prev_hi = 0
                for i, (lo, hi) in enumerate(bounds):
                    assert lo == prev_hi  # contiguous, ordered
                    assert lo % batch == 0 or lo == frame_count
                    if i == nproc - 1:
                        assert hi is None
                        prev_hi = frame_count
                    else:
                        assert hi is not None and hi >= lo
                        assert hi % batch == 0 or hi == frame_count
                        prev_hi = hi
                assert prev_hi == frame_count  # full coverage


@pytest.fixture
def one_process_group():
    """A Gloo group of one process, this one."""
    import torch.distributed as dist

    from stegotpu_torch.parallel.distributed import initialize

    initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    yield
    dist.destroy_process_group()


def test_dist_embed_without_concat_fails_in_preflight(tmp_path, monkeypatch,
                                                      one_process_group):
    """Where the native concat layer is missing (the card's machine), rank
    0 fails dist-embed in its preflight with an OSError naming the layer,
    before any segment is written; dist-extract needs no concat and reads
    a plain embed's stego."""
    from stegotpu_torch.parallel import dist_pipeline

    d = tmp_path
    fixtures.make_secret_image(d / "s.png", 16, 16, kind="noise", seed=7)
    fixtures.make_cover_video(d / "c.mp4", 64, 64, frames=8, kind="moving",
                              seed=8)
    priv, pub_c = crypto.setup_receiver_keys(d / "k.pem", d / "p.pem")
    monkeypatch.setattr(videoio, "available", lambda: False)
    with pytest.raises(OSError, match="dist-embed needs the native concat"):
        dist_pipeline.distributed_embed(d / "c.mp4", d / "s.png", d / "st",
                                        pub_c, StegoConfig(), batch_frames=2,
                                        device="cpu")
    assert sorted(p.name for p in d.iterdir()) == ["c.mp4", "k.pem",
                                                   "p.pem", "s.png"]
    assert embed_image_in_video(d / "c.mp4", d / "s.png", d / "st", pub_c,
                                StegoConfig(), batch_frames=2,
                                device="cpu").success
    res = dist_pipeline.distributed_extract(d / "st.avi", priv,
                                            StegoConfig(), d / "out.png",
                                            batch_frames=2, device="cpu")
    assert res.success and res.hash_ok and res.frames_read > 0
    np.testing.assert_array_equal(load_image_gray(d / "out.png"),
                                  load_image_gray(d / "s.png"))

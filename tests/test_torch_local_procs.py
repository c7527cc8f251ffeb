"""The port's single-host segment-parallel path (`--procs N`,
stegotpu_torch.parallel.local_procs), case for case against
tests/test_local_procs.py, on the CPU (`--device cpu`): exact container
seek, parallel embed/extract against the single-pipeline run, thread and
spawn workers, and the CLI wiring. Like the JAX file, the cases that stitch
segments skip without the native layer (its packet concat).

Stego files are compared byte for byte: an FFV1 `--procs N` file equals
the `--procs 1` file of the same sealed payload in every byte but the AVI
main header's dwMaxBytesPerSec (bytes 36-39), a rate the muxer estimates
from what it wrote — as in the JAX package; thread and spawn files are
equal in every byte. Under the other codecs, as in the JAX file, the
decoded frames are compared (a raw RGBA stitch lays out its index
differently).
"""

from pathlib import Path

import numpy as np
import pytest

from stegotpu_torch import crypto, fixtures
from stegotpu_torch.cli import main
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.image import load_image_gray
from stegotpu_torch.native.videoio import available
from stegotpu_torch.video import VideoReader, VideoWriter

CPU = ["--device", "cpu"]
MAX_BYTES_PER_SEC = slice(36, 40)  # avih.dwMaxBytesPerSec


def cli(*argv) -> int:
    return main([*CPU, *argv])


def _same_stream(a, b) -> None:
    """Byte-identical AVI files but for the muxer's rate estimate."""
    x, y = bytearray(Path(a).read_bytes()), bytearray(Path(b).read_bytes())
    assert len(x) == len(y)
    x[MAX_BYTES_PER_SEC] = y[MAX_BYTES_PER_SEC] = b"\0" * 4
    assert x == y


@pytest.mark.parametrize("backend", ["native", "cv2"])
@pytest.mark.parametrize("container", ["mp4", "avi"])
def test_seek_exact(tmp_path, backend, container):
    """VideoReader.seek positions EXACTLY on inter-coded (mp4) and
    intra-only (FFV1 avi) containers, including past-EOF."""
    if backend == "native" and not available():
        pytest.skip("native layer not built")
    n = 14
    if container == "mp4":
        path = tmp_path / "c.mp4"
        fixtures.make_cover_video(path, 160, 128, frames=n, kind="moving",
                                  seed=3)
    else:
        path = tmp_path / "c.avi"
        rng = np.random.default_rng(1)
        frames = rng.integers(0, 256, (n, 64, 96), np.uint8)
        with VideoWriter(path, 24.0, 96, 64, "FFV1") as w:
            w.write_gray_batch(frames)

    with VideoReader(path, backend=backend) as r:
        seq = np.concatenate(list(r.batches(4, mode="gray")))
    for k in (0, 3, 7, n - 1, n + 5):
        with VideoReader(path, backend=backend) as r:
            r.seek(k)
            got = list(r.batches(4, mode="gray"))
            flat = (np.concatenate(got) if got
                    else np.zeros((0,) + seq.shape[1:], np.uint8))
        assert flat.shape[0] == max(0, n - k), (k, flat.shape)
        np.testing.assert_array_equal(flat, seq[k:], err_msg=str(k))


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli("genkey") == 0
    fixtures.make_secret_image("s.png", 96, 96, kind="noise", seed=21)
    fixtures.make_cover_video("c.mp4", 320, 240, frames=24, kind="moving",
                              seed=22)
    return tmp_path


def _frames_of(p):
    import cv2

    cap = cv2.VideoCapture(str(p))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return np.stack(out)


@pytest.mark.skipif(not available(), reason="native layer not built")
def test_procs_embed_pixel_identical_and_extract(workdir, capsys):
    """`embed --procs 3` output is pixel-identical to the single-pipeline
    run of the same sealed payload (and byte-identical but for the rate
    estimate), and both plain and `--procs 2` extract recover the secret
    exactly."""
    assert cli("embed", "c.mp4", "s.png", "one", "--payload-state", "p",
               "--batch", "4") == 0
    assert cli("embed", "c.mp4", "s.png", "par", "--payload-state", "p",
               "--batch", "4", "--procs", "3") == 0
    capsys.readouterr()
    np.testing.assert_array_equal(_frames_of("one.avi"), _frames_of("par.avi"))
    _same_stream("one.avi", "par.avi")

    assert cli("extract", "par.avi", "x1.png") == 0
    assert cli("extract", "par.avi", "x2.png", "--procs", "2") == 0
    secret = load_image_gray("s.png")
    np.testing.assert_array_equal(load_image_gray("x1.png"), secret)
    np.testing.assert_array_equal(load_image_gray("x2.png"), secret)


@pytest.mark.skipif(not available(), reason="native layer not built")
def test_procs_more_workers_than_segments(workdir, capsys):
    """procs > payload segments: idle workers are skipped, result intact."""
    from stegotpu_torch.parallel.local_procs import (parallel_embed,
                                                     parallel_extract)

    pub = crypto.serialize_public_compressed(
        crypto.load_public_pem("bob_public_key.pem"))
    priv = crypto.load_private_pem("bob_private_key.pem")
    cfg = StegoConfig()
    rng = np.random.default_rng(9)
    res = parallel_embed("c.mp4", "s.png", "many", pub, cfg, batch_frames=4,
                         procs=16, rng=rng, device="cpu")
    assert res.success and res.frames_used == 24
    ext = parallel_extract("many.avi", priv, cfg, "xm.png", batch_frames=4,
                           procs=16, device="cpu")
    assert ext.success and ext.hash_ok, ext.error
    np.testing.assert_array_equal(load_image_gray("xm.png"),
                                  load_image_gray("s.png"))


@pytest.mark.skipif(not available(), reason="native layer not built")
def test_procs_extract_structured_failures(workdir, capsys):
    """parallel_extract keeps the structured-error contract: truncated
    payload region and non-stego inputs fail with .error, no exception."""
    from stegotpu_torch.parallel.local_procs import parallel_extract

    assert cli("embed", "c.mp4", "s.png", "st", "--batch", "4") == 0
    capsys.readouterr()
    priv = crypto.load_private_pem("bob_private_key.pem")

    # truncate inside the payload region
    raw = (workdir / "st.avi").read_bytes()
    (workdir / "cut.avi").write_bytes(raw[: len(raw) // 3])
    res = parallel_extract("cut.avi", priv, StegoConfig(), procs=2,
                           device="cpu")
    assert not res.success and res.error

    # non-stego: noise bits never yield a usable header
    res = parallel_extract("c.mp4", priv, StegoConfig(), procs=2,
                           device="cpu")
    assert not res.success and res.error


def test_procs_flag_conflicts(workdir, capsys):
    assert cli("embed", "c.mp4", "s.png", "o", "--procs", "2",
               "--frame-range", "0:8") == 1
    assert "--frame-range" in capsys.readouterr().err
    assert cli("embed", "c.mp4", "s.png", "o", "--procs", "2",
               "--mesh", "data=2") == 1
    assert "--mesh" in capsys.readouterr().err
    assert cli("extract", "x.avi", "o.png", "--procs", "2",
               "--mesh", "data=2") == 1
    assert "--mesh" in capsys.readouterr().err


@pytest.mark.skipif(not available(), reason="native layer not built")
def test_native_seek_sequence_fuzz(tmp_path):
    """Random seek/read sequences on the native reader (incl. BACKWARD
    seeks, which the C layer supports) always deliver the absolutely-
    indexed frames — differential vs a full sequential decode."""
    n = 17
    path = tmp_path / "c.mp4"
    fixtures.make_cover_video(path, 160, 128, frames=n, kind="moving",
                              seed=61)
    with VideoReader(path, backend="native") as ref:
        oracle = [ref.read_frame() for _ in range(n)]

    rng = np.random.default_rng(62)
    with VideoReader(path, backend="native") as r:
        pos = 0
        for _ in range(24):
            if rng.random() < 0.5:
                pos = int(rng.integers(0, n + 3))
                r.seek(pos)
            else:
                got = r.read_frame()
                if pos >= n:
                    assert got is None, pos
                else:
                    np.testing.assert_array_equal(got, oracle[pos],
                                                  err_msg=f"pos={pos}")
                    pos += 1


@pytest.mark.skipif(not available(), reason="native layer not built")
@pytest.mark.parametrize("codec", ["HFYU", "RGBA"])
def test_procs_embed_non_default_codecs(workdir, capsys, codec):
    """Packet concat is codec-general: --procs output matches --procs 1
    under HFYU and raw too."""
    assert cli("embed", "c.mp4", "s.png", f"one_{codec}",
               "--payload-state", f"p{codec}", "--batch", "4",
               "--codec", codec) == 0
    assert cli("embed", "c.mp4", "s.png", f"par_{codec}",
               "--payload-state", f"p{codec}", "--batch", "4",
               "--codec", codec, "--procs", "2") == 0
    capsys.readouterr()
    np.testing.assert_array_equal(_frames_of(f"one_{codec}.avi"),
                                  _frames_of(f"par_{codec}.avi"))
    assert cli("extract", f"par_{codec}.avi", f"x_{codec}.png") == 0
    np.testing.assert_array_equal(load_image_gray(f"x_{codec}.png"),
                                  load_image_gray("s.png"))


@pytest.mark.skipif(not available(), reason="native layer not built")
def test_embed_data_procs_roundtrip(workdir, capsys):
    """`embed-data --procs 2`: raw-bytes payloads ride the segment-parallel
    path too, and extraction recovers the exact bytes."""
    blob = bytes(np.random.default_rng(77).integers(0, 256, 5000,
                                                    dtype=np.uint8))
    (workdir / "blob.bin").write_bytes(blob)
    assert cli("embed-data", "c.mp4", "blob.bin", "db", "--batch", "4",
               "--procs", "2") == 0
    assert cli("extract", "db.avi", "out.bin") == 0
    capsys.readouterr()
    assert (workdir / "out.bin").read_bytes() == blob


@pytest.mark.skipif(not available(), reason="native layer not built")
def test_procs_with_verified_embed(workdir, capsys):
    """--procs composes with --verified: each segment runs the closed-loop
    repair; the stitched result extracts exactly."""
    assert cli("embed", "c.mp4", "s.png", "pv", "--batch", "4",
               "--procs", "2", "--verified") == 0
    assert cli("extract", "pv.avi", "xv.png") == 0
    capsys.readouterr()
    np.testing.assert_array_equal(load_image_gray("xv.png"),
                                  load_image_gray("s.png"))


def test_resolve_procs_auto(monkeypatch):
    """'auto' = min(effective host cores, batch-aligned segments), as the
    JAX package resolves it."""
    import stegotpu.video as jvideo
    from stegotpu.parallel import local_procs as jlocal

    import stegotpu_torch.video as video
    from stegotpu_torch.parallel import local_procs

    cases = [("auto", 24, 8), ("auto", 640, 8), ("auto", 4, 8), (2, 4, 8),
             ("auto", 0, 8), (None, 640, 8)]
    for cores in (4, 1):
        monkeypatch.setattr(video, "effective_cpu_count", lambda: cores)
        monkeypatch.setattr(jvideo, "effective_cpu_count", lambda: cores)
        for case in cases:
            assert local_procs.resolve_procs(*case) == \
                jlocal.resolve_procs(*case), (cores, case)
    monkeypatch.setattr(video, "effective_cpu_count", lambda: 4)
    assert local_procs.resolve_procs("auto", 24, 8) == 3   # 3 segments
    assert local_procs.resolve_procs("auto", 640, 8) == 4  # core-bound
    assert local_procs.resolve_procs("auto", 4, 8) == 1    # one segment
    assert local_procs.resolve_procs(2, 4, 8) == 2         # explicit N wins
    monkeypatch.setattr(video, "effective_cpu_count", lambda: 1)
    assert local_procs.resolve_procs("auto", 640, 8) == 1


@pytest.mark.skipif(not available(), reason="native layer not built")
def test_procs_auto_on_one_core_falls_back_to_plain(workdir, monkeypatch,
                                                     capsys):
    """`--procs auto` on a 1-core host resolves to the plain pipeline and
    still round-trips."""
    import stegotpu_torch.video as video

    monkeypatch.setattr(video, "effective_cpu_count", lambda: 1)
    assert cli("embed", "c.mp4", "s.png", "auto_out", "--batch", "4",
               "--procs", "auto") == 0
    assert cli("extract", "auto_out.avi", "xa.png", "--procs", "auto") == 0
    np.testing.assert_array_equal(load_image_gray("xa.png"),
                                  load_image_gray("s.png"))


@pytest.mark.skipif(not available(), reason="native layer not built")
def test_procs_spawn_mode_byte_identity(workdir, capsys):
    """`--procs-mode spawn` (OS-process workers computing on the CPU)
    produces a byte-identical container to the thread-mode run of the same
    sealed payload, both equal the single pipeline's file but for the rate
    estimate, and extraction with spawn workers recovers the secret."""
    from stegotpu_torch.pipeline import embed_image_in_video
    from stegotpu_torch import payload as payload_mod
    from stegotpu_torch.bitstream import bits_to_bytes
    from stegotpu_torch.image import image_to_bits
    from stegotpu_torch.parallel.local_procs import (parallel_embed,
                                                     parallel_extract)

    priv = crypto.load_private_pem("bob_private_key.pem")
    pub = crypto.serialize_public_compressed(
        crypto.load_public_pem("bob_public_key.pem"))
    cfg = StegoConfig(delta=20, num_ac_coeffs=10)
    w, h, bits = image_to_bits("s.png")
    sealed, _ = payload_mod.seal_payload(bits_to_bytes(bits), w, h, pub,
                                         rng=np.random.default_rng(7))
    r1 = parallel_embed("c.mp4", "s.png", "thr", pub, cfg, batch_frames=4,
                        procs=2, sealed_bits=sealed, mode="thread",
                        device="cpu")
    assert r1.success
    r2 = parallel_embed("c.mp4", "s.png", "spn", pub, cfg, batch_frames=4,
                        procs=2, sealed_bits=sealed, mode="spawn",
                        device="cpu")
    assert r2.success
    assert Path("thr.avi").read_bytes() == Path("spn.avi").read_bytes()
    assert embed_image_in_video("c.mp4", "s.png", "one", pub, cfg,
                                batch_frames=4, sealed_bits=sealed,
                                device="cpu").success
    _same_stream("one.avi", "spn.avi")

    res = parallel_extract("spn.avi", priv, cfg, procs=2, mode="spawn",
                           device="cpu")
    assert res.success, res.error
    np.testing.assert_array_equal(res.pixels, load_image_gray("s.png"))


def test_procs_auto_falls_back_without_native_layer(workdir, monkeypatch):
    """`--procs auto` resolving to 1 must reach the plain pipeline even
    when the native concat layer is absent (the card's machine has none):
    the availability gate comes AFTER the auto resolution. An explicit
    worker count still demands the layer, with the JAX package's OSError,
    and leaves no segment file behind."""
    from stegotpu_torch.native import videoio
    from stegotpu_torch.parallel import local_procs

    monkeypatch.setattr(videoio, "available", lambda: False)
    monkeypatch.setattr(local_procs, "resolve_procs",
                        lambda procs, fc, bf: 1 if procs == "auto" else
                        int(procs))
    assert cli("embed", "c.mp4", "s.png", "nofb_out", "--batch", "4",
               "--procs", "auto") == 0
    assert cli("extract", "nofb_out.avi", "xnf.png") == 0
    np.testing.assert_array_equal(load_image_gray("xnf.png"),
                                  load_image_gray("s.png"))
    pub = crypto.serialize_public_compressed(
        crypto.load_public_pem("bob_public_key.pem"))
    with pytest.raises(OSError, match="native concat layer"):
        local_procs.parallel_embed("c.mp4", "s.png", "expl", pub,
                                   StegoConfig(), batch_frames=4, procs=2,
                                   device="cpu")
    assert not list(workdir.glob("expl*"))


def test_procs_explicit_without_native_layer_exits_1(workdir, monkeypatch,
                                                     capsys):
    """Through the CLI, an explicit `embed --procs 2` where the concat layer
    failed to build (the card's machine has no FFmpeg headers) exits 1 with
    one line naming it and the compiler's first error, and leaves no
    segment file; `extract --procs 2` needs no concat and still runs."""
    from stegotpu_torch.native import videoio

    gxx = ("/src/videoio.cpp:18:10: fatal error: libavcodec/avcodec.h: No "
           "such file or directory\n   18 | #include <libavcodec/avcodec.h>"
           "\n      |          ^~~~~~~~~~~~~~~~~~~~~~\ncompilation "
           "terminated.\n")
    assert videoio._compiler_error("warning: w\nlast line\n") == "last line"
    assert videoio._compiler_error("") == "g++ failed without output"
    assert cli("embed", "c.mp4", "s.png", "st", "--batch", "4") == 0
    monkeypatch.setattr(videoio, "_load", lambda: None)
    monkeypatch.setattr(videoio, "_build_error", videoio._compiler_error(gxx))
    capsys.readouterr()
    assert cli("embed", "c.mp4", "s.png", "nc", "--batch", "4",
               "--procs", "2") == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert err == ["error: --procs needs the native concat layer (/src/"
                   "videoio.cpp:18:10: fatal error: libavcodec/avcodec.h: "
                   "No such file or directory)"]
    assert not list(workdir.glob("nc*"))
    assert cli("extract", "st.avi", "x.png", "--procs", "2") == 0
    np.testing.assert_array_equal(load_image_gray("x.png"),
                                  load_image_gray("s.png"))


def test_procs_auto_defers_to_plain_with_frame_range(workdir, capsys):
    """`--procs auto --frame-range` runs the plain pipeline (auto means
    "best mode for this invocation") instead of erroring; an explicit
    worker count still conflicts loudly."""
    assert cli("embed", "c.mp4", "s.png", "fr_out", "--batch", "4",
               "--procs", "auto", "--frame-range", "0:24") == 0
    err = capsys.readouterr().err
    assert "defers to the plain pipeline" in err
    assert cli("extract", "fr_out.avi", "xfr.png") == 0
    np.testing.assert_array_equal(load_image_gray("xfr.png"),
                                  load_image_gray("s.png"))

    assert cli("embed", "c.mp4", "s.png", "fr2_out", "--batch", "4",
               "--procs", "2", "--frame-range", "0:24") == 1
    assert "cannot combine" in capsys.readouterr().err


def test_spawn_worker_never_opens_the_card():
    """A spawn worker runs its initializer before any task: CUDA is hidden
    from it, and a segment task on the CPU leaves CUDA uninitialised."""
    import torch

    from stegotpu_torch.parallel.local_procs import _make_pool

    with _make_pool("spawn", 1) as pool:
        assert pool.submit(torch.cuda.is_available).result(timeout=120) \
            is False
        assert pool.submit(torch.cuda.is_initialized).result(timeout=60) \
            is False

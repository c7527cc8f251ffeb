"""The port's file-to-file pipeline against the frozen wire goldens and the
JAX package, on the CPU (device='cpu': the stripe kernels' plain versions).

- Forward: the port extracts ref_stego.avi / ref_stego28.avi (made by the
  real reference embedder) and rev_stego.avi / rev2_stego.avi (accepted by
  the real reference extractor) pixel-identically.
- Reverse: the port's embed with the frozen seeds reproduces the frozen
  stego (tests/test_golden_crossref.py:75-161).
- Both directions against stegotpu on a multi-batch cover whose payload
  stops mid-block.
"""

from pathlib import Path

import numpy as np
import pytest

from stegotpu import crypto as jcrypto
from stegotpu.config import StegoConfig as JConfig
from stegotpu.pipeline import embed_image_in_video as j_embed
from stegotpu.pipeline import extract_image_from_video as j_extract
from stegotpu_torch import crypto
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.image import load_image_gray, save_image_gray
from stegotpu_torch.pipeline import (embed_data_in_video,
                                     embed_image_in_video,
                                     embed_payload_into_gray_frames,
                                     extract_bits_from_gray_frames,
                                     extract_image_from_video)
from stegotpu_torch.video import VideoReader, VideoWriter

GOLDEN = Path(__file__).parent / "golden"


def _decode_all(path):
    with VideoReader(path) as r:
        frames = []
        while True:
            f = r.read_frame()
            if f is None:
                return np.stack(frames)
            frames.append(f)


@pytest.mark.parametrize("stego,key,delta,num_ac,secret,batch", [
    ("ref_stego.avi", "bob_private_key.pem", 20, 10, "secret.png", 4),
    ("ref_stego28.avi", "bob_private_key28.pem", 28, 3, "secret24.png", 3),
    ("rev_stego.avi", "rev_priv.pem", 20, 10, "rev_secret.png", 8),
    ("rev2_stego.avi", "rev2_priv.pem", 20, 10, "rev2_secret.png", 8),
])
@pytest.mark.parametrize("kernel", ["auto", "xla"])
def test_extract_golden_stego(stego, key, delta, num_ac, secret, batch,
                              kernel):
    priv = crypto.load_private_pem(GOLDEN / key)
    res = extract_image_from_video(
        GOLDEN / stego, priv,
        StegoConfig(delta=delta, num_ac_coeffs=num_ac, kernel=kernel),
        batch_frames=batch, device="cpu")
    assert res.success, res.error
    assert res.hash_ok
    np.testing.assert_array_equal(res.pixels, load_image_gray(GOLDEN / secret))


def test_wrong_delta_fails_closed():
    priv = crypto.load_private_pem(GOLDEN / "bob_private_key.pem")
    res = extract_image_from_video(GOLDEN / "ref_stego.avi", priv,
                                   StegoConfig(delta=23, num_ac_coeffs=10),
                                   batch_frames=4, device="cpu")
    assert not res.success


# (case, seed offset, kernel, payload bits, gray pixels that may differ by
# one). The frozen rev stego was made by the JAX package's XLA kernel on the
# CPU (kernel 'auto' there), rev2 by its Pallas kernel interpreted on the
# CPU, whose hi/lo-bf16 DCT is not IEEE f32. The port's oracle ('xla')
# byte-reproduces rev. Its stripe kernel's plain f32 sparse-delta form
# ('auto'/'pallas') lands a few pixels on the other side of the u8
# truncation: measured 1 pixel of rev and 8 of rev2, each off by exactly 1
# (torch 2.13 CPU); a lattice flip would move whole blocks by more. The
# bound below leaves room for another BLAS summation order, and the
# reference-accepted stegotpu extractor must still decode the port's stego.
REVERSE_CASES = [
    ("rev", 2, "xla", 5392, 0),
    ("rev", 2, "auto", 5392, 16),
    ("rev2", 12, "pallas", 5976, 32),
]


@pytest.mark.parametrize("case,seed,kernel,total,max_off", REVERSE_CASES)
def test_reverse_embed_reproduces_frozen_stego(tmp_path, case, seed, kernel,
                                               total, max_off):
    pub = crypto.load_public_pem(GOLDEN / f"{case}_pub.pem")
    cfg = StegoConfig(delta=20, num_ac_coeffs=10, kernel=kernel)
    res = embed_image_in_video(
        GOLDEN / f"{case}_cover.avi", GOLDEN / f"{case}_secret.png",
        tmp_path / "stego.avi", crypto.serialize_public_compressed(pub),
        cfg, batch_frames=4, rng=np.random.default_rng(20260816 + seed),
        device="cpu")
    assert res.success and res.total_payload_bits == total  # mid-block stop
    ours = _decode_all(tmp_path / "stego.avi").astype(int)
    frozen = _decode_all(GOLDEN / f"{case}_stego.avi").astype(int)
    assert ours.shape == frozen.shape
    off = np.abs(ours - frozen)
    assert off.max() <= 1
    assert int((off[..., 0] > 0).sum()) <= max_off
    out = j_extract(tmp_path / "stego.avi",
                    jcrypto.load_private_pem(GOLDEN / f"{case}_priv.pem"),
                    JConfig(delta=20, num_ac_coeffs=10))
    assert out.success and out.hash_ok
    np.testing.assert_array_equal(out.pixels,
                                  load_image_gray(GOLDEN / f"{case}_secret.png"))


@pytest.fixture(scope="module")
def multibatch(tmp_path_factory):
    """A 48x64 FFV1 cover of 9 frames (480 bits per frame at num_ac=10) and
    a 10x11 secret: 976 + 880 = 1856 bits span 4 frames, i.e. two batches
    of 2 frames and part of a third, and end mid-block (1856 % 10 != 0)."""
    d = tmp_path_factory.mktemp("multibatch")
    rng = np.random.default_rng(31)
    with VideoWriter(d / "cover.avi", 24.0, 64, 48) as w:
        w.write_bgr_batch(rng.integers(30, 220, (9, 48, 64, 3), np.uint8))
    save_image_gray(rng.integers(0, 256, (11, 10), np.uint8),
                    d / "secret.png")
    priv, pub = jcrypto.generate_keypair(np.random.default_rng(32))
    jcrypto.save_keypair_pem(priv, d / "priv.pem", d / "pub.pem")
    return d, jcrypto.serialize_public_compressed(pub)


@pytest.mark.parametrize("kernel", ["auto", "xla"])
def test_jax_embed_port_extract(multibatch, tmp_path, kernel):
    d, pub = multibatch
    res = j_embed(d / "cover.avi", d / "secret.png", tmp_path / "s.avi", pub,
                  JConfig(), batch_frames=2)
    assert res.success and res.total_payload_bits == 1856
    out = extract_image_from_video(
        tmp_path / "s.avi", crypto.load_private_pem(d / "priv.pem"),
        StegoConfig(kernel=kernel), batch_frames=2, device="cpu")
    assert out.success and out.hash_ok, out.error
    assert out.frames_read == 4
    np.testing.assert_array_equal(out.pixels, load_image_gray(d / "secret.png"))


@pytest.mark.parametrize("kernel", ["auto", "xla"])
def test_port_embed_jax_extract(multibatch, tmp_path, kernel):
    d, pub = multibatch
    res = embed_image_in_video(d / "cover.avi", d / "secret.png",
                               tmp_path / "s.avi", pub,
                               StegoConfig(kernel=kernel), batch_frames=2,
                               device="cpu")
    assert res.success and res.total_payload_bits == 1856
    assert res.frames_used == 9 and res.first_frame_psnr > 30
    out = j_extract(tmp_path / "s.avi", jcrypto.load_private_pem(d / "priv.pem"),
                    JConfig(), batch_frames=2)
    assert out.success and out.hash_ok, out.error
    np.testing.assert_array_equal(out.pixels, load_image_gray(d / "secret.png"))
    # frames past the payload are the cover's own (color passthrough)
    np.testing.assert_array_equal(_decode_all(tmp_path / "s.avi")[4:],
                                  _decode_all(d / "cover.avi")[4:])


def test_raw_data_round_trip(multibatch, tmp_path):
    d, pub = multibatch
    data = b"raw bytes through the port " * 3
    res = embed_data_in_video(d / "cover.avi", data, tmp_path / "s.avi", pub,
                              StegoConfig(), batch_frames=2, device="cpu")
    assert res.success
    out = extract_image_from_video(tmp_path / "s.avi",
                                   crypto.load_private_pem(d / "priv.pem"),
                                   StegoConfig(), batch_frames=2,
                                   device="cpu")
    assert out.success and out.is_raw_data and out.data == data


@pytest.mark.parametrize("payload", ["image", "data"])
def test_round_trip_through_the_cv2_encoder_lanes(multibatch, tmp_path,
                                                  monkeypatch, payload):
    """The product's embed and extract on the cv2 backend with 4 FFV1
    encoder lanes (video.VideoWriter): the secret image and the raw bytes
    come back exactly."""
    from stegotpu_torch import video

    monkeypatch.setenv("STEGOTPU_VIDEO_BACKEND", "cv2")
    monkeypatch.setattr(video, "effective_cpu_count", lambda: 6)
    d, pub = multibatch
    lanes_before = video.ENCODE_CHUNKS["lane"]
    data = b"raw bytes through the lanes " * 3
    if payload == "image":
        res = embed_image_in_video(d / "cover.avi", d / "secret.png",
                                   tmp_path / "s.avi", pub, StegoConfig(),
                                   batch_frames=2, device="cpu")
    else:
        res = embed_data_in_video(d / "cover.avi", data, tmp_path / "s.avi",
                                  pub, StegoConfig(), batch_frames=2,
                                  device="cpu")
    assert res.success and res.frames_used == 9
    assert video.ENCODE_CHUNKS["lane"] > lanes_before
    assert list(tmp_path.glob(".*.lanes-*")) == []
    out = extract_image_from_video(tmp_path / "s.avi",
                                   crypto.load_private_pem(d / "priv.pem"),
                                   StegoConfig(), batch_frames=2,
                                   device="cpu")
    assert out.success and out.hash_ok, out.error
    if payload == "image":
        np.testing.assert_array_equal(out.pixels,
                                      load_image_gray(d / "secret.png"))
    else:
        assert out.is_raw_data and out.data == data
    # frames past the payload are the cover's own (color passthrough)
    n = out.frames_read
    np.testing.assert_array_equal(_decode_all(tmp_path / "s.avi")[n:],
                                  _decode_all(d / "cover.avi")[n:])


def test_array_api_matches_jax():
    """embed_payload_into_gray_frames / extract_bits_from_gray_frames: the
    port's round trip returns the payload, and its stego decodes identically
    with the JAX package's array API."""
    from stegotpu.pipeline import extract_bits_from_gray_frames as j_bits

    rng = np.random.default_rng(41)
    frames = rng.integers(16, 240, (3, 48, 80), np.uint8)
    bits = rng.integers(0, 2, 1000, np.uint8)
    for kernel in ("auto", "xla"):
        stego, bpf = embed_payload_into_gray_frames(
            frames, bits, StegoConfig(kernel=kernel), device="cpu")
        assert bpf.tolist() == [600, 400, 0]
        np.testing.assert_array_equal(stego[2], frames[2])
        got = extract_bits_from_gray_frames(stego, StegoConfig(kernel=kernel),
                                            device="cpu")
        np.testing.assert_array_equal(got[:1000], bits)
        np.testing.assert_array_equal(j_bits(stego, JConfig())[:1000], bits)

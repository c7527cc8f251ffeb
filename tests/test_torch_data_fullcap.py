"""The port's raw-data embed at exactly full capacity, file to file, against
the benchmark's plain reference (stegobench/reference.py and
reference_data.py, which import nothing of the program).

64x96 covers of 6 frames at num_ac 10 hold 5,760 bits: the 976-bit header
and 598 plaintext bytes, so every slot of every frame carries payload; in
batches of 2 a job takes 3 device batches, as the 1080p30 cell's 24 frames
take 3 batches of 8.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stegobench import media, reference, reference_data
from stegobench.core import rng
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.pipeline import (embed_data_in_video,
                                     extract_image_from_video)
from stegotpu_torch.utils.profiling import StageTimer

H, W, FRAMES, NUM_AC, DELTA, BATCH = 64, 96, 6, 10, 20.0, 2
CAP = (H // 8) * (W // 8) * NUM_AC
FULL_BYTES = (FRAMES * CAP - reference_data.HEADER_BITS) // 8
SEED = 2**31 + 23


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    d = tmp_path_factory.mktemp("fullcap")
    media.write_cover(d / "cover.mp4", H, W, FRAMES, 30, rng(SEED, 2), "mp4v")
    receiver = reference.receiver_key(rng(SEED, 1))
    return d, receiver, reference.public_compressed(receiver)


def _embed(setting, out, data, kernel="auto", timer=None, seal_seed=4):
    d, _, pub = setting
    return embed_data_in_video(d / "cover.mp4", data, out, pub,
                               StegoConfig(kernel=kernel), batch_frames=BATCH,
                               rng=rng(SEED, seal_seed), timer=timer,
                               device="cpu")


def _data(n=FULL_BYTES) -> bytes:
    return rng(SEED, 3).bytes(n)


@pytest.mark.parametrize("kernel", ["auto", "xla"])
def test_full_capacity_embed_matches_the_reference(setting, tmp_path, kernel):
    d, receiver, pub = setting
    assert FULL_BYTES == 598
    data = _data()
    res = _embed(setting, tmp_path / "s.avi", data, kernel)
    assert res.success, res.error
    assert res.bits_embedded == res.total_payload_bits == FRAMES * CAP
    assert res.frames_used == FRAMES
    bits = reference_data.seal_data(data, pub, rng(SEED, 4))
    assert bits.size == FRAMES * CAP

    got = media.read_frames(tmp_path / "s.avi")
    assert got.shape == (FRAMES, H, W, 3)
    assert (got == got[..., :1]).all()           # stego luma in every channel
    stego = torch.from_numpy(np.ascontiguousarray(got[..., 0]))
    cover = torch.from_numpy(reference.gray(media.read_frames(d / "cover.mp4")))
    ref, sure = reference.embed_envelope(
        cover, torch.from_numpy(bits.reshape(FRAMES, CAP)), bits.size, DELTA,
        NUM_AC)
    assert sure.float().mean() > 0.9
    assert int(((stego != ref) & sure).sum()) == 0
    read = reference.extract(stego, DELTA, NUM_AC).numpy().reshape(-1)
    np.testing.assert_array_equal(read, bits)
    assert reference_data.open_data(read, receiver) == data


def test_the_port_extracts_the_bytes(setting, tmp_path):
    _, receiver, _ = setting
    data = _data()
    assert _embed(setting, tmp_path / "s.avi", data).success
    out = extract_image_from_video(tmp_path / "s.avi", receiver, StegoConfig(),
                                   batch_frames=BATCH, device="cpu")
    assert out.success and out.is_raw_data and out.hash_ok, out.error
    assert out.data == data and out.frames_read == FRAMES


def test_the_same_rng_gives_the_same_file(setting, tmp_path):
    data = _data()
    for name in ("a.avi", "b.avi"):
        assert _embed(setting, tmp_path / name, data).success
    assert _embed(setting, tmp_path / "c.avi", data, seal_seed=5).success
    a, b, c = (media.read_frames(tmp_path / n) for n in ("a.avi", "b.avi",
                                                         "c.avi"))
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()                        # another seal, other bits


def test_the_timer_holds_the_data_path_stages(setting, tmp_path):
    timer = StageTimer()
    assert _embed(setting, tmp_path / "s.avi", _data(), timer=timer).success
    assert {"seal", "device_dispatch", "device_readback", "encode",
            "files_open", "files_close"} <= set(timer.totals)
    assert timer.counts["device_dispatch"] == FRAMES // BATCH
    assert timer.counts["device_readback"] == FRAMES // BATCH


def test_one_byte_over_capacity_fails_without_raising(setting, tmp_path):
    res = _embed(setting, tmp_path / "s.avi", _data(FULL_BYTES + 1))
    assert not res.success and res.error
    assert res.total_payload_bits == FRAMES * CAP + 8
    assert res.bits_embedded == FRAMES * CAP and res.frames_used == FRAMES

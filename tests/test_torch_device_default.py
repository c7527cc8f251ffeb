"""The port's entry points run on the card unless the caller asks for the
CPU: called without ``device`` on a machine with no CUDA device, each one
raises instead of running the kernels' plain versions on the CPU."""

from pathlib import Path

import numpy as np
import pytest
import torch

from stegotpu_torch import crypto, evaluation, pipeline, steganalysis
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.device import resolve_device
from stegotpu_torch.ops import exactness

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _pub() -> bytes:
    return crypto.serialize_public_compressed(
        crypto.load_public_pem(GOLDEN / "rev_pub.pem"))


ENTRY_POINTS = {
    "embed_image_in_video": lambda out: pipeline.embed_image_in_video(
        GOLDEN / "rev_cover.avi", GOLDEN / "rev_secret.png", out / "s.avi",
        _pub()),
    "embed_data_in_video": lambda out: pipeline.embed_data_in_video(
        GOLDEN / "rev_cover.avi", b"data", out / "s.avi", _pub()),
    "_embed_payload": lambda out: pipeline._embed_payload(
        GOLDEN / "rev_cover.avi", b"data", 2, 2, out / "s.avi", _pub(),
        StegoConfig(), 4),
    "extract_image_from_video": lambda out: pipeline.extract_image_from_video(
        GOLDEN / "ref_stego.avi",
        crypto.load_private_pem(GOLDEN / "bob_private_key.pem")),
    "embed_payload_into_gray_frames":
        lambda out: pipeline.embed_payload_into_gray_frames(
            np.full((1, 16, 16), 128, np.uint8), np.ones(8, np.uint8)),
    "extract_bits_from_gray_frames":
        lambda out: pipeline.extract_bits_from_gray_frames(
            np.full((1, 16, 16), 128, np.uint8)),
    "compare_videos": lambda out: evaluation.compare_videos(
        GOLDEN / "ref_stego.avi", GOLDEN / "ref_stego.avi"),
    "check_config": lambda out: exactness.check_config(
        1, 16, 16, 10, [20.0], np.random.default_rng(0), verbose=False),
    "quick_exactness_check": lambda out: exactness.quick_exactness_check(),
    "inspect_stego_header": lambda out: pipeline.inspect_stego_header(
        GOLDEN / "ref_stego.avi"),
    "analyze_frames": lambda out: steganalysis.analyze_frames(
        np.full((1, 16, 16), 128, np.uint8)),
    "estimate_num_ac": lambda out: steganalysis.estimate_num_ac(
        np.full((1, 16, 16), 128, np.uint8), 20.0),
    "recover_params": lambda out: steganalysis.recover_params(
        GOLDEN / "ref_stego.avi", StegoConfig()),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_cuda(name, no_cuda,
                                                        tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](tmp_path)
    assert not any(tmp_path.iterdir())  # nothing was written


def test_resolve_device(no_cuda, monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device(None) == torch.device("cuda")

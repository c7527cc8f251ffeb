"""The port's product path on a device mesh, case for case against
tests/test_mesh_product.py: file->file embed/extract through
stegotpu_torch.pipeline with a ('data', 'space') mesh that repeats the CPU
device, the --mesh spec parser and device guard (messages equal to the
JAX package's), the bad 'space' split, the verified embed through the mesh,
and `selftest --mesh` through the port's command line.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stegotpu import crypto as jcrypto
from stegotpu.config import StegoConfig as JConfig
from stegotpu.parallel import mesh as jmesh
from stegotpu.pipeline import extract_image_from_video as j_extract
from stegotpu_torch import crypto, fixtures
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.image import load_image_gray
from stegotpu_torch.parallel.mesh import make_mesh, parse_mesh_spec, product_mesh
from stegotpu_torch.pipeline import embed_image_in_video, extract_image_from_video

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _mesh(n_data, n_space):
    return make_mesh(n_data, n_space, [CPU] * (n_data * n_space))


@pytest.mark.parametrize("spec", ["data=4,space=2", "space=8", "4", "",
                                  " data = 2 , ", "rows=2", "data=0",
                                  "space=-1", "data=x"])
def test_parse_mesh_spec(spec):
    """The port's parser gives the JAX package's result, or raises the same
    ValueError."""
    try:
        want = jmesh.parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert parse_mesh_spec(spec) == want


def test_product_mesh_device_guard():
    import jax

    with pytest.raises(ValueError, match="devices") as got:
        product_mesh("data=64,space=64", devices=[CPU] * 8)
    with pytest.raises(ValueError) as want:
        jmesh.product_mesh("data=64,space=64", devices=jax.devices()[:8])
    assert str(got.value) == str(want.value)
    mesh = product_mesh("data=4,space=2", devices=[CPU] * 8)
    assert mesh.shape == {"data": 4, "space": 2} and mesh.devices.size == 8


@pytest.mark.parametrize("n_data,n_space", [(4, 2), (8, 1), (2, 4)])
def test_mesh_pipeline_file_to_file(tmp_path, n_data, n_space):
    """Embed sharded, extract sharded AND unsharded: byte-identical files,
    pixel-identical secret (the mesh is a pure throughput transform), and
    the JAX package's extractor reads the sharded stego."""
    fixtures.make_secret_image(tmp_path / "s.png", 48, 48, kind="noise", seed=3)
    fixtures.make_cover_video(tmp_path / "c.mp4", 320, 256, frames=12,
                              kind="moving", seed=4)
    priv, pub_c = crypto.setup_receiver_keys(tmp_path / "k.pem", tmp_path / "p.pem")
    cfg = StegoConfig(delta=20, num_ac_coeffs=10)
    mesh = _mesh(n_data, n_space)

    res = embed_image_in_video(tmp_path / "c.mp4", tmp_path / "s.png",
                               tmp_path / "st_mesh", pub_c, cfg,
                               batch_frames=4, rng=np.random.default_rng(7),
                               mesh=mesh)
    assert res.success

    # the sharded embed must produce the SAME stego file as the
    # single-device path given the same deterministic crypto stream
    res1 = embed_image_in_video(tmp_path / "c.mp4", tmp_path / "s.png",
                                tmp_path / "st_one", pub_c, cfg,
                                batch_frames=4, rng=np.random.default_rng(7),
                                device="cpu")
    assert res1.success
    assert Path(res.output_path).read_bytes() == \
        Path(res1.output_path).read_bytes()

    secret = load_image_gray(tmp_path / "s.png")
    ext = extract_image_from_video(res.output_path, priv, cfg,
                                   tmp_path / "out.png", batch_frames=4,
                                   mesh=mesh)
    assert ext.success and ext.hash_ok
    assert np.array_equal(ext.pixels, secret)
    ext1 = extract_image_from_video(res.output_path, priv, cfg,
                                    batch_frames=4, device="cpu")
    assert ext1.success and np.array_equal(ext1.pixels, secret)
    j_ext = j_extract(res.output_path, jcrypto.load_private_pem(
        tmp_path / "k.pem"), JConfig(delta=20, num_ac_coeffs=10))
    assert j_ext.success and j_ext.hash_ok
    assert np.array_equal(j_ext.pixels, secret)


def test_mesh_rejects_bad_space_split(tmp_path):
    """space must divide the block rows; the error must be actionable (the
    JAX package's message)."""
    from stegotpu.pipeline import _mesh_setup as j_mesh_setup

    fixtures.make_secret_image(tmp_path / "s.png", 16, 16, kind="noise", seed=1)
    fixtures.make_cover_video(tmp_path / "c.mp4", 120, 88, frames=4,
                              kind="noise", seed=2)  # 11 block rows: prime
    _, pub_c = crypto.setup_receiver_keys(tmp_path / "k.pem", tmp_path / "p.pem")
    with pytest.raises(ValueError, match="block rows") as got:
        embed_image_in_video(tmp_path / "c.mp4", tmp_path / "s.png",
                             tmp_path / "st", pub_c, StegoConfig(),
                             mesh=_mesh(2, 2))
    with pytest.raises(ValueError) as want:
        j_mesh_setup(jmesh.make_mesh(2, 2), JConfig(), 88, 120, 8)
    assert str(got.value) == str(want.value)


def test_mesh_takes_no_device_beside_it(tmp_path):
    """A mesh names the devices its shards run on: a device beside it is
    refused before any work."""
    fixtures.make_secret_image(tmp_path / "s.png", 8, 8, kind="noise", seed=1)
    with pytest.raises(ValueError, match="not both"):
        embed_image_in_video(tmp_path / "c.mp4", tmp_path / "s.png",
                             tmp_path / "st", b"", StegoConfig(),
                             mesh=_mesh(2, 1), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        extract_image_from_video(tmp_path / "st.avi", None, StegoConfig(),
                                 mesh=_mesh(2, 1), device="cpu")


def test_mesh_verified_composes(tmp_path):
    """--verified composes with the mesh: the sharded step's summed error
    count gates the repair branch. Mid-range cover: fast branch, extract
    OK. Black cover: repair branch fires, still BER=0."""
    import cv2

    fixtures.make_secret_image(tmp_path / "s.png", 24, 24, kind="noise", seed=1)
    fixtures.make_cover_video(tmp_path / "c.mp4", 128, 64, frames=8,
                              kind="noise", seed=2)
    priv, pub_c = crypto.setup_receiver_keys(tmp_path / "k.pem", tmp_path / "p.pem")
    cfg = StegoConfig(verified_embed=True)
    mesh = _mesh(2, 2)

    res = embed_image_in_video(tmp_path / "c.mp4", tmp_path / "s.png",
                               tmp_path / "st", pub_c, cfg, batch_frames=4,
                               mesh=mesh)
    assert res.success and res.residual_bits == 0
    ext = extract_image_from_video(res.output_path, priv, cfg, mesh=mesh,
                                   batch_frames=4)
    assert ext.success and ext.hash_ok
    assert np.array_equal(ext.pixels, load_image_gray(tmp_path / "s.png"))

    # flat-black cover: the plain sharded embed would lose bits to clipping;
    # the verified repair branch must recover them
    vw = cv2.VideoWriter(str(tmp_path / "black.avi"),
                         cv2.VideoWriter_fourcc(*"FFV1"), 24.0, (128, 64), True)
    for _ in range(8):
        vw.write(np.zeros((64, 128, 3), np.uint8))
    vw.release()
    res_b = embed_image_in_video(tmp_path / "black.avi", tmp_path / "s.png",
                                 tmp_path / "stb", pub_c, cfg, batch_frames=4,
                                 mesh=mesh)
    assert res_b.success and res_b.residual_bits == 0
    ext_b = extract_image_from_video(res_b.output_path, priv, cfg,
                                     batch_frames=4, device="cpu")
    assert ext_b.success and ext_b.hash_ok
    assert np.array_equal(ext_b.pixels, load_image_gray(tmp_path / "s.png"))


def test_cli_selftest_mesh(tmp_path):
    """`stegotpu-torch --device cpu --host-devices 8 selftest --mesh
    data=4,space=2` passes end to end on a mesh of 8 CPU devices."""
    proc = subprocess.run(
        [sys.executable, "-m", "stegotpu_torch.cli", "--device", "cpu",
         "--host-devices", "8", "selftest", "--mesh", "data=4,space=2",
         "--dir", str(tmp_path / "st")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "SELFTEST PASSED" in proc.stdout
    assert "mesh: data=4 x space=2" in proc.stdout

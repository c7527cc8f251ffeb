"""The port's command line (stegotpu_torch.cli) on the CPU.

The workflows of tests/test_cli.py, run through ``--device cpu`` (the
kernels' plain versions) at 640x480: genkey -> fixtures -> embed ->
extract -> evaluate -> capacity, wrong parameters, embed-batch and
extract-batch with --jobs, the JSON outputs, --auto-params recovery,
segments with --payload-state and concat, embed-data, selftest. Beside
them: ``inspect`` on the wire goldens gives the JAX package's
``inspect_stego_header`` dict, what the port lacks exits 1 with one line
naming its ROADMAP item, a run that names no device needs the card, and
the CLI imports with jax and stegotpu blocked.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stegotpu_torch import crypto, fixtures
from stegotpu_torch.cli import main
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.image import load_image_gray
from stegotpu_torch.pipeline import extract_image_from_video

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
CPU = ["--device", "cpu"]


def cli(*argv) -> int:
    return main([*CPU, *argv])


def _extract_ok(path, secret):
    priv = crypto.load_private_pem("bob_private_key.pem")
    res = extract_image_from_video(path, priv, StegoConfig(), device="cpu")
    assert res.success and res.hash_ok
    np.testing.assert_array_equal(res.pixels, load_image_gray(secret))


def test_cli_full_workflow(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli("genkey") == 0
    assert (tmp_path / "bob_private_key.pem").exists()
    assert cli("genkey") == 1  # refuses to overwrite without --force
    assert cli("genkey", "--force") == 0
    assert cli("fixtures", "--dir", "media", "--width", "640", "--height",
               "480", "--frames", "8", "--secret-size", "32") == 0
    capsys.readouterr()

    assert cli("embed", "media/cover.mp4", "media/secret.png", "out/stego",
               "--batch", "4", "--timing") == 0
    out = capsys.readouterr()
    assert "PSNR" in out.out
    assert "--- stage timing ---" in out.err and "device_dispatch" in out.err

    assert cli("extract", "out/stego.avi", "out/extracted.png", "--batch",
               "4", "--timing") == 0
    out = capsys.readouterr()
    assert "SHA3-256 integrity: OK" in out.out and "decode_wait" in out.err
    np.testing.assert_array_equal(load_image_gray("out/extracted.png"),
                                  load_image_gray("media/secret.png"))

    assert cli("evaluate", "media/cover.mp4", "out/stego.avi", "--secret",
               "media/secret.png", "--extracted", "out/extracted.png",
               "--all-frames") == 0
    out = capsys.readouterr().out
    assert "SSIM" in out and "security" in out and "8 frames" in out
    assert cli("capacity", "media/cover.mp4") == 0
    assert "48000 bits/frame" in capsys.readouterr().out


def test_cli_extract_wrong_params_fails(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli("genkey") == 0
    assert cli("fixtures", "--dir", "media", "--width", "640", "--height",
               "480", "--frames", "6", "--secret-size", "16") == 0
    assert cli("embed", "media/cover.mp4", "media/secret.png", "stego") == 0
    capsys.readouterr()
    assert cli("extract", "stego.avi", "x.png", "--delta", "19") == 1
    assert "EXTRACT FAILED" in capsys.readouterr().err


def test_cli_embed_and_extract_batch_with_jobs(tmp_path, monkeypatch, capsys):
    """--jobs 2 overlaps files on threads; reports keep input order, every
    output decodes; a missing cover and same-stem covers fail as in the
    JAX CLI; extract-batch reads them all back."""
    monkeypatch.chdir(tmp_path)
    assert cli("genkey") == 0
    fixtures.make_secret_image("secret.png", 16, 16, kind="pattern")
    covers = [f"cover{i}.mp4" for i in range(3)]
    for i, c in enumerate(covers):
        fixtures.make_cover_video(c, 640, 480, frames=4, kind="moving", seed=i)
    capsys.readouterr()
    assert cli("embed-batch", "secret.png", *covers, "--out-dir", "st",
               "--batch", "4", "--jobs", "2") == 0
    out = capsys.readouterr().out
    assert "batch done: 3/3" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("cover")]
    assert [ln.split(":")[0] for ln in lines] == covers
    for i in range(3):
        _extract_ok(f"st/cover{i}.avi", "secret.png")

    assert cli("embed-batch", "secret.png", "cover0.mp4", "missing.mp4",
               "--out-dir", "out2") == 1
    assert "batch done: 1/2" in capsys.readouterr().out
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "cover0.mp4").write_bytes(Path("cover0.mp4").read_bytes())
    assert cli("embed-batch", "secret.png", "cover0.mp4", "d/cover0.mp4",
               "--out-dir", "out3") == 1
    assert "overwrite" in capsys.readouterr().err

    assert cli("extract-batch", "st/cover0.avi", "st/cover1.avi",
               "st/cover2.avi", "--out-dir", "out", "--jobs", "2") == 0
    assert "batch done: 3/3" in capsys.readouterr().out
    for i in range(3):
        np.testing.assert_array_equal(load_image_gray(f"out/cover{i}.png"),
                                      load_image_gray("secret.png"))
    assert cli("extract-batch", "st/cover0.avi", "--out-dir", "out4",
               "--delta", "19") == 1
    assert "FAILED" in capsys.readouterr().err


def test_cli_json_outputs(tmp_path, monkeypatch, capsys):
    """capacity/inspect/steganalyze --json: one parseable JSON line each;
    inspect equals the JAX package's inspect_stego_header on the same file,
    steganalyze finds delta 20 and num_ac 10."""
    from stegotpu.config import StegoConfig as JConfig
    from stegotpu.pipeline import inspect_stego_header

    monkeypatch.chdir(tmp_path)
    assert cli("genkey") == 0
    # a secret that fills frame 0, so steganalysis sees every slot
    fixtures.make_secret_image("s.png", 96, 96, kind="noise", seed=4)
    fixtures.make_cover_video("c.mp4", 640, 480, frames=6, kind="moving")
    assert cli("embed", "c.mp4", "s.png", "st") == 0
    capsys.readouterr()

    assert cli("capacity", "c.mp4", "--json") == 0
    cap = json.loads(capsys.readouterr().out)
    assert cap["qim_bits_per_frame"] == (480 // 8) * (640 // 8) * 10
    assert cli("inspect", "st.avi", "--json") == 0
    ins = json.loads(capsys.readouterr().out)
    assert ins["secret_width"] == 96 and ins["payload_type"] == "image"
    assert ins["ciphertext_bytes"] == 96 * 96
    assert ins == json.loads(json.dumps(inspect_stego_header("st.avi",
                                                             JConfig())))
    assert cli("steganalyze", "st.avi", "--json") == 0
    stz = json.loads(capsys.readouterr().out)
    assert stz["detected"] and stz["verdict"] == "stego-likely"
    assert (stz["estimated_delta"], stz["estimated_num_ac"]) == (20, 10)


@pytest.mark.parametrize("stego,delta,num_ac", [
    ("ref_stego.avi", 20, 10), ("ref_stego28.avi", 28, 3),
    ("rev_stego.avi", 20, 10), ("rev2_stego.avi", 20, 10)])
def test_inspect_goldens_equal_jax(stego, delta, num_ac, capsys):
    from stegotpu.config import StegoConfig as JConfig
    from stegotpu.pipeline import inspect_stego_header

    assert cli("inspect", str(GOLDEN / stego), "--json", "--delta",
               str(delta), "--coeffs", str(num_ac)) == 0
    got = json.loads(capsys.readouterr().out)
    want = inspect_stego_header(GOLDEN / stego,
                                JConfig(delta=delta, num_ac_coeffs=num_ac))
    assert got == json.loads(json.dumps(want))
    assert cli("inspect", str(GOLDEN / stego), "--delta",
               str(delta), "--coeffs", str(num_ac)) == 0
    assert f"ciphertext: {want['ciphertext_bytes']} bytes" in \
        capsys.readouterr().out


def test_cli_extract_auto_params_recovery(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli("genkey") == 0
    fixtures.make_secret_image("s.png", 48, 48, kind="noise", seed=11)
    fixtures.make_cover_video("c.mp4", 640, 480, frames=8, kind="moving",
                              seed=12)
    assert cli("embed", "c.mp4", "s.png", "st", "--delta", "32", "--coeffs",
               "3") == 0
    capsys.readouterr()
    assert cli("extract", "st.avi", "x.png") == 1  # defaults 20/10 fail
    capsys.readouterr()
    assert cli("extract", "st.avi", "x.png", "--auto-params") == 0
    out = capsys.readouterr()
    assert "RECOVERY" in out.err
    assert "recovered parameters: delta=32, coeffs=3" in out.out
    np.testing.assert_array_equal(load_image_gray("x.png"),
                                  load_image_gray("s.png"))
    assert cli("extract", "c.mp4", "y.png", "--auto-params") == 1
    err = capsys.readouterr().err
    assert "RECOVERY FAILED" in err and "EXTRACT FAILED" in err


def test_cli_segments_embed_data_and_selftest(tmp_path, monkeypatch, capsys):
    """Two segment runs against one --payload-state, stitched by concat,
    equal one full run of the same payload (where the native layer is
    built; without it concat exits 1 naming its absence). embed-data round
    trips raw bytes. selftest passes on the CPU."""
    from stegotpu_torch.native import videoio

    monkeypatch.chdir(tmp_path)
    assert cli("genkey") == 0
    fixtures.make_secret_image("s.png", 56, 56, kind="noise", seed=1)
    fixtures.make_cover_video("c.mp4", 160, 128, frames=12, kind="moving",
                              seed=2)
    assert cli("embed", "c.mp4", "s.png", "seg1", "--frame-range", "8:",
               "--batch", "4") == 1  # LO > 0 needs the sealed state
    assert "--payload-state" in capsys.readouterr().err
    assert cli("embed", "c.mp4", "s.png", "seg0", "--batch", "4",
               "--frame-range", "0:8", "--payload-state", "p") == 0
    assert "sealed payload saved" in capsys.readouterr().out
    assert cli("embed", "c.mp4", "s.png", "seg1", "--batch", "4",
               "--frame-range", "8:", "--payload-state", "p") == 0
    assert "loaded sealed payload" in capsys.readouterr().out
    rc = cli("concat", "full.avi", "seg0.avi", "seg1.avi")
    if not videoio.available():
        assert rc == 1 and "native layer" in capsys.readouterr().err
    else:
        assert rc == 0
        assert cli("embed", "c.mp4", "s.png", "one", "--batch", "4",
                   "--payload-state", "p") == 0
        from stegotpu_torch.video import VideoReader

        def frames_of(p):
            frames = []
            with VideoReader(p) as r:
                while (f := r.read_frame()) is not None:
                    frames.append(f)
            return np.stack(frames)
        np.testing.assert_array_equal(frames_of("full.avi"),
                                      frames_of("one.avi"))
        assert cli("extract", "full.avi", "x.png") == 0
        np.testing.assert_array_equal(load_image_gray("x.png"),
                                      load_image_gray("s.png"))

    Path("data.bin").write_bytes(bytes(range(256)) * 3)
    assert cli("embed-data", "c.mp4", "data.bin", "raw") == 0
    assert cli("extract", "raw.avi", "data.out") == 0
    assert "768 bytes of raw data" in capsys.readouterr().out
    assert Path("data.out").read_bytes() == Path("data.bin").read_bytes()

    assert cli("selftest", "--dir", "st") == 0
    out = capsys.readouterr().out
    assert "SELFTEST PASSED" in out and "device cpu" in out
    assert "kernel exactness" not in out  # the card's check: CUDA only


@pytest.mark.parametrize("argv,item", [
    (["serve", "--port", "8752"], "M12"),
    (["serve"], "M12"),
])
def test_unported_surface_exits_1_with_one_line(argv, item, capsys):
    assert cli(*argv) == 1
    out = capsys.readouterr()
    lines = out.err.strip().splitlines()
    assert out.out == "" and len(lines) == 1
    assert lines[0].startswith("error: ") and item in lines[0]
    assert "not ported" in lines[0] and "Traceback" not in out.err


def test_cli_without_a_device_needs_the_card(tmp_path, monkeypatch, capsys):
    """With no --device and no CUDA device, a command that runs the kernels
    exits 1 with one line naming device 'cpu'; bench refuses the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli("genkey") == 0
    fixtures.make_secret_image("s.png", 16, 16, kind="pattern")
    fixtures.make_cover_video("c.mp4", 64, 48, frames=2, kind="moving")
    capsys.readouterr()
    assert main(["embed", "c.mp4", "s.png", "o"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "no CUDA device" in err[0] and "cpu" in err[0]
    assert main(["bench"]) == 1
    assert "CUDA" in capsys.readouterr().err
    assert cli("bench") == 1
    assert "bench measures the card" in capsys.readouterr().err


def test_cli_imports_without_jax_or_stegotpu():
    code = """
import sys
BLOCKED = ("jax", "jaxlib", "stegotpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import stegotpu_torch.cli, stegotpu_torch.steganalysis
import stegotpu_torch.benchmark, stegotpu_torch.utils.profiling
import stegotpu_torch.utils.logging, stegotpu_torch.studies.emitpipe_r4
stegotpu_torch.cli.build_parser()
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    out = subprocess.run([sys.executable, "-m", "stegotpu_torch", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "steganalyze" in out.stdout

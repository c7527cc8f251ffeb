"""The port's host layer is equal to the JAX package's, and imports alone.

stegotpu_torch carries copies of stegotpu's framework-free host modules
(config, bitstream, crypto, payload, image, video, the DCT basis and the
color conversion), because importing any stegotpu module imports JAX. These
tests hold each copy equal to its original, check the state that crosses
from stegotpu (DCT basis, StegoConfig, PEM keys), and prove that the port
imports neither JAX nor stegotpu nor the third-party host libraries.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stegotpu import bitstream as jbits
from stegotpu import config as jconfig
from stegotpu import crypto as jcrypto
from stegotpu import image as jimage
from stegotpu import payload as jpayload
from stegotpu.ops import color as jcolor
from stegotpu.ops import dct as jdct
from stegotpu_torch import bitstream as tbits
from stegotpu_torch import config as tconfig
from stegotpu_torch import crypto as tcrypto
from stegotpu_torch import image as timage
from stegotpu_torch import payload as tpayload
from stegotpu_torch.ops import color as tcolor
from stegotpu_torch.ops import dct as tdct

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"


def test_import_needs_only_torch_numpy_scipy():
    """Importing the pipeline, every kernel module, the verified embed, the
    exactness harness, the fixtures, the GPU check tool, the metrics, the
    evaluation suite, the experimental kernels, every study module, the
    CLI, steganalysis, the benchmark, the utilities, every module of the
    parallel layer, the server, the GUI and every module of the tools
    succeeds with jax, stegotpu, cryptography, PIL and cv2 blocked, and
    leaves no jax module behind; so does the spawn workers' initializer."""
    code = """
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "stegotpu", "cryptography", "PIL", "cv2")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import stegotpu_torch.pipeline, stegotpu_torch.ops.stripe_kernel
import stegotpu_torch.ops.verified, stegotpu_torch.ops.exactness
import stegotpu_torch.fixtures, stegotpu_torch.gpucheck
import stegotpu_torch.metrics, stegotpu_torch.evaluation
import stegotpu_torch.ops.experimental.qim_fast
import stegotpu_torch.ops.experimental.kron_kernel
import stegotpu_torch.ops._build
import stegotpu_torch.cli, stegotpu_torch.steganalysis, stegotpu_torch.benchmark
import stegotpu_torch.utils.logging, stegotpu_torch.utils.profiling
import stegotpu_torch.studies
import stegotpu_torch.parallel, stegotpu_torch.server, stegotpu_torch.gui
import stegotpu_torch.tools
tools = {m.name for m in pkgutil.iter_modules(stegotpu_torch.tools.__path__)}
assert tools == {"reference_model", "soak_kernels", "soak_product",
                 "profile_roundtrip"}, tools
for name in sorted(tools):
    importlib.import_module("stegotpu_torch.tools." + name)
parallel = {m.name for m in pkgutil.iter_modules(stegotpu_torch.parallel.__path__)}
assert parallel == {"mesh", "dist_pipeline", "local_procs", "distributed"}, parallel
for name in sorted(parallel):
    importlib.import_module("stegotpu_torch.parallel." + name)
stegotpu_torch.parallel.local_procs._spawn_init()
studies = [m.name for m in pkgutil.iter_modules(stegotpu_torch.studies.__path__)]
assert {"extract_ablation", "ab_packed_payload", "dualchain_r5",
        "roofline_r4", "device_roofline", "emitpipe_r4"} <= set(studies), studies
for name in studies:
    importlib.import_module("stegotpu_torch.studies." + name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in BLOCKED or m.startswith("jax"))
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_name_no_jax():
    for path in (REPO / "stegotpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped, (path, line)
                assert not stripped.startswith(("import stegotpu ",
                                                "import stegotpu.",
                                                "from stegotpu ",
                                                "from stegotpu.")), (path, line)


def test_dct_basis_bit_equal():
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(tdct.dct_matrix(8, dtype),
                                      jdct.dct_matrix(8, dtype))
        np.testing.assert_array_equal(tdct.kron_dct_matrix(8, dtype),
                                      jdct.kron_dct_matrix(8, dtype))
    np.testing.assert_array_equal(tdct.kron_dct_tensor("cpu").numpy(),
                                  jdct.kron_dct_matrix(8, np.float32))
    x = np.random.default_rng(0).integers(0, 256, (2, 16, 24), np.uint8)
    blocks = tdct.blockify(torch.from_numpy(x))
    np.testing.assert_array_equal(blocks.numpy(), jdct.blockify(x))
    np.testing.assert_array_equal(tdct.unblockify(blocks, 16, 24).numpy(), x)


def test_color_conversion_equal():
    bgr = np.random.default_rng(1).integers(0, 256, (3, 5, 7, 3), np.uint8)
    ref = jcolor.bgr_to_gray_np(bgr)
    np.testing.assert_array_equal(tcolor.bgr_to_gray_np(bgr), ref)
    np.testing.assert_array_equal(
        tcolor.bgr_to_gray(torch.from_numpy(bgr)).numpy(), ref)


def test_config_equal_and_carried_across():
    """StegoConfig(**asdict(stegotpu config)) is accepted and equal field by
    field; both classes accept and reject the same values."""
    assert [f.name for f in dataclasses.fields(tconfig.StegoConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.StegoConfig)]
    for name in ("BLOCK", "DIMS_BITS", "LEN_FIELD_BITS", "CIPHERTEXT_LEN_BITS",
                 "AES_KEY_BYTES", "GCM_NONCE_BYTES", "GCM_TAG_BYTES",
                 "HKDF_SALT_BYTES", "HKDF_INFO", "COMPRESSED_POINT_BYTES"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    cases = [dict(), dict(delta=8, num_ac_coeffs=3), dict(kernel="pallas"),
             dict(kernel="xla", qim_precision="fast", delta=12),
             dict(verified_embed=True, repair_rounds=5, allow_residual=True),
             dict(delta=0), dict(delta=-3), dict(num_ac_coeffs=64),
             dict(num_ac_coeffs=-1), dict(kernel="cuda"),
             dict(qim_precision="tf32"), dict(qim_precision="fast", delta=11)]
    for kw in cases:
        try:
            j = jconfig.StegoConfig(**kw)
        except ValueError:
            with pytest.raises(ValueError):
                tconfig.StegoConfig(**kw)
            continue
        t = tconfig.StegoConfig(**dataclasses.asdict(j))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.frame_capacity_bits(1080, 1920) == \
            j.frame_capacity_bits(1080, 1920)
    assert tconfig.crop_dims(1081, 1367) == jconfig.crop_dims(1081, 1367)


def test_bitstream_codecs_equal():
    rng = np.random.default_rng(2)
    data = rng.bytes(37)
    bits = jbits.bytes_to_bits(data)
    np.testing.assert_array_equal(tbits.bytes_to_bits(data), bits)
    assert tbits.bits_to_bytes(bits[:-3]) == jbits.bits_to_bytes(bits[:-3])
    for v, n in ((0, 1), (5, 8), (65535, 16), (123456, 32)):
        np.testing.assert_array_equal(tbits.int_to_bits(v, n),
                                      jbits.int_to_bits(v, n))
        assert tbits.bits_to_int(jbits.int_to_bits(v, n)) == v
    s = jbits.bits_to_string(bits)
    assert tbits.bits_to_string(bits) == s
    np.testing.assert_array_equal(tbits.string_to_bits(s),
                                  jbits.string_to_bits(s))
    np.testing.assert_array_equal(tbits.pad_bits(bits, 400, 1),
                                  jbits.pad_bits(bits, 400, 1))
    for fn, args in (("bits_to_bytes", (bits[:7],)), ("int_to_bits", (256, 8)),
                     ("string_to_bits", ("0120",)), ("pad_bits", (bits, 3)),
                     ("bits_to_int", (bits[:4], 5))):
        with pytest.raises(ValueError):
            getattr(jbits, fn)(*args)
        with pytest.raises(ValueError):
            getattr(tbits, fn)(*args)


def _receiver():
    priv, pub = jcrypto.generate_keypair(np.random.default_rng(9))
    return priv, jcrypto.serialize_public_compressed(pub)


def test_seal_and_parse_equal():
    """seal_payload with the same seeded rng gives identical bits and
    parts; the parsers read identical fields, positions and errors."""
    priv, pub = _receiver()
    data = np.random.default_rng(3).bytes(300)
    for dims in (16, 12):
        jb, jp = jpayload.seal_payload(data, 20, 15, pub, dims,
                                       rng=np.random.default_rng(4))
        tb, tp = tpayload.seal_payload(data, 20, 15, pub, dims,
                                       rng=np.random.default_rng(4))
        np.testing.assert_array_equal(tb, jb)
        assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
        noisy = np.concatenate([jb, np.ones(77, np.uint8)])
        th, tlen, tpos = tpayload.parse_header_bits(noisy, dims)
        jh, jlen, jpos = jpayload.parse_header_bits(noisy, dims)
        assert (dataclasses.astuple(th), tlen, tpos) == \
            (dataclasses.astuple(jh), jlen, jpos)
        tparts, tused = tpayload.parse_payload_bits(noisy, dims)
        jparts, jused = jpayload.parse_payload_bits(noisy, dims)
        assert dataclasses.astuple(tparts) == dataclasses.astuple(jparts)
        assert tused == jused == jb.size
        np.testing.assert_array_equal(tpayload.build_payload_bits(tparts, dims),
                                      jb)
        with pytest.raises(tpayload.NeedMoreBits) as te:
            tpayload.parse_payload_bits(jb[:-9], dims)
        with pytest.raises(jpayload.NeedMoreBits) as je:
            jpayload.parse_payload_bits(jb[:-9], dims)
        assert te.value.needed == je.value.needed
        plain, ok = tpayload.open_payload(tparts, priv)
        assert plain == data and ok
    with pytest.raises(ValueError):
        tpayload.parse_header_bits(np.zeros(976, np.uint8))
    assert tpayload.FIXED_HEADER_BITS == jpayload.FIXED_HEADER_BITS
    assert tpayload.max_header_bits(12) == jpayload.max_header_bits(12)
    assert tpayload.RAW_DATA_DIMS == jpayload.RAW_DATA_DIMS


def test_pem_keys_cross_load(tmp_path):
    """PEM files are a shared format: each package loads the other's keys,
    encrypted or not, and derives the same key agreement."""
    priv, _ = jcrypto.generate_keypair(np.random.default_rng(5))
    jcrypto.save_keypair_pem(priv, tmp_path / "j.pem", tmp_path / "j.pub")
    t = tcrypto.load_private_pem(tmp_path / "j.pem")
    assert t.private_numbers() == priv.private_numbers()
    assert tcrypto.load_public_pem(tmp_path / "j.pub").public_numbers() == \
        priv.public_key().public_numbers()
    tpriv, tpub = tcrypto.generate_keypair(np.random.default_rng(5))
    assert tpriv.private_numbers() == priv.private_numbers()
    tcrypto.save_keypair_pem(tpriv, tmp_path / "t.pem", tmp_path / "t.pub",
                             passphrase=b"pw")
    back = jcrypto.load_private_pem(tmp_path / "t.pem", passphrase=b"pw")
    assert back.private_numbers() == priv.private_numbers()
    other, other_pub = jcrypto.generate_keypair(np.random.default_rng(6))
    assert tcrypto.ecdh_shared_secret(tpriv, other_pub) == \
        jcrypto.ecdh_shared_secret(priv, other_pub)
    key = tcrypto.derive_aes_key(b"s" * 32, b"salt")
    assert key == jcrypto.derive_aes_key(b"s" * 32, b"salt")
    ct, nonce, tag = tcrypto.aes_gcm_encrypt(b"msg", key,
                                             np.random.default_rng(7))
    assert (ct, nonce, tag) == jcrypto.aes_gcm_encrypt(
        b"msg", key, np.random.default_rng(7))
    assert jcrypto.aes_gcm_decrypt(ct, key, nonce, tag) == b"msg"
    assert tcrypto.aes_gcm_decrypt(ct, key, nonce, b"\0" * 16) is None
    assert tcrypto.sha3_256(b"x") == jcrypto.sha3_256(b"x")
    rpriv, rpub = tcrypto.setup_receiver_keys(tmp_path / "r.pem",
                                              tmp_path / "r.pub")
    assert jcrypto.setup_receiver_keys(tmp_path / "r.pem",
                                       tmp_path / "r.pub")[1] == rpub


def test_image_codec_equal(tmp_path):
    for name in ("secret.png", "rev2_secret.png"):
        w, h, bits = timage.image_to_bits(GOLDEN / name)
        jw, jh, jb = jimage.image_to_bits(GOLDEN / name)
        assert (w, h) == (jw, jh)
        np.testing.assert_array_equal(bits, jb)
    px = np.random.default_rng(8).integers(0, 256, (9, 13), np.uint8)
    timage.save_image_gray(px, tmp_path / "a.png")
    np.testing.assert_array_equal(jimage.load_image_gray(tmp_path / "a.png"),
                                  px)
    assert timage.pixels_to_bytes(px) == jimage.pixels_to_bytes(px)
    np.testing.assert_array_equal(
        timage.bytes_to_pixels(px.tobytes(), 13, 9), px)
    with pytest.raises(ValueError):
        timage.bytes_to_pixels(px.tobytes(), 12, 9)


def test_fixtures_equal(tmp_path):
    """stegotpu_torch.fixtures writes the same secret images and cover
    videos as stegotpu.fixtures from the same arguments."""
    import cv2

    from stegotpu import fixtures as jfix
    from stegotpu_torch import fixtures as tfix

    for kind in ("gray", "pattern", "noise"):
        tfix.make_secret_image(tmp_path / f"t_{kind}.png", 20, 14, kind, 3)
        jfix.make_secret_image(tmp_path / f"j_{kind}.png", 20, 14, kind, 3)
        np.testing.assert_array_equal(
            timage.load_image_gray(tmp_path / f"t_{kind}.png"),
            jimage.load_image_gray(tmp_path / f"j_{kind}.png"))
    with pytest.raises(ValueError):
        tfix.make_secret_image(tmp_path / "x.png", kind="stripes")

    def frames(path):
        cap = cv2.VideoCapture(str(path))
        out = []
        while True:
            ok, f = cap.read()
            if not ok:
                cap.release()
                return np.stack(out)
            out.append(f)

    for kind in ("moving", "noise"):
        tfix.make_cover_video(tmp_path / f"t_{kind}.mp4", 64, 48, 5,
                              kind=kind, seed=2)
        jfix.make_cover_video(tmp_path / f"j_{kind}.mp4", 64, 48, 5,
                              kind=kind, seed=2)
        t = frames(tmp_path / f"t_{kind}.mp4")
        assert t.shape == (5, 48, 64, 3)
        np.testing.assert_array_equal(t, frames(tmp_path / f"j_{kind}.mp4"))


def test_profiling_stage_timer_and_trace(tmp_path):
    """StageTimer is the JAX package's (the same report for the same stage
    totals); device_trace writes a Chrome trace that holds an annotate
    range."""
    from stegotpu.utils import profiling as jprof
    from stegotpu_torch.utils import profiling as tprof

    reports = []
    for mod in (jprof, tprof):
        timer = mod.StageTimer()
        with timer.stage("decode"):
            pass
        timer.totals.update(decode=0.5, encode=1.25)
        timer.counts.update(encode=5)
        reports.append(timer.report())
    assert reports[0] == reports[1]
    assert reports[1].splitlines()[0].startswith("encode: 1.250s total")
    with tprof.device_trace(tmp_path / "trace"):
        with tprof.annotate("stegotpu-span"):
            torch.ones(4).sum()
    assert "stegotpu-span" in (tmp_path / "trace" / "trace.json").read_text()

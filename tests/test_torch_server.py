"""The port's serving daemon (stegotpu_torch.server) on the CPU.

The tests of tests/test_server.py against the port's
``make_server(port=0, device="cpu")`` at the same sizes; the port's server
held to the JAX server (``stegotpu.server``) in one process on the same
request bodies (status codes, response keys, integer fields, PSNR and
detection ratio within a stated tolerance); stego files that each package
extracts from the other pixel-identically; the CLI's ``serve``; a server
that names no device needs the card; a CUDA error reaches the client as a
500, once.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from stegotpu import payload as jpayload
from stegotpu import pipeline as jpipeline
from stegotpu import server as jserver
from stegotpu_torch import crypto, fixtures
from stegotpu_torch import payload as tpayload
from stegotpu_torch import server as tserver
from stegotpu_torch.cli import main as cli_main
from stegotpu_torch.image import load_image_gray
from stegotpu_torch.server import make_server

# first-frame PSNR of the two packages' stego of one sealed payload: their
# f32 embeds may round a coefficient at a rounding boundary apart
PSNR_TOL_DB = 0.05
# steganalysis detection ratio, rounded to 3 places by both servers
RATIO_TOL = 0.01


def _start(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t


@pytest.fixture
def server():
    srv = make_server(port=0, device="cpu")
    t = _start(srv)
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


@pytest.fixture
def both():
    """(port server URL, JAX server URL), both serving in this process."""
    srvs = [make_server(port=0, device="cpu"), jserver.make_server(port=0)]
    threads = [_start(s) for s in srvs]
    yield tuple(f"http://127.0.0.1:{s.server_address[1]}" for s in srvs)
    for s, t in zip(srvs, threads):
        s.shutdown()
        s.server_close()
        t.join(timeout=10)


def _post(base, path, payload, raw: bytes | None = None):
    req = urllib.request.Request(
        base + path, data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_serve_embed_inspect_extract_roundtrip(server, tmp_path):
    fixtures.make_secret_image(tmp_path / "s.png", 24, 24, kind="noise", seed=2)
    fixtures.make_cover_video(tmp_path / "c.mp4", 160, 128, frames=8,
                              kind="moving", seed=3)
    crypto.setup_receiver_keys(tmp_path / "k.pem", tmp_path / "p.pem")

    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["ok"]

    code, out = _post(server, "/embed", {
        "cover": str(tmp_path / "c.mp4"), "secret": str(tmp_path / "s.png"),
        "output": str(tmp_path / "st"), "public_key": str(tmp_path / "p.pem"),
    })
    assert code == 200 and out["success"], out
    assert out["frames_used"] == 8 and out["first_frame_psnr_db"] > 25

    code, out = _post(server, "/inspect", {"stego": str(tmp_path / "st.avi")})
    assert code == 200 and out["payload_type"] == "image"
    assert (out["secret_width"], out["secret_height"]) == (24, 24)

    code, out = _post(server, "/extract", {
        "stego": str(tmp_path / "st.avi"), "output": str(tmp_path / "out.png"),
        "private_key": str(tmp_path / "k.pem"),
    })
    assert code == 200 and out["success"] and out["hash_ok"], out
    np.testing.assert_array_equal(load_image_gray(tmp_path / "out.png"),
                                  load_image_gray(tmp_path / "s.png"))

    # wrong delta: structured 422, daemon stays alive
    code, out = _post(server, "/extract", {
        "stego": str(tmp_path / "st.avi"),
        "private_key": str(tmp_path / "k.pem"), "delta": 19,
    })
    assert code == 422 and not out["success"] and "error" in out

    # missing field -> 400; unknown route -> 404; still healthy after all
    code, out = _post(server, "/embed", {
        "secret": "x.png", "public_key": str(tmp_path / "p.pem")})
    assert code == 400 and "missing required field" in out["error"]
    code, _ = _post(server, "/nope", {})
    assert code == 404
    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        assert r.status == 200


def test_serve_capacity_and_steganalyze(server, tmp_path):
    fixtures.make_secret_image(tmp_path / "s.png", 48, 48, kind="noise", seed=2)
    fixtures.make_cover_video(tmp_path / "c.mp4", 320, 240, frames=6,
                              kind="moving", seed=3)
    crypto.setup_receiver_keys(tmp_path / "k.pem", tmp_path / "p.pem")
    code, out = _post(server, "/capacity", {"video": str(tmp_path / "c.mp4")})
    assert code == 200 and out["qim_bits_per_frame"] == 30 * 40 * 10

    code, out = _post(server, "/embed", {
        "cover": str(tmp_path / "c.mp4"), "secret": str(tmp_path / "s.png"),
        "output": str(tmp_path / "st"), "public_key": str(tmp_path / "p.pem"),
    })
    assert code == 200 and out["success"]
    code, out = _post(server, "/steganalyze",
                      {"video": str(tmp_path / "st.avi")})
    assert code == 200 and out["detected"]
    assert out["estimated_delta"] == 20


def test_serve_rejects_cross_origin_shapes(server):
    """Browser-reachable request shapes are refused: no/simple Content-Type
    -> 415, foreign Host header -> 403 (DNS rebinding)."""
    req = urllib.request.Request(
        server + "/inspect", data=b'{"stego":"x"}',
        headers={"Content-Type": "text/plain"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 415

    req = urllib.request.Request(
        server + "/inspect", data=b'{"stego":"x"}',
        headers={"Content-Type": "application/json",
                 "Host": "evil.example.com"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 403


def test_serve_host_header_bracket_aware(server):
    """Bracketed IPv6 and port-suffixed Host headers pass the rebinding
    check; foreign hosts, bracketed or not, do not."""
    for host in ("[::1]", "[::1]:8752", "localhost:1234", "127.0.0.1:80"):
        req = urllib.request.Request(
            server + "/inspect", data=b'{"stego": "/nonexistent.avi"}',
            headers={"Content-Type": "application/json", "Host": host},
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        # 400 = past the host check into the handler (file missing)
        assert e.value.code == 400, host
    for host in ("evil.example.com:80", "[2001:db8::1]"):
        req = urllib.request.Request(
            server + "/inspect", data=b'{"stego": "x"}',
            headers={"Content-Type": "application/json", "Host": host},
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 403, host


def test_serve_extract_auto_params_recovery(server, tmp_path):
    """/extract {"auto_params": true} recovers non-default delta/coeffs via
    steganalysis and reports them."""
    fixtures.make_secret_image(tmp_path / "s.png", 48, 48, kind="noise",
                               seed=7)
    fixtures.make_cover_video(tmp_path / "c.mp4", 320, 240, frames=8,
                              kind="moving", seed=8)
    crypto.setup_receiver_keys(tmp_path / "k.pem", tmp_path / "p.pem")
    code, out = _post(server, "/embed", {
        "cover": str(tmp_path / "c.mp4"), "secret": str(tmp_path / "s.png"),
        "output": str(tmp_path / "st"), "public_key": str(tmp_path / "p.pem"),
        "delta": 32, "coeffs": 3,
    })
    assert code == 200 and out["success"], out

    base = {"stego": str(tmp_path / "st.avi"),
            "output": str(tmp_path / "x.png"),
            "private_key": str(tmp_path / "k.pem")}
    code, out = _post(server, "/extract", base)  # defaults 20/10: fails
    assert not out["success"]
    code, out = _post(server, "/extract", {**base, "auto_params": True})
    assert code == 200 and out["success"], out
    assert out["recovered_params"] == {"delta": 32, "coeffs": 3}
    secret = np.array(load_image_gray(tmp_path / "s.png"))
    np.testing.assert_array_equal(load_image_gray(tmp_path / "x.png"), secret)


def test_serve_with_encrypted_key_env_passphrase(server, tmp_path,
                                                 monkeypatch):
    """The daemon extracts with an at-rest-encrypted private PEM, decrypted
    via STEGOTPU_KEY_PASSPHRASE."""
    monkeypatch.setenv("STEGOTPU_KEY_PASSPHRASE", "daemon-secret")
    fixtures.make_secret_image(tmp_path / "s.png", 24, 24, kind="noise",
                               seed=4)
    fixtures.make_cover_video(tmp_path / "c.mp4", 160, 128, frames=8,
                              kind="moving", seed=5)
    crypto.setup_receiver_keys(tmp_path / "ek.pem", tmp_path / "ep.pem",
                               b"daemon-secret")
    assert b"ENCRYPTED" in (tmp_path / "ek.pem").read_bytes()

    code, out = _post(server, "/embed", {
        "cover": str(tmp_path / "c.mp4"), "secret": str(tmp_path / "s.png"),
        "output": str(tmp_path / "st"), "public_key": str(tmp_path / "ep.pem"),
    })
    assert code == 200 and out["success"], out
    code, out = _post(server, "/extract", {
        "stego": str(tmp_path / "st.avi"),
        "output": str(tmp_path / "x.png"),
        "private_key": str(tmp_path / "ek.pem"),
    })
    assert code == 200 and out["success"], out
    np.testing.assert_array_equal(load_image_gray(tmp_path / "x.png"),
                                  load_image_gray(tmp_path / "s.png"))


def test_serve_wildcard_bind_accepts_any_host():
    """A 0.0.0.0 bind exposes the daemon on every interface, so the
    anti-rebinding Host allowlist is disabled there."""
    srv = make_server(host="0.0.0.0", port=0, device="cpu")
    port = srv.server_address[1]
    t = _start(srv)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/inspect",
            data=b'{"stego": "/nonexistent.avi"}',
            headers={"Content-Type": "application/json",
                     "Host": "192.168.1.5:8752"},
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


# --- parity with the JAX server ----------------------------------------------

INT_FIELDS = ("payload_bits", "bits_embedded", "frames_used", "residual_bits",
              "frames_read", "width", "height", "frames",
              "qim_bits_per_frame", "total_qim_bits", "max_secret_pixels",
              "secret_width", "secret_height", "estimated_delta",
              "estimated_num_ac")


def _same(ours: tuple, theirs: tuple, what: str) -> None:
    """(status, body) of the port's server against the JAX server's."""
    (c1, o1), (c2, o2) = ours, theirs
    assert c1 == c2, (what, ours, theirs)
    assert sorted(o1) == sorted(o2), (what, o1, o2)
    for k in INT_FIELDS:
        if k in o1:
            assert o1[k] == o2[k], (what, k, o1, o2)
    if "first_frame_psnr_db" in o1:
        assert abs(o1["first_frame_psnr_db"]
                   - o2["first_frame_psnr_db"]) <= PSNR_TOL_DB, (what, o1, o2)
    if "detection_ratio" in o1:
        assert abs(o1["detection_ratio"]
                   - o2["detection_ratio"]) <= RATIO_TOL, (what, o1, o2)


@pytest.fixture
def seeded_seal(monkeypatch):
    """Both packages seal with one seeded crypto stream (a test build's
    rng, payload.seal_payload), so that their stego carries the same
    bits and their PSNR compares."""
    for mod in (jpayload, tpayload):
        real = mod.seal_payload

        def seal(*a, _real=real, **kw):
            kw["rng"] = np.random.default_rng(9)
            return _real(*a, **kw)

        monkeypatch.setattr(mod, "seal_payload", seal)


def test_port_server_matches_jax_server(both, tmp_path, seeded_seal):
    """The same bodies to both servers: the round trip (embed, inspect,
    capacity, steganalyze, extract), delta 0, delta 19 on a delta-20
    stego, a missing field, an unknown route and a non-object body give
    the same status codes, keys and integer fields."""
    ours, theirs = both
    fixtures.make_secret_image(tmp_path / "s.png", 40, 40, kind="noise",
                               seed=2)
    fixtures.make_cover_video(tmp_path / "c.mp4", 320, 240, frames=6,
                              kind="moving", seed=3)
    crypto.setup_receiver_keys(tmp_path / "k.pem", tmp_path / "p.pem")
    keys = {"public_key": str(tmp_path / "p.pem"),
            "private_key": str(tmp_path / "k.pem")}

    def send(path, body, raw=None):
        got = []
        for base, tag in ((ours, "t"), (theirs, "j")):
            b = {k: (v.format(tag=tag) if isinstance(v, str) else v)
                 for k, v in body.items()}
            got.append(_post(base, path, b, raw))
        _same(got[0], got[1], f"{path} {body}")
        return got

    embed = {"cover": str(tmp_path / "c.mp4"),
             "secret": str(tmp_path / "s.png"),
             "output": str(tmp_path / "st_{tag}"), **keys}
    (c, out), _ = send("/embed", embed)
    assert c == 200 and out["success"] and out["residual_bits"] == 0, out
    (_, ins_t), (_, ins_j) = send("/inspect", {"stego": str(tmp_path / "st_{tag}.avi")})
    assert ins_t == ins_j  # one sealed payload: the whole header agrees
    send("/capacity", {"video": str(tmp_path / "c.mp4")})
    (c, out), _ = send("/steganalyze", {"video": str(tmp_path / "st_{tag}.avi")})
    assert c == 200 and out["detected"] and out["estimated_delta"] == 20
    (c, out), _ = send("/extract", {"stego": str(tmp_path / "st_{tag}.avi"),
                                    "output": str(tmp_path / "x_{tag}.png"),
                                    **keys})
    assert c == 200 and out["hash_ok"], out
    for tag in "tj":
        np.testing.assert_array_equal(load_image_gray(tmp_path / f"x_{tag}.png"),
                                      load_image_gray(tmp_path / "s.png"))

    (c, _), _ = send("/embed", {**embed, "delta": 0})
    assert c == 400
    (c, _), _ = send("/extract", {"stego": str(tmp_path / "st_{tag}.avi"),
                                  "delta": 0, **keys})
    assert c == 400
    (c, _), _ = send("/extract", {"stego": str(tmp_path / "st_{tag}.avi"),
                                  "delta": 19, **keys})
    assert c == 422
    send("/inspect", {"stego": str(tmp_path / "st_{tag}.avi"), "delta": 19})
    (c, out), _ = send("/embed", {"secret": "x.png", **keys})
    assert c == 400 and "'cover'" in out["error"]
    (c, _), _ = send("/nope", {})
    assert c == 404
    (c, out), _ = send("/extract", {}, raw=b"[1, 2]")
    assert c == 400 and "JSON object" in out["error"]


def test_stego_crosses_between_packages(both, tmp_path):
    """One key pair: the port server's stego extracts pixel-identically
    through stegotpu.pipeline, and the JAX server's through the port's
    /extract."""
    ours, theirs = both
    fixtures.make_secret_image(tmp_path / "s.png", 24, 24, kind="noise",
                               seed=6)
    fixtures.make_cover_video(tmp_path / "c.mp4", 160, 128, frames=8,
                              kind="moving", seed=7)
    priv, _ = crypto.setup_receiver_keys(tmp_path / "k.pem", tmp_path / "p.pem")
    secret = load_image_gray(tmp_path / "s.png")
    for base, name in ((ours, "t"), (theirs, "j")):
        code, out = _post(base, "/embed", {
            "cover": str(tmp_path / "c.mp4"), "secret": str(tmp_path / "s.png"),
            "output": str(tmp_path / name),
            "public_key": str(tmp_path / "p.pem")})
        assert code == 200 and out["success"], out

    from stegotpu import crypto as jcrypto
    from stegotpu.config import StegoConfig

    res = jpipeline.extract_image_from_video(
        tmp_path / "t.avi", jcrypto.load_private_pem(tmp_path / "k.pem"),
        StegoConfig())
    assert res.success and res.hash_ok
    np.testing.assert_array_equal(res.pixels, secret)

    code, out = _post(ours, "/extract", {
        "stego": str(tmp_path / "j.avi"), "output": str(tmp_path / "x.png"),
        "private_key": str(tmp_path / "k.pem")})
    assert code == 200 and out["success"] and out["hash_ok"], out
    np.testing.assert_array_equal(load_image_gray(tmp_path / "x.png"), secret)


# --- device, CLI and errors ----------------------------------------------------

def test_make_server_needs_the_card_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_server(port=0)
    srv = make_server(port=0, device="cpu")
    try:
        assert srv.device == torch.device("cpu")
    finally:
        srv.server_close()


@pytest.mark.parametrize("argv,want", [
    (["serve"], ("127.0.0.1", 8752, None)),
    (["--device", "cpu", "serve", "--host", "::1", "--port", "9000"],
     ("::1", 9000, "cpu")),
])
def test_cli_serve_passes_host_port_and_device(argv, want, monkeypatch):
    calls = []
    monkeypatch.setattr(tserver, "serve", lambda *a: calls.append(a))
    assert cli_main(argv) == 0
    assert calls == [want]


def test_serve_warms_the_device_before_it_binds(monkeypatch):
    """serve() resolves the device, warms it (on the card: the kernel
    build and the context), then builds the server on that device, and
    closes it when interrupted. make_server itself builds nothing."""
    order = []

    class Fake:
        server_address = ("127.0.0.1", 1)

        def serve_forever(self):
            order.append("serve_forever")
            raise KeyboardInterrupt

        def server_close(self):
            order.append("close")

    monkeypatch.setattr(tserver, "_warm", lambda d: order.append(("warm", d)))
    monkeypatch.setattr(tserver, "make_server",
                        lambda h, p, d: order.append(("bind", h, p, d)) or Fake())
    tserver.serve("127.0.0.1", 0, "cpu")
    cpu = torch.device("cpu")
    assert order == [("warm", cpu), ("bind", "127.0.0.1", 0, cpu),
                     "serve_forever", "close"]

    from stegotpu_torch.ops import _build

    monkeypatch.setattr(_build, "build", lambda: pytest.fail("built on cpu"))
    tserver._warm(cpu)  # the CPU needs no library


def test_runtime_error_is_a_500_and_not_retried(server, tmp_path, monkeypatch):
    """A kernel's CUDA error (a RuntimeError) reaches the client as a 500
    with its message, from one call; a ValueError is the client's 400."""
    import stegotpu_torch.pipeline as tpipeline

    crypto.setup_receiver_keys(tmp_path / "k.pem", tmp_path / "p.pem")
    calls = []

    def boom(*a, **kw):
        calls.append(kw.get("device"))
        raise RuntimeError("stegotpu_qim_embed: CUDA error 700 (an illegal "
                           "memory access was encountered)")

    monkeypatch.setattr(tpipeline, "embed_image_in_video", boom)
    body = {"cover": "c.mp4", "secret": "s.png", "output": "o",
            "public_key": str(tmp_path / "p.pem")}
    code, out = _post(server, "/embed", body)
    assert code == 500 and "CUDA error 700" in out["error"]
    assert out["error"].startswith("RuntimeError: ")
    assert calls == [torch.device("cpu")]

    def bad(*a, **kw):
        raise ValueError("frame height is not a multiple of 8")

    monkeypatch.setattr(tpipeline, "embed_image_in_video", bad)
    code, out = _post(server, "/embed", body)
    assert code == 400 and "multiple of 8" in out["error"]


def test_body_guards_match_jax(both):
    """A body over the 1 MiB cap is a 413 and a negative Content-Length a
    400, before any body is read, on both servers."""
    import http.client
    from urllib.parse import urlsplit

    for base in both:
        code, out = _post(base, "/inspect", None, raw=b" " * ((1 << 20) + 1))
        assert code == 413 and "too large" in out["error"]
        u = urlsplit(base)
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
        try:
            conn.putrequest("POST", "/inspect")
            conn.putheader("Content-Type", "application/json")
            conn.putheader("Content-Length", "-1")
            conn.endheaders()
            r = conn.getresponse()
            assert r.status == 400
            assert "Content-Length" in json.loads(r.read())["error"]
        finally:
            conn.close()

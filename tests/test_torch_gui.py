"""The port's GUI (stegotpu_torch.gui) on the CPU.

The tests of tests/test_gui.py against stegotpu_torch.gui, with
``device="cpu"`` in the workers' snapshot. The Tk-backed tests skip when
Tk or a display is missing, as there; the worker-logic tests run headless
by duck-typing the app object: workers only touch plain Python state
(queue, snapshot), never Tk. Beside them: the module imports and its
workers run with tkinter blocked, and the window needs the card unless
given a device.
"""

import queue
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def _make_root():
    tk = pytest.importorskip("tkinter")
    try:
        root = tk.Tk()
        root.withdraw()
        return root
    except tk.TclError:
        pytest.skip("no display available")


def test_gui_constructs_and_switches_modes():
    from stegotpu_torch.gui import StegoApp

    root = _make_root()
    try:
        app = StegoApp(root, device="cpu")
        assert app.delta.get() == 20 and app.coeffs.get() == 10
        assert app.device == torch.device("cpu")
        for mode in ("extract", "genkey", "embed"):
            app.mode.set(mode)
            app._refresh_fields()
            assert len(app.fields.winfo_children()) > 0
    finally:
        root.destroy()


def test_gui_log_queue_drains():
    from stegotpu_torch.gui import StegoApp

    root = _make_root()
    try:
        app = StegoApp(root, device="cpu")
        app._log("hello from worker", "OK")
        root.update()
        kind, msg, tag = app._q.get_nowait()
        assert (kind, msg, tag) == ("log", "hello from worker", "OK")
    finally:
        root.destroy()


class _Var:
    def __init__(self, value=""):
        self._v = value

    def get(self):
        return self._v


class _HeadlessApp:
    """Duck-typed stand-in: real worker methods, no Tk objects."""

    def __init__(self, paths, delta=20, coeffs=10, auto_recover=False,
                 procs="1", precision="wire"):
        from stegotpu_torch.gui import StegoApp

        self._q = queue.Queue()
        self.paths = {k: _Var(v) for k, v in paths.items()}
        self._delta, self._coeffs = delta, coeffs
        self.auto_recover = _Var(auto_recover)
        self.procs = _Var(procs)
        self.precision = _Var(precision)
        self._do_extract_m = StegoApp._do_extract.__get__(self)
        self._do_embed_m = StegoApp._do_embed.__get__(self)
        self._procs_value = StegoApp._procs_value.__get__(self)

    def snapshot(self):
        # mirrors StegoApp._run's main-thread snapshot: workers receive
        # plain values (the device among them), never Tk variables
        return {
            "paths": {k: v.get() for k, v in self.paths.items()},
            "config": self._config(),
            "procs": self._procs_value(),
            "auto_recover": bool(self.auto_recover.get()),
            "device": torch.device("cpu"),
        }

    def _do_embed(self):
        return self._do_embed_m(self.snapshot())

    def _do_extract(self):
        return self._do_extract_m(self.snapshot())

    def _config(self):
        from stegotpu_torch.config import StegoConfig

        return StegoConfig(delta=self._delta, num_ac_coeffs=self._coeffs,
                           qim_precision=self.precision.get())

    def _log(self, msg, tag="INFO"):
        self._q.put(("log", msg, tag))

    def drain(self):
        out = []
        try:
            while True:
                out.append(self._q.get_nowait())
        except queue.Empty:
            return out


def test_gui_worker_embed_extract_headless(tmp_path):
    """The embed and extract workers run end-to-end with no display, and
    extraction requests the image PREVIEW through the queue."""
    from stegotpu_torch import crypto, fixtures

    fixtures.make_secret_image(tmp_path / "secret.png", 16, 16, kind="pattern")
    fixtures.make_cover_video(tmp_path / "cover.mp4", 320, 240, frames=4,
                              kind="moving")
    crypto.setup_receiver_keys(tmp_path / "priv.pem", tmp_path / "pub.pem")

    app = _HeadlessApp({
        "cover": str(tmp_path / "cover.mp4"),
        "secret": str(tmp_path / "secret.png"),
        "stego_out": str(tmp_path / "stego.avi"),
        "stego_in": str(tmp_path / "stego.avi"),
        "image_out": str(tmp_path / "extracted.png"),
        "pub_key": str(tmp_path / "pub.pem"),
        "priv_key": str(tmp_path / "priv.pem"),
    })
    app._do_embed()
    msgs = app.drain()
    assert any("embedded" in m[1] for m in msgs if m[0] == "log")
    assert not any(m[2] == "ERR" for m in msgs if m[0] == "log")

    app._do_extract()
    msgs = app.drain()
    assert any("SHA3-256 integrity: OK" in m[1] for m in msgs if m[0] == "log")
    previews = [m for m in msgs if m[0] == "preview"]
    assert previews == [("preview", str(tmp_path / "extracted.png"))]


def test_gui_worker_extract_failure_is_logged_not_raised(tmp_path):
    from stegotpu_torch import crypto, fixtures

    fixtures.make_cover_video(tmp_path / "plain.mp4", 320, 240, frames=2,
                              kind="noise")
    crypto.setup_receiver_keys(tmp_path / "priv.pem", tmp_path / "pub.pem")
    app = _HeadlessApp({
        "stego_in": str(tmp_path / "plain.mp4"),
        "image_out": str(tmp_path / "x.png"),
        "priv_key": str(tmp_path / "priv.pem"),
        "secret": "",
    })
    app._do_extract()
    msgs = app.drain()
    assert any(m[2] == "ERR" and "EXTRACT FAILED" in m[1]
               for m in msgs if m[0] == "log")
    assert not [m for m in msgs if m[0] == "preview"]


def test_queue_log_handler_streams_pipeline_records():
    """Pipeline log records (incl. per-batch DEBUG progress) flow into the
    GUI queue with level-mapped tags."""
    import logging

    from stegotpu_torch.gui import QueueLogHandler

    q = queue.Queue()
    h = QueueLogHandler(q)
    h.setFormatter(logging.Formatter("%(message)s"))
    logger = logging.getLogger("stegotpu_torch.test_queue_handler")
    logger.setLevel(logging.DEBUG)
    logger.addHandler(h)
    try:
        logger.debug("embed progress: 100/200 bits, frame 8")
        logger.warning("video ended early")
        logger.error("boom")
    finally:
        logger.removeHandler(h)

    got = [q.get_nowait() for _ in range(3)]
    assert got[0] == ("log", "embed progress: 100/200 bits, frame 8", "INFO")
    assert got[1] == ("log", "video ended early", "RUN")
    assert got[2] == ("log", "boom", "ERR")
    assert q.empty()


def test_gui_worker_extract_auto_recover(tmp_path):
    """The 'auto-recover params' checkbox path: extraction with wrong
    delta/coeffs recovers them via steganalysis and succeeds."""
    from stegotpu_torch import crypto, fixtures
    from stegotpu_torch.config import StegoConfig
    from stegotpu_torch.pipeline import embed_image_in_video

    fixtures.make_secret_image(tmp_path / "s.png", 48, 48, kind="noise",
                               seed=31)
    fixtures.make_cover_video(tmp_path / "c.mp4", 320, 240, frames=6,
                              kind="moving", seed=32)
    priv, pub_c = crypto.setup_receiver_keys(tmp_path / "priv.pem",
                                             tmp_path / "pub.pem")
    res = embed_image_in_video(tmp_path / "c.mp4", tmp_path / "s.png",
                               tmp_path / "st", pub_c,
                               StegoConfig(delta=32, num_ac_coeffs=3),
                               device="cpu")
    assert res.success

    app = _HeadlessApp({
        "stego_in": str(tmp_path / "st.avi"),
        "image_out": str(tmp_path / "x.png"),
        "priv_key": str(tmp_path / "priv.pem"),
        "secret": "",
    }, auto_recover=True)  # defaults 20/10 are wrong; recovery fixes them
    app._do_extract()
    msgs = app.drain()
    assert any("RECOVERY: " in m[1] and "delta=32" in m[1]
               for m in msgs if m[0] == "log"), msgs
    assert any("recovered parameters: delta=32, coeffs=3" in m[1]
               for m in msgs if m[0] == "log")
    assert any("SHA3-256 integrity: OK" in m[1] for m in msgs if m[0] == "log")


def test_gui_worker_procs_knob_headless(tmp_path):
    """The GUI procs knob routes embed AND extract through the
    segment-parallel path (parallel.local_procs); 'auto' and bad values
    degrade gracefully."""
    from stegotpu_torch import crypto, fixtures
    from stegotpu_torch.native.videoio import available

    if not available():
        pytest.skip("native concat layer not built")
    fixtures.make_secret_image(tmp_path / "s.png", 16, 16, kind="pattern")
    fixtures.make_cover_video(tmp_path / "c.mp4", 320, 240, frames=8,
                              kind="moving")
    crypto.setup_receiver_keys(tmp_path / "priv.pem", tmp_path / "pub.pem")
    paths = {
        "cover": str(tmp_path / "c.mp4"), "secret": str(tmp_path / "s.png"),
        "stego_out": str(tmp_path / "st.avi"),
        "stego_in": str(tmp_path / "st.avi"),
        "image_out": str(tmp_path / "x.png"),
        "pub_key": str(tmp_path / "pub.pem"),
        "priv_key": str(tmp_path / "priv.pem"),
    }
    app = _HeadlessApp(paths, procs="2")
    app._do_embed()
    msgs = app.drain()
    assert any("embedded" in m[1] for m in msgs if m[0] == "log"), msgs
    assert not any(m[2] == "ERR" for m in msgs if m[0] == "log"), msgs
    app._do_extract()
    msgs = app.drain()
    assert any("image ->" in m[1] for m in msgs if m[0] == "log"), msgs

    assert _HeadlessApp(paths, procs="auto")._procs_value() == "auto"
    bad = _HeadlessApp(paths, procs="oops")
    assert bad._procs_value() == 1  # logged, not raised


def test_gui_worker_precision_knob_plumbs(tmp_path):
    """The precision knob lands in StegoConfig.qim_precision."""
    app = _HeadlessApp({}, precision="fast")
    assert app._config().qim_precision == "fast"
    assert _HeadlessApp({})._config().qim_precision == "wire"


def test_gui_workers_pass_the_snapshot_device(tmp_path, monkeypatch):
    """The workers hand the snapshot's device to every pipeline call, the
    segment-parallel ones included (procs 2)."""
    import stegotpu_torch.parallel.local_procs as lp
    import stegotpu_torch.pipeline as pipeline
    from stegotpu_torch import crypto

    crypto.setup_receiver_keys(tmp_path / "priv.pem", tmp_path / "pub.pem")
    seen = []

    def fake(name):
        def call(*a, **kw):
            seen.append((name, kw.get("device")))
            raise RuntimeError("stop")
        return call

    for mod, name in ((pipeline, "embed_image_in_video"),
                      (pipeline, "extract_image_from_video"),
                      (lp, "parallel_embed"), (lp, "parallel_extract")):
        monkeypatch.setattr(mod, name, fake(name))
    paths = {"cover": "c", "secret": "s", "stego_out": "o", "stego_in": "i",
             "image_out": "x", "pub_key": str(tmp_path / "pub.pem"),
             "priv_key": str(tmp_path / "priv.pem")}
    for procs in ("1", "2"):
        app = _HeadlessApp(paths, procs=procs)
        for worker in (app._do_embed, app._do_extract):
            with pytest.raises(RuntimeError, match="stop"):
                worker()
    cpu = torch.device("cpu")
    assert seen == [("embed_image_in_video", cpu),
                    ("extract_image_from_video", cpu),
                    ("parallel_embed", cpu), ("parallel_extract", cpu)]


def test_gui_window_needs_the_card_without_a_device(monkeypatch):
    """StegoApp resolves its device before it touches Tk: with no card and
    no device it raises, and builds no window."""
    from stegotpu_torch.gui import StegoApp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StegoApp(root=None)


def test_gui_workers_run_with_tkinter_blocked(tmp_path):
    """stegotpu_torch.gui imports, and its embed and extract workers
    round-trip a secret, on a machine without Tk."""
    code = f"""
import queue, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("tkinter", "_tkinter"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(REPO / "tests")!r})
from test_torch_gui import _HeadlessApp
from stegotpu_torch import crypto, fixtures
from stegotpu_torch.image import load_image_gray
import numpy as np
d = {str(tmp_path)!r}
fixtures.make_secret_image(d + "/s.png", 16, 16, kind="noise", seed=1)
fixtures.make_cover_video(d + "/c.mp4", 160, 128, frames=4, kind="moving")
crypto.setup_receiver_keys(d + "/k.pem", d + "/p.pem")
app = _HeadlessApp({{"cover": d + "/c.mp4", "secret": d + "/s.png",
    "stego_out": d + "/st.avi", "stego_in": d + "/st.avi",
    "image_out": d + "/x.png", "pub_key": d + "/p.pem",
    "priv_key": d + "/k.pem"}})
app._do_embed()
app._do_extract()
logs = [m[1] for m in app.drain() if m[0] == "log"]
assert any("SHA3-256 integrity: OK" in m for m in logs), logs
assert np.array_equal(load_image_gray(d + "/x.png"), load_image_gray(d + "/s.png"))
assert "tkinter" not in sys.modules
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"

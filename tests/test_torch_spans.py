"""The port's spans and stages (utils/profiling.annotate, StageTimer).

On the CPU: with no profiler recording, the hot path makes no
``record_function``; under a CPU ``torch.profiler`` the trace holds the
launch, unpack and eval spans, nested as the code nests them, and no
host_wait inside the evaluation; the launch door counts one launch of
every entry point in ``stripe_kernel.LAUNCHES`` (a variant under its own
key) and none that returned an error;
the file pipelines time decode, seal/unseal, files_open and files_close
and write the same stego bytes with and without a timer.

On the card (marker ``cuda``; this file imports neither JAX nor
stegotpu): under ``torch.cuda.set_sync_debug_mode("error")`` neither the
4K round trip nor its evaluation blocks the host:

    python -m pytest tests/test_torch_spans.py -m cuda --noconftest -q
"""

import contextlib
import json
import threading
import types

import numpy as np
import pytest
import torch

from stegotpu_torch import crypto, video
from stegotpu_torch.config import StegoConfig
from stegotpu_torch.image import save_image_gray
from stegotpu_torch.ops import _build, qim
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.pipeline import (embed_image_in_video,
                                     extract_image_from_video)
from stegotpu_torch.utils import profiling
from stegotpu_torch.video import VideoWriter

H, W, NUM_AC, DELTA = 48, 64, 10, 20.0


def _batch(b=2, device="cpu"):
    rng = np.random.default_rng(7)
    cap = (H // 8) * (W // 8) * NUM_AC
    frames = torch.from_numpy(rng.integers(30, 220, (b, H, W), np.uint8))
    payload = torch.from_numpy(rng.integers(0, 2, (b, cap), np.uint8))
    return frames.to(device), payload.to(device), b * cap - 5


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """A 9-frame 48x64 FFV1 cover, a 10x11 secret (its payload spans 4
    frames: batches of 2 carry it, the rest pass through) and a key pair."""
    d = tmp_path_factory.mktemp("spans")
    rng = np.random.default_rng(31)
    with VideoWriter(d / "cover.avi", 24.0, W, H) as w:
        w.write_bgr_batch(rng.integers(30, 220, (9, H, W, 3), np.uint8))
    save_image_gray(rng.integers(0, 256, (11, 10), np.uint8),
                    d / "secret.png")
    priv, pub = crypto.generate_keypair(np.random.default_rng(32))
    crypto.save_keypair_pem(priv, d / "priv.pem", d / "pub.pem")
    return d, crypto.serialize_public_compressed(pub)


def _embed(media, out, timer=None):
    d, pub = media
    res = embed_image_in_video(d / "cover.avi", d / "secret.png", out, pub,
                               StegoConfig(), batch_frames=2,
                               rng=np.random.default_rng(5), timer=timer,
                               device="cpu")
    assert res.success, res.error
    return res


class _Recorder:
    """A stage timer that records, per stage entered, its thread and the
    stages already open on that thread."""

    def __init__(self):
        self.entries = []
        self._open = threading.local()

    @contextlib.contextmanager
    def stage(self, name):
        stack = self._open.__dict__.setdefault("stack", [])
        self.entries.append((name, threading.get_ident(), tuple(stack)))
        stack.append(name)
        try:
            yield
        finally:
            stack.pop()


def _no_record_function(monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_annotate_is_one_shared_noop_without_a_profiler(monkeypatch):
    _no_record_function(monkeypatch)
    a, b = profiling.annotate("stegotpu_torch.a"), profiling.annotate("x")
    assert a is b
    with a, b:  # re-entrant
        pass


@pytest.mark.parametrize("path", ["roundtrip", "metrics", "file_embed"])
def test_no_record_function_on_the_hot_path_without_a_profiler(
        monkeypatch, media, tmp_path, path):
    _no_record_function(monkeypatch)
    frames, payload, total = _batch()
    if path == "roundtrip":
        stego, bpf, bits = sk.embed_and_extract_frames(frames, payload, total,
                                                       DELTA, NUM_AC)
        assert bits.shape == payload.shape
    elif path == "metrics":
        stego, _, bits = sk.embed_and_extract_frames(frames, payload, total,
                                                     DELTA, NUM_AC)
        m = qim.roundtrip_metrics(frames, stego, bits, payload, total)
        assert int(m["payload_bits"]) == total
    else:
        timer = profiling.StageTimer()
        _embed(media, tmp_path / "s.avi", timer)
        assert timer.totals["decode"] > 0


def _trace(tmp_path, body) -> list[dict]:
    """The complete host ranges of a CPU profile of body()."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _within(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_the_trace_holds_unpack_and_host_wait_inside_eval(tmp_path):
    frames, payload, total = _batch()

    def body():
        stego, _, bits = sk.embed_and_extract_frames(frames, payload, total,
                                                     DELTA, NUM_AC)
        qim.roundtrip_metrics(frames, stego, bits, payload, total)

    spans = _trace(tmp_path, body)
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    assert len(by["stegotpu_torch.unpack"]) == 1
    (ev,) = by["stegotpu_torch.eval"]
    # the payload-bits scalar is built on the device, not copied to it
    assert not any(_within(w, ev)
                   for w in by.get("stegotpu_torch.host_wait", []))
    assert not _within(by["stegotpu_torch.unpack"][0], ev)


def _stand_in(monkeypatch, entry: str, rc: int = 0) -> list:
    """A stand-in kernel library (a CUDA kernel has no CPU mode) whose
    `entry` records its arguments and returns `rc`; returns the record."""
    calls = []
    lib = types.SimpleNamespace(**{
        entry: lambda *a: calls.append(a) or rc,
        "stegotpu_cuda_error_string": lambda code: b"stand-in error"})
    monkeypatch.setattr(sk._build, "load_library", lambda: lib)
    return calls


@pytest.mark.parametrize("entry", sorted(_build.ARGTYPES))
def test_the_trace_names_each_launch_by_its_entry_point(monkeypatch, tmp_path,
                                                        entry):
    """launch, the one door of every kernel launch: it calls the entry
    point, opens the span named for it and counts one launch under its
    name in LAUNCHES, and nothing else."""
    calls = _stand_in(monkeypatch, entry)
    want = sk.LAUNCHES.copy()
    want[entry] += 1
    spans = _trace(tmp_path, lambda: sk.launch(entry, 1, 2))
    assert calls == [(1, 2)]
    assert [e["name"] for e in spans] == ["stegotpu_torch.launch." + entry]
    assert sk.LAUNCHES == want


def test_a_launch_that_returns_an_error_raises_and_counts_nothing(
        monkeypatch):
    entry = "stegotpu_qim_roundtrip_packed"
    calls = _stand_in(monkeypatch, entry, rc=700)
    want = sk.LAUNCHES.copy()
    with pytest.raises(RuntimeError, match=f"{entry} launch: CUDA error 700 "
                       r"\(stand-in error\)"):
        sk.launch(entry, 1, 2)
    assert calls == [(1, 2)]
    assert sk.LAUNCHES == want


def test_a_variant_is_counted_under_its_entry_point_and_name(monkeypatch):
    entry = "stegotpu_qim_ablation"
    _stand_in(monkeypatch, entry)
    want = sk.LAUNCHES.copy()
    want[entry + ":io_f4"] += 1
    sk.launch(entry, 1, 2, variant="io_f4")
    assert sk.LAUNCHES == want


def test_stage_timer_stages_are_spans_in_a_trace(tmp_path):
    timer = profiling.StageTimer()

    def body():
        with timer.stage("encode"):
            torch.ones(4).sum()

    assert [e["name"] for e in _trace(tmp_path, body)] == ["encode"]
    assert timer.counts["encode"] == 1 and timer.totals["encode"] > 0


def test_embed_stages_and_identical_stego(media, tmp_path):
    timer = profiling.StageTimer()
    timed = _embed(media, tmp_path / "timed.avi", timer)
    plain = _embed(media, tmp_path / "plain.avi")
    assert (tmp_path / "timed.avi").read_bytes() == \
        (tmp_path / "plain.avi").read_bytes()
    assert timed.bits_embedded == plain.bits_embedded
    # reader; writer and decode thread / their closes
    assert timer.counts["files_open"] == 2
    assert timer.counts["files_close"] == 2
    assert timer.counts["seal"] == 1
    # 5 batches of 2 frames (the last one short) and the end of the stream
    assert timer.counts["decode"] == 6
    assert {"decode_wait", "device_dispatch", "device_readback",
            "encode"} <= set(timer.totals)


@pytest.mark.parametrize("cores", [1, 4])
def test_decode_runs_on_the_decode_thread_or_inside_decode_wait(
        monkeypatch, media, tmp_path, cores):
    monkeypatch.setattr(video, "effective_cpu_count", lambda: cores)
    rec = _Recorder()
    _embed(media, tmp_path / "s.avi", rec)
    main = threading.get_ident()
    decode = [(tid, parents) for name, tid, parents in rec.entries
              if name == "decode"]
    assert len(decode) == 6
    if cores == 1:  # inline: nested in the main thread's decode_wait
        assert all(tid == main and parents == ("decode_wait",)
                   for tid, parents in decode)
    else:           # on the Prefetcher's thread, nested in nothing
        assert all(tid != main and parents == () for tid, parents in decode)
    top = [name for name, tid, parents in rec.entries
           if tid == main and not parents]
    assert top[:3] == ["seal", "files_open", "files_open"]
    assert top[-2:] == ["files_close", "files_close"]


def test_extract_stages(media, tmp_path):
    d, _ = media
    _embed(media, tmp_path / "s.avi")
    timer = profiling.StageTimer()
    out = extract_image_from_video(tmp_path / "s.avi",
                                   crypto.load_private_pem(d / "priv.pem"),
                                   StegoConfig(), batch_frames=2, timer=timer,
                                   device="cpu")
    assert out.success and out.hash_ok, out.error
    assert timer.counts["files_open"] == 1
    assert timer.counts["files_close"] == 1
    assert timer.counts["unseal"] == 1
    assert timer.counts["decode"] >= 2  # phase 1 inline, phase 2 threaded


# --- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_host_waits_on_the_card_are_the_spans_named(dev, monkeypatch):
    """4K, 8 frames: K4, the unpack and the evaluation kernel never block
    the host; the evaluation opens no host_wait and launches inside its
    span."""
    open_spans, entered = [], []

    @contextlib.contextmanager
    def recording(name):
        open_spans.append(name)
        entered.append(tuple(open_spans))
        try:
            yield
        finally:
            open_spans.pop()

    monkeypatch.setattr(qim, "annotate", recording)
    monkeypatch.setattr(sk, "annotate", recording)
    b, h, w = 8, 2160, 3840
    cap = (h // 8) * (w // 8) * NUM_AC
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    frames = torch.randint(32, 224, (b, h, w), generator=gen, device=dev,
                           dtype=torch.uint8)
    payload = torch.randint(0, 2, (b, cap), generator=gen, device=dev,
                            dtype=torch.uint8)
    sk.embed_and_extract_frames(frames, payload, b * cap, DELTA, NUM_AC)
    torch.cuda.synchronize(dev)   # the library is built and loaded
    torch.cuda.set_sync_debug_mode("error")
    try:
        stego, _, bits = sk.embed_and_extract_frames(frames, payload, b * cap,
                                                     DELTA, NUM_AC)
        entered.clear()
        m = qim.roundtrip_metrics(frames, stego, bits, payload, b * cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert entered == [("stegotpu_torch.eval",),
                       ("stegotpu_torch.eval",
                        "stegotpu_torch.launch.stegotpu_qim_eval")]
    want = qim.roundtrip_metrics_plain(frames, stego, bits, payload, b * cap)
    assert int(m["bit_errors"]) == int(want["bit_errors"])
    assert int(m["payload_bits"]) == b * cap


@pytest.mark.cuda
def test_each_unpack_span_on_the_card_holds_one_unpack_launch(dev,
                                                              monkeypatch):
    """On the card every stegotpu_torch.unpack span (embed_and_extract_
    frames, extract_frames) holds exactly one launch span, that of the
    unpack kernel, so unpack_share_pct.stream reads the kernel's time."""
    open_spans, entered = [], []

    @contextlib.contextmanager
    def recording(name):
        open_spans.append(name)
        entered.append(tuple(open_spans))
        try:
            yield
        finally:
            open_spans.pop()

    monkeypatch.setattr(sk, "annotate", recording)
    frames, payload, total = _batch(device=dev)
    sk.embed_and_extract_frames(frames, payload, total, DELTA, NUM_AC)
    sk.extract_frames(frames, DELTA, NUM_AC)
    torch.cuda.synchronize(dev)
    unpack = "stegotpu_torch.unpack"
    assert sum(e[-1] == unpack for e in entered) == 2
    assert [e for e in entered if unpack in e[:-1]] == [
        (unpack, "stegotpu_torch.launch.stegotpu_qim_unpack_packed")] * 2

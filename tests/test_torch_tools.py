"""The port's soak and trace tools (stegotpu_torch.tools) on the CPU.

The package's copy of the scalar oracle gives tests/reference_model.py's
output; soak_kernels draws tools/soak_kernels.py's configurations from the
same seed (the JAX tool's draws are captured before its kernels run) and
passes on a few of them; soak_product passes one draw; profile_roundtrip
writes a trace and its JSON line at a small size.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import reference_model as tests_oracle
from stegotpu_torch.tools import profile_roundtrip, soak_kernels, soak_product
from stegotpu_torch.tools import reference_model as port_oracle

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed,h,w,delta,num_ac", [
    (0, 16, 32, 20, 10), (1, 24, 40, 9, 1), (2, 8, 64, 48, 32),
    (3, 16, 16, 0, 5),
])
def test_reference_model_copy_matches_tests_oracle(seed, h, w, delta, num_ac):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cap = (h // 8) * (w // 8) * num_ac
    bits = "".join(map(str, rng.integers(0, 2, cap * 3 // 4)))
    s_port, n_port = port_oracle.embed_frame_oracle(frame, bits, delta, num_ac)
    s_test, n_test = tests_oracle.embed_frame_oracle(frame, bits, delta, num_ac)
    assert n_port == n_test
    np.testing.assert_array_equal(s_port, s_test)
    assert (port_oracle.extract_frame_oracle(s_port, delta, num_ac)
            == tests_oracle.extract_frame_oracle(s_test, delta, num_ac))


class _Drawn(Exception):
    pass


def _jax_tool_draws(n: int, seed: int) -> list[tuple]:
    """tools/soak_kernels.py's first n configurations for `seed`: its
    one_config runs with the oracle embed (its first call after the draws)
    replaced by a recorder that stops it, so none of its kernels run."""
    spec = importlib.util.spec_from_file_location(
        "jax_soak_kernels", REPO / "tools" / "soak_kernels.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    seen = []

    def record(frame, bitstr, delta, num_ac):
        seen.append((frame.copy(), bitstr, delta, num_ac))
        raise _Drawn

    tool.embed_frame_oracle = record
    rng = np.random.default_rng(seed)
    for _ in range(n):
        with pytest.raises(_Drawn):
            tool.one_config(rng)
    return seen


@pytest.mark.parametrize("seed", [0, 7])
def test_soak_kernels_draws_match_the_jax_tool(seed):
    rng = np.random.default_rng(seed)
    for frame, bitstr, delta, num_ac in _jax_tool_draws(5, seed):
        d = soak_kernels.draw(rng)
        assert (d.delta, d.num_ac, (d.h, d.w)) == (delta, num_ac, frame.shape)
        np.testing.assert_array_equal(d.frame, frame)
        assert "".join(map(str, d.payload[: d.total])) == bitstr
        lo, hi = (48, 208) if d.style == "midluma" else (64, 192)
        assert lo <= frame.min() and frame.max() < hi


def test_soak_kernels_passes_on_the_cpu(capsys):
    assert soak_kernels.main(["3", "0", "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == ("soak done: 3 configs, 0 failures (arms on cpu: oracle "
                    "0, xla 0, pallas 0)")


def test_soak_kernels_counts_a_failing_arm(monkeypatch, capsys):
    """A kernel that misreads is reported under its arm and exits 1."""
    from stegotpu_torch.ops import stripe_kernel as sk

    real = sk.extract_frames
    monkeypatch.setattr(sk, "extract_frames",
                        lambda f, d, n: 1 - real(f, d, n))
    assert soak_kernels.main(["1", "0", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "[pallas]: kernel misreads oracle stego" in out
    assert "[pallas]: self round trip" in out
    assert "xla 0, pallas 2)" in out


def test_soak_product_passes_on_the_cpu(capsys):
    assert soak_product.main(["1", "0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    row = json.loads(out[0])
    assert row["i"] == 0 and row["device"] == "cpu"
    assert out[-1] == "product soak done: 1 draws, 0 failures"


def test_profile_roundtrip_writes_a_trace(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(profile_roundtrip, "FRAME_HW", (48, 64))
    out = tmp_path / "trace"
    assert profile_roundtrip.main(
        ["--device", "cpu", "--batch", "1", "--iters", "2", "--chain", "2",
         "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["backend"] == "cpu" and line["trace_dir"] == str(out)
    assert line["files"] == ["trace.json"] and line["n_files"] == 1
    # the plain version runs on the CPU: no kernel launched, none traced
    assert line["k4_launches"] == 0 and line["k4_events"] == 0
    assert json.loads((out / "trace.json").read_text())["traceEvents"]


@pytest.mark.parametrize("events,rc", [(1, 1), (3, 0)])
def test_profile_roundtrip_fails_on_a_trace_that_lost_events(
        tmp_path, capsys, monkeypatch, events, rc):
    """Three traced calls that each count a K4 launch (as on the card) and
    a trace with `events` K4 events: fewer events than launches is exit 1
    with one line that names the gap."""
    import contextlib

    from stegotpu_torch.ops import stripe_kernel as sk
    from stegotpu_torch.utils import profiling

    real = sk.embed_and_extract_frames_packed

    def counted(*args, **kwargs):
        sk.LAUNCHES["stegotpu_qim_roundtrip_packed"] += 1
        return real(*args, **kwargs)

    @contextlib.contextmanager
    def fake_trace(logdir):
        yield
        Path(logdir).mkdir(parents=True, exist_ok=True)
        (Path(logdir) / "trace.json").write_text(json.dumps({"traceEvents": [
            {"cat": "kernel", "name": "qim_roundtrip_packed_kernel<2>"}]
            * events}))

    monkeypatch.setattr(profile_roundtrip, "FRAME_HW", (16, 32))
    monkeypatch.setattr(sk, "embed_and_extract_frames_packed", counted)
    monkeypatch.setattr(profiling, "device_trace", fake_trace)
    assert profile_roundtrip.main(
        ["--device", "cpu", "--batch", "1", "--iters", "3",
         "--out", str(tmp_path / "trace")]) == rc
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert (line["k4_launches"], line["k4_events"]) == (3, events)
    if rc:
        assert cap.err.strip().splitlines() == [
            "profile_roundtrip: the trace lost device events: 1 "
            "qim_roundtrip_packed_kernel events for 3 launches"]
    else:
        assert cap.err == ""


def test_k4_events_counts_the_kernel_only(tmp_path):
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "void qim_roundtrip_packed_kernel<2>()"},
        {"cat": "kernel", "name": "qim_embed_kernel"},
        {"cat": "cpu_op", "name": "qim_roundtrip_packed_kernel"},
        {"cat": "kernel", "name": "qim_roundtrip_packed_kernel"},
    ]}))
    assert profile_roundtrip.k4_events(trace) == 2


def test_profile_roundtrip_default_out_is_ignored_by_git():
    """The default trace directory, from the root of a checkout, is one
    that .gitignore lists (anchored at the root)."""
    top = profile_roundtrip.DEFAULT_OUT.parts[0]
    assert f"/{top}/" in (REPO / ".gitignore").read_text().splitlines()

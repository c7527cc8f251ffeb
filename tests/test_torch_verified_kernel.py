"""K3's repair variant (ops/stripe_kernel.embed_and_repair_frames, csrc/
qim_stripe.cu ``qim_embed_repair_kernel``): the verified embed as one
kernel, held to the benchmark's float64 reference of the verified embed
(stegobench/reference_verified.py, plain PyTorch, nothing of the program)
and to the plain repair loop (ops/verified.embed_frames_verified).

On the CPU: the variant's plain version against the reference and K3's
plain version, its counts, the wrapper's argument checks, and the
routing of ops/verified.embed_frames_verified_fast, where the CPU,
``kernel='xla'`` and delta <= 0 keep K3, the host's wait and the loop.

On the card (marker ``cuda``; this file imports neither JAX nor
stegotpu): the kernel against the reference where its answer is certain,
K2's reading of its stego, the plain loop's residual, K3 and K1 byte for
byte at rounds 0 and on a clean cover, one launch and one repair span a
call with no host wait, and the device counts:

    python -m pytest tests/test_torch_verified_kernel.py -m cuda --noconftest -q
"""

from __future__ import annotations

import json

import pytest
import torch

from stegobench import reference_verified
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.ops import verified
from stegotpu_torch.ops.exactness import SCOPE, scope_covers

DELTA, NUM_AC = 20.0, 10
SEED = 2**31 + 23


def covers(kind: str, b: int, h: int, w: int, device="cpu"):
    """(frames, payload bits at full capacity): "scope", letterboxed film
    (bars of h // 6 rows, rounded to blocks, at 0; flat highlights and
    shadows); "mid", textured mid-tones alone (nothing clips); "split",
    scope with every block of the first block row half 0 and half 255 (a
    range no DC shift can fit into [0, 255])."""
    gen = torch.Generator().manual_seed(SEED + h * w)
    bars = h // 6 // 8 * 8
    cfg = {**SCOPE, "letterbox_rows": bars}
    if kind == "mid":
        cfg.update(letterbox_rows=0, highlight_share=0.0, shadow_share=0.0)
    frames = scope_covers((b, h, w), cfg, gen, "cpu")
    if kind == "split":
        frames[:, :8] = 0
        frames[:, :8].view(b, 8, w // 8, 8)[..., 4:] = 255
    cap = (h // 8) * (w // 8) * NUM_AC
    bits = torch.randint(0, 2, (b, cap), generator=gen, dtype=torch.uint8)
    return frames.to(device), bits.to(device)


def counts(device) -> torch.Tensor:
    """The repair counts of `device` (blocks, rounds, residual), summed."""
    return sk.repair_counter(device).to("cpu", copy=True)


def check_against_reference(stego, bpf, residual, frames, bits, total,
                            rounds):
    """The stego and residual of a verified embed against the float64
    reference: equal pixels where the reference is certain, the residual
    inside its window, the bits per frame, and K2's reading of the stego
    wrong on exactly the residual's slots."""
    ref = reference_verified.embed_verified(frames, bits, total, DELTA,
                                            NUM_AC, rounds)
    assert ref.sure.float().mean() > 0.9
    assert torch.equal(stego[ref.sure], ref.stego[ref.sure])
    assert ref.residual <= int(residual) <= ref.residual + ref.unsure
    assert torch.equal(bpf.to(torch.int64), ref.bpf)
    b, cap = bits.shape
    valid = torch.arange(b * cap, device=bits.device).reshape(b, cap) < total
    got = sk.extract_frames(stego, DELTA, NUM_AC)
    assert int(((got != bits) & valid).sum()) == int(residual)
    return ref


# --- the plain version on the CPU --------------------------------------------

CPU_CASES = {  # name -> (kind, b, h, w, total of capacity)
    "scope": ("scope", 2, 96, 256, 1.0),
    "short": ("scope", 2, 96, 256, 0.61),   # ends inside a block
    "split": ("split", 1, 48, 128, 1.0),
    "mid": ("mid", 2, 48, 128, 1.0),
}


@pytest.mark.parametrize("rounds", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("case", list(CPU_CASES))
def test_plain_version_matches_the_reference(case, rounds):
    kind, b, h, w, frac = CPU_CASES[case]
    frames, bits = covers(kind, b, h, w)
    total = int(frac * bits.numel()) - 3 * (frac < 1)
    stego, bpf, residual = sk.embed_and_repair_frames(
        frames, bits, total, DELTA, NUM_AC, rounds)
    assert residual.dtype == torch.int32 and residual.dim() == 0
    ref = check_against_reference(stego, bpf, residual, frames, bits, total,
                                  rounds)
    if kind == "split":   # unfixable: the first block row keeps its errors
        assert int(residual) > 0
    elif rounds >= 2:
        assert int(residual) == ref.residual == 0


@pytest.mark.parametrize("case", ["scope", "short", "mid"])
def test_plain_version_at_rounds_0_is_k3(case):
    kind, b, h, w, frac = CPU_CASES[case]
    frames, bits = covers(kind, b, h, w)
    total = int(frac * bits.numel())
    s3, bpf3, err3 = sk.embed_and_check_frames_plain(frames, bits, total,
                                                     DELTA, NUM_AC)
    s, bpf, residual = sk.embed_and_repair_frames(frames, bits, total, DELTA,
                                                  NUM_AC, 0)
    assert torch.equal(s, s3) and torch.equal(bpf, bpf3)
    assert int(residual) == int(err3.sum())
    if kind == "mid":   # nothing reads wrong: every round count is K1's
        s1, _ = sk.embed_frames_plain(frames, bits, total, DELTA, NUM_AC)
        assert int(residual) == 0
        assert torch.equal(sk.embed_and_repair_frames(
            frames, bits, total, DELTA, NUM_AC, 3)[0], s1)


def test_plain_version_counts():
    """Blocks that read wrong after the embed, rounds summed over blocks
    (each round's blocks are those still wrong after the round before, so
    the sum is what the runs at fewer rounds leave wrong), residual."""
    frames, bits = covers("split", 1, 48, 128)
    total = bits.numel()
    bad_after = []
    for rounds in range(4):
        before = counts("cpu")
        stego, _, residual = sk.embed_and_repair_frames(
            frames, bits, total, DELTA, NUM_AC, rounds)
        got = sk.extract_frames(stego, DELTA, NUM_AC) != bits
        bad_after.append(int(got.reshape(-1, NUM_AC).any(-1).sum()))
        assert (counts("cpu") - before).tolist() == [
            bad_after[0], sum(bad_after[:rounds]), int(residual)]
    assert bad_after[0] > bad_after[-1] > 0


@pytest.mark.parametrize("kind", ["scope", "mid", "split"])
def test_repair_identities_hold_on_the_cpu(kind):
    from stegotpu_torch.ops import exactness

    frames, bits = covers(kind, 2, 48, 128)
    row = exactness.repair_identities(frames, bits, bits.numel() - 13, DELTA,
                                      NUM_AC)
    assert all(row[k] == 0 for k in exactness.REPAIR_KEYS), row
    assert (row["blocks_read_wrong"] > 0) == (kind != "mid")
    assert (row["residual"] > 0) == (kind == "split")


def test_delta_zero_embeds_and_repairs_nothing():
    frames, bits = covers("scope", 1, 48, 128)
    total = bits.numel()
    stego, _, residual = sk.embed_and_repair_frames(frames, bits, total, 0.0,
                                                    NUM_AC, 3)
    assert torch.equal(stego, frames)
    assert int(residual) == int(bits.sum())


@pytest.mark.parametrize("bad", [-1, 1.0, True, None, 2**31])
def test_wrapper_refuses_rounds(bad):
    frames, bits = covers("mid", 1, 16, 16)
    with pytest.raises(ValueError, match="repair_rounds"):
        sk.embed_and_repair_frames(frames, bits, bits.numel(), DELTA, NUM_AC,
                                   bad)


@pytest.mark.parametrize("what", ["dtype", "shape", "payload", "width"])
def test_wrapper_refuses_inputs(what):
    frames, bits = covers("mid", 1, 16, 16)
    if what == "dtype":
        frames = frames.to(torch.int16)
    elif what == "shape":
        frames = frames[0]
    elif what == "payload":
        bits = bits[:, 1:]
    else:
        frames = torch.zeros((1, 16, 12), dtype=torch.uint8)
    with pytest.raises(ValueError):
        sk.embed_and_repair_frames(frames, bits, bits.numel(), DELTA, NUM_AC)


def _spans(tmp_path, body) -> list[str]:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e["name"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("kernel, delta, waits", [
    ("auto", DELTA, 1), ("xla", DELTA, 0), ("auto", 0.0, 1),
    ("auto", -4.0, 1), ("auto", 1e-50, 1)])
def test_fast_path_keeps_todays_path_off_the_card(tmp_path, monkeypatch,
                                                  kernel, delta, waits):
    """The CPU, kernel='xla' and delta <= 0 (1e-50 is 0 in float32) never
    reach the repair variant: K3 and the host's wait, then the loop."""
    def refuse(*a, **k):
        raise AssertionError("the repair variant ran")
    monkeypatch.setattr(sk, "embed_and_repair_frames", refuse)
    frames, bits = covers("scope", 1, 48, 128)
    total = bits.numel()
    before = dict(verified.REPAIRS)
    names = _spans(tmp_path, lambda: verified.embed_frames_verified_fast(
        frames, bits, total, delta, NUM_AC, kernel=kernel))
    assert names.count("stegotpu_torch.host_wait") == waits
    assert verified.REPAIRS["checked"] == before.get("checked", 0) + 1


def test_repair_counts_on_the_cpu_are_repairs():
    """The host's counts are REPAIRS', and the repair variant's, under
    names of their own, those its plain version added on the CPU."""
    verified.embed_frames_verified_fast(*covers("scope", 1, 48, 128),
                                        48 * 128 // 64 * NUM_AC, DELTA, NUM_AC)
    sk.embed_and_repair_frames(*covers("split", 1, 48, 128), 48 * 128 // 64
                               * NUM_AC, DELTA, NUM_AC)
    read = verified.repair_counts("cpu")
    assert {k: read[k] for k in ("checked", "repaired", "rounds")} == \
        dict(verified.REPAIRS)
    assert [read[k] for k in verified.VARIANT_COUNTS] == \
        counts("cpu").tolist()
    assert read["residual_slots"] > 0


# --- the kernel on the card ---------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


CARD_CASES = {  # name -> (kind, b, h, w, total of capacity)
    "scope": ("scope", 2, 96, 256, 1.0),
    "short": ("scope", 2, 96, 256, 0.61),
    "scope1080": ("scope", 2, 1080, 1920, 1.0),
    "strip4k": ("scope", 2, 96, 3840, 1.0),
    "split": ("split", 1, 48, 128, 1.0),
    "mid": ("mid", 2, 96, 256, 1.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_the_reference_and_the_loop(dev, case, rounds):
    kind, b, h, w, frac = CARD_CASES[case]
    frames, bits = covers(kind, b, h, w, dev)
    total = int(frac * bits.numel()) - 3 * (frac < 1)
    before = sk.LAUNCHES["stegotpu_qim_embed_repair"]
    stego, bpf, residual = sk.embed_and_repair_frames(
        frames, bits, total, DELTA, NUM_AC, rounds)
    assert sk.LAUNCHES["stegotpu_qim_embed_repair"] == before + 1
    assert residual.dtype == torch.int32 and residual.device == dev
    ref = check_against_reference(stego, bpf, residual, frames, bits, total,
                                  rounds)
    _, _, r_loop = verified.embed_frames_verified(frames, bits, total, DELTA,
                                                  NUM_AC, rounds)
    assert abs(int(r_loop) - int(residual)) <= ref.unsure
    if kind == "split":
        assert int(residual) > 0
    elif rounds >= 2:
        assert int(residual) == 0
    if rounds == 0 or kind == "mid":  # K3's stego and count, K1's stego
        s3, bpf3, err3 = sk.embed_and_check_frames(frames, bits, total,
                                                   DELTA, NUM_AC)
        s1, _ = sk.embed_frames(frames, bits, total, DELTA, NUM_AC)
        assert torch.equal(bpf, bpf3)
        if rounds == 0 or int(err3.sum()) == 0:
            assert torch.equal(stego, s3) and torch.equal(stego, s1)
            assert int(residual) == int(err3.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [DELTA, 2.0**-11, 0.0, -4.0])
@pytest.mark.parametrize("num_ac", [1, 10, 15, 63])
def test_kernel_at_rounds_0_is_k3(dev, delta, num_ac):
    """Zero tolerance: at rounds 0 the stego, bits per frame and residual
    are K3's, whatever the delta and the rows of slots."""
    frames, _ = covers("scope", 2, 48, 240, dev)
    cap = 6 * 30 * num_ac
    bits = torch.randint(0, 2, (2, cap), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(5)).to(dev)
    for total in (2 * cap, cap + 7, 0):
        s3, bpf3, err3 = sk.embed_and_check_frames(frames, bits, total, delta,
                                                   num_ac)
        s, bpf, residual = sk.embed_and_repair_frames(frames, bits, total,
                                                      delta, num_ac, 0)
        assert torch.equal(s, s3) and torch.equal(bpf, bpf3)
        assert int(residual) == int(err3.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["scope", "mid", "split"])
def test_repair_identities_hold_on_the_card(dev, kind):
    from stegotpu_torch.ops import exactness

    frames, bits = covers(kind, 2, 1080, 1920, dev)
    row = exactness.repair_identities(frames, bits, bits.numel() - 13, DELTA,
                                      NUM_AC)
    assert all(row[k] == 0 for k in exactness.REPAIR_KEYS), row
    assert (row["blocks_read_wrong"] > 0) == (kind != "mid")


@pytest.mark.cuda
def test_kernel_counts(dev):
    """The device counts, as test_plain_version_counts reads them."""
    frames, bits = covers("split", 2, 96, 256, dev)
    total = bits.numel()
    bad_after = []
    for rounds in range(4):
        before = counts(dev)
        stego, _, residual = sk.embed_and_repair_frames(
            frames, bits, total, DELTA, NUM_AC, rounds)
        got = sk.extract_frames(stego, DELTA, NUM_AC) != bits
        bad_after.append(int(got.reshape(-1, NUM_AC).any(-1).sum()))
        assert (counts(dev) - before).tolist() == [
            bad_after[0], sum(bad_after[:rounds]), int(residual)]
    assert bad_after[0] > bad_after[-1] > 0
    read = verified.repair_counts(dev)
    assert [read[k] for k in verified.VARIANT_COUNTS] == counts(dev).tolist()


@pytest.mark.cuda
def test_fast_path_on_the_card_is_one_launch_and_no_wait(dev, tmp_path):
    frames, bits = covers("scope", 2, 96, 256, dev)
    total = bits.numel()
    entries = ("stegotpu_qim_embed_repair", "stegotpu_qim_embed_check")
    before = tuple(sk.LAUNCHES[e] for e in entries)
    out = []
    names = _spans(tmp_path, lambda: out.append(
        verified.embed_frames_verified_fast(frames, bits, total, DELTA,
                                            NUM_AC)))
    assert tuple(sk.LAUNCHES[e] for e in entries) == (before[0] + 1,
                                                      before[1])
    assert names.count("stegotpu_torch.verified.repair") == 1
    assert "stegotpu_torch.host_wait" not in names
    stego, bpf, residual = out[0]
    check_against_reference(stego, bpf, residual, frames, bits, total, 3)
    assert int(residual) == 0


def test_cli_timing_prints_the_repair_counts(tmp_path, capsys, monkeypatch):
    """embed --verified --timing ends its stage report with what the
    verified embed counted (ops/verified.repair_counts); without
    --verified there is no such line."""
    from stegotpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    assert main(["--device", "cpu", "genkey"]) == 0
    assert main(["--device", "cpu", "fixtures", "--dir", "media", "--width",
                 "128", "--height", "64", "--frames", "4", "--secret-size",
                 "8"]) == 0
    for flags, want in ((["--verified"], True), ([], False)):
        capsys.readouterr()
        assert main(["--device", "cpu", "embed", "media/cover.mp4",
                     "media/secret.png", "out/stego", "--batch", "4",
                     "--timing", *flags]) == 0
        err = capsys.readouterr().err
        assert ("verified repair: checked=" in err) == want, err

"""The witness of K7 and K8 (stegotpu_torch/studies/kron_ab.py) on the CPU.

The witness wrappers launch csrc/qim_kron_smem.cu on a CUDA tensor; on a
CPU tensor they run K7's and K8's plain versions, as kron_kernel's
wrappers do, so here they must give exactly what those give and refuse
what those refuse. The zero-tolerance identity of the CUDA kernels with
their witness is held on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 10). Also here: the study's arguments, its exit
without a card, K7's dense-form bound and the SASS reader's rows of
kernels that are no template. No JAX, no nvcc, no card.
"""

import numpy as np
import pytest
import torch

from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.ops.experimental import kron_kernel as kk
from stegotpu_torch.studies import bounds, kron_ab, sass

DELTA = 20.0
OFFSET = 13


def _inputs(seed, b, h, w, num_ac, n_bits):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(32, 224, (b, h, w), np.uint8))
    cap = (h // 8) * (w // 8) * num_ac
    payload = torch.from_numpy(rng.integers(0, 2, (b, cap), np.uint8))
    return frames, payload, OFFSET + n_bits(b, cap, num_ac)


ENDS = {"full": lambda b, cap, n: b * cap,
        "mid-block": lambda b, cap, n: b * cap - n // 2 - 1,
        "mid-frame": lambda b, cap, n: cap // 2 + 3}


@pytest.mark.parametrize("end", sorted(ENDS))
@pytest.mark.parametrize("num_ac", [1, 10, 63])
@pytest.mark.parametrize("shape", [(1, 8, 128), (3, 40, 384)],
                         ids=lambda s: "x".join(map(str, s)))
def test_witness_is_the_plain_version_on_the_cpu(shape, num_ac, end):
    """On a CPU tensor the witness of K7 and K8 gives the plain versions'
    results, shapes and types, with a bit offset; same_bytes holds."""
    b, h, w = shape
    frames, payload, total = _inputs(3, b, h, w, num_ac, ENDS[end])
    keys = ("stegotpu_kron_embed_smem", "stegotpu_kron_extract_smem")
    before = [sk.LAUNCHES[k] for k in keys]
    stego, bpf = kron_ab.embed_frames_kron_smem(frames, payload, total, DELTA,
                                                num_ac, OFFSET)
    s_p, bpf_p = kk.embed_frames_kron_plain(frames, payload, total, DELTA,
                                            num_ac, OFFSET)
    assert stego.shape == frames.shape and stego.dtype == torch.uint8
    assert bpf.shape == (b,) and bpf.dtype == torch.int32
    assert torch.equal(stego, s_p) and torch.equal(bpf, bpf_p)
    assert int(bpf.sum()) == total - OFFSET
    bits = kron_ab.extract_frames_kron_smem(stego, DELTA, num_ac)
    assert bits.shape == (b, (h // 8) * (w // 8) * num_ac)
    assert bits.dtype == torch.uint8
    assert torch.equal(bits, kk.extract_frames_kron_plain(stego, DELTA,
                                                          num_ac))
    n = total - OFFSET
    assert torch.equal(bits.reshape(-1)[:n], payload.reshape(-1)[:n])
    assert kron_ab.same_bytes(frames, payload, total, DELTA, num_ac, OFFSET)
    assert [sk.LAUNCHES[k] for k in keys] == before  # no kernel ran


def test_witness_keeps_the_domain():
    """W % 128 != 0, delta <= 0 and a payload of another capacity raise
    ValueError, as in K7's and K8's wrappers."""
    frames, payload, total = _inputs(4, 1, 16, 120, 10, ENDS["full"])
    with pytest.raises(ValueError, match="128"):
        kron_ab.embed_frames_kron_smem(frames, payload, total, DELTA, 10)
    with pytest.raises(ValueError, match="128"):
        kron_ab.extract_frames_kron_smem(frames, DELTA, 10)
    frames, payload, total = _inputs(4, 1, 16, 128, 10, ENDS["full"])
    for delta in (0.0, -4.0):
        with pytest.raises(ValueError, match="delta"):
            kron_ab.embed_frames_kron_smem(frames, payload, total, delta, 10)
        with pytest.raises(ValueError, match="delta"):
            kron_ab.extract_frames_kron_smem(frames, delta, 10)
    with pytest.raises(ValueError, match="payload_bits"):
        kron_ab.embed_frames_kron_smem(frames, payload[:, :-1], total, DELTA,
                                       10)
    with pytest.raises(ValueError, match="uint8"):
        kron_ab.extract_frames_kron_smem(frames.float(), DELTA, 10)


def test_study_arguments():
    args = kron_ab.parse_args([])
    assert (args.batch, args.large_batch, args.iters, args.height,
            args.width) == (8, 128, 10, 1080, 1920)
    args = kron_ab.parse_args(["--batch", "2", "--large-batch", "0",
                               "--iters", "3", "--height", "48", "--width",
                               "256"])
    assert (args.batch, args.large_batch, args.iters, args.height,
            args.width) == (2, 0, 3, 48, 256)
    for bad in (["--batch", "0"], ["--large-batch", "-1"], ["--iters", "0"],
                ["--batch", "x"]):
        with pytest.raises(SystemExit):
            kron_ab.parse_args(bad)


def test_stage_builds_edit_the_source_once(monkeypatch):
    """Every --stages build takes its stage out of the current
    csrc/qim_kron.cu by edits whose texts occur there once; an edit that
    no longer applies is an error, not a build of the library as it is."""
    assert not kron_ab.parse_args([]).stages
    assert kron_ab.parse_args(["--stages"]).stages
    from stegotpu_torch.ops import _build

    src = (_build.CSRC / "qim_kron.cu").read_text()
    for name in kron_ab.STAGES:
        edited = kron_ab.stage_source(name)
        assert edited != src
        for old, new in kron_ab.STAGES[name]:
            assert new in edited and src.count(old) == 1
    monkeypatch.setitem(kron_ab.STAGES, "gone", [("no such text", "")])
    with pytest.raises(ValueError, match="occurs 0 times"):
        kron_ab.stage_source("gone")


def test_study_exits_nonzero_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kron_ab.main(["--batch", "2", "--iters", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA device" in out.err


@pytest.mark.parametrize("b,h,w,num_ac", [(8, 1080, 1920, 10),
                                          (1, 8, 128, 63)])
def test_bounds_count_the_dense_form(b, h, w, num_ac):
    """kron_embed_dense: K7's bytes and the dense 64x64 form's FLOPs, four
    times the separable count; the witness rows take their kernels'
    work."""
    blocks = b * (h // 8) * (w // 8)
    sep = bounds.work("kron_embed", b, h, w, num_ac, 8)
    dense = bounds.work("kron_embed_dense", b, h, w, num_ac, 8)
    assert dense[0] == sep[0]
    assert dense[1] == 4 * sep[1] == blocks * 2 * (64 * 64) * 2
    assert bounds.work("kron_embed_smem", b, h, w, num_ac, 8) == sep
    assert bounds.work("kron_extract_smem", b, h, w, num_ac, 8) == \
        bounds.work("kron_extract", b, h, w, num_ac, 8)
    ms, by = bounds.bound_ms(*dense)
    t_bytes, t_ops = dense[0] / 3.35e9, dense[1] / 67e9
    assert ms == pytest.approx(max(t_bytes, t_ops))
    assert by == ("operations" if t_ops > t_bytes else "bytes")


def test_sass_rows_take_kernels_that_are_no_template(monkeypatch):
    """rows() matches K7, K8 and their witness by name, and K7's name
    does not pick its witness's kernel."""
    ns = "_ZN44_GLOBAL__N__6510120b_11_qim_kron_cu_d1dda33b"
    fns = {
        ns + "17kron_embed_kernelEPKhS1_PhPKfiiiixf":
            ["  /*0000*/  FFMA R1, R2, R3, R4 ;", "  /*0010*/  BAR.SYNC 0x0 ;",
             "  /*0020*/  LDG.E.64 R4, desc[UR4][R2.64] ;"],
        ns + "22kron_embed_smem_kernelEPKhS1_PhPKfiiixxxf":
            ["  /*0000*/  LDS R1, [R2] ;"],
        ns + "19kron_extract_kernelEPKhPhPKfiiiif": ["  /*0000*/  EXIT ;"],
    }
    text = "".join(f"\t\tFunction : {name}\n" + "\n".join(lines) + "\n"
                   for name, lines in fns.items())
    monkeypatch.setattr(sass, "dump", lambda lib: text)
    got = {r["kernel"]: r for r in sass.rows("lib.so", ("kron_embed_kernel",))}
    assert set(got) == {"kron_embed_kernel"}
    k7 = got["kron_embed_kernel"]
    assert (k7["FFMA"], k7["BAR"], k7["LDG"], k7["LDS"],
            k7["instructions"]) == (1, 1, 1, 0, 3)
    got = sass.rows("lib.so", ("kron_embed_smem_kernel", "kron_extract_kernel"))
    assert {r["kernel"] for r in got} == {"kron_embed_smem_kernel",
                                          "kron_extract_kernel"}

"""The SASS and ptxas readers of stegotpu_torch/studies/sass.py, and the
build list of studies/stripe_cap.py, on text made here: no cuobjdump,
no nvcc, no card."""

import pytest

from stegotpu_torch.studies import sass, stripe_cap

ANON = "_ZN46_GLOBAL__N__37f1a9c4_13_qim_stripe_cu_3417f3f1"


@pytest.mark.parametrize("mangled,want", [
    (ANON + "16qim_embed_kernelILi2EEEvPKhS2_PhPKfiiixxxf",
     "qim_embed_kernel<2>"),
    (ANON + "16qim_embed_kernelILi2ENS_11ArithHopperELi8EEEvPKhS3_PhPiiiixxxf",
     "qim_embed_kernel<2, ArithHopper, 8>"),
    ("_ZN12_GLOBAL__N_125qim_extract_packed_kernelILi1EN12_GLOBAL__N_1"
     "21ArithHopperSmallDeltaEEEvPKhPhiiiif",
     "qim_extract_packed_kernel<1, ArithHopperSmallDelta>"),
    (ANON + "25qim_roundtrip_pipe_kernelILi2ELi3ELi4EEEvPKh",
     "qim_roundtrip_pipe_kernel<2, 3, 4>"),
    ("_ZN12_GLOBAL__N_123qim_extract_rows_kernelILi2EN12_GLOBAL__N_1"
     "11ArithHopperEEEvPKhPhiiiif",
     "qim_extract_rows_kernel<2, ArithHopper>"),
    (ANON + "25qim_roundtrip_rows_kernelILi2ENS_21ArithHopperSmallDeltaELi8EEE"
     "vPKhS3_PhPiS4_iiixxiif",
     "qim_roundtrip_rows_kernel<2, ArithHopperSmallDelta, 8>"),
    ("_ZN44_GLOBAL__N__6510120b_11_qim_kron_cu_d1dda33b19kron_extract_kernelEPKhPhPKfiiixf",
     "kron_extract_kernel"),
    ("not_mangled", "not_mangled"),
])
def test_label_reads_the_kernel_and_its_template_arguments(mangled, want):
    assert sass.label(mangled) == want


def test_counts_by_base_opcode_with_predicates_and_constant_bank():
    lines = [
        "        /*0050*/                   FFMA R1, R2, c[0x3][0x10], R3 ;",
        "        /*0060*/                   FFMA R1, R2, c[0x0][0x210], R3 ;",
        "        /*0070*/              @!P0 I2F.U8 R5, R102 ;",
        "        /*0080*/               @P1 FRND.FLOOR R51, R51 ;",
        "        /*0090*/                   I2FP.F32.U32 R5, R5 ;",
        "        /*00a0*/                   FFMA R7, R0.reuse, 0.35355338454246520996, RZ ;",
        "        /*00b0*/                   FFMA R7, R0, -1.5, R2 ;",
        "        /*00c0*/                   FFMA R7, R0, R3, 1 ;",
        "                                                            ",
        "        .L_x_3:",
    ]
    assert sass.counts(lines) == {"FFMA": 5, "FFMA_imm": 2, "FFMA_cbank": 1,
                                  "I2F": 1, "FRND": 1, "I2FP": 1}


def test_split_functions_and_ptxas_report():
    text = ("\n\tcode for sm_90a\n\t\tFunction : " + ANON
            + "16qim_embed_kernelILi2EEEvPKh\n        /*0000*/  EXIT ;\n"
            "\t\tFunction : k2\n        /*0000*/  LDS R1, [R2] ;\n")
    fns = sass.split_functions(text)
    assert list(fns) == [ANON + "16qim_embed_kernelILi2EEEvPKh", "k2"]
    assert sass.counts(fns["k2"]) == {"LDS": 1}
    log = (f"ptxas info    : Compiling entry function '{ANON}16qim_embed_"
           "kernelILi2ENS_11ArithHopperELi8EEEvPKh' for 'sm_90a'\n"
           "    0 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Used 64 registers, used 0 barriers\n")
    assert sass.ptxas(log) == {"qim_embed_kernel<2, ArithHopper, 8>": (64, 12)}


def test_cap_builds_of_the_minb_option():
    assert stripe_cap.variants_of("") == [("library", None)]
    assert stripe_cap.variants_of("k1:1,k3:8,k4:4", "step1=/tmp/a") == [
        ("library", None),
        ("k1_minb_1", {"defines": {"STEGOTPU_K1_MINB": 1}}),
        ("k3_minb_8", {"defines": {"STEGOTPU_K3_MINB": 8}}),
        ("k4_minb_4", {"defines": {"STEGOTPU_K4_MINB": 4}}),
        ("step1", {"src": "/tmp/a"})]
    assert stripe_cap.variants_of("k6:1,k6:8,k6:9") == [
        ("library", None),
        ("k6_minb_1", {"defines": {"STEGOTPU_K6_MINB": 1}}),
        ("k6_minb_8", {"defines": {"STEGOTPU_K6_MINB": 8}}),
        ("k6_minb_9", {"defines": {"STEGOTPU_K6_MINB": 9}})]
    # K2 and K5 have no cap; k6:0 asks for no CTA at all
    for bad in ("k1:0", "k1:8/16", "k1:x", "9", "k2:8", "k5:8", "k6:0",
                "k6:", "k7:8"):
        with pytest.raises(ValueError, match="CTAs per SM"):
            stripe_cap.variants_of(bad)
    for bad in ("step1", "=/tmp/a", "library=/tmp/a"):
        with pytest.raises(ValueError, match="name=DIR"):
            stripe_cap.variants_of("", bad)


def test_cap_builds_of_k11():
    """--minb takes K11's cap (qim_study.cu) and K13's, one per ring depth
    (qim_pipe.cu); a variant compiles the sources of the kernels it
    holds."""
    assert stripe_cap.variants_of("k11:1,k11:5,k13_2:7,k13_4:1") == [
        ("library", None),
        ("k11_minb_1", {"defines": {"STEGOTPU_K11_MINB": 1}}),
        ("k11_minb_5", {"defines": {"STEGOTPU_K11_MINB": 5}}),
        ("k13_2_minb_7", {"defines": {"STEGOTPU_K13_BUF2_MINB": 7}}),
        ("k13_4_minb_1", {"defines": {"STEGOTPU_K13_BUF4_MINB": 1}})]
    for bad in ("k13:8", "k13_5:8", "k11:0", "k13_3:0"):
        with pytest.raises(ValueError, match="CTAs per SM"):
            stripe_cap.variants_of(bad)
    assert set(stripe_cap.SOURCES.values()) == {"qim_stripe.cu", "qim_study.cu",
                                                "qim_pipe.cu"}


def test_src_builds_take_defines():
    """--src name=DIR:NAME=VALUE:... adds -D flags to a source build; a
    flag needs a name and a value."""
    assert stripe_cap.variants_of(
        "", "a=/tmp/a,t0=/tmp/b:STEGOTPU_K13_PRODUCER=0:X=y") == [
        ("library", None), ("a", {"src": "/tmp/a"}),
        ("t0", {"src": "/tmp/b",
                "defines": {"STEGOTPU_K13_PRODUCER": 0, "X": "y"}})]
    for bad in ("a=/tmp/a:", "a=/tmp/a:X", "a=/tmp/a:=1", "a=/tmp/a:X="):
        with pytest.raises(ValueError, match="name=DIR"):
            stripe_cap.variants_of("", bad)


def test_kernels_timed_follow_the_builds(tmp_path):
    """stripe_cap holds and times K4 and the kernels its builds vary: the
    caps --minb names, the sources a --src DIR holds; every kernel when the
    library is the only build."""
    assert stripe_cap.keys_of(stripe_cap.variants_of("")) == ["k4", *(
        k for k in stripe_cap.KERNELS if k != "k4")]
    assert stripe_cap.keys_of(stripe_cap.variants_of("k11:4")) == ["k4", "k11"]
    assert stripe_cap.keys_of(stripe_cap.variants_of("k4:4,k6:1")) == [
        "k4", "k6"]
    (tmp_path / "qim_pipe.cu").write_text("// a study source\n")
    assert stripe_cap.keys_of(stripe_cap.variants_of(
        "k13_2:7", f"bulk={tmp_path}")) == ["k4", "k13_2", "k13_3", "k13_4"]
    (tmp_path / "qim_stripe.cu").write_text("// a study source\n")
    assert stripe_cap.keys_of(stripe_cap.variants_of(
        "", f"s={tmp_path}")) == ["k4", "k1", "k3", "k5", "k6", "k13_2",
                                  "k13_3", "k13_4"]


def test_src_build_falls_back_to_csrc(tmp_path, monkeypatch):
    """A --src build compiles each source its DIR holds and csrc/'s for
    the others (qim_stripe.cu always: K4, the yardstick), with csrc/ as an
    include directory so that DIR need hold no header."""
    from stegotpu_torch.ops import _build

    (tmp_path / "qim_pipe.cu").write_text("// a study source\n")
    calls = []
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_compile", lambda srcs, out, defines=(),
                        includes=(): calls.append(
                            (srcs, defines, includes)) or "")
    monkeypatch.setattr(_build, "bind", lambda lib: lib)
    monkeypatch.setattr(stripe_cap.ctypes, "CDLL", lambda path: path)
    variants = stripe_cap.variants_of(
        "", f"bulk={tmp_path}:STEGOTPU_K13_PRODUCER=1")[1:]
    built = stripe_cap.build_variants(variants, stripe_cap.keys_of(variants))
    assert list(built) == ["bulk"]
    [(srcs, defines, includes)] = calls
    assert srcs == [tmp_path / "qim_pipe.cu", _build.CSRC / "qim_stripe.cu"]
    assert defines == ("STEGOTPU_K13_PRODUCER=1",)
    assert includes == (_build.CSRC,)


def test_study_sass_gate_is_keyed_by_ring_depth():
    """chip_smoke.py holds each K13 build to the shared loads of its own
    ring depth (the BUFS template argument), capped or not, and K11 to
    K4's one I2F and one F2I."""
    import importlib.util

    path = _build_root() / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_gate", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    lds = {n: cs._study_left(f"qim_roundtrip_pipe_kernel<2, ArithHopper, {n}, "
                             f"{m}>")["LDS"]
           for n in (2, 3, 4) for m in (1, 8)}
    assert lds == {2: 143, 3: 239, 4: 311}
    assert cs._study_left("qim_roundtrip_dual_kernel<2, ArithHopper, 1>") == {
        "I2F": 1, "F2I": 1}
    with pytest.raises(KeyError):
        cs._study_left("qim_roundtrip_pipe_kernel<2, ArithHopper, 5, 1>")


def _build_root():
    from pathlib import Path

    return Path(__file__).resolve().parents[1]


def test_default_kernels_are_the_six_stripe_templates():
    """sass.py's default rows are K1-K6, each a kernel template of
    csrc/qim_stripe.cu."""
    from stegotpu_torch.ops import _build

    src = (_build.CSRC / "qim_stripe.cu").read_text()
    assert sass.DEFAULT_KERNELS == (
        "qim_embed_kernel", "qim_extract_packed_kernel",
        "qim_embed_check_kernel", "qim_roundtrip_packed_kernel",
        "qim_extract_rows_kernel", "qim_roundtrip_rows_kernel")
    for k in sass.DEFAULT_KERNELS:
        assert f"\n{k}(" in src, k


def test_rows_take_the_default_kernels_at_rn(monkeypatch):
    """rows() keeps every instantiation of a default kernel at the asked
    rn, K5's and K6's among them, and nothing else."""
    fns = {
        ANON + "23qim_extract_rows_kernelILi2ENS_11ArithHopperEEEvPKh":
            ["  /*0000*/  I2F.U32.RP R1, R2 ;", "  /*0010*/  PRMT R3, R4 ;"],
        ANON + "25qim_roundtrip_rows_kernelILi2ENS_11ArithHopperELi8EEEvPKh":
            ["  /*0000*/  FFMA R1, R2, 0.5, R3 ;"],
        ANON + "25qim_roundtrip_rows_kernelILi3ENS_11ArithHopperELi1EEEvPKh":
            ["  /*0000*/  FRND R1, R2 ;"],
        ANON + "19qim_ablation_kernelILi2ELi0EEEvPKv": ["  /*0000*/  LDS R1 ;"],
    }
    text = "".join(f"\t\tFunction : {name}\n" + "\n".join(lines) + "\n"
                   for name, lines in fns.items())
    monkeypatch.setattr(sass, "dump", lambda lib: text)
    got = {r["kernel"]: r for r in sass.rows("lib.so")}
    assert set(got) == {"qim_extract_rows_kernel<2, ArithHopper>",
                        "qim_roundtrip_rows_kernel<2, ArithHopper, 8>"}
    k5 = got["qim_extract_rows_kernel<2, ArithHopper>"]
    assert (k5["I2F"], k5["PRMT"], k5["FRND"], k5["instructions"]) == (1, 1, 0, 2)
    k6 = got["qim_roundtrip_rows_kernel<2, ArithHopper, 8>"]
    assert (k6["FFMA"], k6["FFMA_imm"], k6["LDS"]) == (1, 1, 0)
    assert "qim_extract_rows_kernel<2, ArithHopper> I2F=1" in sass.summary(
        list(got.values()))

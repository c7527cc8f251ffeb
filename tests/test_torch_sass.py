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
    for bad in ("k1:0", "k1:8/16", "k1:x", "9", "k2:8"):
        with pytest.raises(ValueError, match="CTAs per SM"):
            stripe_cap.variants_of(bad)
    for bad in ("step1", "=/tmp/a", "library=/tmp/a"):
        with pytest.raises(ValueError, match="name=DIR"):
            stripe_cap.variants_of("", bad)

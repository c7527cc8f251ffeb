"""The exact conversions of the stripe kernels' Hopper arithmetic, the DCT
literals of the constant bank, K5's lane spread and K6's bits per frame,
proven on the CPU.

csrc/qim_common.cuh spells three exact operations on the full-rate pipes
(ArithHopper) instead of the conversion instructions (ArithCvt). Each is
checked here with numpy in float32 and float64 as the exact reference:

- u8 -> f32: __uint_as_float(0x4B000000 | b) - 2^23 == (float)b, the word
  built by __byte_perm with either of the two selectors the header uses;
- rint and its floor-mod-2 parity: t = RN(r + 1.5 * 2^23); t - 1.5 * 2^23
  == rint(r) (half to even) and the low bit of t == rint(r) mod 2, for
  |r| <= 2^22, over every half-integer tie in [-64, 64], the edges at
  +-2^22 and random quotients y / delta at the deltas the kernels see;
- the truncating f32 -> u8 after the clamp: the low byte of
  RZ(o + 2^23) == trunc(o) on [0, 255], and the PRMT packing of four;
- the 64 hex-float literals of csrc/dct8_f32.cuh, bit for bit the port's
  and the JAX package's dct_matrix(8, float32);
- write_rows' spread of a slot row's byte to its 8 lanes by two integer
  multiplies, against the first design's shifts and the plain version's
  lanes, for every byte;
- frame_bits' clamp with K6's arguments (no bit offset) against the
  wrapper's plain _bits_per_frame, int64 totals included.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stegotpu.ops.dct import dct_matrix as jax_pkg_dct_matrix
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.ops.dct import dct_matrix

CSRC = Path(__file__).resolve().parents[1] / "stegotpu_torch" / "csrc"
TWO23 = np.float32(2.0**23)
SHIFT = np.float32(1.5 * 2.0**23)        # kRoundShift
MIN_DELTA = 2.0**-10                     # kAddRoundMinDelta
DELTAS = (2.0**-10, 0.5, 1.0, 8.0, 20.0, 100.0)


def byte_perm(x, y, s: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, s): byte n of the result is byte (nibble n
    of s) & 7 of the 8-byte value y:x."""
    xy = (np.asarray(x, dtype=np.uint64)
          | (np.asarray(y, dtype=np.uint64) << np.uint64(32)))
    out = np.zeros_like(xy)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        byte = (xy >> np.uint64(8 * sel)) & np.uint64(0xFF)
        out |= byte << np.uint64(8 * n)
    return out.astype(np.uint32)


def as_f32(u: np.ndarray) -> np.ndarray:
    return np.asarray(u, dtype=np.uint32).view(np.float32)


def as_u32(f: np.ndarray) -> np.ndarray:
    return np.asarray(f, dtype=np.float32).view(np.uint32)


# --- u8 -> f32 ----------------------------------------------------------------

def test_u8_to_f32_by_or_and_subtract_is_exact_for_every_byte():
    b = np.arange(256, dtype=np.uint32)
    got = as_f32(np.uint32(0x4B000000) | b) - TWO23
    assert got.dtype == np.float32
    np.testing.assert_array_equal(as_u32(got), as_u32(b.astype(np.float32)))


@pytest.mark.parametrize("select", [0x7540, 0x7650])
@pytest.mark.parametrize("k", range(4))
def test_byte_perm_builds_the_word_from_any_byte_of_the_row(select, k):
    """pixel() and pixel_again(): selector (select | k) puts byte k of the
    row word under 0x4B0000, so the float is 2^23 + that byte."""
    rng = np.random.default_rng(k)
    words = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    built = byte_perm(words, 0x4B000000, select | k)
    byte = (words >> np.uint32(8 * k)) & np.uint32(0xFF)
    np.testing.assert_array_equal(built, np.uint32(0x4B000000) | byte)
    np.testing.assert_array_equal(as_f32(built) - TWO23,
                                  byte.astype(np.float32))


# --- round half to even and parity ----------------------------------------------

def _check_round(r: np.ndarray) -> None:
    """kAddRound against np.rint and floor-mod 2, for f32 quotients r."""
    r = np.asarray(r, dtype=np.float32)
    assert np.abs(r).max() <= 2.0**22
    t = r + SHIFT                                  # one f32 add, RN-even
    assert t.dtype == np.float32
    q = t - SHIFT
    want = np.rint(r)                              # half to even
    np.testing.assert_array_equal(q, want)
    parity = as_u32(t) & np.uint32(1)
    np.testing.assert_array_equal(parity, np.mod(want, 2.0).astype(np.uint32))
    # the ArithCvt spelling: q - 2 floor(q / 2)
    np.testing.assert_array_equal(
        parity, (want - np.float32(2.0) * np.floor(want * np.float32(0.5)))
        .astype(np.uint32))


def test_round_every_half_integer_tie_and_neighbour_in_64():
    ties = np.arange(-128, 129, dtype=np.float32) / np.float32(2.0)
    near = np.concatenate([np.nextafter(ties, np.float32(np.inf)),
                           np.nextafter(ties, np.float32(-np.inf))])
    _check_round(np.concatenate([ties, near, -ties]))
    # the ties round to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    t = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32) + SHIFT
    np.testing.assert_array_equal(t - SHIFT, [0, 2, 2, 0, -2, -2])


def test_round_dense_sweep_of_small_quotients():
    r = np.linspace(-64.0, 64.0, 1_000_001, dtype=np.float32)
    _check_round(r)


def test_round_at_the_edges_of_the_range():
    edge = np.float32(2.0**22)
    vals = [edge, edge - 0.5, edge - 1.0, edge - 1.5, edge - 0.25, edge - 0.75]
    vals = np.array(vals, dtype=np.float32)
    down = [vals]
    x = vals.copy()
    for _ in range(8):
        x = np.nextafter(x, np.float32(0.0))
        down.append(x)
    r = np.concatenate(down)
    _check_round(np.concatenate([r, -r]))


@pytest.mark.parametrize("delta", DELTAS)
def test_round_random_quotients_at_the_kernels_deltas(delta):
    """y / delta as the kernels divide (IEEE f32), y over the range of the
    orthonormal DCT of u8 pixels, |y| <= 8 * 255."""
    rng = np.random.default_rng(int(delta * 1024))
    y = rng.uniform(-2040.0, 2040.0, 400_000).astype(np.float32)
    # and y on and next to the lattice's half points, where rint ties
    k = rng.integers(-2040, 2040, 100_000).astype(np.float64)
    lattice = ((k + 0.5) * delta).astype(np.float32)
    lattice = lattice[np.abs(lattice) <= 2040]
    y = np.concatenate([y, lattice, np.nextafter(lattice, np.float32(np.inf)),
                        np.nextafter(lattice, np.float32(-np.inf))])
    r = y / np.float32(delta)
    assert r.dtype == np.float32
    _check_round(r)


def test_the_dct_of_u8_blocks_stays_in_the_fast_range():
    """|y| <= 8 * 255 for the orthonormal DCT of any u8 block (each basis
    function's absolute sum is at most 8), so delta >= 2^-10 keeps
    |y / delta| <= 2040 * 2^10 < 2^22, with room for f32 rounding."""
    m64 = dct_matrix(8, np.float64)
    basis_abs_sum = np.abs(np.einsum("gr,vc->gvrc", m64, m64)).sum((-1, -2))
    assert basis_abs_sum.max() <= 8.0 + 1e-12
    m = dct_matrix(8, np.float32)
    rng = np.random.default_rng(3)
    blocks = [np.full((8, 8), 255, np.float32), np.zeros((8, 8), np.float32)]
    for g in range(8):  # the sign pattern of every basis function, at 0/255
        for v in range(8):
            blocks.append(np.where(np.outer(m[g], m[v]) > 0, 255, 0)
                          .astype(np.float32))
    blocks += list(rng.integers(0, 256, (1000, 8, 8)).astype(np.float32))
    y = np.stack([m @ x @ m.T for x in blocks])
    assert np.abs(y).max() <= 2040.0 * (1 + 1e-5)
    assert np.abs(y).max() / MIN_DELTA < 2.0**21


# --- truncating f32 -> u8 ---------------------------------------------------------

def _trunc_by_add(o: np.ndarray) -> np.ndarray:
    """The low byte of __fadd_rz(o, 2^23): the exact sum in float64 (o has
    24 bits, the sum under 2^24), rounded toward zero to the f32 grid,
    which is the integers on [2^23, 2^24)."""
    s = o.astype(np.float64) + 2.0**23
    assert (s >= 2.0**23).all() and (s < 2.0**24).all()
    word = as_u32(np.floor(s).astype(np.float32))   # exact: an integer < 2^24
    return word & np.uint32(0xFF)


def test_truncation_by_add_matches_trunc_on_0_255():
    ints = np.arange(256, dtype=np.float32)
    vals = [ints, np.float32(-0.0) * ints[:1]]
    x_up, x_down = ints.copy(), ints.copy()
    for _ in range(16):  # 16 f32 neighbours on each side of every integer
        x_up = np.nextafter(x_up, np.float32(np.inf))
        x_down = np.nextafter(x_down, np.float32(-np.inf))
        vals += [x_up, x_down]
    rng = np.random.default_rng(4)
    vals.append(rng.uniform(0.0, 255.0, 1_000_000).astype(np.float32))
    vals.append(np.arange(0, 256, 0.125, dtype=np.float32))
    o = np.clip(np.concatenate(vals), 0.0, 255.0).astype(np.float32)
    np.testing.assert_array_equal(_trunc_by_add(o),
                                  np.trunc(o).astype(np.uint32))


def test_four_bytes_pack_to_a_word_by_byte_perm():
    """The embed's packing: byte 0 of each of four 2^23 + byte words, in
    order, by three PRMTs."""
    rng = np.random.default_rng(5)
    u = [np.uint32(0x4B000000) | rng.integers(0, 256, 4096).astype(np.uint32)
         for _ in range(4)]
    word = byte_perm(byte_perm(u[0], u[1], 0x0040),
                     byte_perm(u[2], u[3], 0x0040), 0x5410)
    want = sum((x & np.uint32(0xFF)) << np.uint32(8 * i) for i, x in enumerate(u))
    np.testing.assert_array_equal(word, want)


# --- the DCT literals of the constant bank ---------------------------------------

def _dct_literals() -> np.ndarray:
    text = (CSRC / "dct8_f32.cuh").read_text()
    body = text[text.index("kDct8F32[64] = {"):text.index("};")]
    lits = re.findall(r"-?0x[0-9a-f]\.?[0-9a-f]*p[-+]?\d+f", body)
    assert len(lits) == 64, lits
    return np.array([float.fromhex(s[:-1]) for s in lits],
                    dtype=np.float64).reshape(8, 8)


def test_dct_literals_are_the_f32_matrix_bit_for_bit():
    lit = _dct_literals()
    as32 = lit.astype(np.float32)
    np.testing.assert_array_equal(as32.astype(np.float64), lit)  # exact f32s
    for ref in (dct_matrix(8, np.float32), jax_pkg_dct_matrix(8, np.float32)):
        np.testing.assert_array_equal(as_u32(as32), as_u32(ref))


# --- K5's and K6's lane spread ----------------------------------------------------

def _between(path: str, start: str, end: str) -> str:
    text = (CSRC / path).read_text()
    i = text.index(start)
    return text[i:text.index(end, i)]


def test_lane_spread_by_multiply_equals_the_shifts_for_every_byte():
    """write_rows (csrc/qim_common.cuh): lo = ((byte & 0xF) * M) & L and
    hi = ((byte >> 4) * M) & L, M = 1 + 2^7 + 2^14 + 2^21, L = 0x01010101,
    equal the first design's four shift/and/or steps a half, and their
    bytes are the plain version's lanes ((byte >> s) & 1, s = 0..7)."""
    body = _between("qim_common.cuh", "void write_rows(", "void load_dct(")
    consts = re.findall(r"\) \* (0x[0-9a-f]+)u\) & (0x[0-9a-f]+)u", body)
    assert consts == [("0x00204081", "0x01010101")] * 2, consts
    mul, mask = (np.uint32(int(c, 16)) for c in consts[0])
    byte = np.arange(256, dtype=np.uint32)
    lo = ((byte & np.uint32(0xF)) * mul) & mask
    hi = ((byte >> np.uint32(4)) * mul) & mask
    old_lo = np.zeros_like(byte)
    old_hi = np.zeros_like(byte)
    for s in range(4):
        old_lo |= ((byte >> np.uint32(s)) & np.uint32(1)) << np.uint32(8 * s)
        old_hi |= ((byte >> np.uint32(s + 4)) & np.uint32(1)) << np.uint32(8 * s)
    np.testing.assert_array_equal(lo, old_lo)
    np.testing.assert_array_equal(hi, old_hi)
    lanes = np.stack([lo, hi], axis=1).view(np.uint8)  # little-endian words
    want = (byte[:, None] >> np.arange(8, dtype=np.uint32)) & np.uint32(1)
    np.testing.assert_array_equal(lanes, want.astype(np.uint8))


# --- K6's, K11's and K13's bits per frame --------------------------------------------

def _frame_bits(left: int, cap: int) -> int:
    """frame_bits_clamp of csrc/qim_common.cuh: clamp(left, 0, cap) in long
    long, cast to int."""
    return int(np.int32(0 if left < 0 else (left if left < cap else cap)))


# kernel -> (its source, the start and end of its body, the call that
# writes its bits per frame): each passes total_bits - f * cap (no bit
# offset) to the shared clamp, K6 and K11 through frame_bits' writer
# predicate, K13 through its tile's
FRAME_BITS_CALLS = {
    "K6": ("qim_stripe.cu", "qim_roundtrip_rows_kernel(const", "store_rows(",
           "frame_bits(bpf, f, total_bits - f * cap, cap);"),
    "K11": ("qim_study.cu", "qim_roundtrip_dual_kernel(const", "store_rows(",
            "frame_bits(bpf, f, total_bits - f * cap, cap);"),
    "K13": ("qim_pipe.cu", "qim_roundtrip_pipe_kernel(const", "store_rows(",
            "bpf[t.f] = frame_bits_clamp(total_bits - t.f * cap, cap);"),
}


@pytest.mark.parametrize("kernel", sorted(FRAME_BITS_CALLS))
def test_k6_passes_frame_bits_no_bit_offset(kernel):
    clamp = _between("qim_common.cuh", "int frame_bits_clamp(", "}")
    assert "left < 0 ? 0 : (left < cap ? left : cap)" in clamp
    writer = _between("qim_common.cuh", "void frame_bits(", "}")
    assert "bpf[f] = frame_bits_clamp(left, cap);" in writer
    src, start, end, call = FRAME_BITS_CALLS[kernel]
    body = _between(src, start, end)
    assert call in body
    assert "long long cap, long long total_bits" in body
    # no kernel carries its own copy of the clamp or the cap's pieces
    text = (CSRC / src).read_text()
    assert "left < cap ? left : cap" not in text
    assert "struct RederiveIfCapped" not in text
    assert "int capped_minb(" not in text


CAP_1080 = 135 * 240 * 10


@pytest.mark.parametrize("b,cap,total", [
    (3, 4800, 0),                           # no payload
    (3, 4800, int(1.6 * 4800)),             # ends mid-frame
    (3, 4800, 2 * 4800),                    # ends at a frame's end
    (3, 4800, 10**9),                       # runs past the last frame
    (4, 9216, -5),                          # a negative total
    (2, 1, 1),                              # one slot a frame
    (8, CAP_1080, 2**33 + 7),               # an int64 total
    (8000, CAP_1080, 7000 * CAP_1080 + 17),  # f * cap past 2^31
])
def test_frame_bits_clamp_equals_bits_per_frame(b, cap, total):
    want = sk._bits_per_frame(b, cap, total, 0, "cpu")
    got = [_frame_bits(total - f * cap, cap) for f in range(b)]
    assert want.dtype == torch.int32
    assert want.tolist() == got


@pytest.mark.parametrize("kernel,src", [("K11", "qim_study.cu"),
                                        ("K13", "qim_pipe.cu")])
def test_k11_and_k13_take_k4s_spelling(kernel, src):
    """K11 and K13 take K4's Hopper design: an Arith template parameter
    (ArithHopper, or ArithHopperSmallDelta below delta 2^-10, picked by the
    launch as K4's is), the matrix from the constant bank (ConstDct), no
    shared-memory copy of it (load_dct), and the pixel re-derive only where
    capped."""
    name = {"K11": "qim_roundtrip_dual_kernel",
            "K13": "qim_roundtrip_pipe_kernel"}[kernel]
    text = (CSRC / src).read_text()
    head = text[:text.index(f"\n{name}(")]
    template = head[head.rindex("template <"):]
    assert re.match(r"template <int RN, class Arith, (int BUFS, )?int MINB>",
                    template), template
    body = _between(src, f"\n{name}(", "\n}\n")
    assert "const ConstDct m{};" in body
    assert "load_dct" not in body and "__shared__ float m" not in body
    assert "embed_block<RN, RederiveIfCapped<Arith, (MINB > 1)>>(" in body
    assert "slot_bits<RN, Arith>(" in body
    launch = text[text.index("extern \"C\""):] if kernel == "K11" else text
    assert "const bool fast = delta >= kAddRoundMinDelta;" in launch \
        or "const bool fast = a.delta >= kAddRoundMinDelta;" in launch
    assert "ArithHopperSmallDelta" in launch

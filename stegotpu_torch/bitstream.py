"""Packed bit-array codecs (a copy of ``stegotpu/bitstream.py``).

The reference shuttles payload bits around as Python ``'0'/'1'`` strings built
with ``format(byte, '08b')`` (reference: config_and_setup.py:22-41) — i.e.
big-endian, MSB-first bit order. Here bits are ``numpy`` ``uint8`` arrays of
0/1 values ("bit arrays"): the natural representation both for vectorized host
packing (``np.packbits``/``np.unpackbits`` are MSB-first, matching the
reference's layout exactly) and for shipping payload segments to the device.

String-bitstream helpers are kept for interop/debug and tests.
"""

from __future__ import annotations

import numpy as np

BitArray = np.ndarray  # uint8 array of 0/1, MSB-first semantics


def bytes_to_bits(data: bytes) -> BitArray:
    """bytes -> bit array, MSB-first (reference: config_and_setup.py:22-23)."""
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def bits_to_bytes(bits: BitArray) -> bytes:
    """bit array -> bytes, truncating any tail that is not a whole byte.

    Mirrors the reference's truncation of non-multiple-of-8 tails
    (reference: config_and_setup.py:25-30), including the error on an
    empty result.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    n = (bits.size // 8) * 8
    if n == 0:
        raise ValueError("bitstream empty after truncation to whole bytes")
    return np.packbits(bits[:n]).tobytes()


def int_to_bits(value: int, num_bits: int) -> BitArray:
    """Fixed-width big-endian int -> bit array (reference: config_and_setup.py:32-35).

    Scalar Python loop BY DESIGN: only header FIELDS (8-32 bits each, a
    handful per payload) pass through here — never pixel data. The bulk
    paths are the vectorized bytes_to_bits/bits_to_bytes."""
    if value < 0 or value >= (1 << num_bits):
        raise ValueError(f"value {value} out of range for {num_bits} bits")
    return np.array(
        [(value >> (num_bits - 1 - i)) & 1 for i in range(num_bits)], dtype=np.uint8
    )


def bits_to_int(bits: BitArray, expected_bits: int | None = None) -> int:
    """Big-endian bit array -> int (reference: config_and_setup.py:37-41).

    Scalar loop BY DESIGN — header fields only; see int_to_bits."""
    bits = np.asarray(bits, dtype=np.uint8)
    if expected_bits is not None and bits.size != expected_bits:
        raise ValueError(f"bitstream length {bits.size} != expected {expected_bits}")
    if bits.size == 0:
        raise ValueError("empty bit array")
    out = 0
    for b in bits.tolist():
        out = (out << 1) | int(b)
    return out


def bits_to_string(bits: BitArray) -> str:
    """Bit array -> '0'/'1' string (reference string-bitstream interop)."""
    return "".join("1" if b else "0" for b in np.asarray(bits, dtype=np.uint8).tolist())


def string_to_bits(s: str) -> BitArray:
    """'0'/'1' string -> bit array. Rejects any other character (silently
    mapping '2'->2 or letters->49 would corrupt downstream bits_to_int)."""
    arr = np.frombuffer(s.encode("ascii"), dtype=np.uint8) - ord("0")
    if arr.size and (arr > 1).any():
        bad = s[int(np.argmax(arr > 1))]
        raise ValueError(f"bitstream string contains non-binary char {bad!r}")
    return arr


def pad_bits(bits: BitArray, target_len: int, fill: int = 0) -> BitArray:
    """Right-pad a bit array with `fill` up to `target_len` (don't-care bits)."""
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.size > target_len:
        raise ValueError(f"bit array ({bits.size}) longer than target ({target_len})")
    if bits.size == target_len:
        return bits
    out = np.full(target_len, fill, dtype=np.uint8)
    out[: bits.size] = bits
    return out

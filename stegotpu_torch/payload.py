"""Payload wire format: build and parse the embedded bitstream.

A copy of ``stegotpu/payload.py``; tests/test_torch_host.py holds the two
bit-equal.

Layout (all integers big-endian, MSB-first; reference: embed_process.py:60-82
built, extract_process.py:89-188 parsed):

    [16] secret width          [16] secret height
    [ 8] len(ephemeral pubkey) [8*len] X9.62 compressed P-256 point (33B)
    [ 8] len(HKDF salt)        [8*len] salt (16B)
    [ 8] len(SHA3 hash)        [8*len] SHA3-256(plaintext image bytes) (32B)
    [ 8] len(AES nonce)        [8*len] GCM nonce (12B)
    [ 8] len(GCM tag)          [8*len] tag (16B)
    [32] len(ciphertext) bytes [8*len] AES-GCM ciphertext

With the standard field sizes the fixed header (everything before the
ciphertext) is 976 bits; the reference hardcodes that threshold
(extract_process.py:53,81) — here it is *derived* and parsing is fully
length-driven, so nonstandard sizes still parse.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from stegotpu_torch import crypto
from stegotpu_torch.bitstream import BitArray, bits_to_bytes, bits_to_int, bytes_to_bits, int_to_bits
from stegotpu_torch.config import (
    CIPHERTEXT_LEN_BITS,
    COMPRESSED_POINT_BYTES,
    DIMS_BITS,
    GCM_NONCE_BYTES,
    GCM_TAG_BYTES,
    HKDF_SALT_BYTES,
    LEN_FIELD_BITS,
)

# Extension: raw-byte payloads (not in the reference, which only embeds
# grayscale images). The dims header carries this marker instead of real
# image dimensions; the payload length is the ciphertext length. A reference
# extractor encountering it fails cleanly at image reassembly (the marker
# product mismatches any plausible byte count), it cannot misdecode.
RAW_DATA_DIMS = (0xFFFF, 0xFFFF)

# Fixed header size for the standard field sizes (reference hardcodes 976,
# extract_process.py:50-53). Derived here: dims + 5 length-prefixed fields +
# 32-bit ciphertext length.
FIXED_HEADER_BITS = (
    2 * DIMS_BITS
    + LEN_FIELD_BITS + 8 * COMPRESSED_POINT_BYTES
    + LEN_FIELD_BITS + 8 * HKDF_SALT_BYTES
    + LEN_FIELD_BITS + 8 * 32  # SHA3-256 digest
    + LEN_FIELD_BITS + 8 * GCM_NONCE_BYTES
    + LEN_FIELD_BITS + 8 * GCM_TAG_BYTES
    + CIPHERTEXT_LEN_BITS
)
assert FIXED_HEADER_BITS == 976


def max_header_bits(dims_bits: int = DIMS_BITS) -> int:
    """Upper bound on a parseable header, for any field contents.

    The length-driven format allows each of the five length-prefixed fields
    (pubkey/salt/hash/nonce/tag) to declare up to 255 bytes; collectors that
    stop at FIXED_HEADER_BITS would misreport valid nonstandard headers as
    unparseable.
    """
    return 2 * dims_bits + 5 * (LEN_FIELD_BITS + 8 * 255) + CIPHERTEXT_LEN_BITS


@dataclasses.dataclass(frozen=True)
class PayloadParts:
    """Decomposed payload fields (pre- or post-parse)."""

    secret_width: int
    secret_height: int
    sender_pub_compressed: bytes
    hkdf_salt: bytes
    sha3_hash: bytes
    nonce: bytes
    tag: bytes
    ciphertext: bytes

    @property
    def is_raw_data(self) -> bool:
        return (self.secret_width, self.secret_height) == RAW_DATA_DIMS


def dims_header_bits(width: int, height: int, dims_bits: int = DIMS_BITS) -> BitArray:
    """Two fixed-width dimension fields (reference: helpers.py:86-105)."""
    if not (0 <= width < (1 << dims_bits)) or not (0 <= height < (1 << dims_bits)):
        raise ValueError(f"dims ({width}x{height}) out of range for {dims_bits}-bit fields")
    return np.concatenate([int_to_bits(width, dims_bits), int_to_bits(height, dims_bits)])


def parse_dims_header(bits: BitArray, dims_bits: int = DIMS_BITS) -> tuple[int, int]:
    """Inverse of dims_header_bits (reference: helpers.py:107-126)."""
    if bits.size < 2 * dims_bits:
        raise ValueError(
            f"metadata bitstream too short ({bits.size} bits), need {2 * dims_bits}"
        )
    return bits_to_int(bits[:dims_bits]), bits_to_int(bits[dims_bits : 2 * dims_bits])


def build_payload_bits(parts: PayloadParts, dims_bits: int = DIMS_BITS) -> BitArray:
    """Assemble the full payload bit array (reference: embed_process.py:60-74)."""
    chunks = [
        dims_header_bits(parts.secret_width, parts.secret_height, dims_bits),
        int_to_bits(len(parts.sender_pub_compressed), LEN_FIELD_BITS),
        bytes_to_bits(parts.sender_pub_compressed),
        int_to_bits(len(parts.hkdf_salt), LEN_FIELD_BITS),
        bytes_to_bits(parts.hkdf_salt),
        int_to_bits(len(parts.sha3_hash), LEN_FIELD_BITS),
        bytes_to_bits(parts.sha3_hash),
        int_to_bits(len(parts.nonce), LEN_FIELD_BITS),
        bytes_to_bits(parts.nonce),
        int_to_bits(len(parts.tag), LEN_FIELD_BITS),
        bytes_to_bits(parts.tag),
        int_to_bits(len(parts.ciphertext), CIPHERTEXT_LEN_BITS),
        bytes_to_bits(parts.ciphertext),
    ]
    return np.concatenate(chunks)


def seal_payload(
    image_bytes: bytes,
    width: int,
    height: int,
    receiver_pub_compressed: bytes,
    dims_bits: int = DIMS_BITS,
    rng=None,
) -> tuple[BitArray, PayloadParts]:
    """Crypto stage + framing: SHA3, ephemeral ECDH, HKDF, AES-GCM, assemble.

    rng: optional numpy Generator making the ephemeral key / salt / nonce
    deterministic — test builds only (frozen golden artifacts).

    (reference: embed_process.py:30-86, stages 1-2)
    """
    if len(image_bytes) >= (1 << 28) - 256:
        # the device kernels index payload bits with int32 (a deliberate
        # trade: 2^31 bits = 268 MB of payload); beyond that the masks
        # would wrap negative and the embed would silently write nothing
        raise ValueError(
            f"payload of {len(image_bytes)} bytes exceeds the 2^31-bit "
            "(268 MB) indexing limit")
    if width == 0 or height == 0:
        # the parser rejects 0x0 dims as corrupt (parse_header_bits), so a
        # zero-dim embed would produce a payload NO extractor accepts, with
        # a misleading wrong-key diagnosis at extract time — fail at seal
        raise ValueError(f"secret dimensions {width}x{height} invalid: "
                         "both must be nonzero")
    sha3 = crypto.sha3_256(image_bytes)
    eph_priv, eph_pub = crypto.generate_keypair(rng)
    receiver_pub = crypto.deserialize_public_compressed(receiver_pub_compressed)
    shared = crypto.ecdh_shared_secret(eph_priv, receiver_pub)
    salt = crypto.hkdf_salt(rng)
    aes_key = crypto.derive_aes_key(shared, salt)
    ciphertext, nonce, tag = crypto.aes_gcm_encrypt(image_bytes, aes_key, rng)
    parts = PayloadParts(
        secret_width=width,
        secret_height=height,
        sender_pub_compressed=crypto.serialize_public_compressed(eph_pub),
        hkdf_salt=salt,
        sha3_hash=sha3,
        nonce=nonce,
        tag=tag,
        ciphertext=ciphertext,
    )
    return build_payload_bits(parts, dims_bits), parts


class NeedMoreBits(Exception):
    """Raised by the incremental parser when the bit buffer is too short.

    ``needed`` is a lower bound on the total bits required so far.
    """

    def __init__(self, needed: int):
        super().__init__(f"need at least {needed} payload bits")
        self.needed = needed


class _Cursor:
    def __init__(self, bits: BitArray):
        self.bits = np.asarray(bits, dtype=np.uint8)
        self.pos = 0

    def take(self, n: int) -> BitArray:
        if self.bits.size < self.pos + n:
            raise NeedMoreBits(self.pos + n)
        out = self.bits[self.pos : self.pos + n]
        self.pos += n
        return out

    def take_int(self, n: int) -> int:
        return bits_to_int(self.take(n))

    def take_bytes_field(self, len_bits: int = LEN_FIELD_BITS) -> bytes:
        n_bytes = self.take_int(len_bits)
        if n_bytes == 0:
            return b""
        return bits_to_bytes(self.take(8 * n_bytes))


def parse_header_bits(
    bits: BitArray, dims_bits: int = DIMS_BITS
) -> tuple[PayloadParts, int, int]:
    """Parse ONLY the header (everything before the ciphertext).

    Returns (parts-with-empty-ciphertext, ciphertext_bytes, bits_consumed).
    Raises NeedMoreBits if the buffer ends mid-header. Useful for inspection
    tools that must not require the whole payload to be present.
    """
    cur = _Cursor(bits)
    width = cur.take_int(dims_bits)
    height = cur.take_int(dims_bits)
    if width == 0 or height == 0:
        raise ValueError("parsed secret dimensions are 0x0 — wrong key/params or corrupt stego")
    parts = PayloadParts(
        secret_width=width,
        secret_height=height,
        sender_pub_compressed=cur.take_bytes_field(),
        hkdf_salt=cur.take_bytes_field(),
        sha3_hash=cur.take_bytes_field(),
        nonce=cur.take_bytes_field(),
        tag=cur.take_bytes_field(),
        ciphertext=b"",
    )
    ct_len = cur.take_int(CIPHERTEXT_LEN_BITS)
    return parts, ct_len, cur.pos


def parse_payload_bits(
    bits: BitArray, dims_bits: int = DIMS_BITS
) -> tuple[PayloadParts, int]:
    """Parse a (possibly over-long) extracted bit buffer into payload fields.

    Sequential, length-driven parse (reference: extract_process.py:89-188).
    Returns (parts, bits_consumed). Raises NeedMoreBits if the buffer ends
    mid-field — the caller should extract more frames and retry.
    """
    parts, ct_len, pos = parse_header_bits(bits, dims_bits)
    cur = _Cursor(bits)
    cur.pos = pos
    ciphertext = bits_to_bytes(cur.take(8 * ct_len)) if ct_len else b""
    return dataclasses.replace(parts, ciphertext=ciphertext), cur.pos


def open_payload(parts: PayloadParts, receiver_private) -> tuple[bytes | None, bool]:
    """Re-derive the AES key and decrypt; verify SHA3.

    Returns (plaintext or None on auth failure, hash_ok). A hash mismatch does
    not fail the decryption (the reference warns but continues,
    extract_process.py:196-202).
    """
    sender_pub = crypto.deserialize_public_compressed(parts.sender_pub_compressed)
    shared = crypto.ecdh_shared_secret(receiver_private, sender_pub)
    aes_key = crypto.derive_aes_key(shared, parts.hkdf_salt)
    plaintext = crypto.aes_gcm_decrypt(parts.ciphertext, aes_key, parts.nonce, parts.tag)
    if plaintext is None:
        return None, False
    return plaintext, crypto.sha3_256(plaintext) == parts.sha3_hash

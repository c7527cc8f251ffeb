"""The plain reference of the raw-data payload: the wire format of
stegobench/reference.py with the raw-bytes marker in its dimensions.

A byte payload is sealed as an image secret is (SHA3-256 of the plaintext,
an ephemeral P-256 key, ECDH, HKDF-SHA256, AES-256-GCM) and framed the same
way, with width and height both 0xFFFF, the marker that tells an extractor
the plaintext is bytes and not pixels. Like reference.py it imports nothing
of the program under test.
"""

from __future__ import annotations

import hashlib

import numpy as np

from stegobench.reference import (CT_LEN_BITS, DIMS_BITS, LEN_BITS, _aes_key,
                                  _compressed, _field, _int_bits, receiver_key)

# width and height of a raw-bytes payload
RAW_DIMS = 0xFFFF
# the framing before the ciphertext: dims, the five length-prefixed fields
# (33-byte compressed key, 16-byte salt, 32-byte SHA3, 12-byte nonce,
# 16-byte tag) and the ciphertext's length
HEADER_BITS = (2 * DIMS_BITS + 5 * LEN_BITS + 8 * (33 + 16 + 32 + 12 + 16)
               + CT_LEN_BITS)


def seal_data(data: bytes, receiver_pub_compressed: bytes,
              rng: np.random.Generator) -> np.ndarray:
    """The payload bits of `data`, sealed for the receiver. The rng is
    consumed as reference.seal consumes it: 48 bytes of ephemeral key, a
    16-byte salt, a 12-byte nonce."""
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    digest = hashlib.sha3_256(data).digest()
    eph = receiver_key(rng)
    peer = ec.EllipticCurvePublicKey.from_encoded_point(
        ec.SECP256R1(), receiver_pub_compressed)
    salt = rng.bytes(16)
    nonce = rng.bytes(12)
    sealed = AESGCM(_aes_key(eph, peer, salt)).encrypt(nonce, bytes(data), None)
    ct, tag = sealed[:-16], sealed[-16:]
    parts = [_int_bits(RAW_DIMS, DIMS_BITS), _int_bits(RAW_DIMS, DIMS_BITS)]
    for f in (_compressed(eph.public_key()), salt, digest, nonce, tag):
        parts += _field(f)
    parts += [_int_bits(len(ct), CT_LEN_BITS),
              np.unpackbits(np.frombuffer(ct, np.uint8))]
    return np.concatenate(parts)


def _num(bits: np.ndarray) -> int:
    return int("".join(map(str, bits.tolist())) or "0", 2)


def open_data(bits: np.ndarray, receiver_private) -> bytes | None:
    """The plaintext bytes from payload bits (a prefix of the wire stream),
    or None where the framing does not parse, the dimensions are not the
    raw-bytes marker, AES-GCM refuses it or the SHA3 does not match."""
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    bits = np.asarray(bits, np.uint8)
    pos = 0

    def take(n: int) -> np.ndarray:
        nonlocal pos
        if pos + n > bits.size:
            raise ValueError("payload ends early")
        pos += n
        return bits[pos - n:pos]

    def field() -> bytes:
        return np.packbits(take(8 * _num(take(LEN_BITS)))).tobytes()

    try:
        w, h = _num(take(DIMS_BITS)), _num(take(DIMS_BITS))
        if (w, h) != (RAW_DIMS, RAW_DIMS):
            return None
        pub, salt, digest, nonce, tag = (field() for _ in range(5))
        ct = np.packbits(take(8 * _num(take(CT_LEN_BITS)))).tobytes()
        peer = ec.EllipticCurvePublicKey.from_encoded_point(ec.SECP256R1(), pub)
        plain = AESGCM(_aes_key(receiver_private, peer, salt)).decrypt(
            nonce, ct + tag, None)
    except (ValueError, InvalidTag):
        return None
    if hashlib.sha3_256(plain).digest() != digest:
        return None
    return plain

"""Host-side cryptography: P-256 ECDH, HKDF-SHA256, AES-256-GCM, SHA3-256.

A copy of ``stegotpu/crypto.py`` with ``cryptography`` imported inside the
functions that use it, so that the pipeline imports without it.

Crypto is not device work: these stay host-side, built on the ``cryptography``
library (OpenSSL), exactly like the reference (reference:
config_and_setup.py:44-103). The derivation protocol is part of the wire
format and must match the reference byte-for-byte:

- ephemeral sender keypair on SECP256R1, public key serialized as an X9.62
  compressed point (33 bytes) (reference: config_and_setup.py:73-85);
- ECDH shared secret -> HKDF-SHA256 with a random 16-byte salt and the fixed
  info string ``b'kunci aes untuk steganografi video'`` -> 32-byte AES key
  (reference: config_and_setup.py:91-96, embed_process.py:41-42);
- AES-256-GCM with a random 12-byte nonce, no AAD, 16-byte tag carried
  separately from the ciphertext (reference: config_and_setup.py:44-70);
- SHA3-256 of the plaintext image bytes for integrity (reference:
  config_and_setup.py:99-103).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

from stegotpu_torch.config import (
    AES_KEY_BYTES,
    GCM_NONCE_BYTES,
    GCM_TAG_BYTES,
    HKDF_INFO,
    HKDF_SALT_BYTES,
)

log = logging.getLogger("stegotpu_torch")

# group order of SECP256R1 (SEC 2), for deterministic scalar derivation
_P256_ORDER = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551


def _random_bytes(n: int, rng=None) -> bytes:
    """os.urandom, or bytes from an injected numpy Generator.

    The injected-RNG path exists for DETERMINISTIC TEST BUILDS ONLY (frozen
    wire-compat golden artifacts need a reproducible ephemeral key / salt /
    nonce); production callers never pass rng.
    """
    return os.urandom(n) if rng is None else rng.bytes(n)


# --- keypairs and point serialization ---------------------------------------

def generate_keypair(rng=None) -> tuple[ec.EllipticCurvePrivateKey, ec.EllipticCurvePublicKey]:
    from cryptography.hazmat.primitives.asymmetric import ec

    if rng is None:
        priv = ec.generate_private_key(ec.SECP256R1())
    else:  # deterministic test builds: derive the scalar from the rng
        val = int.from_bytes(_random_bytes(48, rng), "big") % (_P256_ORDER - 1) + 1
        priv = ec.derive_private_key(val, ec.SECP256R1())
    return priv, priv.public_key()


def serialize_public_compressed(pub: ec.EllipticCurvePublicKey) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return pub.public_bytes(
        encoding=serialization.Encoding.X962,
        format=serialization.PublicFormat.CompressedPoint,
    )


def deserialize_public_compressed(data: bytes) -> ec.EllipticCurvePublicKey:
    from cryptography.hazmat.primitives.asymmetric import ec

    return ec.EllipticCurvePublicKey.from_encoded_point(ec.SECP256R1(), data)


# --- key agreement -----------------------------------------------------------

def ecdh_shared_secret(
    local_private: ec.EllipticCurvePrivateKey, remote_public: ec.EllipticCurvePublicKey
) -> bytes:
    from cryptography.hazmat.primitives.asymmetric import ec

    return local_private.exchange(ec.ECDH(), remote_public)


def derive_aes_key(
    shared_secret: bytes, salt: bytes | None = None, key_bytes: int = AES_KEY_BYTES
) -> bytes:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    hkdf = HKDF(algorithm=hashes.SHA256(), length=key_bytes, salt=salt, info=HKDF_INFO)
    return hkdf.derive(shared_secret)


# --- AES-GCM -----------------------------------------------------------------

def aes_gcm_encrypt(plaintext: bytes, key: bytes, rng=None) -> tuple[bytes, bytes, bytes]:
    """Returns (ciphertext, nonce, tag); tag split off the AESGCM output tail."""
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    if len(key) not in (16, 24, 32):
        raise ValueError("AES key must be 16, 24, or 32 bytes")
    nonce = _random_bytes(GCM_NONCE_BYTES, rng)
    ct_with_tag = AESGCM(key).encrypt(nonce, plaintext, None)
    return ct_with_tag[:-GCM_TAG_BYTES], nonce, ct_with_tag[-GCM_TAG_BYTES:]


def aes_gcm_decrypt(ciphertext: bytes, key: bytes, nonce: bytes, tag: bytes) -> bytes | None:
    """Returns plaintext, or None on authentication failure (reference:
    config_and_setup.py:57-70 returns None on InvalidTag)."""
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    if len(key) not in (16, 24, 32):
        raise ValueError("AES key must be 16, 24, or 32 bytes")
    try:
        return AESGCM(key).decrypt(nonce, ciphertext + tag, None)
    except InvalidTag:
        return None


# --- integrity ---------------------------------------------------------------

def sha3_256(data: bytes) -> bytes:
    from cryptography.hazmat.primitives import hashes

    digest = hashes.Hash(hashes.SHA3_256())
    digest.update(data)
    return digest.finalize()


# --- persistent receiver keys (PEM) ------------------------------------------

def save_keypair_pem(
    priv: ec.EllipticCurvePrivateKey, private_path: str | Path,
    public_path: str | Path, passphrase: bytes | None = None,
) -> None:
    """PKCS8 private + SubjectPublicKeyInfo public PEMs
    (reference: config_and_setup.py:188-198 — which stores the private key
    UNENCRYPTED; that stays the default for wire-compatibility, but
    `passphrase` opts into encrypted PKCS8 at rest, the right choice for a
    serving daemon's key (genkey --passphrase))."""
    from cryptography.hazmat.primitives import serialization

    if passphrase is not None and not passphrase:
        # fail-closed: a caller passing an empty passphrase believes the
        # key will be protected; silently writing NoEncryption would be
        # fail-open (cli.py guards interactively, the library must too)
        raise ValueError("empty passphrase; pass None for an unencrypted key")
    enc = (serialization.BestAvailableEncryption(passphrase)
           if passphrase else serialization.NoEncryption())
    private_path = Path(private_path)
    private_path.touch(mode=0o600, exist_ok=True)
    private_path.chmod(0o600)  # owner-only even for a pre-existing file
    private_path.write_bytes(
        priv.private_bytes(
            encoding=serialization.Encoding.PEM,
            format=serialization.PrivateFormat.PKCS8,
            encryption_algorithm=enc,
        )
    )
    Path(public_path).write_bytes(
        priv.public_key().public_bytes(
            encoding=serialization.Encoding.PEM,
            format=serialization.PublicFormat.SubjectPublicKeyInfo,
        )
    )


def load_private_pem(path: str | Path,
                     passphrase: bytes | None = None
                     ) -> ec.EllipticCurvePrivateKey:
    """Load a PKCS8 private PEM, encrypted or not.

    For an encrypted PEM with no explicit passphrase, the
    STEGOTPU_KEY_PASSPHRASE environment variable is consulted — this is how
    every existing caller (CLI, GUI, serving daemon) transparently supports
    at-rest-encrypted keys without plumbing a secret through argv."""
    from cryptography.hazmat.primitives import serialization

    data = Path(path).read_bytes()
    try:
        return serialization.load_pem_private_key(data, password=passphrase)
    except TypeError:
        # "password was not given but private key is encrypted"
        if passphrase is None:
            env = os.environ.get("STEGOTPU_KEY_PASSPHRASE")
            if env:
                return serialization.load_pem_private_key(
                    data, password=env.encode())
            raise ValueError(
                f"private key {path} is encrypted; set "
                "STEGOTPU_KEY_PASSPHRASE or pass a passphrase"
            ) from None
        raise


def load_public_pem(path: str | Path) -> ec.EllipticCurvePublicKey:
    from cryptography.hazmat.primitives import serialization

    return serialization.load_pem_public_key(Path(path).read_bytes())


def setup_receiver_keys(
    private_path: str | Path = "bob_private_key.pem",
    public_path: str | Path = "bob_public_key.pem",
    passphrase: bytes | None = None,
) -> tuple[ec.EllipticCurvePrivateKey, bytes]:
    """Create-or-load the receiver's persistent keypair.

    Returns (private key, compressed public point bytes)
    (reference: config_and_setup.py:177-216 ``setup_kunci_ecc``).
    passphrase: encrypt a NEWLY created private PEM at rest (and decrypt an
    existing one); None keeps the reference's unencrypted default.
    """
    from cryptography.hazmat.primitives import serialization

    private_path, public_path = Path(private_path), Path(public_path)
    if not private_path.exists():
        priv, _ = generate_keypair()
        save_keypair_pem(priv, private_path, public_path, passphrase)
    elif not public_path.exists():
        # NEVER regenerate over an existing private key (stego videos
        # encrypted to it would become undecryptable) — the public half is
        # derivable from the private PEM.
        priv = load_private_pem(private_path, passphrase)
        public_path.write_bytes(
            priv.public_key().public_bytes(
                encoding=serialization.Encoding.PEM,
                format=serialization.PublicFormat.SubjectPublicKeyInfo,
            )
        )
    priv = load_private_pem(private_path, passphrase)
    try:
        pub = load_public_pem(public_path)
    except ValueError:
        # corrupt/unparseable public PEM beside a valid private PEM: the
        # private PEM is the source of truth (same policy as the mismatch
        # branch below) — repair rather than crash
        log.warning("public PEM %s is unreadable — rewriting it from the "
                    "private key", public_path)
        pub = priv.public_key()
        public_path.write_bytes(
            pub.public_bytes(
                encoding=serialization.Encoding.PEM,
                format=serialization.PublicFormat.SubjectPublicKeyInfo,
            )
        )
    # a stale/mismatched public PEM beside a valid private PEM would silently
    # produce stego videos the private key cannot decrypt — rewrite it from
    # the private key (the private PEM is the source of truth)
    if pub.public_numbers() != priv.public_key().public_numbers():
        log.warning(
            "public PEM %s did not match private PEM %s — rewriting the "
            "public file from the private key (check for a restored/stale "
            "key backup if this is unexpected)", public_path, private_path,
        )
        pub = priv.public_key()
        public_path.write_bytes(
            pub.public_bytes(
                encoding=serialization.Encoding.PEM,
                format=serialization.PublicFormat.SubjectPublicKeyInfo,
            )
        )
    return priv, serialize_public_compressed(pub)


def hkdf_salt(rng=None) -> bytes:
    return _random_bytes(HKDF_SALT_BYTES, rng)

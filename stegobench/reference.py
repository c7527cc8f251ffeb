"""The plain reference that decides ``correct``: QIM in 8x8 DCT blocks, the
payload's wire format and its sealing, written from the algorithm's
description in plain PyTorch and numpy.

It imports nothing of the program under test. Its semantics are the
reference project's (erc-a/Secure-Video-Steganography-using-ECC-and-DCT,
config_and_setup.py and embed/extract_process.py):

- frames are 8-bit luma; a BGR frame becomes luma by OpenCV's fixed-point
  BT.601 rule, (R*9798 + G*19235 + B*3735 + 2^14) >> 15;
- blocks are 8x8, row of blocks outer; the transform is the orthonormal
  DCT-II, the payload slots are the flat row-major coefficients 1..num_ac
  of each block, and bits are consumed block by block, num_ac per block;
- embed: q = round(c / delta), half to even; where q's parity (floor mod)
  differs from the bit, q moves by +1 for a 1 and by -1 for a 0; the
  coefficient becomes q * delta; blocks that carry no payload are left as
  they are; pixels are clipped to [0, 255] and truncated to uint8;
- extract: round(c / delta) mod 2 of every slot.

The transform runs as the difference form x + (c' - c) K_slots, the same
function as inverse(forward(x) with the slots replaced), in float32 with
TF32 off: the precision the configurations state. ``precision="tf32"``
rounds every matrix operand to TF32 (10 mantissa bits, round to nearest
even) before the float32 product, as a TF32 tensor-core product does; that
is the control that a check has to refuse.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

BLOCK = 8
# the wire format: [16] width [16] height, then five byte fields each behind
# an 8-bit length (ephemeral public key, HKDF salt, SHA3-256, nonce, tag),
# then a 32-bit ciphertext length and the ciphertext
DIMS_BITS = 16
LEN_BITS = 8
CT_LEN_BITS = 32
HKDF_INFO = b"kunci aes untuk steganografi video"
P256_ORDER = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dct_kron(device, dtype=torch.float32) -> torch.Tensor:
    """The 2-D orthonormal DCT-II on a flattened 8x8 block as a 64x64
    matrix (kron of the 1-D matrix with itself), made in float64."""
    k = np.arange(BLOCK, dtype=np.float64)[:, None]
    n = np.arange(BLOCK, dtype=np.float64)[None, :]
    c = np.cos(math.pi * (2 * n + 1) * k / (2 * BLOCK)) * math.sqrt(2 / BLOCK)
    c[0] *= math.sqrt(0.5)
    return torch.tensor(np.kron(c, c), dtype=dtype, device=device)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    _no_tf32()
    if precision == "tf32":
        return tf32(a) @ tf32(b)
    if precision == "f64":
        return a.double() @ b.double()
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b


def gray(bgr: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) uint8 BGR -> (..., H, W) uint8 luma, OpenCV's rule."""
    f = bgr.astype(np.int32)
    return ((f[..., 2] * 9798 + f[..., 1] * 19235 + f[..., 0] * 3735
             + (1 << 14)) >> 15).astype(np.uint8)


def blocks(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H/8 * W/8, 64) float32, row of blocks outer."""
    b, h, w = frames.shape
    x = frames.reshape(b, h // BLOCK, BLOCK, w // BLOCK, BLOCK)
    return x.permute(0, 1, 3, 2, 4).reshape(b, -1, BLOCK * BLOCK).float()


def unblocks(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = x.shape[0]
    x = x.reshape(b, h // BLOCK, w // BLOCK, BLOCK, BLOCK)
    return x.permute(0, 1, 3, 2, 4).reshape(b, h, w)


def capacity(h: int, w: int, num_ac: int) -> int:
    return (h // BLOCK) * (w // BLOCK) * num_ac


def embed(frames: torch.Tensor, bits: torch.Tensor, total_bits: int,
          delta: float, num_ac: int, precision: str = "f32"
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """QIM embed of wire-order payload bits (B, C) into (B, H, W) uint8
    frames; global bit i lies in frame i // C. Slots at or past total_bits
    carry nothing. Returns (stego uint8, bits per frame int64)."""
    b, h, w = frames.shape
    nb = (h // BLOCK) * (w // BLOCK)
    cap = nb * num_ac
    delta = float(np.float32(delta))
    dev = frames.device
    ks = dct_kron(dev)[1:1 + num_ac]                        # (n, 64)
    x = blocks(frames)                                      # (b, nb, 64)
    y = _mm(x, ks.T, precision)                             # (b, nb, n)
    idx = (torch.arange(b, device=dev)[:, None, None] * cap
           + torch.arange(nb, device=dev)[None, :, None] * num_ac
           + torch.arange(num_ac, device=dev)[None, None, :])
    valid = idx < int(total_bits)
    bit = bits.reshape(b, nb, num_ac).float()
    q = torch.round(y / delta)
    move = torch.where(torch.remainder(q, 2.0) != bit,
                       torch.where(bit == 1.0, 1.0, -1.0), 0.0)
    dy = torch.where(valid, (q + move) * delta - y, 0.0)
    x = x + _mm(dy, ks, precision)
    stego = unblocks(x, h, w).clamp(0.0, 255.0).to(torch.int32).to(torch.uint8)
    bpf = (int(total_bits) - torch.arange(b, device=dev) * cap).clamp(0, cap)
    return stego, bpf


def slot_values(frames: torch.Tensor, delta: float, num_ac: int,
                precision: str = "f32") -> torch.Tensor:
    """c / delta of every payload slot, (B, C) in wire order (float64 for
    precision "f64", the matrix then made in float64 too)."""
    delta = float(np.float32(delta))
    dtype = torch.float64 if precision == "f64" else torch.float32
    ks = dct_kron(frames.device, dtype)[1:1 + num_ac]
    y = _mm(blocks(frames), ks.T, precision)
    return (y / delta).reshape(frames.shape[0], -1)


def extract(frames: torch.Tensor, delta: float, num_ac: int,
            precision: str = "f32") -> torch.Tensor:
    """Every slot's bit, (B, C) uint8 in wire order."""
    v = slot_values(frames, delta, num_ac, precision)
    return torch.remainder(torch.round(v), 2.0).to(torch.uint8)


def near_boundary(v: torch.Tensor, delta: float) -> torch.Tensor:
    """Slots whose coefficient c = v * delta lies within the float32
    envelope of a rounding boundary: |c - (k + 1/2) delta| < 1e-2 +
    2e-5 |c| (at most 0.45 delta). Two float32 programs that sum in other
    orders may read such a slot either way; v is best taken in float64."""
    delta = float(np.float32(delta))
    dist = (v - torch.floor(v) - 0.5).abs() * delta
    return dist < torch.clamp(1e-2 + 2e-5 * (v * delta).abs(), max=0.45 * delta)


# A float32 embed's pixels before truncation lie within about 3.5e-5 of
# the float64 ones (K1 and this file's float32 embed on 8 frames of 4K,
# H100); TF32's within about 0.5.
PIXEL_TOL = 1e-4


def embed_envelope(frames: torch.Tensor, bits: torch.Tensor, total_bits: int,
                   delta: float, num_ac: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The embed in float64 and where its answer is certain. Returns (the
    stego, uint8, and `sure`, bool, both (B, H, W)). A pixel is sure unless
    its block holds a payload slot within the float32 envelope of a rounding
    boundary (near_boundary: a float32 program may round that slot either
    way, and a slot exactly on a boundary, such as flat coefficient 4 whose
    weights are +-1/8, is a tie that only exact arithmetic settles), or its
    value before truncation lies within PIXEL_TOL of an integer (a float32
    program may truncate it either way: a flat block's pixels are such
    integers). Blocks that carry no payload pass through, sure."""
    b, h, w = frames.shape
    nb = (h // BLOCK) * (w // BLOCK)
    cap = nb * num_ac
    delta = float(np.float32(delta))
    dev = frames.device
    ks = dct_kron(dev, torch.float64)[1:1 + num_ac]
    x = blocks(frames).double()
    y = x @ ks.T
    idx = (torch.arange(b, device=dev)[:, None, None] * cap
           + torch.arange(nb, device=dev)[None, :, None] * num_ac
           + torch.arange(num_ac, device=dev)[None, None, :])
    valid = idx < int(total_bits)
    del idx
    v = y / delta
    bit = bits.reshape(b, nb, num_ac).double()
    q = torch.round(v)
    move = torch.where(torch.remainder(q, 2.0) != bit,
                       torch.where(bit == 1.0, 1.0, -1.0), 0.0)
    dy = torch.where(valid, (q + move) * delta - y, 0.0)
    tie = (near_boundary(v, delta) & valid).any(-1, keepdim=True)
    entered = valid.any(-1, keepdim=True)
    del y, v, q, move, bit
    z = x + dy @ ks
    frac = z - torch.floor(z)
    sure = ~entered | (~tie & (frac > PIXEL_TOL) & (frac < 1 - PIXEL_TOL))
    stego = torch.where(entered, z.clamp(0.0, 255.0).floor(), x).to(torch.uint8)
    return unblocks(stego, h, w), unblocks(sure, h, w)


def psnr_f64(a: torch.Tensor, b: torch.Tensor, frames: int = 8) -> float:
    """PSNR in dB of two uint8 stacks, the mean squared error in float64,
    summed `frames` frames at a time."""
    sq = 0.0
    for f in range(0, a.shape[0], frames):
        d = a[f:f + frames].double() - b[f:f + frames].double()
        sq += float((d * d).sum())
    m = sq / a.numel()
    return math.inf if m == 0 else 10.0 * math.log10(255.0 ** 2 / m)


# --- the payload: sealing, framing, parsing, opening --------------------------

def _int_bits(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def _field(data: bytes) -> list[np.ndarray]:
    return [_int_bits(len(data), LEN_BITS),
            np.unpackbits(np.frombuffer(data, np.uint8))]


def receiver_key(rng: np.random.Generator):
    """A P-256 private key whose scalar comes from 48 bytes of rng."""
    from cryptography.hazmat.primitives.asymmetric import ec

    val = int.from_bytes(rng.bytes(48), "big") % (P256_ORDER - 1) + 1
    return ec.derive_private_key(val, ec.SECP256R1())


def _compressed(pub) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return pub.public_bytes(serialization.Encoding.X962,
                            serialization.PublicFormat.CompressedPoint)


def _aes_key(private, peer_pub, salt: bytes) -> bytes:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    shared = private.exchange(ec.ECDH(), peer_pub)
    return HKDF(algorithm=hashes.SHA256(), length=32, salt=salt,
                info=HKDF_INFO).derive(shared)


def seal(pixels: np.ndarray, receiver_pub_compressed: bytes,
         rng: np.random.Generator) -> np.ndarray:
    """The payload bits of a (H, W) uint8 secret, sealed for the receiver:
    SHA3-256 of the row-major pixels, an ephemeral P-256 key (48 bytes of
    rng), ECDH, HKDF-SHA256 with a 16-byte salt, AES-256-GCM with a 12-byte
    nonce (both from rng, in that order), framed as the wire format says."""
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    h, w = pixels.shape
    plain = np.ascontiguousarray(pixels, np.uint8).tobytes()
    digest = hashlib.sha3_256(plain).digest()
    eph = receiver_key(rng)
    peer = ec.EllipticCurvePublicKey.from_encoded_point(
        ec.SECP256R1(), receiver_pub_compressed)
    salt = rng.bytes(16)
    nonce = rng.bytes(12)
    sealed = AESGCM(_aes_key(eph, peer, salt)).encrypt(nonce, plain, None)
    ct, tag = sealed[:-16], sealed[-16:]
    parts = [_int_bits(w, DIMS_BITS), _int_bits(h, DIMS_BITS)]
    for f in (_compressed(eph.public_key()), salt, digest, nonce, tag):
        parts += _field(f)
    parts += [_int_bits(len(ct), CT_LEN_BITS),
              np.unpackbits(np.frombuffer(ct, np.uint8))]
    return np.concatenate(parts)


def open_sealed(bits: np.ndarray, receiver_private) -> np.ndarray | None:
    """The secret's pixels from payload bits (a prefix of the wire stream),
    or None where the framing does not parse or AES-GCM refuses it."""
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    pos = 0

    def take(n: int) -> np.ndarray:
        nonlocal pos
        if pos + n > bits.size:
            raise ValueError("payload ends early")
        pos += n
        return bits[pos - n:pos]

    def num(n: int) -> int:
        return int("".join(map(str, take(n).tolist())) or "0", 2)

    def field() -> bytes:
        return np.packbits(take(8 * num(LEN_BITS))).tobytes()

    try:
        w, h = num(DIMS_BITS), num(DIMS_BITS)
        pub, salt, digest, nonce, tag = (field() for _ in range(5))
        ct = np.packbits(take(8 * num(CT_LEN_BITS))).tobytes()
        peer = ec.EllipticCurvePublicKey.from_encoded_point(ec.SECP256R1(), pub)
        plain = AESGCM(_aes_key(receiver_private, peer, salt)).decrypt(
            nonce, ct + tag, None)
    except (ValueError, InvalidTag):
        return None
    if hashlib.sha3_256(plain).digest() != digest or len(plain) != w * h:
        return None
    return np.frombuffer(plain, np.uint8).reshape(h, w)


def public_compressed(private) -> bytes:
    return _compressed(private.public_key())

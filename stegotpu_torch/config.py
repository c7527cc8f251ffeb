"""Typed configuration for the stegotpu_torch pipeline.

A copy of ``stegotpu/config.py`` (tests/test_torch_host.py holds the two
equal): the port cannot import ``stegotpu``, whose package ``__init__``
pulls in JAX.

The reference has no config system — parameters are hardcoded ``__main__``
constants (reference: embed_process.py:169-170 ``DELTA_UNTUK_TES = 20``,
``JUMLAH_AC_KOEFISIEN_DIPAKAI = 10``) and GUI spinboxes bounded [1,100] /
[1,63] (reference: app.py:68-69, 231-234). This module gives the same defaults
a real typed home. ``delta`` and ``num_ac_coeffs`` are out-of-band shared
secrets: both embed and extract sides must agree (they are not part of the
embedded header).
"""

from __future__ import annotations

import dataclasses

BLOCK = 8  # DCT block edge (reference: config_and_setup.py:119 block_size = 8)
BLOCK_AREA = BLOCK * BLOCK

# Wire-format constants (reference: embed_process.py:60-74; helpers.py:86-105)
DIMS_BITS = 16           # bits per secret-image dimension field
LEN_FIELD_BITS = 8       # bits for each length-prefix (pubkey/salt/hash/nonce/tag)
CIPHERTEXT_LEN_BITS = 32  # bits for the ciphertext length field

# Crypto constants (reference: config_and_setup.py:44-96)
AES_KEY_BYTES = 32
GCM_NONCE_BYTES = 12
GCM_TAG_BYTES = 16
HKDF_SALT_BYTES = 16
HKDF_INFO = b"kunci aes untuk steganografi video"  # part of the wire protocol
COMPRESSED_POINT_BYTES = 33  # X9.62 compressed P-256 point


@dataclasses.dataclass(frozen=True)
class StegoConfig:
    """QIM/DCT embedding parameters.

    delta: QIM quantization step. Max per-coefficient perturbation is
        1.5*delta (directional parity move + lattice snap). Must be large
        enough that uint8 pixel quantization cannot flip parity on re-DCT
        (default 20 is robust; 1 is not).
    num_ac_coeffs: number of AC coefficients used per 8x8 block, in row-major
        flat order starting at flat index 1 (NOT zigzag; reference:
        config_and_setup.py:136-140). Clamped to [0, 63].
    dims_bits: width of each secret-dimension header field.
    codec: fourcc for the lossless stego video container.
    kernel: device kernel variant — 'auto' (default) and 'pallas' run the
        hand-written CUDA stripe kernels on a CUDA tensor and their plain
        PyTorch versions on a CPU tensor; 'xla' runs the Kronecker-matmul
        oracle (ops/qim.py). The names are the JAX package's, so one
        config serves both (ops/dispatch.py).
    verified_embed: closed-loop repair of clipping-induced bit losses
        (ops/verified.py) — guarantees BER=0 even on saturated covers, at the
        cost of a fused re-extract (and, only when errors are found,
        `repair_rounds` repair passes). The stego stays decodable by any
        standard QIM extractor (including the reference).
    allow_residual: verified mode normally FAILS the embed when unrepairable
        slots remain (extreme saturated covers whose pre-clip dynamic range
        exceeds 255); set True to keep the reference's silent-loss behavior
        and emit the stego anyway (residual is still reported).
    qim_precision: 'wire' (default) or 'fast'. In the JAX package 'fast'
        selects single-pass bf16 TPU matmuls; this port computes IEEE f32
        (the wire arithmetic) under both names, on the CPU and on CUDA.
        The field and its validation are kept so configs stay
        interchangeable with ``stegotpu.config.StegoConfig``.
    """

    delta: int = 20
    num_ac_coeffs: int = 10
    dims_bits: int = DIMS_BITS
    codec: str = "FFV1"
    kernel: str = "auto"
    verified_embed: bool = False
    repair_rounds: int = 3
    allow_residual: bool = False
    qim_precision: str = "wire"

    def __post_init__(self) -> None:
        if self.delta <= 0:
            # the QIM quantizer divides by delta: 0 would produce NaN
            # coefficients and silently corrupt stego (the reference
            # crashes on it too)
            raise ValueError(f"delta must be > 0, got {self.delta}")
        if not (0 <= self.num_ac_coeffs <= BLOCK_AREA - 1):
            raise ValueError(
                f"num_ac_coeffs must be in [0, {BLOCK_AREA - 1}], got {self.num_ac_coeffs}"
            )
        if self.kernel not in ("auto", "xla", "pallas"):
            raise ValueError(f"kernel must be auto/xla/pallas, got {self.kernel!r}")
        if self.qim_precision not in ("wire", "fast"):
            raise ValueError(
                f"qim_precision must be wire/fast, got {self.qim_precision!r}")
        if self.qim_precision == "fast" and self.delta < 12:
            raise ValueError(
                "qim_precision='fast' needs delta >= 12: the bf16 lattice "
                "drift (~2.0 at 1080p coefficient magnitudes) consumes too "
                f"much of delta/2 margin at delta={self.delta}")

    def frame_capacity_bits(self, height: int, width: int) -> int:
        """Embedding capacity of one (pre-cropped) frame in bits.

        (W//8)*(H//8)*num_ac_coeffs (reference: extract_process.py:39).
        """
        return (width // BLOCK) * (height // BLOCK) * self.num_ac_coeffs


def crop_dims(height: int, width: int) -> tuple[int, int]:
    """Frame dims cropped down to multiples of 8, top-left anchored.

    (reference: embed_process.py:94,113; extract_process.py:34,62)
    """
    return (height // BLOCK) * BLOCK, (width // BLOCK) * BLOCK

"""The work each kernel's call must do, and the least time an H100 could
take for it.

``work`` counts the bytes a call must move, each input read once and each
output written once (the transform matrix and the wrapper's small outputs,
such as bits per frame, included), and the f32 operations of its
transforms, two per FMA, counted for the separable 8-point DCT, the least
work of the function (K7 does the Kronecker form's dense 64x64 product,
four times as many: the key ``kron_embed_dense`` counts those). The bound
is the larger of bytes over the HBM rate and operations over the f32 rate
outside the tensor cores, at the published peaks of the NVIDIA H100 SXM
(NVIDIA's data sheet; they assume the full 700 W power limit).
"""

from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12

# separable transforms of the RN slot rows per 8x8 block: a forward or an
# inverse is two passes of RN*64 FMAs
_TRANSFORMS = {
    "embed": 2, "embed_check": 3, "roundtrip_packed": 3, "roundtrip_rows": 3,
    "embed_packedin": 2, "roundtrip_dual": 3,
    "extract_packed": 1, "extract_rows": 1,
    "ablation_full": 1, "ablation_no_qim": 1, "ablation_full_notrunc": 1,
}

# K13 computes K4's function through a ring of 2, 3 or 4 tiles: K4's work;
# the witnesses of K7 and K8 (studies/kron_ab.py) compute theirs
_SAME_WORK = {**{f"roundtrip_pipe_buf{n}": "roundtrip_packed" for n in (2, 3, 4)},
              "kron_embed_smem": "kron_embed",
              "kron_extract_smem": "kron_extract"}


def work(kernel: str, b: int, h: int, w: int, num_ac: int,
         stripe: int) -> tuple[int, int]:
    """(bytes, f32 operations) of one call of `kernel` on B frames of HxW
    at num_ac slots, with the packed and unpacked rows laid out by
    `stripe`. Kernel names are those of chip_smoke.py's kernels line."""
    kernel = _SAME_WORK.get(kernel, kernel)
    rn = num_ac // 8 + 1
    rp = -(-(stripe // 8) * rn // 8) * 8
    blocks = b * (h // 8) * (w // 8)
    pixels = b * h * w
    payload = blocks * num_ac              # wire-order bits, one u8 each
    packed = b * (h // stripe) * rp * (w // 8)
    rows = b * (h // stripe) * rp * w
    dct, kron = 64 * 4, 64 * 64 * 4        # the f32 transform matrices
    embed = pixels + payload + dct + pixels + 4 * b  # + bits per frame
    nbytes = {
        "embed": embed,
        "embed_check": embed + 4 * b,      # + errors per frame
        "roundtrip_packed": embed + packed,
        "roundtrip_dual": embed + packed,
        "roundtrip_rows": embed + rows,
        "embed_packedin": embed - payload + packed,
        "extract_packed": pixels + dct + packed,
        "extract_rows": pixels + dct + rows,
        "kron_embed": embed - dct + kron,
        "kron_embed_dense": embed - dct + kron,
        "kron_extract": pixels + kron + payload,
        "ablation_full": pixels + dct + rows,
        "ablation_no_qim": pixels + dct + rows,
        "ablation_no_horiz": pixels + dct + rows,
        "ablation_io_only": rows + rows,   # only the rows it scales are read
        "ablation_io_f4": rows + rows,
        "ablation_full_notrunc": 4 * pixels + dct + rows,
        "copy": pixels + pixels,
        "dmaspec": pixels + payload + pixels + packed,
        # frames and stego, extracted and payload bits; the sums, the
        # ticket and the three results
        "roundtrip_eval": 2 * pixels + 2 * payload + 4 * 8 + 4,
    }[kernel]
    flops = {
        # forward + inverse of the whole block, separable: two passes of
        # 8x64 FMAs each (K7 itself does the dense 64x64 product, 4x this)
        "kron_embed": blocks * 2 * 2 * 2 * 8 * 64,
        "kron_embed_dense": blocks * 2 * 2 * 64 * 64,  # the form K7 computes
        "kron_extract": blocks * 2 * 64 * num_ac,  # the slot rows only
        "ablation_no_horiz": blocks * 2 * rn * 64,  # the vertical pass
        "ablation_io_only": rows,                  # one multiply a byte
        "ablation_io_f4": rows,
        "copy": 0,
        "dmaspec": 0,
        "roundtrip_eval": 0,                       # integer work only
    }.get(kernel)
    if flops is None:
        flops = blocks * 2 * 2 * rn * 64 * _TRANSFORMS[kernel]
    return nbytes, flops


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    """(least ms on an H100 SXM, "bytes" or "operations": which bounds)."""
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_ops = flops / H100_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")

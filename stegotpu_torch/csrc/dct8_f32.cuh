// The 8x8 orthonormal DCT-II matrix of the wire format, as f32:
// kDct8F32[k * 8 + j] = dct_matrix(8, np.float32)[k, j]
// (stegotpu_torch/ops/dct.py, the JAX package's stegotpu/ops/dct.py), the
// same float64 formula cast once. Hex-float literals, so each entry is the
// f32 value bit for bit (tests/test_torch_exact_arith.py parses them and
// holds them to both packages' matrices).
//
// A compile-time constant in the constant bank: a kernel that indexes it
// with indices fixed at compile time (the unrolled transforms of
// qim_common.cuh) gets each FFMA's matrix operand with no shared-memory
// copy, no barrier and no register to hold it. nvcc folds the values into
// the FFMAs as immediates (K1-K6's SASS, studies/sass.py FFMA_imm).

#pragma once

namespace {

__constant__ const float kDct8F32[64] = {
    0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
    0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
    0x1.f6297cp-2f, 0x1.a9b662p-2f, 0x1.1c73b4p-2f, 0x1.8f8b84p-4f,
    -0x1.8f8b84p-4f, -0x1.1c73b4p-2f, -0x1.a9b662p-2f, -0x1.f6297cp-2f,
    0x1.d906bcp-2f, 0x1.87de2ap-3f, -0x1.87de2ap-3f, -0x1.d906bcp-2f,
    -0x1.d906bcp-2f, -0x1.87de2ap-3f, 0x1.87de2ap-3f, 0x1.d906bcp-2f,
    0x1.a9b662p-2f, -0x1.8f8b84p-4f, -0x1.f6297cp-2f, -0x1.1c73b4p-2f,
    0x1.1c73b4p-2f, 0x1.f6297cp-2f, 0x1.8f8b84p-4f, -0x1.a9b662p-2f,
    0x1.6a09e6p-2f, -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
    0x1.6a09e6p-2f, -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
    0x1.1c73b4p-2f, -0x1.f6297cp-2f, 0x1.8f8b84p-4f, 0x1.a9b662p-2f,
    -0x1.a9b662p-2f, -0x1.8f8b84p-4f, 0x1.f6297cp-2f, -0x1.1c73b4p-2f,
    0x1.87de2ap-3f, -0x1.d906bcp-2f, 0x1.d906bcp-2f, -0x1.87de2ap-3f,
    -0x1.87de2ap-3f, 0x1.d906bcp-2f, -0x1.d906bcp-2f, 0x1.87de2ap-3f,
    0x1.8f8b84p-4f, -0x1.1c73b4p-2f, 0x1.a9b662p-2f, -0x1.f6297cp-2f,
    0x1.f6297cp-2f, -0x1.a9b662p-2f, 0x1.1c73b4p-2f, -0x1.8f8b84p-4f,
};

// The matrix operand of the transforms in qim_common.cuh, taken from the
// constant bank; `const float*` (a shared-memory copy) is the other.
struct ConstDct {
  __device__ __forceinline__ float operator[](int i) const { return kDct8F32[i]; }
};

}  // namespace

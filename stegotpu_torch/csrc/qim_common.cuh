// The block arithmetic shared by every QIM stripe kernel (qim_stripe.cu,
// K1-K6), the study kernels (qim_study.cu, K9-K12) and K13 (qim_pipe.cu):
// one embed (embed_block) and one decode (slot_bits), as the TPU kernels
// share _embed_core and _extract_bits_f32 (stegotpu/ops/pallas_kernel.py),
// and the register cap and bits per frame of the fused kernels
// (capped_minb, RederiveIfCapped, frame_bits). Each source that includes
// this header compiles its own copy of the same code, so a study kernel
// and the stripe kernel it varies compute the same bytes by construction:
// K9 `full` is K5, K10 is K1, and K11 and K13 are K4.
//
// Every rounding is explicit (fmaf, __fmul_rn, __fsub_rn, __fadd_rn), so
// nvcc's default FMA contraction cannot round one inlined copy differently
// from another. No tensor cores (no TF32) and no --use_fast_math.
//
// Two spellings of the same arithmetic, chosen at compile time by a tag
// (ArithCvt, ArithHopper, ArithHopperSmallDelta below) inside the one body
// of each function, never by a second copy of the block code. They give the
// same bytes for every input: each Hopper step re-expresses an exact
// operation on the full-rate pipes (FADD, integer ALU, PRMT) instead of the
// conversion pipe, which retires 16 results a clock an SM against FADD's
// 128 (CUDA C++ Programming Guide, throughput table, compute capability
// 9.0). tests/test_torch_exact_arith.py proves each step on the CPU; the
// zero-tolerance identities K10 == K1 (stego) and K9 `full` == K5 hold the
// two spellings to each other on the card: only K9 and K10 keep ArithCvt.
// The matrix operand is a template parameter too: `const float*` into a
// shared-memory copy (K9, K10), or ConstDct, the constant bank
// (dct8_f32.cuh).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "dct8_f32.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void load_rows(const uint8_t* __restrict__ p, int w,
                                          uint2 (&raw)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
    raw[r] = __ldg(reinterpret_cast<const uint2*>(p + static_cast<size_t>(r) * w));
}

__device__ __forceinline__ void store_rows(uint8_t* __restrict__ p, int w,
                                           const uint2 (&raw)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
    *reinterpret_cast<uint2*>(p + static_cast<size_t>(r) * w) = raw[r];
}

// The arithmetic tags. Each flag picks one spelling of an exact operation.
// kAddConvert: a u8 pixel becomes f32 as __uint_as_float(0x4B000000 | b)
//   - 2^23 (PRMT, FADD), and a clamped f32 pixel o in [0, 255] becomes its
//   truncated u8 as the low byte of __fadd_rz(o, 2^23) = 2^23 + floor(o),
//   four packed to a word by PRMT; else I2F and F2I.
// kAddRound: t = __fadd_rn(y / delta, 1.5 * 2^23) holds rint(y / delta)
//   (round half to even) + 1.5 * 2^23 exactly while |y / delta| <= 2^22, so
//   t - 1.5 * 2^23 is rint(y / delta) and the low mantissa bit of t is its
//   floor-mod-2 parity, negatives included; the payload byte is compared
//   with that bit as an integer. |y| <= 8 * 255 = 2040 for the orthonormal
//   DCT of u8 pixels, so every delta >= 2^-10 keeps |y / delta| under 2^21.
//   Else rintf and floorf (FRND), and the payload bit as a float.
// kRederive: the final add of the embed re-derives each pixel from the
//   block's bytes instead of keeping x[8][8] live across the embed. On its
//   own it costs K1 a little; it is what lets K1's register cap at 64 go
//   without spills, so a kernel takes it in a capped build only
//   (RederiveIfCapped below).
// kBitsFirst: the embed loads the block's payload bits (every slot up to
//   num_ac, in bounds whatever rem is) before the first slot; else each
//   slot loads its bit inside its own branch, one round trip after another.
struct ArithCvt {  // K9, K10: the conversion instructions
  static constexpr bool kAddConvert = false, kAddRound = false, kRederive = false,
                        kBitsFirst = false;
};
struct ArithHopper {  // K1-K6, K11, K13 at delta >= 2^-10
  static constexpr bool kAddConvert = true, kAddRound = true, kRederive = true,
                        kBitsFirst = true;
};
struct ArithHopperSmallDelta {  // K1-K6, K11, K13 at delta < 2^-10
  static constexpr bool kAddConvert = true, kAddRound = false, kRederive = true,
                        kBitsFirst = true;
};

// The smallest delta at which kAddRound is exact for every u8 block.
constexpr float kAddRoundMinDelta = 0x1p-10f;
constexpr float kTwo23 = 8388608.0f;          // 2^23
constexpr float kRoundShift = 12582912.0f;    // 1.5 * 2^23

// A kernel's CTAs per SM for __launch_bounds__: its cap `minb` at rn <= 2
// (num_ac <= 15), none (1) above.
constexpr int capped_minb(int rn, int minb) { return rn <= 2 ? minb : 1; }

// Arith with its pixel re-derive only where a register cap needs it: K1's
// capped build spills without it, and every build without a cap (rn > 2)
// is 4-6% faster keeping x[8][8] live.
template <class Arith, bool Capped>
struct RederiveIfCapped : Arith {
  static constexpr bool kRederive = Arith::kRederive && Capped;
};

// Pixel c of a block row (byte c & 3 of `word`, its half of the row) as f32.
template <class Arith>
__device__ __forceinline__ float pixel(uint32_t word, int c) {
  if constexpr (Arith::kAddConvert)  // selector: the byte, then 0x00, 0x00, 0x4B
    return __fadd_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | (c & 3))),
                     -kTwo23);
  else
    return static_cast<float>((word >> (8 * (c & 3))) & 0xFFu);
}

// pixel() once more, spelled with another PRMT selector that builds the
// same word (bytes 5 and 6 of 0x4B000000 are zero too), so that the
// compiler cannot merge it with the first reading and keep all 64 values
// live across the embed (kRederive).
__device__ __forceinline__ float pixel_again(uint32_t word, int c) {
  return __fadd_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7650u | (c & 3))),
                   -kTwo23);
}

template <class Arith>
__device__ __forceinline__ void unpack_rows(const uint2 (&raw)[8], float (&x)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) x[r][c] = pixel<Arith>(c < 4 ? raw[r].x : raw[r].y, c);
}

// The vertical pass: t[g][c] = sum_r M[g][r] x[r][c] for the slot rows g < RN.
// Mat: `const float*` (a shared-memory copy of the matrix) or ConstDct.
template <int RN, class Mat>
__device__ __forceinline__ void vertical_rows(const float (&x)[8][8], Mat m,
                                              float (&t)[RN][8]) {
#pragma unroll
  for (int g = 0; g < RN; ++g)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) acc = fmaf(m[g * 8 + r], x[r][c], acc);
      t[g][c] = acc;
    }
}

// y[g][v] = sum_r sum_c M[g][r] x[r][c] M[v][c] for the slot rows g < RN.
template <int RN, class Mat>
__device__ __forceinline__ void forward_rows(const float (&x)[8][8], Mat m,
                                             float (&y)[RN][8]) {
  float t[RN][8];
  vertical_rows<RN>(x, m, t);
#pragma unroll
  for (int g = 0; g < RN; ++g)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc = fmaf(t[g][c], m[v * 8 + c], acc);
      y[g][v] = acc;
    }
}

// Floor-mod 2 of an integral float (jnp.mod / torch.remainder semantics,
// right for negative q too). Exact for |q| < 2^24.
__device__ __forceinline__ float parity(float q) {
  return q - 2.0f * floorf(q * 0.5f);
}

// The QIM bit of a coefficient: round(y / delta) mod 2, round half to even.
template <class Arith>
__device__ __forceinline__ uint32_t qim_bit(float y, float delta) {
  if constexpr (Arith::kAddRound)
    return __float_as_uint(__fadd_rn(__fdiv_rn(y, delta), kRoundShift)) & 1u;
  else
    return static_cast<uint32_t>(parity(rintf(y / delta)));
}

// Payload bit sources for embed_block: bit(j) is the block's payload bit j
// (flat coefficient j + 1), 0 or 1 (a wire byte is taken as it is).
struct WireBits {  // wire order: num_ac u8 bits per block
  const uint8_t* __restrict__ p;
  __device__ __forceinline__ uint32_t operator()(int j) const { return p[j]; }
};

template <int RN>
struct PackedBits {  // K2's packed bytes: bit s of byte g is coefficient 8g+s
  uint32_t byte[RN];
  __device__ __forceinline__ uint32_t operator()(int j) const {
    const int c = j + 1;
    return (byte[c >> 3] >> (c & 7)) & 1u;
  }
};

// K3's bits: the block's wire bytes loaded once into registers (bit j is
// slot j + 1; 0 past num_ac, every load in bounds), so that the count of
// wrong bits after the re-extract reads the registers the embed read.
template <int RN>
struct HeldBits {
  uint32_t v[8 * RN - 1];
  __device__ __forceinline__ void load(const uint8_t* __restrict__ p, int num_ac) {
#pragma unroll
    for (int j = 0; j < 8 * RN - 1; ++j) v[j] = j < num_ac ? p[j] : 0u;
  }
  __device__ __forceinline__ uint32_t operator()(int j) const { return v[j]; }
};

// The QIM embed of one block (_embed_core): the cover's 8 rows of u8 in
// raw become the stego's. bit gives the block's num_ac payload bits; rem
// is the number of payload bits left at the block's first slot. The
// caller passes through blocks with rem <= 0, and every block when
// delta <= 0, without calling this.
template <int RN, class Arith, class Mat, class Bits>
__device__ __forceinline__ void embed_block(uint2 (&raw)[8], Mat m, const Bits& bit,
                                            long long rem, int num_ac, float delta) {
  float x[8][8];
  unpack_rows<Arith>(raw, x);
  float y[RN][8];
  forward_rows<RN>(x, m, y);

  uint32_t first[8 * RN];  // kBitsFirst: bit c - 1 of slot c, 0 past num_ac
  if constexpr (Arith::kBitsFirst) {
#pragma unroll
    for (int c = 1; c < 8 * RN; ++c) first[c] = c <= num_ac ? bit(c - 1) : 0u;
  }
  const auto bit_of_slot = [&](int c) -> uint32_t {
    if constexpr (Arith::kBitsFirst) return first[c];
    else return bit(c - 1);
  };

  // directional-parity QIM + lattice snap, as a sparse coefficient delta
  float dy[RN][8];
#pragma unroll
  for (int g = 0; g < RN; ++g)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int c = g * 8 + v;
      float d = 0.0f;
      if (c >= 1 && c <= num_ac && c - 1 < rem) {
        float q, adj;
        if constexpr (Arith::kAddRound) {
          const float t = __fadd_rn(__fdiv_rn(y[g][v], delta), kRoundShift);
          q = __fsub_rn(t, kRoundShift);  // round half to even
          const uint32_t b = bit_of_slot(c);
          adj = (__float_as_uint(t) & 1u) != b ? (b == 1u ? 1.0f : -1.0f) : 0.0f;
        } else {
          const float b = static_cast<float>(bit_of_slot(c));
          q = rintf(y[g][v] / delta);  // round half to even
          adj = parity(q) != b ? (b == 1.0f ? 1.0f : -1.0f) : 0.0f;
        }
        d = __fsub_rn(__fmul_rn(q + adj, delta), y[g][v]);
      }
      dy[g][v] = d;
    }

  // pixel image of the sparse delta: d[r][c] = sum_g sum_v M[g][r] dy[g][v] M[v][c]
  float u[RN][8];
#pragma unroll
  for (int g = 0; g < RN; ++g)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < 8; ++v) acc = fmaf(dy[g][v], m[v * 8 + c], acc);
      u[g][c] = acc;
    }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint32_t out[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int g = 0; g < RN; ++g) acc = fmaf(m[g * 8 + r], u[g][c], acc);
      const float px =
          Arith::kRederive ? pixel_again(c < 4 ? raw[r].x : raw[r].y, c) : x[r][c];
      const float o = fminf(fmaxf(__fadd_rn(px, acc), 0.0f), 255.0f);
      if constexpr (Arith::kAddConvert)  // 2^23 + floor(o): the byte is the low one
        out[c] = __float_as_uint(__fadd_rz(o, kTwo23));
      else
        out[c] = static_cast<uint32_t>(static_cast<int>(o));  // truncating
    }
    if constexpr (Arith::kAddConvert) {  // byte 0 of each, four to a word
      raw[r] = make_uint2(
          __byte_perm(__byte_perm(out[0], out[1], 0x0040u), __byte_perm(out[2], out[3], 0x0040u),
                      0x5410u),
          __byte_perm(__byte_perm(out[4], out[5], 0x0040u), __byte_perm(out[6], out[7], 0x0040u),
                      0x5410u));
    } else {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (c < 4) lo |= out[c] << (8 * c);
        else hi |= out[c] << (8 * (c - 4));
      }
      raw[r] = make_uint2(lo, hi);
    }
  }
}

// The decode (_extract_bits_f32) of a block's pixels as floats: bit v of
// byte[g] is round(y[g][v]/delta) mod 2. delta <= 0 reads all-zero bits.
template <int RN, class Arith, class Mat>
__device__ __forceinline__ void slot_bits_of(const float (&x)[8][8], Mat m, float delta,
                                             uint32_t (&byte)[RN]) {
  float y[RN][8];
  forward_rows<RN>(x, m, y);
#pragma unroll
  for (int g = 0; g < RN; ++g) {
    byte[g] = 0;
    if (delta > 0.0f) {
#pragma unroll
      for (int v = 0; v < 8; ++v) byte[g] |= qim_bit<Arith>(y[g][v], delta) << v;
    }
  }
}

// slot_bits_of the block's u8 rows in raw, read exactly as they lie in
// memory (K3, K4 and K6 pass the quantized stego).
template <int RN, class Arith, class Mat>
__device__ __forceinline__ void slot_bits(const uint2 (&raw)[8], Mat m, float delta,
                                          uint32_t (&byte)[RN]) {
  float x[8][8];
  unpack_rows<Arith>(raw, x);
  slot_bits_of<RN, Arith>(x, m, delta, byte);
}

// Output row jg*rows_pad + i*RN + g of the compact-rows layout of frame f
// belongs to block row by = jg*stripe_blocks + i; returns the frame's
// first row of the block's stripe group (jg*rows_pad) and sets i.
__device__ __forceinline__ size_t group_row(int f, int by, int h,
                                            int stripe_blocks, int rows_pad,
                                            int& i) {
  const int jg = by / stripe_blocks;
  i = by - jg * stripe_blocks;
  const size_t frame_rows = static_cast<size_t>(h / 8 / stripe_blocks) * rows_pad;
  return static_cast<size_t>(f) * frame_rows + static_cast<size_t>(jg) * rows_pad;
}

// K2's layout: byte (row, bx) of (B, (H/stripe)*rows_pad, W/8); the last
// block row of a stripe zeroes the stripe's padding rows.
template <int RN>
__device__ __forceinline__ void write_packed(uint8_t* __restrict__ packed,
                                             const uint32_t (&byte)[RN], int f,
                                             int by, int bx, int h, int bw,
                                             int stripe_blocks, int rows_pad) {
  int i;
  uint8_t* group =
      packed + group_row(f, by, h, stripe_blocks, rows_pad, i) * bw + bx;
#pragma unroll
  for (int g = 0; g < RN; ++g)
    group[static_cast<size_t>(i * RN + g) * bw] = static_cast<uint8_t>(byte[g]);
  if (i == stripe_blocks - 1)
    for (int k = stripe_blocks * RN; k < rows_pad; ++k)
      group[static_cast<size_t>(k) * bw] = 0;
}

// K5's layout: lanes 8*bx .. 8*bx+7 of row jg*rows_pad + i*RN + g of
// (B, (H/stripe)*rows_pad, W) hold bits 0..7 of byte[g], one u8 each
// (K5, K6 and K9's row variants).
template <int RN>
__device__ __forceinline__ void write_rows(uint8_t* __restrict__ rows,
                                           const uint32_t (&byte)[RN], int f,
                                           int by, int bx, int h, int w,
                                           int stripe_blocks, int rows_pad) {
  int i;
  uint8_t* group = rows + group_row(f, by, h, stripe_blocks, rows_pad, i) * w +
                   static_cast<size_t>(bx) * 8;
#pragma unroll
  for (int g = 0; g < RN; ++g) {
    // spread bit s of the byte (< 256) to the low bit of byte lane s: a
    // nibble times 1 + 2^7 + 2^14 + 2^21 holds its bit s at bit s + 7k for
    // each k < 4; those 16 positions differ (no carry), and bit 8k is bit k
    // (tests/test_torch_exact_arith.py, every byte)
    const uint32_t lo = ((byte[g] & 0xFu) * 0x00204081u) & 0x01010101u;
    const uint32_t hi = ((byte[g] >> 4) * 0x00204081u) & 0x01010101u;
    *reinterpret_cast<uint2*>(group + static_cast<size_t>(i * RN + g) * w) =
        make_uint2(lo, hi);
  }
  if (i == stripe_blocks - 1)
    for (int k = stripe_blocks * RN; k < rows_pad; ++k)
      *reinterpret_cast<uint2*>(group + static_cast<size_t>(k) * w) =
          make_uint2(0u, 0u);
}

__device__ __forceinline__ void load_dct(float* m, const float* __restrict__ dct) {
  if (threadIdx.x < 64) m[threadIdx.x] = dct[threadIdx.x];
  __syncthreads();
}

// Byte offset of block (by, bx) of frame f in a (B, H, W) u8 tensor.
__device__ __forceinline__ size_t block_offset(int f, int by, int bx, int h, int w) {
  return (static_cast<size_t>(f) * h + static_cast<size_t>(by) * 8) * w +
         static_cast<size_t>(bx) * 8;
}

// A frame's payload bits, clamp(left, 0, cap), where left is the number of
// bits left at the frame's first slot: what each fused kernel writes to
// bpf[f], so that its wrapper needs no device op of its own.
__device__ __forceinline__ int frame_bits_clamp(long long left, long long cap) {
  return static_cast<int>(left < 0 ? 0 : (left < cap ? left : cap));
}

// Thread 0 of the frame's first CTA of a (column chunks, block rows,
// frames) grid writes bpf[f]; a persistent kernel (K13) picks its writer
// by the tile instead and calls frame_bits_clamp itself.
__device__ __forceinline__ void frame_bits(int* __restrict__ bpf, int f,
                                           long long left, long long cap) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    bpf[f] = frame_bits_clamp(left, cap);
}

// Select the device and clear a stale error of an earlier call.
cudaError_t begin(int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) (void)cudaGetLastError();
  return err;
}

// One thread per 8x8 block: (block columns / kThreads, block rows, frames).
dim3 grid_of(int b, int h, int w) {
  return dim3((w / 8 + kThreads - 1) / kThreads, h / 8, b);
}

}  // namespace

#define STEGOTPU_RN_SWITCH(rn, LAUNCH) \
  switch (rn) {                        \
    case 1: LAUNCH(1); break;          \
    case 2: LAUNCH(2); break;          \
    case 3: LAUNCH(3); break;          \
    case 4: LAUNCH(4); break;          \
    case 5: LAUNCH(5); break;          \
    case 6: LAUNCH(6); break;          \
    case 7: LAUNCH(7); break;          \
    case 8: LAUNCH(8); break;          \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

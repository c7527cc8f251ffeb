// QIM/DCT stripe kernels for Hopper (sm_90a), with a plain C interface
// bound by ctypes (stegotpu_torch/ops/_build.py, ops/stripe_kernel.py).
//
// K1 qim_embed_kernel replaces the TPU kernel _embed_kernel
//    (stegotpu/ops/pallas_kernel.py:529, body _embed_core :501).
// K2 qim_extract_packed_kernel replaces _extract_kernel_packed
//    (stegotpu/ops/pallas_kernel.py:577).
// K3 qim_embed_check_kernel replaces _embed_check_kernel (:906): K1, then
//    a re-extract of the quantized stego still in registers and a count of
//    the valid slots that read back wrong, one int32 per frame.
// K4 qim_roundtrip_packed_kernel replaces _roundtrip_kernel_packed (:804):
//    K1, then K2 on the quantized stego still in registers.
// K5 qim_extract_rows_kernel replaces _extract_kernel (:545): K2 with one
//    u8 per lane instead of one bit.
// K6 qim_roundtrip_rows_kernel replaces _roundtrip_kernel (:785): K1, then
//    K5 on the quantized stego still in registers.
//
// Design. One thread owns one 8x8 block: it loads the block as 8 rows of
// 8 bytes (neighbouring threads hold neighbouring blocks of a block row,
// so each row load of a warp is 256 contiguous bytes), computes only the
// rn = num_ac/8 + 1 coefficient rows that hold payload slots with a
// separable DCT in FP32 FMAs, and writes its result. The grid is
// (block columns / 128, block rows, frames). The TPU kernel's stripe
// grid, lane padding and compact payload rows were Mosaic tiling devices
// and are gone: the payload is read in wire order (block n, slot j at
// n*num_ac + j) and any width W % 8 == 0 works.
//
// All six kernels share one embed (embed_block) and one decode
// (slot_bits), as the TPU kernels share _embed_core and _extract_bits_f32:
// the exactness harness (ops/exactness.py) holds K3's and K4's stego
// byte-identical to K1's, K4's bits and K3's count to K2 on their stego,
// and K5 to K2, with zero tolerance; K6's stego is K1's and its rows are
// K5's reading of that stego (chip_smoke.py phase 10, tests/
// test_torch_cuda.py). Every rounding in that arithmetic is
// explicit (fmaf, __fmul_rn, __fsub_rn), so nvcc's default FMA
// contraction cannot round one inlined copy differently from another.
//
// Bound on the H100: memory traffic, about 2 B of u8 pixels per pixel
// (read + write; extract writes rn/64 B, K5 rn/8 B) plus num_ac/64 B of
// payload per pixel for embed, against 2*rn FP32 FMAs per pixel for the
// forward transform and as many again for the inverse (8 per pixel for
// embed at the default num_ac=10; K3, K4 and K6 add a second forward) — far
// under the FP32 rate for the bytes they move. No tensor cores are used,
// so no TF32 can enter: the wire contract is IEEE f32 (scipy's DCT in the
// reference). Build WITHOUT --use_fast_math: fast math turns y/delta into
// an approximate divide and flushes denormals, which moves round(y/delta)
// at the rounding boundary.

#include <cstdint>
#include <cuda_runtime.h>

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

__device__ __forceinline__ void unpack_rows(const uint2 (&raw)[8], float (&x)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t word = c < 4 ? raw[r].x : raw[r].y;
      x[r][c] = static_cast<float>((word >> (8 * (c & 3))) & 0xFFu);
    }
}

// y[g][v] = sum_r sum_c M[g][r] x[r][c] M[v][c] for the slot rows g < RN.
template <int RN>
__device__ __forceinline__ void forward_rows(const float (&x)[8][8], const float* m,
                                             float (&y)[RN][8]) {
  float t[RN][8];
#pragma unroll
  for (int g = 0; g < RN; ++g)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) acc = fmaf(m[g * 8 + r], x[r][c], acc);
      t[g][c] = acc;
    }
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

// The QIM embed of one block (_embed_core): the cover's 8 rows of u8 in
// raw become the stego's. bits points at the block's num_ac payload bits;
// rem is the number of payload bits left at the block's first slot. The
// caller passes through blocks with rem <= 0, and every block when
// delta <= 0, without calling this.
template <int RN>
__device__ __forceinline__ void embed_block(uint2 (&raw)[8], const float* m,
                                            const uint8_t* __restrict__ bits,
                                            long long rem, int num_ac,
                                            float delta) {
  float x[8][8];
  unpack_rows(raw, x);
  float y[RN][8];
  forward_rows<RN>(x, m, y);

  // directional-parity QIM + lattice snap, as a sparse coefficient delta
  float dy[RN][8];
#pragma unroll
  for (int g = 0; g < RN; ++g)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int c = g * 8 + v;
      float d = 0.0f;
      if (c >= 1 && c <= num_ac && c - 1 < rem) {
        const float b = static_cast<float>(bits[c - 1]);
        const float q = rintf(y[g][v] / delta);  // round half to even
        const float adj = parity(q) != b ? (b == 1.0f ? 1.0f : -1.0f) : 0.0f;
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
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int g = 0; g < RN; ++g) acc = fmaf(m[g * 8 + r], u[g][c], acc);
      const float o = fminf(fmaxf(__fadd_rn(x[r][c], acc), 0.0f), 255.0f);
      const uint32_t byte = static_cast<uint32_t>(static_cast<int>(o));  // truncating
      if (c < 4) lo |= byte << (8 * c);
      else hi |= byte << (8 * (c - 4));
    }
    raw[r] = make_uint2(lo, hi);
  }
}

// The decode (_extract_bits_f32): bit v of byte[g] is round(y[g][v]/delta)
// mod 2 of the block's u8 rows in raw, read exactly as they lie in memory
// (K3 and K4 pass the quantized stego). delta <= 0 reads all-zero bits.
template <int RN>
__device__ __forceinline__ void slot_bits(const uint2 (&raw)[8], const float* m,
                                          float delta, uint32_t (&byte)[RN]) {
  float x[8][8];
  unpack_rows(raw, x);
  float y[RN][8];
  forward_rows<RN>(x, m, y);
#pragma unroll
  for (int g = 0; g < RN; ++g) {
    byte[g] = 0;
    if (delta > 0.0f) {
#pragma unroll
      for (int v = 0; v < 8; ++v)
        byte[g] |= static_cast<uint32_t>(parity(rintf(y[g][v] / delta))) << v;
    }
  }
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
// (B, (H/stripe)*rows_pad, W) hold bits 0..7 of byte[g], one u8 each.
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
    // spread bit s of the byte to the low bit of byte lane s
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      lo |= ((byte[g] >> s) & 1u) << (8 * s);
      hi |= ((byte[g] >> (s + 4)) & 1u) << (8 * s);
    }
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

template <int RN>
__global__ void __launch_bounds__(kThreads)
qim_embed_kernel(const uint8_t* __restrict__ frames,
                 const uint8_t* __restrict__ payload,
                 uint8_t* __restrict__ stego, const float* __restrict__ dct,
                 int h, int w, int num_ac, long long cap, long long total_bits,
                 long long bit_offset, float delta) {
  __shared__ float m[64];
  load_dct(m, dct);

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  const int by = blockIdx.y;
  const int f = blockIdx.z;
  const long long blk = static_cast<long long>(by) * bw + bx;
  // payload bits left at this block's first slot (global bit indices)
  const long long rem = total_bits - bit_offset - f * cap - blk * num_ac;
  const size_t off = block_offset(f, by, bx, h, w);

  uint2 raw[8];
  load_rows(frames + off, w, raw);
  if (rem > 0 && delta > 0.0f)  // else never entered, or delta <= 0: passthrough
    embed_block<RN>(raw, m, payload + f * cap + blk * num_ac, rem, num_ac, delta);
  store_rows(stego + off, w, raw);
}

template <int RN>
__global__ void __launch_bounds__(kThreads)
qim_extract_packed_kernel(const uint8_t* __restrict__ frames,
                          uint8_t* __restrict__ packed,
                          const float* __restrict__ dct, int h, int w,
                          int stripe_blocks, int rows_pad, float delta) {
  __shared__ float m[64];
  load_dct(m, dct);

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  const int by = blockIdx.y;
  const int f = blockIdx.z;

  uint2 raw[8];
  load_rows(frames + block_offset(f, by, bx, h, w), w, raw);
  uint32_t byte[RN];
  slot_bits<RN>(raw, m, delta, byte);
  write_packed<RN>(packed, byte, f, by, bx, h, bw, stripe_blocks, rows_pad);
}

template <int RN>
__global__ void __launch_bounds__(kThreads)
qim_extract_rows_kernel(const uint8_t* __restrict__ frames,
                        uint8_t* __restrict__ rows,
                        const float* __restrict__ dct, int h, int w,
                        int stripe_blocks, int rows_pad, float delta) {
  __shared__ float m[64];
  load_dct(m, dct);

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  const int by = blockIdx.y;
  const int f = blockIdx.z;

  uint2 raw[8];
  load_rows(frames + block_offset(f, by, bx, h, w), w, raw);
  uint32_t byte[RN];
  slot_bits<RN>(raw, m, delta, byte);
  write_rows<RN>(rows, byte, f, by, bx, h, w, stripe_blocks, rows_pad);
}

template <int RN>
__global__ void __launch_bounds__(kThreads)
qim_roundtrip_packed_kernel(const uint8_t* __restrict__ frames,
                            const uint8_t* __restrict__ payload,
                            uint8_t* __restrict__ stego,
                            uint8_t* __restrict__ packed,
                            const float* __restrict__ dct, int h, int w,
                            int num_ac, long long cap, long long total_bits,
                            int stripe_blocks, int rows_pad, float delta) {
  __shared__ float m[64];
  load_dct(m, dct);

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  const int by = blockIdx.y;
  const int f = blockIdx.z;
  const long long blk = static_cast<long long>(by) * bw + bx;
  const long long rem = total_bits - f * cap - blk * num_ac;  // no bit offset
  const size_t off = block_offset(f, by, bx, h, w);

  uint2 raw[8];
  load_rows(frames + off, w, raw);
  if (rem > 0 && delta > 0.0f)
    embed_block<RN>(raw, m, payload + f * cap + blk * num_ac, rem, num_ac, delta);
  store_rows(stego + off, w, raw);
  // re-extract from the quantized stego, still in registers
  uint32_t byte[RN];
  slot_bits<RN>(raw, m, delta, byte);
  write_packed<RN>(packed, byte, f, by, bx, h, bw, stripe_blocks, rows_pad);
}

template <int RN>
__global__ void __launch_bounds__(kThreads)
qim_roundtrip_rows_kernel(const uint8_t* __restrict__ frames,
                          const uint8_t* __restrict__ payload,
                          uint8_t* __restrict__ stego,
                          uint8_t* __restrict__ rows,
                          const float* __restrict__ dct, int h, int w,
                          int num_ac, long long cap, long long total_bits,
                          int stripe_blocks, int rows_pad, float delta) {
  __shared__ float m[64];
  load_dct(m, dct);

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  const int by = blockIdx.y;
  const int f = blockIdx.z;
  const long long blk = static_cast<long long>(by) * bw + bx;
  const long long rem = total_bits - f * cap - blk * num_ac;  // no bit offset
  const size_t off = block_offset(f, by, bx, h, w);

  uint2 raw[8];
  load_rows(frames + off, w, raw);
  if (rem > 0 && delta > 0.0f)
    embed_block<RN>(raw, m, payload + f * cap + blk * num_ac, rem, num_ac, delta);
  store_rows(stego + off, w, raw);
  // re-extract from the quantized stego, still in registers
  uint32_t byte[RN];
  slot_bits<RN>(raw, m, delta, byte);
  write_rows<RN>(rows, byte, f, by, bx, h, w, stripe_blocks, rows_pad);
}

// errors: (B,) int32, zeroed by the caller on the launch stream. Blocks of
// the GPU grid run in no order, so there is no sequential axis to carry a
// sum along (the TPU kernel's stripe axis): each warp sums its threads'
// counts and adds them to its frame's slot with one atomic. Integer sums
// are exact, so the count does not depend on the order of the atomics.
template <int RN>
__global__ void __launch_bounds__(kThreads)
qim_embed_check_kernel(const uint8_t* __restrict__ frames,
                       const uint8_t* __restrict__ payload,
                       uint8_t* __restrict__ stego, int* __restrict__ errors,
                       const float* __restrict__ dct, int h, int w, int num_ac,
                       long long cap, long long total_bits, float delta) {
  __shared__ float m[64];
  load_dct(m, dct);

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  const int by = blockIdx.y;
  const int f = blockIdx.z;
  int count = 0;
  if (bx < bw) {  // no early return: the whole warp takes part in the sum
    const long long blk = static_cast<long long>(by) * bw + bx;
    const long long rem = total_bits - f * cap - blk * num_ac;  // no bit offset
    const size_t off = block_offset(f, by, bx, h, w);
    const uint8_t* bits = payload + f * cap + blk * num_ac;

    uint2 raw[8];
    load_rows(frames + off, w, raw);
    if (rem > 0 && delta > 0.0f) embed_block<RN>(raw, m, bits, rem, num_ac, delta);
    store_rows(stego + off, w, raw);
    if (rem > 0) {  // blocks never entered hold no valid slot
      // re-extract from the quantized stego, still in registers; with
      // delta <= 0 every valid slot reads 0
      uint32_t byte[RN];
      slot_bits<RN>(raw, m, delta, byte);
#pragma unroll
      for (int g = 0; g < RN; ++g)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int c = g * 8 + v;
          if (c >= 1 && c <= num_ac && c - 1 < rem)
            count += ((byte[g] >> v) & 1u) != bits[c - 1];
        }
    }
  }
  count = __reduce_add_sync(0xFFFFFFFFu, count);
  if ((threadIdx.x & 31) == 0 && count != 0) atomicAdd(errors + f, count);
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

namespace {

// Select the device and clear a stale error of an earlier call.
cudaError_t begin(int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) (void)cudaGetLastError();
  return err;
}

dim3 grid_of(int b, int h, int w) {
  return dim3((w / 8 + kThreads - 1) / kThreads, h / 8, b);
}

}  // namespace

extern "C" {

// frames, stego: (B, H, W) u8; payload: (B, cap) u8, cap = (H/8)(W/8)num_ac;
// dct: the 8x8 DCT-II matrix, 64 f32 on the device. Each entry point
// returns a cudaError_t.
int stegotpu_qim_embed(const void* frames, const void* payload, void* stego,
                       const void* dct, int device, int b, int h, int w,
                       int num_ac, long long total_bits, long long bit_offset,
                       float delta, void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STEGOTPU_EMBED(RN)                                                  \
  qim_embed_kernel<RN><<<grid_of(b, h, w), kThreads, 0, s>>>(               \
      static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload), \
      static_cast<uint8_t*>(stego), static_cast<const float*>(dct), h, w,   \
      num_ac, cap, total_bits, bit_offset, delta)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_EMBED)
#undef STEGOTPU_EMBED
  return static_cast<int>(cudaGetLastError());
}

// frames: (B, H, W) u8; packed: (B, (H/stripe)*rows_pad, W/8) u8.
int stegotpu_qim_extract_packed(const void* frames, void* packed, const void* dct,
                                int device, int b, int h, int w, int num_ac,
                                int stripe, int rows_pad, float delta,
                                void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STEGOTPU_EXTRACT(RN)                                                \
  qim_extract_packed_kernel<RN><<<grid_of(b, h, w), kThreads, 0, s>>>(      \
      static_cast<const uint8_t*>(frames), static_cast<uint8_t*>(packed),   \
      static_cast<const float*>(dct), h, w, stripe / 8, rows_pad, delta)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_EXTRACT)
#undef STEGOTPU_EXTRACT
  return static_cast<int>(cudaGetLastError());
}

// frames: (B, H, W) u8; rows: (B, (H/stripe)*rows_pad, W) u8.
int stegotpu_qim_extract_rows(const void* frames, void* rows, const void* dct,
                              int device, int b, int h, int w, int num_ac,
                              int stripe, int rows_pad, float delta,
                              void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STEGOTPU_ROWS(RN)                                                   \
  qim_extract_rows_kernel<RN><<<grid_of(b, h, w), kThreads, 0, s>>>(        \
      static_cast<const uint8_t*>(frames), static_cast<uint8_t*>(rows),     \
      static_cast<const float*>(dct), h, w, stripe / 8, rows_pad, delta)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_ROWS)
#undef STEGOTPU_ROWS
  return static_cast<int>(cudaGetLastError());
}

// frames, stego: (B, H, W) u8; payload: (B, cap) u8; packed as for
// stegotpu_qim_extract_packed. Global bit 0 is the payload's first bit.
int stegotpu_qim_roundtrip_packed(const void* frames, const void* payload,
                                  void* stego, void* packed, const void* dct,
                                  int device, int b, int h, int w, int num_ac,
                                  long long total_bits, int stripe,
                                  int rows_pad, float delta, void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STEGOTPU_ROUNDTRIP(RN)                                              \
  qim_roundtrip_packed_kernel<RN><<<grid_of(b, h, w), kThreads, 0, s>>>(    \
      static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload), \
      static_cast<uint8_t*>(stego), static_cast<uint8_t*>(packed),          \
      static_cast<const float*>(dct), h, w, num_ac, cap, total_bits,        \
      stripe / 8, rows_pad, delta)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_ROUNDTRIP)
#undef STEGOTPU_ROUNDTRIP
  return static_cast<int>(cudaGetLastError());
}

// frames, stego: (B, H, W) u8; payload: (B, cap) u8; rows as for
// stegotpu_qim_extract_rows. Global bit 0 is the payload's first bit.
int stegotpu_qim_roundtrip_rows(const void* frames, const void* payload,
                                void* stego, void* rows, const void* dct,
                                int device, int b, int h, int w, int num_ac,
                                long long total_bits, int stripe, int rows_pad,
                                float delta, void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STEGOTPU_ROUNDTRIP_ROWS(RN)                                         \
  qim_roundtrip_rows_kernel<RN><<<grid_of(b, h, w), kThreads, 0, s>>>(      \
      static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload), \
      static_cast<uint8_t*>(stego), static_cast<uint8_t*>(rows),            \
      static_cast<const float*>(dct), h, w, num_ac, cap, total_bits,        \
      stripe / 8, rows_pad, delta)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_ROUNDTRIP_ROWS)
#undef STEGOTPU_ROUNDTRIP_ROWS
  return static_cast<int>(cudaGetLastError());
}

// frames, stego: (B, H, W) u8; payload: (B, cap) u8; errors: (B,) int32,
// zeroed by the caller on `stream`. Global bit 0 is the payload's first bit.
int stegotpu_qim_embed_check(const void* frames, const void* payload,
                             void* stego, void* errors, const void* dct,
                             int device, int b, int h, int w, int num_ac,
                             long long total_bits, float delta, void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STEGOTPU_CHECK(RN)                                                  \
  qim_embed_check_kernel<RN><<<grid_of(b, h, w), kThreads, 0, s>>>(         \
      static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload), \
      static_cast<uint8_t*>(stego), static_cast<int*>(errors),              \
      static_cast<const float*>(dct), h, w, num_ac, cap, total_bits, delta)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_CHECK)
#undef STEGOTPU_CHECK
  return static_cast<int>(cudaGetLastError());
}

const char* stegotpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Dense Kronecker-DCT QIM kernels for Hopper (sm_90a), with a plain C
// interface bound by ctypes (stegotpu_torch/ops/_build.py,
// ops/experimental/kron_kernel.py).
//
// K7 kron_embed_kernel replaces the TPU kernel _embed_kernel
//    (stegotpu/ops/experimental/pallas_kron.py:58): y = xb K64^T over all
//    64 coefficients of each 8x8 block, directional-parity QIM on the slots
//    whose state is < 2, the FULL inverse x' = y_new K64 (not the stripe
//    kernels' sparse delta), blocks never entered passed through exactly,
//    clip, then a truncating u8 cast.
// K8 kron_extract_kernel replaces _extract_kernel (pallas_kron.py:80):
//    round(y / delta) mod 2 on AC slots 1..num_ac, written in wire order
//    (B, nb*num_ac). The TPU kernel wrote all 64 lanes (B, nb, 64) and
//    sliced them afterwards; that was a tiling device.
//
// The TPU kernels read a (B, nb, 64) u8 state plane (qim_fast.
// build_plane_blocks: 0/1 payload bit, 2 slot without payload in an
// entered block, 3 block never entered). K7 derives each slot's state
// itself, in int64: block g of the flattened (frame, block) index holds
// the global bits bit_offset + g*num_ac + j, and reads the payload in wire
// order (g*num_ac + j) as the stripe kernels do; the plane is never
// materialized. A payload byte other than 0/1 is state >= 2 there and is
// not embedded here either.
//
// Bound on the H100. K7 computes the dense form: 2 x 64 x 64 FMAs a block,
// 4.25 GFLOP a 1080p batch of 8 (63.38 us at the f32 peak of 67 TFLOP/s),
// four times the separable transform's count (15.85 us), against 2 B of u8
// traffic a pixel: the FP32 FMA rate bounds it. K8 computes 64 x num_ac
// FMAs a block (0.33 GFLOP, 5.0 us) against 1 B read a pixel (4.9 us).
//
// Design. Both kernels run a persistent grid: the SMs times the CTAs of
// 256 threads that fit on one. Each CTA copies the matrix rows it needs
// into shared memory once (K7: K64 and K64^T, 32 KB; K8: rows 1..num_ac of
// K64, 2.5 KB at num_ac = 10) and then walks the blocks.
//  - K7 takes tiles of kTile = 256 consecutive blocks. A tile is a product
//    of a 256 x 64 matrix with a 64 x 64 one: its pixels go into shared
//    memory as f32, transposed to [pixel][column] (rows padded to kLdx
//    words), and each thread computes an 8 x 8 register micro-tile of
//    Y = X K64^T, 8 blocks by 8 coefficients, from two LDS.128 of pixels
//    and two of a K64^T row per 64 FFMAs. Y goes back over X, the QIM runs
//    one thread a block on its slots there, and the same micro-kernel
//    computes X' = Y_new K64; each thread clips and packs its 8 blocks' two
//    4-pixel runs into 4-byte stores, a warp's four stores at once falling
//    on four neighbouring blocks. Five barriers a tile of 256 blocks. K7
//    writes the bits per frame too, so a call is this one kernel.
//  - K8 has one thread a block, on tiles of 256 blocks: its 64 pixels in
//    registers (the next tile's rows loaded while this one computes),
//    num_ac dot products against broadcast LDS.128 of the K64 rows, two
//    chains side by side (a chain of 64 FMAs waits on each one), the
//    bits staged in shared memory and written as the tile's one run of
//    wire-order bytes, 16-byte stores. No thread waits on an unused
//    coefficient.
// Every output keeps the fmaf chain of the kernels' first version (forward:
// c ascending from 0.0f; inverse: r ascending from 0.0f) and the same QIM,
// so K7 and K8 give its bytes exactly; qim_kron_smem.cu keeps that version
// as their witness. No tensor cores are used, so no TF32 can enter (the
// f32 wire contract); the build has no --use_fast_math (y / delta must be
// an IEEE divide). u8 -> f32 and the truncating f32 -> u8 take
// ArithHopper's exact FADD/PRMT spelling (qim_common.cuh).

#include "qim_common.cuh"

namespace {

constexpr int kKronThreads = 256;  // threads of a CTA, both kernels
constexpr int kTile = 256;         // K7: blocks of a tile
constexpr int kLdx = kTile + 4;    // K7: padded row of the tile in shared memory
constexpr int kEmbedSmem = (2 * 64 * 64 + 64 * kLdx) * static_cast<int>(sizeof(float));

// Byte offset of block g of the flattened (frame, block) index.
__device__ __forceinline__ size_t offset_of(int g, int nb, int bw, int h, int w) {
  const int f = g / nb, blk = g - f * nb, by = blk / bw;
  return block_offset(f, by, blk - by * bw, h, w);
}

// The tile column of the tile's block b: blocks 16q + 4i + r sit at
// column 16q + 4r + i. The map swaps two 2-bit fields, so it is its own
// inverse: column_of(c) is the block at column c.
__device__ __forceinline__ int column_of(int b) {
  return (b & ~15) | ((b & 3) << 2) | ((b >> 2) & 3);
}

// The micro-kernel: acc[m][n] = sum_k a[k][col m] b[k][n], k ascending from
// 0.0f by one fmaf chain each. Thread (ty, tx) = (t / 8, t % 8) takes the
// columns ty*4 + i and 128 + ty*4 + i of a (m = i, 4 + i) and the columns
// tx*4 + j and 32 + tx*4 + j of b (n = j, 4 + j).
__device__ __forceinline__ void micro_gemm(const float* __restrict__ a,
                                           const float* __restrict__ b, int ty, int tx,
                                           float (&acc)[8][8]) {
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * kLdx + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * kLdx + 128 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * 64 + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(b + k * 64 + 32 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
  }
}

// Four clamped pixels as their truncated bytes, packed into a word.
__device__ __forceinline__ uint32_t pack4(float o0, float o1, float o2, float o3) {
  const auto byte = [](float o) {  // 2^23 + floor(o): the byte is the low one
    return __float_as_uint(__fadd_rz(fminf(fmaxf(o, 0.0f), 255.0f), kTwo23));
  };
  return __byte_perm(__byte_perm(byte(o0), byte(o1), 0x0040u),
                     __byte_perm(byte(o2), byte(o3), 0x0040u), 0x5410u);
}

// left: payload bits at and after block 0's first slot (total_bits -
// bit_offset); blocks: B * nb; bpf[f]: frame f's payload bits, clamp(left -
// f*cap, 0, cap).
__global__ void __launch_bounds__(kKronThreads, 2)
kron_embed_kernel(const uint8_t* __restrict__ frames, const uint8_t* __restrict__ payload,
                  uint8_t* __restrict__ stego, int* __restrict__ bpf,
                  const float* __restrict__ kron, int h, int w, int num_ac, int blocks,
                  long long left, float delta) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // ks[r*64 + p] = K[r][p]
  float* kt = ks + 64 * 64;                     // kt[c*64 + e] = K[e][c]
  float* xs = kt + 64 * 64;                     // the tile: [pixel or coefficient][column]
  for (int i = threadIdx.x; i < 64 * 64; i += kKronThreads) {
    const float v = kron[i];
    ks[i] = v;
    kt[(i & 63) * 64 + (i >> 6)] = v;
  }  // the first tile's barrier orders these stores before any read

  const int t = threadIdx.x, tx = t & 7, ty = t >> 3;
  const int bw = w / 8, nb = (h / 8) * bw;
  const long long cap = static_cast<long long>(nb) * num_ac;
  for (int f = blockIdx.x * kKronThreads + t; f < blocks / nb;
       f += gridDim.x * kKronThreads) {
    const long long bits = left - f * cap;
    bpf[f] = static_cast<int>(bits < 0 ? 0 : (bits < cap ? bits : cap));
  }
  float* mine = xs + column_of(t);  // block t of the tile: load and QIM
  const int tiles = (blocks + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g0 = tile * kTile;
    const int g = g0 + t;
    const size_t at = g < blocks ? offset_of(g, nb, bw, h, w) : 0;
    uint2 raw[8];
    if (g < blocks) load_rows(frames + at, w, raw);
    if (left - static_cast<long long>(g0) * num_ac <= 0) {  // no block entered
      if (g < blocks) store_rows(stego + at, w, raw);
      continue;  // uniform across the CTA
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        mine[(r * 8 + c) * kLdx] =
            g < blocks ? pixel<ArithHopper>(c < 4 ? raw[r].x : raw[r].y, c) : 0.0f;
    __syncthreads();

    float acc[8][8];
    micro_gemm(xs, kt, ty, tx, acc);  // Y = X K64^T
    __syncthreads();                  // every thread has read X
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float* row = xs + ((n & 4) * 8 + tx * 4 + (n & 3)) * kLdx + ty * 4;
      *reinterpret_cast<float4*>(row) = make_float4(acc[0][n], acc[1][n], acc[2][n], acc[3][n]);
      *reinterpret_cast<float4*>(row + 128) =
          make_float4(acc[4][n], acc[5][n], acc[6][n], acc[7][n]);
    }
    __syncthreads();

    // the QIM of block t: its slots j < rem, coefficient j + 1
    const long long rem = left - static_cast<long long>(g) * num_ac;
    if (g < blocks && rem > 0) {
      const uint8_t* bits = payload + static_cast<long long>(g) * num_ac;
      for (int j = 0; j < num_ac && j < rem; ++j) {
        const uint8_t bit = bits[j];
        if (bit < 2) {  // the plane's state 0/1; any other byte is state >= 2
          float* y = mine + (j + 1) * kLdx;
          const float b = static_cast<float>(bit);
          const float q = rintf(*y / delta);  // round half to even
          const float adj = parity(q) != b ? (b == 1.0f ? 1.0f : -1.0f) : 0.0f;
          *y = __fmul_rn(q + adj, delta);
        }
      }
    }
    __syncthreads();

    micro_gemm(xs, ks, ty, tx, acc);  // X' = Y_new K64
    // pixels p = tx*4 + j (row tx/2) and 32 + tx*4 + j (row 4 + tx/2), at
    // column (tx % 2) * 4 + j of their block rows
    const size_t px = static_cast<size_t>(tx >> 1) * w + (tx & 1) * 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // the thread's four blocks of this half: 16q + 4i + r, i = 0..3, all in
      // one block row (16 divides W/8)
      const int first = g0 + half * 128 + (ty & ~3) * 4 + (ty & 3);
      if (first >= blocks) continue;
      const size_t base = offset_of(first, nb, bw, h, w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = first + 4 * i;
        if (gi >= blocks) break;
        const size_t o = base + static_cast<size_t>(4 * i) * 8 + px;
        const float* v = acc[half * 4 + i];
        const bool entered = left - static_cast<long long>(gi) * num_ac > 0;
        const uint32_t lo = entered ? pack4(v[0], v[1], v[2], v[3])
                                    : *reinterpret_cast<const uint32_t*>(frames + o);
        const uint32_t hi =
            entered ? pack4(v[4], v[5], v[6], v[7])
                    : *reinterpret_cast<const uint32_t*>(frames + o + 4 * static_cast<size_t>(w));
        *reinterpret_cast<uint32_t*>(stego + o) = lo;
        *reinterpret_cast<uint32_t*>(stego + o + 4 * static_cast<size_t>(w)) = hi;
      }
    }
    __syncthreads();  // the tile is read before the next one is written
  }
}

// The bits of N slot rows of a block whose 64 pixels are x, from the rows
// k[0..N) (64 floats apart): N fmaf chains side by side, each c ascending
// from 0.0f, so that the card overlaps their latencies.
template <int N>
__device__ __forceinline__ void slot_rows(const float* k, const float (&x)[64], float delta,
                                          uint8_t* out) {
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int c = 0; c < 64; c += 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 kv = *reinterpret_cast<const float4*>(k + i * 64 + c);
      acc[i] = fmaf(kv.x, x[c], acc[i]);
      acc[i] = fmaf(kv.y, x[c + 1], acc[i]);
      acc[i] = fmaf(kv.z, x[c + 2], acc[i]);
      acc[i] = fmaf(kv.w, x[c + 3], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = static_cast<uint8_t>(parity(rintf(acc[i] / delta)));
}

// One thread a block of a tile of kKronThreads blocks: bits[g*num_ac + j]
// = round(y[1 + j] / delta) mod 2, staged in shared memory and written as
// the tile's one run of wire-order bytes, 16 a store.
__global__ void __launch_bounds__(kKronThreads, 2)
kron_extract_kernel(const uint8_t* __restrict__ frames, uint8_t* __restrict__ bits,
                    const float* __restrict__ kron, int h, int w, int num_ac, int blocks,
                    float delta) {
  extern __shared__ float4 smem4[];
  float* kr = reinterpret_cast<float*>(smem4);  // kr[j*64 + c] = K[1 + j][c]
  uint8_t* staged = reinterpret_cast<uint8_t*>(kr + num_ac * 64);  // the tile's bits
  for (int i = threadIdx.x; i < num_ac * 64; i += kKronThreads) kr[i] = kron[64 + i];
  __syncthreads();

  const int t = threadIdx.x;
  const int bw = w / 8, nb = (h / 8) * bw;
  const int tiles = (blocks + kKronThreads - 1) / kKronThreads;
  int tile = blockIdx.x;
  uint2 raw[8];
  if (tile < tiles && tile * kKronThreads + t < blocks)
    load_rows(frames + offset_of(tile * kKronThreads + t, nb, bw, h, w), w, raw);
  for (; tile < tiles; tile += gridDim.x) {
    const int g0 = tile * kKronThreads, g = g0 + t;
    if (g < blocks) {
      float x[64];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          x[r * 8 + c] = pixel<ArithHopper>(c < 4 ? raw[r].x : raw[r].y, c);
      const int next = g + gridDim.x * kKronThreads;  // the next tile's block, loaded
      if (next < blocks)                              // while this one computes
        load_rows(frames + offset_of(next, nb, bw, h, w), w, raw);
      uint8_t* own = staged + t * num_ac;
      int j = 0;
      for (; j + 2 <= num_ac; j += 2) slot_rows<2>(kr + j * 64, x, delta, own + j);
      if (j < num_ac) slot_rows<1>(kr + j * 64, x, delta, own + j);
    }
    __syncthreads();
    // the tile's bytes: 16 a store from 16-byte aligned g0*num_ac (a
    // multiple of 256), then the tail of the last tile one by one
    const int n = min(blocks - g0, kKronThreads) * num_ac;
    uint8_t* out = bits + static_cast<long long>(g0) * num_ac;
    for (int i = t; i < n / 16; i += kKronThreads)
      reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<const uint4*>(staged)[i];
    for (int i = (n & ~15) + t; i < n; i += kKronThreads) out[i] = staged[i];
    __syncthreads();  // the bytes are read before the next tile stages its own
  }
}

// Shapes the kernels take: W a multiple of 128 (the TPU kernel's domain;
// K7's four neighbouring blocks of a warp store lie in one block row),
// B*nb blocks at most 2^30 (the block indices, a tile and a grid stride
// beyond the last, stay ints), 1 <= num_ac <= 63, delta > 0.
bool shape_ok(int b, int h, int w, int num_ac, float delta) {
  return b > 0 && h > 0 && h % 8 == 0 && w > 0 && w % 128 == 0 && num_ac >= 1 &&
         num_ac <= 63 && delta > 0.0f &&
         static_cast<long long>(b) * (h / 8) * (w / 8) <= (1LL << 30);
}

// The persistent grid of `kernel` for `units` units of work (K7's tiles,
// K8's CTA loads of blocks): the SMs times the CTAs of kKronThreads that
// fit on one with `smem` bytes of dynamic shared memory, at most `units`.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, int device, int smem, long long units,
                            unsigned& grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kKronThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = static_cast<long long>(sms) * per_sm;
  grid = static_cast<unsigned>(units < resident ? units : resident);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// frames, stego: (B, H, W) u8; payload: (B, cap) u8 in wire order, cap =
// (H/8)(W/8)num_ac; bpf: (B,) int32, each frame's payload bits; kron: K64 =
// M (x) M, 64x64 f32 row-major on the device. Frame i holds global bits
// [bit_offset + i*cap, ...). Returns a cudaError_t.
int stegotpu_kron_embed(const void* frames, const void* payload, void* stego,
                        void* bpf, const void* kron, int device, int b, int h,
                        int w, int num_ac, long long total_bits,
                        long long bit_offset, float delta, void* stream) {
  if (!shape_ok(b, h, w, num_ac, delta)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = b * (h / 8) * (w / 8);
  unsigned grid = 0;
  err = persistent_grid(kron_embed_kernel, device, kEmbedSmem,
                        (blocks + kTile - 1) / kTile, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kron_embed_kernel<<<grid, kKronThreads, kEmbedSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload),
      static_cast<uint8_t*>(stego), static_cast<int*>(bpf),
      static_cast<const float*>(kron), h, w, num_ac, blocks, total_bits - bit_offset,
      delta);
  return static_cast<int>(cudaGetLastError());
}

// frames: (B, H, W) u8; bits: (B, cap) u8 in wire order.
int stegotpu_kron_extract(const void* frames, void* bits, const void* kron,
                          int device, int b, int h, int w, int num_ac,
                          float delta, void* stream) {
  if (!shape_ok(b, h, w, num_ac, delta)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = b * (h / 8) * (w / 8);
  const int smem = num_ac * 64 * static_cast<int>(sizeof(float)) + kKronThreads * num_ac;
  unsigned grid = 0;
  err = persistent_grid(kron_extract_kernel, device, smem,
                        (blocks + kKronThreads - 1) / kKronThreads, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kron_extract_kernel<<<grid, kKronThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<uint8_t*>(bits),
      static_cast<const float*>(kron), h, w, num_ac, blocks, delta);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

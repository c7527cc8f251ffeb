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
// itself, in int64, from total_bits, bit_offset, the frame and the block,
// and reads the payload in wire order (block n, slot j at n*num_ac + j) as
// the stripe kernels do; the plane is never materialized. A payload byte
// other than 0/1 is state >= 2 there and is not embedded here either.
//
// Design. 64 threads own one 8x8 block, one coefficient (forward) or one
// pixel (inverse) each; a CUDA block of 256 threads takes 4 neighbouring
// blocks of a block row. K64 sits in shared memory once, its rows padded to
// kStride = 65 words: the forward dot product of thread k reads row k
// (word k*65 + c, bank (k + c) % 32) and the inverse of thread p reads
// column p (word k*65 + p), so a warp's 32 reads fall in 32 banks either
// way, while the pixel or coefficient operand is a broadcast. Each dot
// product is 64 FP32 FMAs in a fixed order (fmaf), with __syncthreads
// between the forward pass, the QIM and the inverse pass.
//
// Bound on the H100: 2 x 64 FMAs per pixel for K7, about 0.53 GFLOP per
// 1080p frame (0.27 for K8), each FMA with one shared-memory load beside
// it, against 2 B of u8 traffic per pixel (plus num_ac/64 B of payload):
// the shared-memory load rate, not HBM, sets the pace. No tensor cores are
// used, so no TF32 can enter (the f32 wire contract); the build has no
// --use_fast_math (y / delta must be an IEEE divide). This kernel is
// right and simple; making it fast is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerCta = 4;                  // 8x8 blocks per CUDA block
constexpr int kThreads = 64 * kBlocksPerCta;
constexpr int kStride = 65;                       // padded row of K64 in shared memory

struct KronTile {
  float x[kBlocksPerCta][64];  // pixels
  float y[kBlocksPerCta][64];  // K7: the coefficients after the QIM
};

// K (row-major, kron[k*64 + c] = K[k][c]) into k[k*kStride + c].
__device__ __forceinline__ void load_kron(float* k, const float* __restrict__ kron) {
  for (int i = threadIdx.x; i < 64 * 64; i += kThreads)
    k[(i >> 6) * kStride + (i & 63)] = kron[i];
}

// Thread t owns block j = t / 64 of the CTA and index e = t % 64 of it:
// pixel (e / 8, e % 8), coefficient e. Returns the pixel's byte offset.
__device__ __forceinline__ size_t pixel_offset(int f, int by, int bx, int e,
                                               int h, int w) {
  return (static_cast<size_t>(f) * h + static_cast<size_t>(by) * 8 + e / 8) * w +
         static_cast<size_t>(bx) * 8 + (e & 7);
}

// y[e] = sum_c K[e][c] x[c], c ascending.
__device__ __forceinline__ float forward_coeff(const float* __restrict__ x,
                                               const float* k, int e) {
  float acc = 0.0f;
#pragma unroll 16
  for (int c = 0; c < 64; ++c) acc = fmaf(k[e * kStride + c], x[c], acc);
  return acc;
}

// Floor-mod 2 of an integral float (jnp.mod semantics, right for negative q).
__device__ __forceinline__ float parity(float q) {
  return q - 2.0f * floorf(q * 0.5f);
}

__global__ void __launch_bounds__(kThreads)
kron_embed_kernel(const uint8_t* __restrict__ frames,
                  const uint8_t* __restrict__ payload,
                  uint8_t* __restrict__ stego, const float* __restrict__ kron,
                  int h, int w, int num_ac, long long cap, long long total_bits,
                  long long bit_offset, float delta) {
  __shared__ float k[64 * kStride];
  __shared__ KronTile tile;
  load_kron(k, kron);

  const int j = threadIdx.x / 64;
  const int e = threadIdx.x % 64;
  const int bw = w / 8;
  const int bx = blockIdx.x * kBlocksPerCta + j;
  const int by = blockIdx.y;
  const int f = blockIdx.z;
  const size_t off = pixel_offset(f, by, bx, e, h, w);
  const float x = static_cast<float>(frames[off]);
  tile.x[j][e] = x;
  __syncthreads();

  const float y = forward_coeff(tile.x[j], k, e);
  // payload bits left at the block's first slot (global bit indices)
  const long long blk = static_cast<long long>(by) * bw + bx;
  const long long rem = total_bits - bit_offset - f * cap - blk * num_ac;
  float y_new = y;
  if (rem > 0 && e >= 1 && e <= num_ac && e - 1 < rem) {
    const uint8_t bit = payload[f * cap + blk * num_ac + (e - 1)];
    if (bit < 2) {  // the plane's state 0/1; any other byte is state >= 2
      const float b = static_cast<float>(bit);
      const float q = rintf(y / delta);  // round half to even
      const float adj = parity(q) != b ? (b == 1.0f ? 1.0f : -1.0f) : 0.0f;
      y_new = __fmul_rn(q + adj, delta);
    }
  }
  tile.y[j][e] = y_new;
  __syncthreads();

  // full inverse: x'[p] = sum_r y_new[r] K[r][p], r ascending
  float acc = 0.0f;
#pragma unroll 16
  for (int r = 0; r < 64; ++r) acc = fmaf(tile.y[j][r], k[r * kStride + e], acc);
  const float o = rem > 0 ? fminf(fmaxf(acc, 0.0f), 255.0f) : x;  // never entered: exact
  stego[off] = static_cast<uint8_t>(static_cast<int>(o));  // truncating
}

__global__ void __launch_bounds__(kThreads)
kron_extract_kernel(const uint8_t* __restrict__ frames, uint8_t* __restrict__ bits,
                    const float* __restrict__ kron, int h, int w, int num_ac,
                    long long cap, float delta) {
  __shared__ float k[64 * kStride];
  __shared__ KronTile tile;
  load_kron(k, kron);

  const int j = threadIdx.x / 64;
  const int e = threadIdx.x % 64;
  const int bw = w / 8;
  const int bx = blockIdx.x * kBlocksPerCta + j;
  const int by = blockIdx.y;
  const int f = blockIdx.z;
  tile.x[j][e] = static_cast<float>(frames[pixel_offset(f, by, bx, e, h, w)]);
  __syncthreads();

  if (e >= 1 && e <= num_ac) {
    const float y = forward_coeff(tile.x[j], k, e);
    const long long blk = static_cast<long long>(by) * bw + bx;
    bits[f * cap + blk * num_ac + (e - 1)] =
        static_cast<uint8_t>(parity(rintf(y / delta)));
  }
}

cudaError_t begin(int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) (void)cudaGetLastError();
  return err;
}

// Shapes the kernels take: W a multiple of 8 blocks x kBlocksPerCta (the
// wrappers require W % 128 == 0, the TPU kernel's domain), 1 <= num_ac <=
// 63, delta > 0.
bool shape_ok(int b, int h, int w, int num_ac, float delta) {
  return b > 0 && h > 0 && h % 8 == 0 && w > 0 && w % (8 * kBlocksPerCta) == 0 &&
         num_ac >= 1 && num_ac <= 63 && delta > 0.0f;
}

dim3 grid_of(int b, int h, int w) { return dim3(w / 8 / kBlocksPerCta, h / 8, b); }

}  // namespace

extern "C" {

// frames, stego: (B, H, W) u8; payload: (B, cap) u8 in wire order, cap =
// (H/8)(W/8)num_ac; kron: K64 = M (x) M, 64x64 f32 row-major on the
// device. Frame i holds global bits [bit_offset + i*cap, ...). Returns a
// cudaError_t.
int stegotpu_kron_embed(const void* frames, const void* payload, void* stego,
                        const void* kron, int device, int b, int h, int w,
                        int num_ac, long long total_bits, long long bit_offset,
                        float delta, void* stream) {
  if (!shape_ok(b, h, w, num_ac, delta)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  kron_embed_kernel<<<grid_of(b, h, w), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload),
      static_cast<uint8_t*>(stego), static_cast<const float*>(kron), h, w, num_ac,
      cap, total_bits, bit_offset, delta);
  return static_cast<int>(cudaGetLastError());
}

// frames: (B, H, W) u8; bits: (B, cap) u8 in wire order.
int stegotpu_kron_extract(const void* frames, void* bits, const void* kron,
                          int device, int b, int h, int w, int num_ac,
                          float delta, void* stream) {
  if (!shape_ok(b, h, w, num_ac, delta)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  kron_extract_kernel<<<grid_of(b, h, w), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<uint8_t*>(bits),
      static_cast<const float*>(kron), h, w, num_ac, cap, delta);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

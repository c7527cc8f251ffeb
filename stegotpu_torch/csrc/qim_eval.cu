// The round trip's evaluation for Hopper (sm_90a), with a plain C interface
// bound by ctypes (stegotpu_torch/ops/_build.py, ops/stripe_kernel.py
// roundtrip_eval).
//
// qim_eval_kernel replaces no Pallas kernel: the JAX package evaluates a
// round trip in XLA code (stegotpu/ops/qim.py:165-189, roundtrip_metrics),
// and the port's plain version (ops/qim.roundtrip_metrics_plain) casts both
// stacks to float32, subtracts, squares and takes the mean, then counts the
// payload-carrying slots that read back wrong in more torch passes. This
// kernel computes the same three scalars in one pass over the inputs:
//
// - the exact sum of squared pixel differences of frames and stego, as a
//   64-bit integer, and from it psnr_db = 10 log10(65025 N_px / sse) taken
//   in double and rounded once to float32 (+inf when sse == 0);
// - bit_errors: the flat slots below n = min(total_bits, B*C) at which
//   extracted and payload differ (any byte values, as `!=` compares them);
// - payload_bits: n.
//
// Bound on the H100: bytes. Each input is read once (2 B*H*W + 2 B*C bytes:
// 2,455,142,400 B, 0.733 ms at 3.35 TB/s, for 128 4K frames at num_ac 10)
// against a few integer operations a byte, and nothing is reused. Design:
// a persistent grid (kCtasPerSm CTAs of kThreads threads on every SM) walks
// both pairs of arrays grid-stride in 16-byte vectors, neighbouring threads
// on neighbouring vectors, kUnroll vectors of each array loaded before any
// is used (32 KB a CTA, 128 KB an SM in flight), by non-coherent loads that
// do not allocate in L1. A word of pixels is __vabsdiffu4 then the unsigned
// __dp4a(d, d, acc): four squared differences in two instructions. A word of
// bits is __popc(__vcmpne4(a, b)), 8 a differing byte (shifted out at the
// end). Partial sums stay in 32 bits for at most kUnroll vectors (at most
// 4 * 16 * 65025 < 2^32), then go to 64-bit per-thread sums; every index is
// 64-bit (B*H*W passes 2^31 at 256 4K frames). Every input starts on a
// 16-byte boundary (the wrapper refuses any other); the bytes after the
// last whole vector go byte by byte. A CTA reduces by warp shuffles
// and adds its two sums with one 64-bit atomicAdd each; a ticket counter
// behind __threadfence() lets the last CTA to finish write the results.
// Integer sums are associative, so every run gives the same bits. The
// entry point zeroes the sums and the ticket with one cudaMemsetAsync on
// the launch stream; nothing in a call waits for the host or the host for
// it. No TMA or bulk-copy ring: a streaming read with enough loads in
// flight needs none, and K13's bulk-copy ring lost to cp.async (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kCtasPerSm = 4;

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Sums of squared byte differences.
struct SquaredError {
  static __device__ unsigned word(unsigned a, unsigned b, unsigned acc) {
    const unsigned d = __vabsdiffu4(a, b);
    return __dp4a(d, d, acc);
  }
  static __device__ unsigned byte(uint8_t a, uint8_t b) {
    const int d = static_cast<int>(a) - static_cast<int>(b);
    return static_cast<unsigned>(d * d);
  }
  static __device__ unsigned long long result(unsigned long long s) { return s; }
};

// Counts of differing bytes, 8 a byte (a differing byte is 0xff in
// __vcmpne4's result).
struct Mismatch {
  static __device__ unsigned word(unsigned a, unsigned b, unsigned acc) {
    return acc + __popc(__vcmpne4(a, b));
  }
  static __device__ unsigned byte(uint8_t a, uint8_t b) { return a != b ? 8u : 0u; }
  static __device__ unsigned long long result(unsigned long long s) { return s >> 3; }
};

template <class Op>
__device__ __forceinline__ unsigned vec(uint4 x, uint4 y, unsigned acc) {
  acc = Op::word(x.x, y.x, acc);
  acc = Op::word(x.y, y.y, acc);
  acc = Op::word(x.z, y.z, acc);
  return Op::word(x.w, y.w, acc);
}

// This thread's share of Op over bytes [0, n) of a and b, both 16-byte
// aligned.
template <class Op>
__device__ unsigned long long stream_sum(const uint8_t* __restrict__ a,
                                         const uint8_t* __restrict__ b,
                                         long long n, long long tid,
                                         long long nthreads) {
  const long long nvec = n / 16;
  const uint4* va = reinterpret_cast<const uint4*>(a);
  const uint4* vb = reinterpret_cast<const uint4*>(b);
  unsigned long long sum = 0;
  long long v = tid;
  for (; v + (kUnroll - 1) * nthreads < nvec; v += kUnroll * nthreads) {
    uint4 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = load_stream(va + v + u * nthreads);
      y[u] = load_stream(vb + v + u * nthreads);
    }
    unsigned part = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) part = vec<Op>(x[u], y[u], part);
    sum += part;
  }
  for (; v < nvec; v += nthreads) sum += vec<Op>(load_stream(va + v), load_stream(vb + v), 0u);
  for (long long i = 16 * nvec + tid; i < n; i += nthreads) sum += Op::byte(a[i], b[i]);
  return sum;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

// acc: [sse, bit errors, ticket], zeroed before the launch; the bit-error
// sum is the result itself once every CTA has added to it.
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
qim_eval_kernel(const uint8_t* __restrict__ frames, const uint8_t* __restrict__ stego,
                long long n_px, const uint8_t* __restrict__ extracted,
                const uint8_t* __restrict__ payload, long long n_count,
                long long n_bits, unsigned long long* acc, float* psnr,
                long long* payload_bits) {
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long sse = stream_sum<SquaredError>(frames, stego, n_px, tid, nthreads);
  unsigned long long wrong = stream_sum<Mismatch>(extracted, payload, n_count, tid, nthreads);
  sse = warp_sum(sse);
  wrong = warp_sum(wrong);
  __shared__ unsigned long long s_sse[kThreads / 32], s_wrong[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_sse[warp] = sse;
    s_wrong[warp] = wrong;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  sse = 0;
  wrong = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    sse += s_sse[i];
    wrong += s_wrong[i];
  }
  atomicAdd(&acc[0], SquaredError::result(sse));
  atomicAdd(&acc[1], Mismatch::result(wrong));
  __threadfence();
  if (atomicAdd(&acc[2], 1ull) != gridDim.x - 1) return;
  // the last CTA: every other CTA's sums are in acc
  const unsigned long long total = atomicAdd(&acc[0], 0ull);
  // 65025 N / 0 is +inf and log10(+inf) +inf: identical stacks read inf
  *psnr = static_cast<float>(10.0 * log10(65025.0 * static_cast<double>(n_px) /
                                          static_cast<double>(total)));
  *payload_bits = n_bits;
}

}  // namespace

extern "C" {

// frames, stego: B*H*W = n_px u8 each; extracted, payload: B*C = n_slots u8
// each; all four 16-byte aligned; n_bits = min(total_bits, B*C), the payload's bits in the batch
// (slots at flat index < n_bits are counted; none where it is <= 0). acc:
// 3 u64, zeroed here on `stream` before the launch, acc[1] then holding the
// bit errors as int64; psnr: one f32; payload_bits: one int64, set to
// n_bits. Returns a cudaError_t.
int stegotpu_qim_eval(const void* frames, const void* stego, long long n_px,
                      const void* extracted, const void* payload,
                      long long n_slots, long long n_bits, void* acc,
                      void* psnr, void* payload_bits, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  (void)cudaGetLastError();
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(acc, 0, 3 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_count = n_bits < 0 ? 0 : (n_bits < n_slots ? n_bits : n_slots);
  const long long most = n_px > n_count ? n_px : n_count;
  const long long per_cta = static_cast<long long>(kThreads) * kUnroll * 16;
  long long ctas = (most + per_cta - 1) / per_cta;
  if (ctas > static_cast<long long>(sms) * kCtasPerSm) ctas = static_cast<long long>(sms) * kCtasPerSm;
  if (ctas < 1) ctas = 1;  // the last CTA writes the results, even of nothing
  qim_eval_kernel<<<static_cast<unsigned>(ctas), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(stego), n_px,
      static_cast<const uint8_t*>(extracted), static_cast<const uint8_t*>(payload),
      n_count, n_bits, static_cast<unsigned long long*>(acc), static_cast<float*>(psnr),
      static_cast<long long*>(payload_bits));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

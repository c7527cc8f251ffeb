// The A/B study kernels for Hopper (sm_90a), with a plain C interface
// bound by ctypes (stegotpu_torch/ops/_build.py, stegotpu_torch/studies/).
// Each is a variant of a stripe kernel of qim_stripe.cu and shares its
// block arithmetic through qim_common.cuh:
//
// K9  qim_ablation_kernel<RN, V> replaces the kern_* bodies of
//     benchmarks/extract_ablation.py:35-116 (pallas_call :61, :92): K5
//     with stages removed. V picks the variant:
//       full          slot-row coefficients, then round(y/delta) mod 2: K5;
//       no_qim        the same coefficients through the truncating u8 cast,
//                     which wraps mod 256 through int32 (_f32_to_u8);
//       no_horiz      the vertical 8-point DCT rows g < RN of each block at
//                     every pixel column, then the QIM bits;
//       io_only       u8(int32(pixel[jg*stripe + k, x] * delta)), k < rows_pad;
//       io_f4         io_only with four frames per CTA;
//       full_notrunc  full, reading f32 frames.
//     Out: K5's layout (B, (H/stripe)*rows_pad, W) u8 with zero pad rows.
// K10 qim_embed_packedin_kernel<RN> replaces _embed_kernel_packedin
//     (benchmarks/ab_packed_payload.py:73, pallas_call :111): K1 with the
//     payload read bit-packed in K2's layout (8 slot bits per byte), the
//     layout of payload_to_rows_packed (:53-61). Non-slot bits and pad rows
//     are never read into the stego.
// K11 qim_roundtrip_dual_kernel<RN, Arith, MINB> replaces _dual_kernel
//     (benchmarks/dualchain_r5.py:43, pallas_call :91): K4 with two frames
//     per thread as two independent dependency chains, for
//     instruction-level parallelism. It takes K4's Hopper design (the
//     ArithHopper spelling, the matrix from the constant bank, the bits
//     per frame written in the kernel, a register cap), so that its A/B
//     against K4 measures the second chain and nothing else.
// K12 copy_kernel<V> replaces the DMA-only variants of
//     benchmarks/roofline_r4.py:53-149 (pallas_call :91, :149):
//       copy     stego = frames, 16-byte loads and stores (:85-86): the
//                card's u8 streaming ceiling;
//       dmaspec  K4's in/out set with no math (:79-81): it reads the frames
//                and the wire-order payload and writes stego = frames and
//                packed = the payload in K2's packed layout.
//
// Bound on the H100: memory traffic, as for the stripe kernels. The study
// kernels measure how far each stage of K5, K1 and K4 stands above it.
// K9 and K10 keep the first design's conversion spelling (ArithCvt, the
// matrix in shared memory): K9 `full` == K5 and K10 == K1 are the
// zero-tolerance witnesses that the two spellings agree.
// Build WITHOUT --use_fast_math (see qim_stripe.cu).

#include "qim_common.cuh"

namespace {

// The CTAs per SM that K11's build asks ptxas to fit at rn <= 2 (1: no
// cap). A thread holds two blocks, twice K4's live state, so the cap that
// gives K4 its 64 registers would spill here; the cap also sets the tail,
// since the grid is 2 x 135 x 4 = 1,080 CTAs at 1080p B=8. At 1080p B=8
// on an H100 80GB HBM3 at 700 W, no cap (167 registers, 3 CTAs an SM,
// 2.73 waves) took 0.0335 ms, 4 (125 registers, 2.05 waves) 0.0346, 5
// (96, 1.64 waves) 0.0345, and 6 (80 registers, 1.36 waves) spills 52 B
// and took 0.0350 (PERF.md section 6):
// the second chain's latency hiding needs its registers more than the
// tail needs CTAs. studies/stripe_cap.py rebuilds this source with
// -DSTEGOTPU_K11_MINB=<n> for the A/B (`--minb k11:<n>`).
#ifndef STEGOTPU_K11_MINB
#define STEGOTPU_K11_MINB 1
#endif

enum Ablation : int {
  kFull = 0,
  kNoQim = 1,
  kNoHoriz = 2,
  kIoOnly = 3,
  kIoF4 = 4,
  kFullNotrunc = 5,
};

enum CopyVariant : int { kCopy = 0, kDmaSpec = 1 };

// The truncating u8 cast through int32 (_f32_to_u8): toward zero, then
// the low 8 bits, so it wraps mod 256 for negative values and values
// above 255.
__device__ __forceinline__ uint32_t wrap_u8(float v) {
  return static_cast<uint32_t>(static_cast<int>(v)) & 0xFFu;
}

__device__ __forceinline__ uint2 pack_lanes(const uint32_t (&lane)[8]) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    lo |= lane[s] << (8 * s);
    hi |= lane[s + 4] << (8 * s);
  }
  return make_uint2(lo, hi);
}

// K5's layout with 8 arbitrary u8 lanes per slot row: lanes 8*bx .. 8*bx+7
// of row jg*rows_pad + i*RN + g hold lane[g]; the last block row of a
// stripe zeroes the stripe's padding rows.
template <int RN>
__device__ __forceinline__ void write_lane_rows(uint8_t* __restrict__ rows,
                                                const uint2 (&lane)[RN], int f,
                                                int by, int bx, int h, int w,
                                                int stripe_blocks, int rows_pad) {
  int i;
  uint8_t* group = rows + group_row(f, by, h, stripe_blocks, rows_pad, i) * w +
                   static_cast<size_t>(bx) * 8;
#pragma unroll
  for (int g = 0; g < RN; ++g)
    *reinterpret_cast<uint2*>(group + static_cast<size_t>(i * RN + g) * w) = lane[g];
  if (i == stripe_blocks - 1)
    for (int k = stripe_blocks * RN; k < rows_pad; ++k)
      *reinterpret_cast<uint2*>(group + static_cast<size_t>(k) * w) =
          make_uint2(0u, 0u);
}

// 8 rows of 8 f32 pixels, two 16-byte loads a row.
__device__ __forceinline__ void load_rows_f32(const float* __restrict__ p, int w,
                                              float (&x)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4* row = reinterpret_cast<const float4*>(p + static_cast<size_t>(r) * w);
    const float4 a = __ldg(row), b = __ldg(row + 1);
    x[r][0] = a.x; x[r][1] = a.y; x[r][2] = a.z; x[r][3] = a.w;
    x[r][4] = b.x; x[r][5] = b.y; x[r][6] = b.z; x[r][7] = b.w;
  }
}

// io_only / io_f4: one thread per 8x8 tile of the output. Grid
// (block columns / kThreads, (H/stripe)*(rows_pad/8), B or B/4).
template <int V>
__device__ __forceinline__ void ablate_io(const uint8_t* __restrict__ frames,
                                          uint8_t* __restrict__ out, int bx,
                                          int h, int w, int stripe_blocks,
                                          int rows_pad, float delta) {
  constexpr int kFrames = V == kIoF4 ? 4 : 1;
  const int tiles = rows_pad / 8;
  const int jg = blockIdx.y / tiles;
  const int k = (blockIdx.y - jg * tiles) * 8;  // first row in the stripe
  const size_t groups = static_cast<size_t>(h / 8 / stripe_blocks);
#pragma unroll
  for (int s = 0; s < kFrames; ++s) {
    const size_t f = static_cast<size_t>(blockIdx.z) * kFrames + s;
    const size_t src_row = f * h + static_cast<size_t>(jg) * stripe_blocks * 8 + k;
    const size_t dst_row = (f * groups + jg) * rows_pad + k;
    uint2 raw[8];
    load_rows(frames + src_row * w + static_cast<size_t>(bx) * 8, w, raw);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      uint32_t lane[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t word = c < 4 ? raw[r].x : raw[r].y;
        const float p = static_cast<float>((word >> (8 * (c & 3))) & 0xFFu);
        lane[c] = wrap_u8(__fmul_rn(p, delta));
      }
      raw[r] = pack_lanes(lane);
    }
    store_rows(out + dst_row * w + static_cast<size_t>(bx) * 8, w, raw);
  }
}

template <int RN, int V>
__global__ void __launch_bounds__(kThreads)
qim_ablation_kernel(const void* __restrict__ frames, uint8_t* __restrict__ out,
                    const float* __restrict__ dct, int h, int w,
                    int stripe_blocks, int rows_pad, float delta) {
  __shared__ float m[64];
  load_dct(m, dct);

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  if constexpr (V == kIoOnly || V == kIoF4) {
    ablate_io<V>(static_cast<const uint8_t*>(frames), out, bx, h, w,
                 stripe_blocks, rows_pad, delta);
  } else {
    const int by = blockIdx.y;
    const int f = blockIdx.z;
    const size_t off = block_offset(f, by, bx, h, w);
    float x[8][8];
    if constexpr (V == kFullNotrunc) {
      load_rows_f32(static_cast<const float*>(frames) + off, w, x);
    } else {
      uint2 raw[8];
      load_rows(static_cast<const uint8_t*>(frames) + off, w, raw);
      unpack_rows<ArithCvt>(raw, x);
    }
    if constexpr (V == kFull || V == kFullNotrunc) {
      uint32_t byte[RN];
      slot_bits_of<RN, ArithCvt>(x, m, delta, byte);  // K5's decode
      write_rows<RN>(out, byte, f, by, bx, h, w, stripe_blocks, rows_pad);
    } else {
      float y[RN][8];
      if constexpr (V == kNoQim) forward_rows<RN>(x, m, y);
      else vertical_rows<RN>(x, m, y);
      uint2 lanes[RN];
#pragma unroll
      for (int g = 0; g < RN; ++g) {
        uint32_t lane[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          if constexpr (V == kNoQim) lane[v] = wrap_u8(y[g][v]);
          else lane[v] = delta > 0.0f ? qim_bit<ArithCvt>(y[g][v], delta) : 0u;
        }
        lanes[g] = pack_lanes(lane);
      }
      write_lane_rows<RN>(out, lanes, f, by, bx, h, w, stripe_blocks, rows_pad);
    }
  }
}

template <int RN>
__global__ void __launch_bounds__(kThreads)
qim_embed_packedin_kernel(const uint8_t* __restrict__ frames,
                          const uint8_t* __restrict__ packed_payload,
                          uint8_t* __restrict__ stego,
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
  if (rem > 0 && delta > 0.0f) {
    int i;
    const uint8_t* group =
        packed_payload + group_row(f, by, h, stripe_blocks, rows_pad, i) * bw + bx;
    PackedBits<RN> bits;
#pragma unroll
    for (int g = 0; g < RN; ++g)
      bits.byte[g] = __ldg(group + static_cast<size_t>(i * RN + g) * bw);
    embed_block<RN, ArithCvt>(raw, m, bits, rem, num_ac, delta);
  }
  store_rows(stego + off, w, raw);
}

// K11: each thread takes block (by, bx) of frames 2z and 2z+1, two chains
// with no data dependence between them. Both frames' rows and then both
// blocks' payload bits are loaded before either chain's first FMA, so
// neither chain waits on the other's loads; then each chain is K4's
// embed_block and slot_bits with K4's Arith, so the stego, bits per frame
// and packed bits are K4's byte for byte. Thread 0 of CTA (0, 0, z) writes
// the bits per frame of both frames: a call is one launch.
template <int RN, class Arith, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
qim_roundtrip_dual_kernel(const uint8_t* __restrict__ frames,
                          const uint8_t* __restrict__ payload,
                          uint8_t* __restrict__ stego, int* __restrict__ bpf,
                          uint8_t* __restrict__ packed, int h, int w,
                          int num_ac, long long cap, long long total_bits,
                          int stripe_blocks, int rows_pad, float delta) {
  const ConstDct m{};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int f = 2 * blockIdx.z + k;
    frame_bits(bpf, f, total_bits - f * cap, cap);  // no bit offset
  }

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  const int by = blockIdx.y;
  const long long blk = static_cast<long long>(by) * bw + bx;

  // two frames, two chains: every load of both before the first FMA
  uint2 raw[2][8];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    load_rows(frames + block_offset(2 * blockIdx.z + k, by, bx, h, w), w, raw[k]);
  long long rem[2];
  HeldBits<RN> bits[2];  // read only where the chain embeds
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int f = 2 * blockIdx.z + k;
    rem[k] = total_bits - f * cap - blk * num_ac;  // no bit offset
    if (rem[k] > 0 && delta > 0.0f)
      bits[k].load(payload + f * cap + blk * num_ac, num_ac);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (rem[k] > 0 && delta > 0.0f)
      embed_block<RN, RederiveIfCapped<Arith, (MINB > 1)>>(raw[k], m, bits[k], rem[k],
                                                           num_ac, delta);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    store_rows(stego + block_offset(2 * blockIdx.z + k, by, bx, h, w), w, raw[k]);
  // re-extract from the quantized stego, still in registers
  uint32_t byte[2][RN];
#pragma unroll
  for (int k = 0; k < 2; ++k) slot_bits<RN, Arith>(raw[k], m, delta, byte[k]);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    write_packed<RN>(packed, byte[k], 2 * blockIdx.z + k, by, bx, h, bw,
                     stripe_blocks, rows_pad);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint8_t* __restrict__ frames, const uint8_t* __restrict__ payload,
            uint8_t* __restrict__ stego, uint8_t* __restrict__ packed,
            long long n16, int h, int w, int num_ac, long long cap,
            int stripe_blocks, int rows_pad) {
  if constexpr (V == kCopy) {
    const uint4* src = reinterpret_cast<const uint4*>(frames);
    uint4* dst = reinterpret_cast<uint4*>(stego);
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         k < n16; k += stride)
      dst[k] = __ldg(src + k);
  } else {
    const int bw = w / 8;
    const int bx = blockIdx.x * blockDim.x + threadIdx.x;
    if (bx >= bw) return;
    const int by = blockIdx.y;
    const int f = blockIdx.z;
    const size_t off = block_offset(f, by, bx, h, w);
    uint2 raw[8];
    load_rows(frames + off, w, raw);
    store_rows(stego + off, w, raw);
    // the block's wire-order bits, 8 to a byte in K2's packed layout
    const uint8_t* bits =
        payload + f * cap + (static_cast<long long>(by) * bw + bx) * num_ac;
    const int rn = num_ac / 8 + 1;
    int i;
    uint8_t* group = packed + group_row(f, by, h, stripe_blocks, rows_pad, i) * bw + bx;
    for (int g = 0; g < rn; ++g) {
      uint32_t byte = 0;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int c = 8 * g + s;
        if (c >= 1 && c <= num_ac) byte |= static_cast<uint32_t>(bits[c - 1]) << s;
      }
      group[static_cast<size_t>(i * rn + g) * bw] = static_cast<uint8_t>(byte);
    }
    if (i == stripe_blocks - 1)
      for (int k = stripe_blocks * rn; k < rows_pad; ++k)
        group[static_cast<size_t>(k) * bw] = 0;
  }
}

}  // namespace

extern "C" {

// frames: (B, H, W) u8, or f32 for full_notrunc; out: (B,
// (H/stripe)*rows_pad, W) u8; variant: the Ablation value. io_f4 needs
// B % 4 == 0. Each entry point returns a cudaError_t.
int stegotpu_qim_ablation(const void* frames, void* out, const void* dct,
                          int device, int variant, int b, int h, int w,
                          int num_ac, int stripe, int rows_pad, float delta,
                          void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bwg = (w / 8 + kThreads - 1) / kThreads;
#define STEGOTPU_ABLATE(RN, V, GRID)                                        \
  qim_ablation_kernel<RN, V><<<GRID, kThreads, 0, s>>>(                     \
      frames, static_cast<uint8_t*>(out), static_cast<const float*>(dct), h, \
      w, stripe / 8, rows_pad, delta)
#define STEGOTPU_FULL(RN) STEGOTPU_ABLATE(RN, kFull, grid_of(b, h, w))
#define STEGOTPU_NO_QIM(RN) STEGOTPU_ABLATE(RN, kNoQim, grid_of(b, h, w))
#define STEGOTPU_NO_HORIZ(RN) STEGOTPU_ABLATE(RN, kNoHoriz, grid_of(b, h, w))
#define STEGOTPU_NOTRUNC(RN) STEGOTPU_ABLATE(RN, kFullNotrunc, grid_of(b, h, w))
  const int rn = num_ac / 8 + 1;
  const unsigned io_rows = static_cast<unsigned>(h / stripe * (rows_pad / 8));
  switch (variant) {
    case kFull: STEGOTPU_RN_SWITCH(rn, STEGOTPU_FULL) break;
    case kNoQim: STEGOTPU_RN_SWITCH(rn, STEGOTPU_NO_QIM) break;
    case kNoHoriz: STEGOTPU_RN_SWITCH(rn, STEGOTPU_NO_HORIZ) break;
    case kFullNotrunc: STEGOTPU_RN_SWITCH(rn, STEGOTPU_NOTRUNC) break;
    case kIoOnly:  // RN does not enter the io variants
      STEGOTPU_ABLATE(1, kIoOnly, dim3(bwg, io_rows, b));
      break;
    case kIoF4:
      if (b % 4) return static_cast<int>(cudaErrorInvalidValue);
      STEGOTPU_ABLATE(1, kIoF4, dim3(bwg, io_rows, b / 4));
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef STEGOTPU_NOTRUNC
#undef STEGOTPU_NO_HORIZ
#undef STEGOTPU_NO_QIM
#undef STEGOTPU_FULL
#undef STEGOTPU_ABLATE
  return static_cast<int>(cudaGetLastError());
}

// frames, stego: (B, H, W) u8; packed_payload: (B, (H/stripe)*rows_pad,
// W/8) u8 in K2's packed layout. Global bit 0 is the payload's first bit.
int stegotpu_qim_embed_packedin(const void* frames, const void* packed_payload,
                                void* stego, const void* dct, int device, int b,
                                int h, int w, int num_ac, long long total_bits,
                                int stripe, int rows_pad, float delta,
                                void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STEGOTPU_PACKEDIN(RN)                                               \
  qim_embed_packedin_kernel<RN><<<grid_of(b, h, w), kThreads, 0, s>>>(      \
      static_cast<const uint8_t*>(frames),                                  \
      static_cast<const uint8_t*>(packed_payload),                          \
      static_cast<uint8_t*>(stego), static_cast<const float*>(dct), h, w,   \
      num_ac, cap, total_bits, stripe / 8, rows_pad, delta)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_PACKEDIN)
#undef STEGOTPU_PACKEDIN
  return static_cast<int>(cudaGetLastError());
}

// As stegotpu_qim_roundtrip_packed (qim_stripe.cu), two frames per
// thread; B % 2 == 0. bpf: (B,) int32, written by the kernel.
int stegotpu_qim_roundtrip_dual(const void* frames, const void* payload,
                                void* stego, void* bpf, void* packed,
                                int device, int b, int h, int w, int num_ac,
                                long long total_bits, int stripe, int rows_pad,
                                float delta, void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b % 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) {
    kernel<<<grid_of(b / 2, h, w), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload),
        static_cast<uint8_t*>(stego), static_cast<int*>(bpf),
        static_cast<uint8_t*>(packed), h, w, num_ac, cap, total_bits,
        stripe / 8, rows_pad, delta);
  };
  const bool fast = delta >= kAddRoundMinDelta;
#define STEGOTPU_DUAL(RN)                                                 \
  launch(fast ? qim_roundtrip_dual_kernel<RN, ArithHopper,               \
                                          capped_minb(RN, STEGOTPU_K11_MINB)> \
              : qim_roundtrip_dual_kernel<RN, ArithHopperSmallDelta,     \
                                          capped_minb(RN, STEGOTPU_K11_MINB)>)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_DUAL)
#undef STEGOTPU_DUAL
  return static_cast<int>(cudaGetLastError());
}

// variant kCopy: stego = frames, (B, H, W) u8, B*H*W % 16 == 0, 16-byte
// aligned; payload and packed unused. variant kDmaSpec: as
// stegotpu_qim_roundtrip_packed with stego = frames and packed = the
// payload packed.
int stegotpu_copy(const void* frames, const void* payload, void* stego,
                  void* packed, int device, int variant, int b, int h, int w,
                  int num_ac, int stripe, int rows_pad, void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const long long n16 = static_cast<long long>(b) * h * w / 16;
  const auto* in = static_cast<const uint8_t*>(frames);
  const auto* bits = static_cast<const uint8_t*>(payload);
  auto* out = static_cast<uint8_t*>(stego);
  auto* pk = static_cast<uint8_t*>(packed);
  if (variant == kCopy) {
    const long long blocks = (n16 + kThreads - 1) / kThreads;
    const unsigned grid = static_cast<unsigned>(blocks < (1LL << 30) ? blocks : (1LL << 30));
    if (grid == 0) return static_cast<int>(cudaSuccess);
    copy_kernel<kCopy><<<grid, kThreads, 0, s>>>(in, bits, out, pk, n16, h, w,
                                                  num_ac, cap, stripe / 8, rows_pad);
  } else if (variant == kDmaSpec) {
    copy_kernel<kDmaSpec><<<grid_of(b, h, w), kThreads, 0, s>>>(
        in, bits, out, pk, n16, h, w, num_ac, cap, stripe / 8, rows_pad);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// K13 qim_roundtrip_pipe_kernel<RN, Arith, BUFS, MINB> for Hopper (sm_90a),
// with a plain C interface bound by ctypes (stegotpu_torch/ops/_build.py,
// stegotpu_torch/studies/emitpipe_r4.py).
//
// Replaces `outer` of benchmarks/emitpipe_r4.py (body :71-108, pallas_call
// :119): K4's fused embed + packed re-extract behind an input pipeline
// written by hand (pltpu.emit_pipeline with a --bufs deep input ring) in
// place of the automatic one. The function is K4's: wire-order payload
// (B, C) u8 in, stego (B, H, W) u8, bits per frame (B,) int32 and K2's
// packed layout (B, (H/stripe)*rows_pad, W/8) u8 out, no bit offset. The
// script's 120-row stripe tile, its 256-lane packed padding and its
// compact payload rows were Mosaic DMA and tiling devices and are not
// ported.
//
// Design. A persistent kernel: the grid is the card's SMs times the CTAs
// that fit on one (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and each
// CTA walks the tiles (frame, block row, column chunk of kThreads blocks)
// with a stride of gridDim.x (TileWalk: 32-bit carries, no division after
// the first tile). A ring of BUFS slots in dynamic shared memory holds one
// tile each: its 8 pixel rows (8 x 8*kThreads bytes) and its blocks'
// num_ac payload bytes. cp.async fills the slots BUFS-1 tiles ahead of the
// compute (16-byte copies where the rows are 16-byte aligned, 8 otherwise;
// the payload in 16-byte copies inside, 4-byte and single-byte ones at its
// ragged ends, never past its end), with one commit group per tile and
// wait_group<BUFS-1> before a tile is read. A slot is refilled only after
// the __syncthreads() that ends the compute of the tile it held; the CTA's
// last BUFS-1 tiles drain the ring.
//
// The arithmetic is K4's (ArithHopper at delta >= 2^-10, else
// ArithHopperSmallDelta; the matrix from the constant bank; the pixel
// re-derive where capped): compute is one thread per 8x8 block through the
// shared embed_block and slot_bits of qim_common.cuh, and write_packed for
// the bits; stores go from registers to global, as K4's do. Thread 0 of
// the tile that holds block row 0, chunk 0 of a frame writes its bits per
// frame, so a call is one launch, and K13's outputs are K4's byte for
// byte by construction (chip_smoke.py phase 12, tests/test_torch_cuda.py).
//
// The ring stays on cp.async and the CTA's barrier: the same kernel on
// Hopper's bulk asynchronous copies with a full and an empty mbarrier a
// slot and no barrier in the loop (in three producer forms) lost to it at
// every ring depth at 1080p B=128, where a CTA walks many tiles: by 10-13%
// with thread 0 or a producer warp filling, 44-46% with the warps taking
// turns (H100 80GB HBM3, 700 W). At B=8 it lost by 4-19%, save the
// producer warp at a ring of 4, 3% faster (PERF.md section 6).
//
// Bound on the H100: memory traffic, K4's bytes (studies/bounds.py
// "roundtrip_packed"). The ring overlaps the next tiles' loads with the
// compute of this one inside one CTA, where K4 relies on other CTAs of the
// SM to hide its loads. At 1080p B=8 a CTA walks two to four tiles, so the
// ring is mostly prologue; at B=128 some 30-65. Build WITHOUT
// --use_fast_math (see qim_stripe.cu).

#include "qim_common.cuh"

namespace {

constexpr int kRowBytes = 8 * kThreads;  // one tile row: kThreads blocks

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes [lo, hi) of an address range of fewer than 32 bytes, copied by one
// thread: 4-byte cp.async where aligned, single bytes at the ends. dst and
// src share their address modulo 16.
__device__ __forceinline__ void copy_ragged(uint8_t* dst, const uint8_t* src,
                                            uintptr_t lo, uintptr_t hi) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a4 = (lo + 3) & ~uintptr_t{3}, z4 = hi & ~uintptr_t{3};
  if (a4 < z4) {
    for (uintptr_t p = a4; p < z4; p += 4) cp_async4(dst + (p - base), src + (p - base));
    for (uintptr_t p = lo; p < a4; ++p) dst[p - base] = __ldg(src + (p - base));
    for (uintptr_t p = z4; p < hi; ++p) dst[p - base] = __ldg(src + (p - base));
  } else {
    for (uintptr_t p = lo; p < hi; ++p) dst[p - base] = __ldg(src + (p - base));
  }
}

// n bytes from src to dst, where dst and src share their address modulo
// 16: 16-byte cp.async over the aligned inside, spread over the CTA; the
// ragged head and tail by one thread each. Reads nothing outside
// [src, src + n).
__device__ __forceinline__ void copy_payload(uint8_t* dst, const uint8_t* src, int n) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src), e = s + n;
  uintptr_t a16 = (s + 15) & ~uintptr_t{15}, z16 = e & ~uintptr_t{15};
  if (a16 >= z16) a16 = z16 = e;  // no whole 16-byte unit: all head
  for (uintptr_t p = a16 + 16 * threadIdx.x; p < z16; p += 16 * kThreads)
    cp_async16(dst + (p - s), src + (p - s));
  if (threadIdx.x == kThreads - 1) copy_ragged(dst, src, s, a16);
  if (threadIdx.x == kThreads - 2) copy_ragged(dst, src, z16, e);
}

// A CTA's walk over the tiles t = (f * bh + by) * chunks + cx (frame f,
// block row by, column chunk cx): start() decomposes a tile index once,
// next() adds the decomposed stride with two carries, so the loop divides
// nothing. A tile exists while f < b.
struct TileWalk {
  int f, by, cx;
  __device__ __forceinline__ void start(int t, int bh, int chunks) {
    const int row = t / chunks;
    cx = t - row * chunks;
    f = row / bh;
    by = row - f * bh;
  }
  __device__ __forceinline__ void next(const TileWalk& step, int bh, int chunks) {
    cx += step.cx;
    const int c1 = cx >= chunks;
    cx -= c1 ? chunks : 0;
    by += step.by + c1;
    const int c2 = by >= bh;
    by -= c2 ? bh : 0;
    f += step.f + c2;
  }
};

// The bytes of one ring slot: 8 tile rows, then the payload of kThreads
// blocks with up to 15 bytes of lead for the address match.
constexpr int slot_bytes_of(int num_ac) {
  return 8 * kRowBytes + ((kThreads * num_ac + 15 + 15) & ~15);
}

// The CTAs per SM that K13's capped build asks ptxas to fit at rn <= 2
// (num_ac <= 15), one define per ring depth (1: no cap). An SM holds
// 228 KB of shared memory and reserves 1 KB a CTA, so at num_ac 15 (a
// slot of 10,128 B) a ring of 2, 3 or 4 slots fits 10, 7 or 5 CTAs: the
// caps of 3 and 4 slots are 7 and 5 (72 and 96 registers, no spill). A
// ring of 2 takes 7 too: at K4's 8 it spills 32 B at 64 registers, and at
// 1080p on an H100 80GB HBM3 at 700 W, MINB 7 (72 registers) took 0.0310
// ms at B=8 and 0.4236-0.4263 per 128 frames, against 0.0322-0.0323 and
// 0.4259-0.4269 at 8, 0.0322-0.0323 and 0.4241-0.4262 at 6, and
// 0.0319-0.0320 and 0.4539-0.4542 without a cap (PERF.md section 6).
// Without a cap a ring of 3 was 2% faster at B=8 and 6% slower at B=128,
// a ring of 4 tied at B=8 and was 3% slower at B=128, so both keep theirs.
// studies/stripe_cap.py rebuilds this source with
// -DSTEGOTPU_K13_BUF2_MINB=<n> and so on for the A/B (`--minb k13_2:<n>`).
#ifndef STEGOTPU_K13_BUF2_MINB
#define STEGOTPU_K13_BUF2_MINB 7
#endif
#ifndef STEGOTPU_K13_BUF3_MINB
#define STEGOTPU_K13_BUF3_MINB 7
#endif
#ifndef STEGOTPU_K13_BUF4_MINB
#define STEGOTPU_K13_BUF4_MINB 5
#endif
constexpr int pipe_minb(int bufs) {
  return bufs == 2 ? STEGOTPU_K13_BUF2_MINB
                   : bufs == 3 ? STEGOTPU_K13_BUF3_MINB : STEGOTPU_K13_BUF4_MINB;
}

// MINB is the CTAs per SM that __launch_bounds__ asks ptxas to fit:
// pipe_minb(BUFS) at rn <= 2 unless the launch asks for the build without
// the cap (MINB 1), the A/B of the cap (emitpipe_r4 --uncapped;
// chip_smoke.py phase 12, whose build line prints both builds' registers
// and spills).
template <int RN, class Arith, int BUFS, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
qim_roundtrip_pipe_kernel(const uint8_t* __restrict__ frames,
                          const uint8_t* __restrict__ payload,
                          uint8_t* __restrict__ stego, int* __restrict__ bpf,
                          uint8_t* __restrict__ packed, int b, int h, int w,
                          int num_ac, long long cap, long long total_bits,
                          int stripe_blocks, int rows_pad, float delta,
                          int slot_bytes) {
  extern __shared__ __align__(16) uint8_t ring[];
  const ConstDct m{};

  const int bw = w / 8, bh = h / 8;
  const int chunks = (bw + kThreads - 1) / kThreads;
  TileWalk step;
  step.start(gridDim.x, bh, chunks);

  auto payload_of = [&](const TileWalk& t) {
    return payload + t.f * cap +
           (static_cast<long long>(t.by) * bw + static_cast<long long>(t.cx) * kThreads) *
               num_ac;
  };
  // the slot's payload bytes start at this offset, so that they share the
  // global address modulo 16
  auto payload_slot = [&](uint8_t* slot, const uint8_t* src) {
    return slot + 8 * kRowBytes + (reinterpret_cast<uintptr_t>(src) & 15);
  };

  // fill slot s with tile t: 8 pixel rows, then the payload bytes. Unit i
  // of the tile is unit i % units of row i / units, units the most a row
  // holds (a power of two: no division), skipped past the tile's width.
  auto issue = [&](const TileWalk& t, int s) {
    uint8_t* slot = ring + s * slot_bytes;
    const int nb = min(kThreads, bw - t.cx * kThreads);
    const int cw = 8 * nb;
    const uint8_t* src = frames + block_offset(t.f, t.by, t.cx * kThreads, h, w);
    if (((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(w)) & 15) == 0) {
      constexpr int kUnits = kRowBytes / 16;  // the row's last unit may be 8 bytes
      for (int i = threadIdx.x; i < 8 * kUnits; i += kThreads) {
        const int r = i / kUnits, u = 16 * (i % kUnits);
        if (u >= cw) continue;
        const uint8_t* s16 = src + static_cast<size_t>(r) * w + u;
        uint8_t* d = slot + r * kRowBytes + u;
        if (u + 16 <= cw) cp_async16(d, s16);
        else cp_async8(d, s16);
      }
    } else {  // rows 8-byte aligned only (W % 16 != 0)
      constexpr int kUnits = kRowBytes / 8;
      for (int i = threadIdx.x; i < 8 * kUnits; i += kThreads) {
        const int r = i / kUnits, u = 8 * (i % kUnits);
        if (u < cw)
          cp_async8(slot + r * kRowBytes + u, src + static_cast<size_t>(r) * w + u);
      }
    }
    const uint8_t* bits = payload_of(t);
    copy_payload(payload_slot(slot, bits), bits, nb * num_ac);
  };

  // prologue: BUFS-1 tiles in flight; one commit group per tile, empty
  // groups past the CTA's last tile keep the count uniform
  TileWalk ahead;  // the next tile to issue
  ahead.start(blockIdx.x, bh, chunks);
#pragma unroll
  for (int s = 0; s < BUFS - 1; ++s) {
    if (ahead.f < b) {
      issue(ahead, s);
      ahead.next(step, bh, chunks);
    }
    cp_async_commit();
  }
  TileWalk t;
  t.start(blockIdx.x, bh, chunks);
  for (int s = 0, ps = BUFS - 1; t.f < b; t.next(step, bh, chunks)) {
    if (ahead.f < b) {  // into slot ps, which the tile before t freed
      issue(ahead, ps);
      ahead.next(step, bh, chunks);
    }
    if (++ps == BUFS) ps = 0;
    cp_async_commit();
    cp_async_wait<BUFS - 1>();  // this thread's copies of tile t have landed
    __syncthreads();            // and every other thread's

    if (t.by == 0 && t.cx == 0 && threadIdx.x == 0)
      bpf[t.f] = frame_bits_clamp(total_bits - t.f * cap, cap);  // no bit offset
    uint8_t* slot = ring + s * slot_bytes;
    const int bx = t.cx * kThreads + threadIdx.x;
    if (bx < bw) {
      uint2 raw[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        raw[r] = *reinterpret_cast<const uint2*>(slot + r * kRowBytes + 8 * threadIdx.x);
      const long long blk = static_cast<long long>(t.by) * bw + bx;
      const long long rem = total_bits - t.f * cap - blk * num_ac;  // no bit offset
      if (rem > 0 && delta > 0.0f) {
        const uint8_t* bits = payload_slot(slot, payload_of(t)) + threadIdx.x * num_ac;
        embed_block<RN, RederiveIfCapped<Arith, (MINB > 1)>>(raw, m, WireBits{bits}, rem,
                                                             num_ac, delta);
      }
      store_rows(stego + block_offset(t.f, t.by, bx, h, w), w, raw);
      // re-extract from the quantized stego, still in registers
      uint32_t byte[RN];
      slot_bits<RN, Arith>(raw, m, delta, byte);
      write_packed<RN>(packed, byte, t.f, t.by, bx, h, bw, stripe_blocks, rows_pad);
    }
    __syncthreads();  // every thread is done with the slot before its refill
    if (++s == BUFS) s = 0;
  }
}

struct PipeArgs {
  const uint8_t* frames;
  const uint8_t* payload;
  uint8_t* stego;
  int* bpf;
  uint8_t* packed;
  int device, b, h, w, num_ac;
  long long cap, total_bits;
  int stripe_blocks, rows_pad;
  float delta;
  cudaStream_t stream;
};

template <int RN, class Arith, int BUFS, int MINB>
cudaError_t launch_pipe(const PipeArgs& a) {
  const auto kernel = qim_roundtrip_pipe_kernel<RN, Arith, BUFS, MINB>;
  const int slot = slot_bytes_of(a.num_ac);
  const int smem = BUFS * slot;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a.device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long chunks = (a.w / 8 + kThreads - 1) / kThreads;
  const long long tiles = static_cast<long long>(a.b) * (a.h / 8) * chunks;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(tiles < resident ? tiles : resident);
  if (grid == 0) return cudaSuccess;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.frames, a.payload, a.stego, a.bpf, a.packed, a.b, a.h, a.w, a.num_ac, a.cap,
      a.total_bits, a.stripe_blocks, a.rows_pad, a.delta, slot);
  return cudaGetLastError();
}

// The arithmetic by delta, as K4's launch picks it; the register cap at
// rn <= 2 only (above, MINB is 1 either way).
template <int RN, int BUFS>
cudaError_t launch_pipe_capped(bool capped, const PipeArgs& a) {
  const bool fast = a.delta >= kAddRoundMinDelta;
  if constexpr (RN <= 2) {
    if (capped)
      return fast ? launch_pipe<RN, ArithHopper, BUFS, pipe_minb(BUFS)>(a)
                  : launch_pipe<RN, ArithHopperSmallDelta, BUFS, pipe_minb(BUFS)>(a);
  }
  return fast ? launch_pipe<RN, ArithHopper, BUFS, 1>(a)
              : launch_pipe<RN, ArithHopperSmallDelta, BUFS, 1>(a);
}

template <int RN>
cudaError_t launch_pipe_bufs(int bufs, bool capped, const PipeArgs& a) {
  switch (bufs) {
    case 2: return launch_pipe_capped<RN, 2>(capped, a);
    case 3: return launch_pipe_capped<RN, 3>(capped, a);
    case 4: return launch_pipe_capped<RN, 4>(capped, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// As stegotpu_qim_roundtrip_packed (qim_stripe.cu), through a ring of
// `bufs` (2, 3 or 4) slots; `capped` 0 launches the build without the
// register cap of rn <= 2. bpf: (B,) int32, written by the kernel.
// Returns a cudaError_t.
int stegotpu_qim_roundtrip_pipe(const void* frames, const void* payload,
                                void* stego, void* bpf, void* packed,
                                int device, int bufs, int capped, int b, int h,
                                int w, int num_ac, long long total_bits, int stripe,
                                int rows_pad, float delta, void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PipeArgs a{static_cast<const uint8_t*>(frames),
                   static_cast<const uint8_t*>(payload),
                   static_cast<uint8_t*>(stego),
                   static_cast<int*>(bpf),
                   static_cast<uint8_t*>(packed),
                   device, b, h, w, num_ac,
                   static_cast<long long>(h / 8) * (w / 8) * num_ac, total_bits,
                   stripe / 8, rows_pad, delta,
                   static_cast<cudaStream_t>(stream)};
#define STEGOTPU_PIPE(RN) err = launch_pipe_bufs<RN>(bufs, capped != 0, a)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_PIPE)
#undef STEGOTPU_PIPE
  return static_cast<int>(err);
}

}  // extern "C"

// K13 qim_roundtrip_pipe_kernel<RN, Arith, BUFS, MINB> for Hopper (sm_90a),
// step (b) of its redesign: the ring on bulk asynchronous copies and
// mbarriers. A study source, not part of the kernel library: the
// library's K13 is ../qim_pipe.cu, the same function in a cp.async ring
// with the CTA's barrier, which this one lost to (PERF.md section 6). It
// has the library's C interface, so studies/stripe_cap.py builds it in
// place of ../qim_pipe.cu, holds it to the library byte for byte and
// times both, one build per producer form:
//
//   python -m stegotpu_torch.studies.stripe_cap \
//       --src bulk_t0=stegotpu_torch/csrc/pipe_bulk:STEGOTPU_K13_PRODUCER=0
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
// tile each: its 8 pixel rows and its blocks' num_ac payload bytes, each
// row and the payload placed at their global address modulo 16. Each slot
// has a `full` and an `empty` mbarrier. One producer thread fills a slot
// with Hopper's bulk asynchronous copies (cp.async.bulk, completing on the
// slot's `full` barrier by bytes): one copy per pixel row's whole 16-byte
// units and one for the payload's, so a tile costs the producer some ten
// instructions where a CTA-wide cp.async fill cost 512 and more. What the
// bulk copy cannot take (16-byte units only) goes through cp.async: an
// 8-byte row head or tail where W % 16 == 8, and the payload's ragged ends
// in 4-byte units, single bytes by ordinary loads, all before the
// producer's release. `full` completes on two arrivals, the producer's
// arrive.expect_tx of the tile's bulk bytes and the cp.async.mbarrier
// arrive that fires once its cp.async have landed, and on those bytes.
// The consumers (kThreads threads, one 8x8 block each) wait on `full` with
// the slot's phase parity, compute through the shared embed_block and
// slot_bits of qim_common.cuh, store from registers to global as K4 does,
// and each arrives on `empty`; the producer waits on `empty` before a
// refill. No __syncthreads() in the tile loop. Who produces is a build
// option, STEGOTPU_K13_PRODUCER (the A/B of warp specialisation, PERF.md
// section 6): 2 (the default) lane 0 of warp j % 4 fills the CTA's tile j
// between its own blocks, BUFS-1 tiles ahead, so the fills spread over
// the four warps and the prologue's go out side by side; 0 thread 0 fills
// every tile; 1 one thread of a 5th warp that computes no block.
//
// The arithmetic is K4's (ArithHopper at delta >= 2^-10, else
// ArithHopperSmallDelta; the matrix from the constant bank; the pixel
// re-derive where capped), and thread 0 of the tile that holds block row
// 0, chunk 0 of a frame writes its bits per frame, so a call is one
// launch and K13's outputs are K4's byte for byte by construction
// (chip_smoke.py phase 12, tests/test_torch_cuda.py).
//
// Bound on the H100: memory traffic, K4's bytes (studies/bounds.py
// "roundtrip_packed"). The ring overlaps the next tiles' loads with the
// compute of this one inside one CTA, where K4 relies on other CTAs of the
// SM to hide its loads. At 1080p B=8 a CTA walks about four tiles, so the
// ring is mostly prologue; at B=128 some 65. Build WITHOUT --use_fast_math
// (see qim_stripe.cu).

#include "qim_common.cuh"

#ifndef STEGOTPU_K13_PRODUCER
#define STEGOTPU_K13_PRODUCER 2
#endif

namespace {

constexpr int kRowBytes = 8 * kThreads;     // one tile row: kThreads blocks
constexpr int kRowStride = kRowBytes + 16;  // and its lead, the address mod 16
constexpr bool kWarpProducer = STEGOTPU_K13_PRODUCER == 1;
constexpr int kPipeThreads = kThreads + (kWarpProducer ? 32 : 0);

// Whether this consumer thread fills the CTA's tile j (no producer warp).
__device__ __forceinline__ bool fills(int j) {
  return threadIdx.x == (STEGOTPU_K13_PRODUCER == 2 ? 32 * (j % (kThreads / 32)) : 0);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// `bytes` (a multiple of 16) from 16-byte aligned global src to 16-byte
// aligned shared dst; completes on `bar` by its bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued has landed
// (.noinc: it is one of the arrivals the barrier was initialised with).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Bytes [lo, hi) of an address range of fewer than 32 bytes, copied by one
// thread: 4-byte cp.async where aligned, single bytes by ordinary loads
// and stores at the ends. dst and src share their address modulo 16.
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

// The bytes of one ring slot: 8 tile rows with their leads, then the
// payload of kThreads blocks with up to 15 bytes of lead.
constexpr int slot_bytes_of(int num_ac) {
  return 8 * kRowStride + ((kThreads * num_ac + 15 + 15) & ~15);
}

// The CTAs per SM that K13's capped build asks ptxas to fit at rn <= 2
// (num_ac <= 15): as many as give each thread K4's 64 registers (8 CTAs of
// 128 threads, 6 with the producer warp) where the ring's shared memory
// lets that many share an SM, else as many as it lets. An SM holds 228 KB
// of shared memory and reserves 1 KB a CTA, so at num_ac 15 a ring of 2,
// 3 or 4 slots fits 10, 7 or 5 CTAs: MINB 8, 7 and 5 (6, 6 and 5).
constexpr int kSmemPerSm = 228 * 1024;
constexpr int kSmemReservedPerCta = 1024;
constexpr int pipe_minb(int bufs) {
  const int by_smem =
      kSmemPerSm / (bufs * slot_bytes_of(15) + kSmemReservedPerCta + 16 * bufs);
  const int by_regs = 65536 / (kPipeThreads * 64);
  return by_smem < by_regs ? by_smem : by_regs;
}

// MINB is the CTAs per SM that __launch_bounds__ asks ptxas to fit:
// pipe_minb(BUFS) at rn <= 2 unless the launch asks for the build without
// the cap (MINB 1), the A/B of the cap (emitpipe_r4 --uncapped;
// chip_smoke.py phase 12, whose build line prints both builds' registers
// and spills).
template <int RN, class Arith, int BUFS, int MINB>
__global__ void __launch_bounds__(kPipeThreads, MINB)
qim_roundtrip_pipe_kernel(const uint8_t* __restrict__ frames,
                          const uint8_t* __restrict__ payload,
                          uint8_t* __restrict__ stego, int* __restrict__ bpf,
                          uint8_t* __restrict__ packed, int b, int h, int w,
                          int num_ac, long long cap, long long total_bits,
                          int stripe_blocks, int rows_pad, float delta,
                          int slot_bytes) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ uint64_t full[BUFS], empty[BUFS];
  const ConstDct m{};

  const int bw = w / 8, bh = h / 8;
  const int chunks = (bw + kThreads - 1) / kThreads;
  TileWalk step;
  step.start(gridDim.x, bh, chunks);

  if (threadIdx.x == 0) {
    for (int s = 0; s < BUFS; ++s) {
      mbar_init(&full[s], 2);  // the producer's two arrivals (fill below)
      mbar_init(&empty[s], kThreads);  // every consumer thread's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers exist before any thread waits on one

  // fill slot s with tile t: called by one thread, once `empty` let it
  auto fill = [&](const TileWalk& t, int s) {
    uint8_t* slot = ring + s * slot_bytes;
    uint64_t* bar = &full[s];
    const int nb = min(kThreads, bw - t.cx * kThreads);
    const uint8_t* src = frames + block_offset(t.f, t.by, t.cx * kThreads, h, w);
    const uint8_t* bits =
        payload + t.f * cap +
        (static_cast<long long>(t.by) * bw + static_cast<long long>(t.cx) * kThreads) *
            num_ac;
    // the payload: whole 16-byte units by one bulk copy, the ends by
    // copy_ragged, whose ordinary stores come before the release below
    const uintptr_t bs = reinterpret_cast<uintptr_t>(bits), be = bs + nb * num_ac;
    uintptr_t ba = (bs + 15) & ~uintptr_t{15}, bz = be & ~uintptr_t{15};
    if (ba >= bz) ba = bz = be;  // no whole 16-byte unit: all head
    uint8_t* bdst = slot + 8 * kRowStride + (bs & 15);
    copy_ragged(bdst, bits, bs, ba);
    copy_ragged(bdst, bits, bz, be);
    unsigned tx = static_cast<unsigned>(bz - ba);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uintptr_t rs = reinterpret_cast<uintptr_t>(src) + static_cast<uintptr_t>(r) * w;
      tx += static_cast<unsigned>(((rs + 8 * nb) & ~uintptr_t{15}) -
                                  ((rs + 15) & ~uintptr_t{15}));
    }
    // the slot's earlier reads and ordinary stores before the async copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive_expect_tx(bar, tx);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      // row r lands at its address mod 16 (rows and frames are 8-byte
      // aligned, so a row has at most an 8-byte head and tail)
      const uintptr_t rs = reinterpret_cast<uintptr_t>(src) + static_cast<uintptr_t>(r) * w;
      const uintptr_t re = rs + 8 * nb;
      const uintptr_t ra = (rs + 15) & ~uintptr_t{15}, rz = re & ~uintptr_t{15};
      uint8_t* row = slot + r * kRowStride + (rs & 15);
      if (ra < rz)
        bulk_copy(row + (ra - rs), reinterpret_cast<const void*>(ra),
                  static_cast<unsigned>(rz - ra), bar);
      if (rs < ra) cp_async8(row, reinterpret_cast<const void*>(rs));
      if (rz < re) cp_async8(row + (rz - rs), reinterpret_cast<const void*>(rz));
    }
    if (ba < bz)
      bulk_copy(bdst + (ba - bs), reinterpret_cast<const void*>(ba),
                static_cast<unsigned>(bz - ba), bar);
    cp_async_mbar_arrive(bar);  // the second arrival, once the cp.async land
  };

  if constexpr (kWarpProducer) {
    if (threadIdx.x >= kThreads) {  // the producer warp: one thread fills
      if (threadIdx.x == kThreads) {
        TileWalk t;
        t.start(blockIdx.x, bh, chunks);
        for (int s = 0, phase = 0; t.f < b; t.next(step, bh, chunks)) {
          mbar_wait(&empty[s], phase ^ 1);  // passes at once on a slot's first use
          fill(t, s);
          if (++s == BUFS) s = 0, phase ^= 1;
        }
      }
      return;
    }
  }
  // a consumer thread as the producer of tile j (fills): BUFS-1 tiles in
  // flight before the first compute, then one more (into the slot tile
  // k-1 frees) before tile k. Every thread walks `ahead`, so each knows
  // the next tile and its slot.
  TileWalk ahead;
  int ps = 0, pphase = 0, j = 0;
  if constexpr (!kWarpProducer) {
    ahead.start(blockIdx.x, bh, chunks);
    for (; ps < BUFS - 1 && ahead.f < b; ++ps, ++j) {  // each slot's first use
      if (fills(j)) fill(ahead, ps);
      ahead.next(step, bh, chunks);
    }
  }

  TileWalk t;
  t.start(blockIdx.x, bh, chunks);
  for (int s = 0, phase = 0; t.f < b; t.next(step, bh, chunks)) {
    if constexpr (!kWarpProducer) {
      if (ahead.f < b) {
        if (fills(j)) {
          mbar_wait(&empty[ps], pphase ^ 1);
          fill(ahead, ps);
        }
        ahead.next(step, bh, chunks);
        ++j;
        if (++ps == BUFS) ps = 0, pphase ^= 1;
      }
    }
    if (t.by == 0 && t.cx == 0 && threadIdx.x == 0)
      bpf[t.f] = frame_bits_clamp(total_bits - t.f * cap, cap);  // no bit offset

    mbar_wait(&full[s], phase);
    const uint8_t* slot = ring + s * slot_bytes;
    const int bx = t.cx * kThreads + threadIdx.x;
    if (bx < bw) {
      const uint8_t* src = frames + block_offset(t.f, t.by, t.cx * kThreads, h, w);
      uint2 raw[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uintptr_t lead = (reinterpret_cast<uintptr_t>(src) + static_cast<uintptr_t>(r) * w) & 15;
        raw[r] = *reinterpret_cast<const uint2*>(slot + r * kRowStride + lead +
                                                 8 * threadIdx.x);
      }
      const long long blk = static_cast<long long>(t.by) * bw + bx;
      const long long rem = total_bits - t.f * cap - blk * num_ac;  // no bit offset
      if (rem > 0 && delta > 0.0f) {
        const uintptr_t bits = reinterpret_cast<uintptr_t>(payload + t.f * cap + (blk - threadIdx.x) * num_ac);
        embed_block<RN, RederiveIfCapped<Arith, (MINB > 1)>>(
            raw, m, WireBits{slot + 8 * kRowStride + (bits & 15) + threadIdx.x * num_ac}, rem,
            num_ac, delta);
      }
      mbar_arrive(&empty[s]);  // this thread is done with the slot
      store_rows(stego + block_offset(t.f, t.by, bx, h, w), w, raw);
      // re-extract from the quantized stego, still in registers
      uint32_t byte[RN];
      slot_bits<RN, Arith>(raw, m, delta, byte);
      write_packed<RN>(packed, byte, t.f, t.by, bx, h, bw, stripe_blocks, rows_pad);
    } else {
      mbar_arrive(&empty[s]);
    }
    if (++s == BUFS) s = 0, phase ^= 1;
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPipeThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long chunks = (a.w / 8 + kThreads - 1) / kThreads;
  const long long tiles = static_cast<long long>(a.b) * (a.h / 8) * chunks;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(tiles < resident ? tiles : resident);
  if (grid == 0) return cudaSuccess;
  kernel<<<grid, kPipeThreads, smem, a.stream>>>(
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

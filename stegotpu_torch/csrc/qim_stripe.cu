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
// (slot_bits), defined in qim_common.cuh with the study kernels of
// qim_study.cu, as the TPU kernels share _embed_core and _extract_bits_f32:
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
//
// All six kernels are designed for Hopper: K1 and K2, the main path's
// kernels, K3 and K4, the verified embed's and the bench's, and K5 and
// K6, the exactness harness's unpacked extract and the fused unpacked
// round trip; only the study kernels K9 and K10 keep the first design's
// conversion spelling. What held the first design back was
// instruction throughput, not bytes: every u8 pixel became a float on the
// conversion pipe (16 results a clock an SM against FADD's 128), every
// slot rounded with FRND and converted back, every FMA took its matrix
// operand from shared memory behind a barrier, each slot loaded its
// payload byte inside its own branch, and the wrappers added five small
// device ops for the bits per frame. Now (the ArithHopper spelling of
// qim_common.cuh, the same bytes): the matrix comes from the constant bank
// (dct8_f32.cuh), conversions and rounding are FADDs and PRMTs, the
// payload bits load before the first slot (K3 holds them in registers for
// its count too), each embedding kernel writes the bits per frame itself
// (one launch is the whole call; K3's counts are zeroed by one memset
// before it), and at num_ac <= 15 a register cap (__launch_bounds__ MINB)
// lets more of K1's, K3's, K4's and K6's CTAs fit an SM. K5 and K6 write
// 8x K2's and K4's extract bytes (one u8 a lane): their bits spread to
// lanes by two integer multiplies a slot row (write_rows).

#include "qim_common.cuh"

namespace {

// The CTAs per SM that K1's, K3's, K4's and K6's builds ask ptxas to fit
// at rn <= 2 (1: no cap). 8 gives each 64 registers and no spill. At 1080p
// B=8 it takes 23% less time than no cap in K1 (134 registers; 9 spills
// 16 B, 10 spills 48 B and is slower), 11% less in K3 (152) and 13% less
// in K4 (136). studies/stripe_cap.py rebuilds this source with
// -DSTEGOTPU_K1_MINB=<n> (K3_MINB, K4_MINB, K6_MINB) for the A/B. In K6
// the cap takes 14% less time than none (138 registers); 9 CTAs spill
// 24 B and are slower. K2 and K5 need only 40 registers and have no cap:
// at 16 CTAs (32 registers) K2 spills 24 B and is slower.
#ifndef STEGOTPU_K1_MINB
#define STEGOTPU_K1_MINB 8
#endif
// K3's cap holds for its repair variant too: at 4K B=128 on scope covers
// 6 CTAs (80 registers, no spill) take 8% more time than 8 (64
// registers, 48 B spilled).
#ifndef STEGOTPU_K3_MINB
#define STEGOTPU_K3_MINB 8
#endif
#ifndef STEGOTPU_K4_MINB
#define STEGOTPU_K4_MINB 8
#endif
#ifndef STEGOTPU_K6_MINB
#define STEGOTPU_K6_MINB 8
#endif

// K1-K6 take the Hopper arithmetic (qim_common.cuh): the matrix from the
// constant bank, no barrier, and at delta >= 2^-10 no conversion
// instruction (ArithHopper; the launch takes ArithHopperSmallDelta, with
// rintf/floorf, below it). MINB is the CTAs per SM that __launch_bounds__
// asks ptxas to fit, as K13's MINB is: capped_minb(RN, ...).
template <int RN, class Arith, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
qim_embed_kernel(const uint8_t* __restrict__ frames,
                 const uint8_t* __restrict__ payload,
                 uint8_t* __restrict__ stego, int* __restrict__ bpf, int h, int w,
                 int num_ac, long long cap, long long total_bits,
                 long long bit_offset, float delta) {
  const ConstDct m{};
  const int f = blockIdx.z;
  frame_bits(bpf, f, total_bits - bit_offset - f * cap, cap);

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  const int by = blockIdx.y;
  const long long blk = static_cast<long long>(by) * bw + bx;
  // payload bits left at this block's first slot (global bit indices)
  const long long rem = total_bits - bit_offset - f * cap - blk * num_ac;
  const size_t off = block_offset(f, by, bx, h, w);

  uint2 raw[8];
  load_rows(frames + off, w, raw);
  if (rem > 0 && delta > 0.0f)  // else never entered, or delta <= 0: passthrough
    embed_block<RN, RederiveIfCapped<Arith, (MINB > 1)>>(
        raw, m, WireBits{payload + f * cap + blk * num_ac}, rem, num_ac, delta);
  store_rows(stego + off, w, raw);
}

template <int RN, class Arith>
__global__ void __launch_bounds__(kThreads)
qim_extract_packed_kernel(const uint8_t* __restrict__ frames,
                          uint8_t* __restrict__ packed, int h, int w,
                          int stripe_blocks, int rows_pad, float delta) {
  const ConstDct m{};
  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  const int by = blockIdx.y;
  const int f = blockIdx.z;

  uint2 raw[8];
  load_rows(frames + block_offset(f, by, bx, h, w), w, raw);
  uint32_t byte[RN];
  slot_bits<RN, Arith>(raw, m, delta, byte);
  write_packed<RN>(packed, byte, f, by, bx, h, bw, stripe_blocks, rows_pad);
}

// K5 is K2 with one u8 a lane: the same decode, and 8x the output bytes.
// Its bound on the H100 is its bytes (21 MB at 1080p B=8, 6.27 us at 3.35
// TB/s), but what holds it back is instruction issue, as in K2: so it
// takes K2's Hopper arithmetic and constant-bank matrix, and spreads each
// slot row to its 8 lanes with two multiplies (write_rows). No register
// cap: it needs K2's 40 registers.
template <int RN, class Arith>
__global__ void __launch_bounds__(kThreads)
qim_extract_rows_kernel(const uint8_t* __restrict__ frames,
                        uint8_t* __restrict__ rows, int h, int w,
                        int stripe_blocks, int rows_pad, float delta) {
  const ConstDct m{};
  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  const int by = blockIdx.y;
  const int f = blockIdx.z;

  uint2 raw[8];
  load_rows(frames + block_offset(f, by, bx, h, w), w, raw);
  uint32_t byte[RN];
  slot_bits<RN, Arith>(raw, m, delta, byte);
  write_rows<RN>(rows, byte, f, by, bx, h, w, stripe_blocks, rows_pad);
}

template <int RN, class Arith, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
qim_roundtrip_packed_kernel(const uint8_t* __restrict__ frames,
                            const uint8_t* __restrict__ payload,
                            uint8_t* __restrict__ stego, int* __restrict__ bpf,
                            uint8_t* __restrict__ packed, int h, int w,
                            int num_ac, long long cap, long long total_bits,
                            int stripe_blocks, int rows_pad, float delta) {
  const ConstDct m{};
  const int f = blockIdx.z;
  frame_bits(bpf, f, total_bits - f * cap, cap);  // no bit offset

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  const int by = blockIdx.y;
  const long long blk = static_cast<long long>(by) * bw + bx;
  const long long rem = total_bits - f * cap - blk * num_ac;
  const size_t off = block_offset(f, by, bx, h, w);

  uint2 raw[8];
  load_rows(frames + off, w, raw);
  if (rem > 0 && delta > 0.0f)
    embed_block<RN, RederiveIfCapped<Arith, (MINB > 1)>>(
        raw, m, WireBits{payload + f * cap + blk * num_ac}, rem, num_ac, delta);
  store_rows(stego + off, w, raw);
  // re-extract from the quantized stego, still in registers
  uint32_t byte[RN];
  slot_bits<RN, Arith>(raw, m, delta, byte);
  write_packed<RN>(packed, byte, f, by, bx, h, bw, stripe_blocks, rows_pad);
}

// K6 is K4 with K5's output: K1's embed, then K5's decode of the
// quantized stego still in registers. Its bound on the H100 is its bytes
// (40 MB at 1080p B=8, 12.00 us), but what holds it back is instruction
// issue and occupancy, as in K4: so it takes K4's arithmetic and its
// register cap (STEGOTPU_K6_MINB), and writes the bits per frame itself,
// so a call is one launch.
template <int RN, class Arith, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
qim_roundtrip_rows_kernel(const uint8_t* __restrict__ frames,
                          const uint8_t* __restrict__ payload,
                          uint8_t* __restrict__ stego, int* __restrict__ bpf,
                          uint8_t* __restrict__ rows, int h, int w,
                          int num_ac, long long cap, long long total_bits,
                          int stripe_blocks, int rows_pad, float delta) {
  const ConstDct m{};
  const int f = blockIdx.z;
  frame_bits(bpf, f, total_bits - f * cap, cap);  // no bit offset

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bw) return;
  const int by = blockIdx.y;
  const long long blk = static_cast<long long>(by) * bw + bx;
  const long long rem = total_bits - f * cap - blk * num_ac;
  const size_t off = block_offset(f, by, bx, h, w);

  uint2 raw[8];
  load_rows(frames + off, w, raw);
  if (rem > 0 && delta > 0.0f)
    embed_block<RN, RederiveIfCapped<Arith, (MINB > 1)>>(
        raw, m, WireBits{payload + f * cap + blk * num_ac}, rem, num_ac, delta);
  store_rows(stego + off, w, raw);
  // re-extract from the quantized stego, still in registers
  uint32_t byte[RN];
  slot_bits<RN, Arith>(raw, m, delta, byte);
  write_rows<RN>(rows, byte, f, by, bx, h, w, stripe_blocks, rows_pad);
}

// errors: (B,) int32, zeroed by the entry point on the launch stream.
// Blocks of the GPU grid run in no order, so there is no sequential axis
// to carry a sum along (the TPU kernel's stripe axis): each warp sums its
// threads' counts and adds them to its frame's slot with one atomic.
// Integer sums are exact, so the count does not depend on the order of
// the atomics. The block's payload bytes are loaded once, into registers
// (HeldBits), for the embed and the count alike.
template <int RN, class Arith, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
qim_embed_check_kernel(const uint8_t* __restrict__ frames,
                       const uint8_t* __restrict__ payload,
                       uint8_t* __restrict__ stego, int* __restrict__ bpf,
                       int* __restrict__ errors, int h, int w, int num_ac,
                       long long cap, long long total_bits, float delta) {
  const ConstDct m{};
  const int f = blockIdx.z;
  frame_bits(bpf, f, total_bits - f * cap, cap);  // no bit offset

  const int bw = w / 8;
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  const int by = blockIdx.y;
  int count = 0;
  if (bx < bw) {  // no early return: the whole warp takes part in the sum
    const long long blk = static_cast<long long>(by) * bw + bx;
    const long long rem = total_bits - f * cap - blk * num_ac;
    const size_t off = block_offset(f, by, bx, h, w);

    uint2 raw[8];
    load_rows(frames + off, w, raw);
    HeldBits<RN> bits;  // read only where rem > 0
    if (rem > 0) bits.load(payload + f * cap + blk * num_ac, num_ac);
    if (rem > 0 && delta > 0.0f)
      embed_block<RN, RederiveIfCapped<Arith, (MINB > 1)>>(raw, m, bits, rem,
                                                           num_ac, delta);
    store_rows(stego + off, w, raw);
    if (rem > 0) {  // blocks never entered hold no valid slot
      // re-extract from the quantized stego, still in registers; with
      // delta <= 0 every valid slot reads 0
      uint32_t byte[RN];
      slot_bits<RN, Arith>(raw, m, delta, byte);
#pragma unroll
      for (int g = 0; g < RN; ++g)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int c = g * 8 + v;
          if (c >= 1 && c <= num_ac && c - 1 < rem)
            count += ((byte[g] >> v) & 1u) != bits(c - 1);
        }
    }
  }
  count = __reduce_add_sync(0xFFFFFFFFu, count);
  if ((threadIdx.x & 31) == 0 && count != 0) atomicAdd(errors + f, count);
}

// The valid slots of a block that the quantized stego in raw reads wrong:
// K3's count.
template <int RN, class Arith, class Mat, class Bits>
__device__ __forceinline__ int wrong_slots(const uint2 (&raw)[8], Mat m, float delta,
                                           const Bits& bits, long long rem, int num_ac) {
  uint32_t byte[RN];
  slot_bits<RN, Arith>(raw, m, delta, byte);
  int count = 0;
#pragma unroll
  for (int g = 0; g < RN; ++g)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int c = g * 8 + v;
      if (c >= 1 && c <= num_ac && c - 1 < rem) count += ((byte[g] >> v) & 1u) != bits(c - 1);
    }
  return count;
}

// The repair rule of the plain loop (ops/verified._repair) in pixels: lift
// the block out of the floor but never past the ceiling, or the reverse.
// lo, hi: its least and greatest pixel before the clip.
__device__ __forceinline__ float shift_rule(float lo, float hi) {
  const float up = fminf(fmaxf(-lo, 0.0f), fmaxf(__fsub_rn(255.0f, hi), 0.0f));
  const float down = -fminf(fmaxf(__fsub_rn(hi, 255.0f), 0.0f), fmaxf(lo, 0.0f));
  return lo < 0.0f ? up : down;
}

// The rounds of one block that reads wrong, from its first shift: derive
// the block again from the cover's rows (the same embed, the cumulative
// shift added to every pixel before the clip and the truncation), read it
// again, and while a valid slot reads wrong and rounds remain, add the
// rule's shift once more. A block that reads right stops: nothing of it
// would change in a later round. raw: the last round's stego; ran: the
// rounds run; returns the valid slots still wrong.
template <int RN, class A, class Mat, class Bits>
__device__ __forceinline__ int repair_rounds(uint2 (&raw)[8], const uint8_t* __restrict__ cover,
                                             int w, Mat m, const Bits& bits, long long rem,
                                             int num_ac, float delta, int rounds, float px,
                                             int& ran) {
  DcShift shift;
  shift.px = px;
  for (ran = 1;; ++ran) {
    load_rows(cover, w, raw);
    shift.reset();
    embed_block<RN, A>(raw, m, bits, rem, num_ac, delta, &shift);
    const int wrong = wrong_slots<RN, A>(raw, m, delta, bits, rem, num_ac);
    if (wrong == 0 || ran == rounds) return wrong;
    shift.px = __fadd_rn(shift.px, shift_rule(shift.lo, shift.hi));
  }
}

// K3's repair variant: the verified embed (ops/verified.py) as one kernel.
// Each thread first owns one block, as in K3: it embeds (K1's arithmetic,
// the difference form), keeps the least and greatest pixel before the clip,
// re-extracts the truncated stego in registers and compares the valid
// slots with the payload bits it holds (HeldBits). A block that reads
// right is stored. A block that reads wrong, while rounds remain, takes
// the repair rule of the plain loop on its own pixels (repair_rounds): no
// value crosses blocks, so no block waits for another and only the final
// rows go to memory. With repair_rounds 0 nothing is repaired, and the
// stego and the count are K3's. Blocks with rem <= 0 pass through; with
// delta <= 0 the block passes through and is counted, as in K3.
//
// The blocks that read wrong are dealt out again before their rounds: the
// CTA lists them in order in shared memory, with their first shift, and
// its first threads take one each, so that a CTA whose blocks mostly read
// right repairs in one warp, not in all of them (were each thread to
// repair its own block, a warp would take as many passes as its worst
// block, and 99.9% of the warps of a scope batch hold one: 22% slower at
// 4K B=128).
//
// residual: an int32 scalar, zeroed by the entry point on the launch
// stream: the valid slots still wrong after the last round. counts:
// 3 int64 that only grow, a warp's counts added once: the blocks that read wrong
// after the embed, the repair rounds run summed over blocks, the residual
// slots. Bound on the H100: K3's bytes; each round a block takes adds an
// embed and a read of that block in registers, and a read of its cover's
// rows and payload bytes (in L2).
template <int RN, class Arith, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
qim_embed_repair_kernel(const uint8_t* __restrict__ frames,
                        const uint8_t* __restrict__ payload,
                        uint8_t* __restrict__ stego, int* __restrict__ bpf,
                        int* __restrict__ residual,
                        unsigned long long* __restrict__ counts, int h, int w,
                        int num_ac, long long cap, long long total_bits,
                        float delta, int rounds) {
  using A = RederiveIfCapped<Arith, (MINB > 1)>;
  const ConstDct m{};
  const int f = blockIdx.z;
  frame_bits(bpf, f, total_bits - f * cap, cap);  // no bit offset

  const int bw = w / 8;
  const int by = blockIdx.y;
  const int x0 = blockIdx.x * blockDim.x;
  int wrong = 0, bad = 0, ran = 0;
  bool repair = false;
  float px = 0.0f;  // a block that reads wrong: its first shift
  if (x0 + threadIdx.x < bw) {  // no early return: every thread meets the barriers
    const int bx = x0 + threadIdx.x;
    const long long blk = static_cast<long long>(by) * bw + bx;
    const long long rem = total_bits - f * cap - blk * num_ac;
    const size_t off = block_offset(f, by, bx, h, w);

    uint2 raw[8];
    load_rows(frames + off, w, raw);
    if (rem > 0) {  // blocks never entered pass through and hold no valid slot
      HeldBits<RN> bits;
      bits.load(payload + f * cap + blk * num_ac, num_ac);
      DcRange range;  // no shift: K3's stego, and the block's range
      range.reset();
      if (delta > 0.0f) embed_block<RN, A>(raw, m, bits, rem, num_ac, delta, &range);
      wrong = wrong_slots<RN, A>(raw, m, delta, bits, rem, num_ac);
      bad = wrong != 0;
      repair = bad && rounds > 0 && delta > 0.0f;
      if (repair) px = shift_rule(range.lo, range.hi);
    }
    if (!repair) store_rows(stego + off, w, raw);
  }
  // deal the blocks that read wrong out again, in order: thread i of the
  // CTA takes the i-th of them (a CTA whose blocks all read right is done)
  __shared__ int warp_todo[kThreads / 32];
  __shared__ unsigned char who[kThreads];
  __shared__ float first[kThreads];
  if (__syncthreads_or(repair)) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, repair);
    if (lane == 0) warp_todo[warp] = __popc(mask);
    __syncthreads();
    int todo = 0, at = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      at += i < warp ? warp_todo[i] : 0;
      todo += warp_todo[i];
    }
    if (repair) {
      at += __popc(mask & ((1u << lane) - 1u));
      who[at] = static_cast<unsigned char>(threadIdx.x);
      first[at] = px;
      wrong = 0;  // the thread that takes the block counts it
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < todo) {
      const int bx = x0 + who[threadIdx.x];
      const long long blk = static_cast<long long>(by) * bw + bx;
      const long long rem = total_bits - f * cap - blk * num_ac;
      const size_t off = block_offset(f, by, bx, h, w);
      HeldBits<RN> bits;
      bits.load(payload + f * cap + blk * num_ac, num_ac);
      uint2 raw[8];
      wrong += repair_rounds<RN, A>(raw, frames + off, w, m, bits, rem, num_ac, delta, rounds,
                                    first[threadIdx.x], ran);
      store_rows(stego + off, w, raw);
    }
  }
  wrong = __reduce_add_sync(0xFFFFFFFFu, wrong);
  bad = __reduce_add_sync(0xFFFFFFFFu, bad);
  ran = __reduce_add_sync(0xFFFFFFFFu, ran);
  if ((threadIdx.x & 31) == 0) {
    if (wrong != 0) atomicAdd(residual, wrong);
    if (bad != 0) atomicAdd(counts, static_cast<unsigned long long>(bad));
    if (ran != 0) atomicAdd(counts + 1, static_cast<unsigned long long>(ran));
    if (wrong != 0) atomicAdd(counts + 2, static_cast<unsigned long long>(wrong));
  }
}

}  // namespace

extern "C" {

// frames, stego: (B, H, W) u8; payload: (B, cap) u8, cap = (H/8)(W/8)num_ac;
// bpf: (B,) int32, each frame's payload bits, written by the kernel. Each
// entry point returns a cudaError_t.
int stegotpu_qim_embed(const void* frames, const void* payload, void* stego,
                       void* bpf, int device, int b, int h, int w, int num_ac,
                       long long total_bits, long long bit_offset, float delta,
                       void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) {
    kernel<<<grid_of(b, h, w), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload),
        static_cast<uint8_t*>(stego), static_cast<int*>(bpf), h, w, num_ac, cap,
        total_bits, bit_offset, delta);
  };
  const bool fast = delta >= kAddRoundMinDelta;
#define STEGOTPU_EMBED(RN)                                               \
  launch(fast ? qim_embed_kernel<RN, ArithHopper,                         \
                                 capped_minb(RN, STEGOTPU_K1_MINB)>       \
              : qim_embed_kernel<RN, ArithHopperSmallDelta,               \
                                 capped_minb(RN, STEGOTPU_K1_MINB)>)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_EMBED)
#undef STEGOTPU_EMBED
  return static_cast<int>(cudaGetLastError());
}

// frames: (B, H, W) u8; packed: (B, (H/stripe)*rows_pad, W/8) u8.
int stegotpu_qim_extract_packed(const void* frames, void* packed, int device,
                                int b, int h, int w, int num_ac, int stripe,
                                int rows_pad, float delta, void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) {
    kernel<<<grid_of(b, h, w), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(frames), static_cast<uint8_t*>(packed), h, w,
        stripe / 8, rows_pad, delta);
  };
  const bool fast = delta >= kAddRoundMinDelta;
#define STEGOTPU_EXTRACT(RN)                                    \
  launch(fast ? qim_extract_packed_kernel<RN, ArithHopper>     \
              : qim_extract_packed_kernel<RN, ArithHopperSmallDelta>)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_EXTRACT)
#undef STEGOTPU_EXTRACT
  return static_cast<int>(cudaGetLastError());
}

// frames: (B, H, W) u8; rows: (B, (H/stripe)*rows_pad, W) u8.
int stegotpu_qim_extract_rows(const void* frames, void* rows, int device,
                              int b, int h, int w, int num_ac, int stripe,
                              int rows_pad, float delta, void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) {
    kernel<<<grid_of(b, h, w), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(frames), static_cast<uint8_t*>(rows), h, w,
        stripe / 8, rows_pad, delta);
  };
  const bool fast = delta >= kAddRoundMinDelta;
#define STEGOTPU_ROWS(RN)                                      \
  launch(fast ? qim_extract_rows_kernel<RN, ArithHopper>      \
              : qim_extract_rows_kernel<RN, ArithHopperSmallDelta>)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_ROWS)
#undef STEGOTPU_ROWS
  return static_cast<int>(cudaGetLastError());
}

// frames, stego: (B, H, W) u8; payload: (B, cap) u8; bpf as for
// stegotpu_qim_embed; packed as for stegotpu_qim_extract_packed. Global
// bit 0 is the payload's first bit.
int stegotpu_qim_roundtrip_packed(const void* frames, const void* payload,
                                  void* stego, void* bpf, void* packed,
                                  int device, int b, int h, int w, int num_ac,
                                  long long total_bits, int stripe,
                                  int rows_pad, float delta, void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) {
    kernel<<<grid_of(b, h, w), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload),
        static_cast<uint8_t*>(stego), static_cast<int*>(bpf),
        static_cast<uint8_t*>(packed), h, w, num_ac, cap, total_bits,
        stripe / 8, rows_pad, delta);
  };
  const bool fast = delta >= kAddRoundMinDelta;
#define STEGOTPU_ROUNDTRIP(RN)                                           \
  launch(fast ? qim_roundtrip_packed_kernel<RN, ArithHopper,            \
                                            capped_minb(RN, STEGOTPU_K4_MINB)> \
              : qim_roundtrip_packed_kernel<RN, ArithHopperSmallDelta,  \
                                            capped_minb(RN, STEGOTPU_K4_MINB)>)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_ROUNDTRIP)
#undef STEGOTPU_ROUNDTRIP
  return static_cast<int>(cudaGetLastError());
}

// frames, stego: (B, H, W) u8; payload: (B, cap) u8; bpf as for
// stegotpu_qim_embed; rows as for stegotpu_qim_extract_rows. Global bit 0
// is the payload's first bit.
int stegotpu_qim_roundtrip_rows(const void* frames, const void* payload,
                                void* stego, void* bpf, void* rows, int device,
                                int b, int h, int w, int num_ac,
                                long long total_bits, int stripe, int rows_pad,
                                float delta, void* stream) {
  const cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) {
    kernel<<<grid_of(b, h, w), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload),
        static_cast<uint8_t*>(stego), static_cast<int*>(bpf),
        static_cast<uint8_t*>(rows), h, w, num_ac, cap, total_bits,
        stripe / 8, rows_pad, delta);
  };
  const bool fast = delta >= kAddRoundMinDelta;
#define STEGOTPU_ROUNDTRIP_ROWS(RN)                                     \
  launch(fast ? qim_roundtrip_rows_kernel<RN, ArithHopper,             \
                                          capped_minb(RN, STEGOTPU_K6_MINB)> \
              : qim_roundtrip_rows_kernel<RN, ArithHopperSmallDelta,   \
                                          capped_minb(RN, STEGOTPU_K6_MINB)>)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_ROUNDTRIP_ROWS)
#undef STEGOTPU_ROUNDTRIP_ROWS
  return static_cast<int>(cudaGetLastError());
}

// frames, stego: (B, H, W) u8; payload: (B, cap) u8; bpf as for
// stegotpu_qim_embed; errors: (B,) int32, zeroed here on `stream` before
// the launch. Global bit 0 is the payload's first bit.
int stegotpu_qim_embed_check(const void* frames, const void* payload,
                             void* stego, void* bpf, void* errors, int device,
                             int b, int h, int w, int num_ac,
                             long long total_bits, float delta, void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(errors, 0, sizeof(int) * b, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto launch = [&](auto kernel) {
    kernel<<<grid_of(b, h, w), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload),
        static_cast<uint8_t*>(stego), static_cast<int*>(bpf),
        static_cast<int*>(errors), h, w, num_ac, cap, total_bits, delta);
  };
  const bool fast = delta >= kAddRoundMinDelta;
#define STEGOTPU_CHECK(RN)                                               \
  launch(fast ? qim_embed_check_kernel<RN, ArithHopper,                 \
                                       capped_minb(RN, STEGOTPU_K3_MINB)> \
              : qim_embed_check_kernel<RN, ArithHopperSmallDelta,       \
                                       capped_minb(RN, STEGOTPU_K3_MINB)>)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_CHECK)
#undef STEGOTPU_CHECK
  return static_cast<int>(cudaGetLastError());
}

// frames, stego: (B, H, W) u8; payload: (B, cap) u8; bpf as for
// stegotpu_qim_embed; residual: an int32 scalar, zeroed here on `stream`
// before the launch; counts: 3 int64, added to and never zeroed
// here; rounds >= 0. Global bit 0 is the payload's first bit.
int stegotpu_qim_embed_repair(const void* frames, const void* payload,
                              void* stego, void* bpf, void* residual,
                              void* counts, int device, int b, int h, int w,
                              int num_ac, long long total_bits, float delta,
                              int rounds, void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rounds < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long cap = static_cast<long long>(h / 8) * (w / 8) * num_ac;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(residual, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto launch = [&](auto kernel) {
    kernel<<<grid_of(b, h, w), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(frames), static_cast<const uint8_t*>(payload),
        static_cast<uint8_t*>(stego), static_cast<int*>(bpf),
        static_cast<int*>(residual), static_cast<unsigned long long*>(counts),
        h, w, num_ac, cap, total_bits, delta, rounds);
  };
  const bool fast = delta >= kAddRoundMinDelta;
#define STEGOTPU_REPAIR(RN)                                               \
  launch(fast ? qim_embed_repair_kernel<RN, ArithHopper,                 \
                                        capped_minb(RN, STEGOTPU_K3_MINB)> \
              : qim_embed_repair_kernel<RN, ArithHopperSmallDelta,       \
                                        capped_minb(RN, STEGOTPU_K3_MINB)>)
  STEGOTPU_RN_SWITCH(num_ac / 8 + 1, STEGOTPU_REPAIR)
#undef STEGOTPU_REPAIR
  return static_cast<int>(cudaGetLastError());
}

const char* stegotpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

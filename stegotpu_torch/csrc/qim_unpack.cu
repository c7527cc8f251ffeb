// The wire-order unpack of the packed compact rows for Hopper (sm_90a), with
// a plain C interface bound by ctypes (stegotpu_torch/ops/_build.py,
// ops/stripe_kernel.py packed_rows_to_bits).
//
// qim_unpack_kernel replaces no Pallas kernel: the JAX package unpacks in
// XLA ops (stegotpu/ops/pallas_kernel.py:217, packed_rows_to_bits), and the
// port's plain version (ops/stripe_kernel.packed_rows_to_bits_plain) spreads
// every packed byte to 8 lanes with a broadcast shift and a mask, then
// gathers the slot lanes of each slot row with strided slices and a cat:
// some 1.2 GB of traffic at 4K B=128 to write 166 MB. This kernel takes
// K2's and K4's packed rows (B, (H/stripe)*rows_pad, W/8) u8, where byte
// (f, jg*rows_pad + i*rn + g, bx) holds bit s of slot 8g+s-1 of block
// (jg*stripe/8 + i, bx), to the (B, C) wire-order bits, C =
// (H/8)(W/8)num_ac, in one pass: byte (f, ((jg*stripe/8 + i)*(W/8) + bx)*
// num_ac + 8g + s - 1) of the output is that bit, for the slots s of
// _slot_span(g, num_ac). Padding rows are never read.
//
// Bound on the H100: bytes. The least traffic reads each slot-row byte once
// and writes each wire byte once (259,200 + 1,296,000 B a 4K frame at
// num_ac 10: 59.4 us for 128 frames at 3.35 TB/s), against a few integer
// operations an output byte. Design: within a stripe group the slot rows of
// consecutive block rows are one contiguous run of input, and they expand to
// one contiguous run of output. A tile is such a run of up to
// rows_per_tile block rows (at most kTileInBytes of input; one stripe group
// at 4K and 1080p, num_ac 10). A persistent grid walks the tiles
// grid-stride; each CTA stages its next tile into shared memory with 16-byte
// cp.async while it unpacks the current one (a ring of two buffers; the
// ragged ends of a tile go byte by byte, so any input alignment takes the
// vector path). A thread then takes 16 output bytes at a time: the 16
// consecutive slot bits come from the at most 16 blocks they cover (each
// block's rn slot-row bytes as one word, shifted past its DC bit and masked
// to num_ac bits), and the multiply (nibble * 0x00204081) & 0x01010101
// spreads each four bits to four bytes, so the thread writes one 16-byte
// vector, neighbouring threads on neighbouring addresses. Where a chunk
// starts follows from one multiply by a reciprocal computed once a launch,
// never a division a byte. The store width follows the shape: 16-byte stores
// where every output row starts on a 16-byte boundary ((W/8)*num_ac % 16 ==
// 0 and an aligned base: 4K, 1080p, 720p at num_ac 3), else single bytes,
// the same bytes (STORE, chosen by the wrapper from what it is given).

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// most input bytes of one tile (a buffer of the ring holds one tile)
constexpr int kTileInBytes = 16 * 1024;

struct UnpackShape {
  int bw;               // W/8: bytes of a slot row, blocks of a block row
  int bh_s;             // block rows of a stripe group
  int num_ac;
  int rows_pad;         // packed rows of a stripe group, padding included
  int rows_per_tile;    // block rows of a whole tile
  int tiles_per_group;
  int tiles;            // of the whole batch
  int row_bits;         // output bytes of a block row: bw * num_ac
  int buf_bytes;        // one buffer of the ring, a multiple of 16
  unsigned long long div_ac, div_bw;  // reciprocals of num_ac and bw
};

// floor(x / d) for the reciprocal m = 2^40 / d + 1: exact while x * d < 2^40
// (in a tile x < 2^22 and d < 2^16)
unsigned long long reciprocal(unsigned d) {
  return (1ull << 40) / d + 1;
}

__device__ __forceinline__ unsigned div_by(unsigned x, unsigned long long m) {
  return static_cast<unsigned>((static_cast<unsigned long long>(x) * m) >> 40);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
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

// One tile: its input run, and where its output run starts.
struct Tile {
  const uint8_t* src;
  int n_in;       // input bytes: rows * RN * bw
  int n_out;      // output bytes: rows * row_bits
  long long out;  // offset of the output run in the (B, C) bits
};

template <int RN>
__device__ __forceinline__ Tile tile_at(int t, const UnpackShape& s,
                                        const uint8_t* packed) {
  const int fg = t / s.tiles_per_group;  // frame * groups + stripe group
  const int i0 = (t - fg * s.tiles_per_group) * s.rows_per_tile;
  const int rows = min(s.rows_per_tile, s.bh_s - i0);
  Tile tile;
  tile.src = packed + (static_cast<long long>(fg) * s.rows_pad +
                       static_cast<long long>(i0) * RN) * s.bw;
  tile.n_in = rows * RN * s.bw;
  tile.n_out = rows * s.row_bits;
  tile.out = (static_cast<long long>(fg) * s.bh_s + i0) * s.row_bits;
  return tile;
}

// Where a tile's input starts in its buffer: at the source's address modulo
// 16, so that the 16-byte vectors of the source land on 16-byte boundaries.
__device__ __forceinline__ int lead_of(const uint8_t* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
}

// Every thread: the tile's aligned 16-byte vectors by cp.async (one commit
// group), the ragged head and tail (under 16 bytes each) by plain loads.
__device__ __forceinline__ void stage(uint8_t* buf, const Tile& tile) {
  uint8_t* dst = buf + lead_of(tile.src);
  const uint8_t* src = tile.src;
  const int head = min((16 - lead_of(src)) & 15, tile.n_in);
  const int nv = (tile.n_in - head) >> 4;
  for (int k = threadIdx.x; k < nv; k += kThreads)
    cp_async16(dst + head + 16 * k, src + head + 16 * k);
  cp_async_commit();
  for (int k = threadIdx.x; k < head; k += kThreads) dst[k] = __ldg(src + k);
  for (int k = head + 16 * nv + threadIdx.x; k < tile.n_in; k += kThreads)
    dst[k] = __ldg(src + k);
}

// Four bits to the low bit of four bytes: bit b of the nibble lands at bit
// b + 7i of the product for each i, and only i == b lands on a byte's low
// bit; the 16 landing places are distinct, so nothing carries.
__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

// The tile's wire bytes from its input `in` in shared memory ([row][g][bx],
// as in the packed rows), 16 at a time a thread.
template <int RN, int STORE>
__device__ __forceinline__ void unpack_tile(const uint8_t* in, const Tile& tile,
                                            uint8_t* __restrict__ bits,
                                            const UnpackShape& s) {
  // a block's RN slot-row bytes as one word: 32 bits hold them up to rn 4
  using Word = std::conditional_t<(RN <= 4), uint32_t, unsigned long long>;
  const Word mask = (Word{1} << s.num_ac) - 1;
  const int bw = s.bw, num_ac = s.num_ac;
  const unsigned nblk = static_cast<unsigned>(tile.n_out / num_ac);
  const int chunks = (tile.n_out + 15) >> 4;
  uint8_t* dst = bits + tile.out;
  for (int q = threadIdx.x; q < chunks; q += kThreads) {
    const unsigned j0 = 16u * q;
    unsigned v = div_by(j0, s.div_ac);            // the block of byte j0
    int pos = static_cast<int>(v * num_ac) - static_cast<int>(j0);  // <= 0
    const unsigned row = div_by(v, s.div_bw);
    int bx = static_cast<int>(v - row * bw);
    const uint8_t* p = in + row * (RN * bw);
    uint32_t acc = 0;  // bit u: output byte j0 + u
    for (; pos < 16 && v < nblk; pos += num_ac, ++v) {
      Word w = p[bx];
#pragma unroll
      for (int g = 1; g < RN; ++g) w |= static_cast<Word>(p[g * bw + bx]) << (8 * g);
      const Word slots = (w >> 1) & mask;  // slots 1..num_ac at bits 0..
      acc |= pos >= 0 ? static_cast<uint32_t>(slots << pos)
                      : static_cast<uint32_t>(slots >> -pos);
      if (++bx == bw) {
        bx = 0;
        p += RN * bw;
      }
    }
    if constexpr (STORE == 16) {
      *reinterpret_cast<uint4*>(dst + j0) =
          make_uint4(spread4(acc & 15u), spread4((acc >> 4) & 15u),
                     spread4((acc >> 8) & 15u), spread4((acc >> 12) & 15u));
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (j0 + u < static_cast<unsigned>(tile.n_out))
          dst[j0 + u] = static_cast<uint8_t>((acc >> u) & 1u);
    }
  }
}

template <int RN, int STORE>
__global__ void __launch_bounds__(kThreads)
qim_unpack_kernel(const uint8_t* __restrict__ packed, uint8_t* __restrict__ bits,
                  UnpackShape s) {
  extern __shared__ __align__(16) uint8_t smem[];
  int t = blockIdx.x;
  if (t >= s.tiles) return;
  Tile cur = tile_at<RN>(t, s, packed);
  stage(smem, cur);
  for (int it = 0; t < s.tiles; ++it, t += gridDim.x) {
    const int tn = t + gridDim.x;
    Tile next = cur;
    if (tn < s.tiles) {  // the next tile's loads fly while this one unpacks
      next = tile_at<RN>(tn, s, packed);
      stage(smem + ((it + 1) & 1) * s.buf_bytes, next);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unpack_tile<RN, STORE>(smem + (it & 1) * s.buf_bytes + lead_of(cur.src), cur,
                           bits, s);
    __syncthreads();  // the buffer is staged again two tiles on
    cur = next;
  }
}

cudaError_t begin(int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) (void)cudaGetLastError();
  return err;
}

}  // namespace

#define STEGOTPU_UNPACK_RN_SWITCH(rn, LAUNCH) \
  switch (rn) {                               \
    case 1: LAUNCH(1); break;                 \
    case 2: LAUNCH(2); break;                 \
    case 3: LAUNCH(3); break;                 \
    case 4: LAUNCH(4); break;                 \
    case 5: LAUNCH(5); break;                 \
    case 6: LAUNCH(6); break;                 \
    case 7: LAUNCH(7); break;                 \
    case 8: LAUNCH(8); break;                 \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

extern "C" {

// packed: (B, (H/stripe)*rows_pad, W/8) u8, contiguous; bits: (B, C) u8,
// C = (H/8)(W/8)num_ac, contiguous; 1 <= num_ac <= 63; store: 16 (the
// output rows and base 16-byte aligned) or 1. Returns a cudaError_t
// (cudaErrorInvalidValue for a shape or store width the kernel does not
// take).
int stegotpu_qim_unpack_packed(const void* packed, void* bits, int device, int b,
                               int h, int w, int num_ac, int stripe,
                               int rows_pad, int store, void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rn = num_ac / 8 + 1;
  const long long bw = w / 8;
  const bool ok = b >= 0 && h > 0 && w > 0 && h % 8 == 0 && w % 8 == 0 &&
                  bw < 65536 && stripe > 0 && stripe % 8 == 0 && h % stripe == 0 &&
                  num_ac >= 1 && num_ac <= 63 && rows_pad >= stripe / 8 * rn &&
                  (store == 1 || (store == 16 && bw * num_ac % 16 == 0 &&
                                  reinterpret_cast<uintptr_t>(bits) % 16 == 0));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  UnpackShape s;
  s.bw = static_cast<int>(bw);
  s.bh_s = stripe / 8;
  s.num_ac = num_ac;
  s.rows_pad = rows_pad;
  const long long per_row = rn * bw;
  const long long fit = kTileInBytes / per_row;
  s.rows_per_tile = static_cast<int>(fit < 1 ? 1 : (fit < s.bh_s ? fit : s.bh_s));
  s.tiles_per_group = (s.bh_s + s.rows_per_tile - 1) / s.rows_per_tile;
  const long long tiles = static_cast<long long>(b) * (h / stripe) * s.tiles_per_group;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  s.tiles = static_cast<int>(tiles);
  s.row_bits = static_cast<int>(bw * num_ac);
  s.buf_bytes = static_cast<int>((s.rows_per_tile * per_row + 16 + 15) / 16 * 16);
  s.div_ac = reciprocal(static_cast<unsigned>(num_ac));
  s.div_bw = reciprocal(static_cast<unsigned>(bw));
  const size_t smem = 2 * static_cast<size_t>(s.buf_bytes);
  int sms = 0, smem_max = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(smem_max)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) -> cudaError_t {
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return e;
    const long long most = static_cast<long long>(sms) * (per_sm < 1 ? 1 : per_sm);
    const unsigned grid = static_cast<unsigned>(s.tiles < most ? s.tiles : most);
    kernel<<<grid, kThreads, smem, st>>>(static_cast<const uint8_t*>(packed),
                                         static_cast<uint8_t*>(bits), s);
    return cudaGetLastError();
  };
#define STEGOTPU_UNPACK(RN)                                                   \
  err = store == 16 ? launch(qim_unpack_kernel<RN, 16>) : launch(qim_unpack_kernel<RN, 1>)
  STEGOTPU_UNPACK_RN_SWITCH(rn, STEGOTPU_UNPACK)
#undef STEGOTPU_UNPACK
  return static_cast<int>(err);
}

}  // extern "C"

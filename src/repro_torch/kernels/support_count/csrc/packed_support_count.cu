// Packed-bitmap support count on Hopper's tensor cores: the rows' packed
// words stream in by TMA, are unpacked to int8 {0,1} bytes in shared
// memory, and int8 wgmma sums their products with the candidates' unpacked
// bits in int32; the "== k" compare and the per-candidate sum (the
// MapReduce combiner) stay in registers.  Written by hand for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/support_count/packed.py
// (packed_support_count_pallas, body _kernel).  Same function:
//   out[c] = #{ n : sum_w popcount(t[n, w] & cand[c, w]) == kvec[c] }
// Words arrive as int32 tensors carrying the uint32 bit pattern and are read
// as unsigned here (bit 31, the int32 sign, is item 31 of its word).  Pad
// candidates carry kvec = -1 and never match; every candidate reads its own
// kvec, so one call may mix k (combined waves).
//
// Why the tensor cores.  The AND-popcount of two packed rows equals the dot
// of their unpacked {0,1} bytes, exact in int32.  The card's CUDA cores
// issue 16 popcounts a clock an SM (32 items each); its tensor cores do
// 8,192 int8 operations a clock an SM (4,096 products of one item each),
// eight times as many items.  So what bounds this kernel is the int8
// tensor-core operations over the unpacked bits, 2 N C F for F = 32 W
// items: at the main path's shape (N 2,048, W 16, C 32,768) 6.9e10
// operations against ~2.5 MB of packed words.  The packed store exists to
// keep one bit an item in device memory, so the unpacked bytes exist only
// in shared memory: nothing unpacked is ever written to device memory.
//
// What the design does about it.
// - The bit map.  Any permutation of the bit positions inside a k-slab
//   leaves every dot unchanged as long as rows and candidates unpack with
//   the same map; the identity suits the layout wgmma reads: bit b of word
//   j of a slab is byte 32 j + b of a 128-byte K-major row, stored with the
//   128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)).  One
//   16-bit half-word becomes one 16-byte chunk, four bytes a nibble as
//   (nib * 0x00204081) & 0x01010101, so each store is one st.shared.v4.
// - Warp-specialised, like the bitmap kernel (csrc/support_count.cu): one
//   producer warpgroup, two consumer warpgroups.  One producer thread keeps
//   a ring of TMA stages of packed words in flight (64 rows x 4 words, 1 KB,
//   against 8 KB of bytes for the bitmap kernel's row stage); all 128
//   producer threads unpack each stage into a ring of swizzled int8 slots
//   and hand it over through an mbarrier.  The consumers run m64n128k32 s8
//   wgmma from shared memory, each on its own 128 of the block's BN = 256
//   candidates, so the ALU work of unpacking runs beside the tensor cores.
// - Candidates, W <= 20 (F <= 640, the main path and serving): the block's
//   256 candidates are read from device memory once and unpacked once into
//   resident swizzled slabs (up to 160 KB); only rows stream.
// - Candidates, W > 20 (the production share's W = 128): the unpacked
//   candidates do not fit.  Each stage then also carries the candidates'
//   packed words of one slab (256 x 4 words, 4 KB, from L2), and one slot
//   holds the slab unpacked (32 KB) beside TWO 64-row tiles: each consumer
//   runs both tiles against it with two accumulator sets (128 registers;
//   setmaxnreg moves registers from the producer, though ptxas still
//   spills a few hundred bytes there, see -Xptxas -v).  Unpacking a 32 KB
//   slab costs about as much shared-memory bandwidth as the wgmma of one
//   64-row tile on it, so sharing it between two tiles keeps shared memory
//   under the tensor cores' time; a third accumulator set would not fit in
//   registers.  The
//   candidates' packed words are streamed rather than kept resident
//   (256 x 128 x 4 B = 128 KB would leave one slot for unpacking), and that
//   holds for any W.
// - The epilogue stays in registers: each accumulator is compared with its
//   column's kvec and added to a per-thread hit counter, rows at or past
//   the block's end (zero-filled by TMA) masked; the counters meet by warp
//   shuffles and shared-memory atomics, and each candidate is written once
//   a block.  When there are fewer candidate tiles than SMs the host splits
//   N across blocks, which meet by atomicAdd into a zeroed output.
// - Few rows (one-row eviction deltas): the block still unpacks its
//   candidates once and runs one 64-row tile.  On an H100 that takes about
//   half the time of the 64 x 64 SIMT popcount tile it replaced, so there
//   is no separate path for small N.
// - Hit counters: two 16-bit counts a register (32 columns in 16
//   registers), flushed to shared memory every FLUSH_TILES tiles.
// TMA needs rows of a multiple of 16 bytes (W % 4 == 0) at 16-byte-aligned
// addresses; the Python wrapper zero-pads a copy of both operands where
// they are not (zero words add nothing to any count).

#include <climits>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and the CUDA driver API's enums (types only)
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                  // rows per wgmma tile
constexpr int BN = 256;                 // candidates per block
constexpr int HALF = BN / 2;            // candidates per consumer warpgroup
constexpr int SLAB_WORDS = 4;           // packed words per k-slab
constexpr int BK = 32 * SLAB_WORDS;     // 128 unpacked bytes: one swizzle row
constexpr int WK = 32;                  // wgmma k depth for 8-bit operands
constexpr int TILE_BYTES = BM * BK;     // one unpacked 64-row slab: 8 KB
constexpr int B_BYTES = BN * BK;        // one unpacked candidate slab: 32 KB
constexpr int PACKED_ROW = SLAB_WORDS * 4;  // a slab's packed words a row: 16 B
constexpr int THREADS = 384;            // producer warpgroup + 2 consumers
constexpr int PRODUCER_REGS = 56;       // 128 x 56 + 256 x 224 = 384 x 168
constexpr int CONSUMER_REGS = 224;
constexpr int MAX_RESIDENT_SLABS = 5;   // W <= 20 keeps candidates unpacked
constexpr int STREAM_TILES = 2;         // tiles sharing a streamed slab
constexpr int STAGES = 8;               // TMA stages of packed words
constexpr int MAX_SLOTS = 8;            // unpacked slots
constexpr int SMEM_LIMIT = 232448;      // per-block dynamic shared memory
constexpr int N_BARS = STAGES + 2 * MAX_SLOTS;
// 1 KB of alignment slack, the mbarriers, kvec and the hit counts.
constexpr int SMEM_FIXED = 1024 + N_BARS * 8 + 2 * BN * 4;
// A 16-bit hit counter gains at most 2 a 64-row tile: flush them to shared
// memory every FLUSH_TILES tiles, long before one could overflow.
constexpr int FLUSH_TILES = 16384;
constexpr long long WAIT_LIMIT_NS = 10000000000LL;  // trap, never hang
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase differs from ``parity``.  A wait that
// outlasts WAIT_LIMIT_NS traps, so a fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t spins = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((++spins & 0xFFF) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > WAIT_LIMIT_NS) __trap();
    }
  }
}

// One 2-D TMA tile (inner coordinate in words, then rows) into shared
// memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int word, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(word), "r"(row),
      "r"(bar) : "memory");
}

// Order this thread's generic-proxy shared-memory stores before later
// async-proxy reads (wgmma) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: 8-row x 128-byte atoms, 1,024 bytes apart (SBO); the leading
// offset is unused for swizzled K-major layouts.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads across a wgmma wait.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, int32) (+)= A (64 x 32 s8, K-major) * B (128 x 32 s8, K-major)^T
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Four {0,1} bytes from a nibble: bit i of ``nib`` becomes byte i.
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// Unpack packed word ``j`` of a slab's row ``row`` into the swizzled slab
// at ``slab``: bits 0-15 are 16-byte chunk 2j of the row, bits 16-31 chunk
// 2j + 1, each at chunk ^ (row % 8) of its 128-byte line.
__device__ __forceinline__ void unpack_word(uint8_t* slab, int row, int j,
                                            uint32_t word) {
  uint8_t* line = slab + (row >> 3) * 1024 + (row & 7) * 128;
  const int sw = row & 7;
  const uint4 lo = make_uint4(spread4(word & 15u), spread4((word >> 4) & 15u),
                              spread4((word >> 8) & 15u),
                              spread4((word >> 12) & 15u));
  const uint4 hi = make_uint4(spread4((word >> 16) & 15u),
                              spread4((word >> 20) & 15u),
                              spread4((word >> 24) & 15u), spread4(word >> 28));
  *reinterpret_cast<uint4*>(line + (((2 * j) ^ sw) << 4)) = lo;
  *reinterpret_cast<uint4*>(line + (((2 * j + 1) ^ sw) << 4)) = hi;
}

// Add a consumer thread's packed hit counters into the block's per-column
// counts and zero them: hits[j] holds columns 8j + 2q (low 16 bits) and
// 8j + 2q + 1 (high 16 bits) of its warpgroup's half, summed here over the
// 8 lanes that share a column, then over the 4 warps in shared memory.
__device__ __forceinline__ void flush_hits(uint32_t (&hits)[HALF / 8],
                                           int* cols, int lane) {
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j) {
    int lo = hits[j] & 0xFFFFu, hi = hits[j] >> 16;
#pragma unroll
    for (int m = 4; m < 32; m *= 2) {
      lo += __shfl_xor_sync(0xFFFFFFFFu, lo, m);
      hi += __shfl_xor_sync(0xFFFFFFFFu, hi, m);
    }
    if (lane < 4) {
      if (lo) atomicAdd(&cols[8 * j + 2 * lane], lo);
      if (hi) atomicAdd(&cols[8 * j + 2 * lane + 1], hi);
    }
    hits[j] = 0;
  }
}

// Grid: cand_tiles x splits blocks; block b owns candidates
// [(b % cand_tiles) * BN, +BN) and rows [(b / cand_tiles) * split_rows,
// +split_rows).  R = 1: candidates resident (W <= 20); R = 2: candidates
// streamed a slab at a time, each slab serving two 64-row tiles.  Work
// items run group by group (R tiles of rows), slab by slab within a group.
// Shared memory, from a 1,024-byte-aligned base: the resident candidate
// slabs (R = 1), ``slots`` unpacked slots (R tiles of rows, plus the
// candidate slab when streamed), STAGES packed stages, the mbarriers, kvec,
// the hits.
template <int R>
__global__ void __launch_bounds__(THREADS, 1)
packed_support_count_kernel(const __grid_constant__ CUtensorMap map_rows,
                            const __grid_constant__ CUtensorMap map_cands,
                            const uint32_t* __restrict__ cpacked,
                            const int32_t* __restrict__ kvec,
                            int32_t* __restrict__ out, int n, int n_cand,
                            int w, int cand_tiles, int split_rows, int slots,
                            int atomic_out) {
  constexpr bool RESIDENT = R == 1;
  constexpr int SLOT_BYTES = R * TILE_BYTES + (RESIDENT ? 0 : B_BYTES);
  constexpr int ROWS_BYTES = R * BM * PACKED_ROW;
  constexpr int STAGE_BYTES = ROWS_BYTES + (RESIDENT ? 0 : BN * PACKED_ROW);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int nslab = w / SLAB_WORDS;
  const int res_bytes = RESIDENT ? nslab * B_BYTES : 0;
  const int slot_off = res_bytes;
  const int stage_off = slot_off + slots * SLOT_BYTES;
  const int bar_off = stage_off + STAGES * STAGE_BYTES;
  const auto full_bar = [&](int s) { return base + bar_off + 8u * s; };
  const auto ready_bar = [&](int u) {
    return base + bar_off + 8u * (STAGES + u);
  };
  const auto free_bar = [&](int u) {
    return base + bar_off + 8u * (STAGES + MAX_SLOTS + u);
  };
  int* s_kv = reinterpret_cast<int*>(smem + bar_off + N_BARS * 8);
  int* s_hits = s_kv + BN;

  const int tid = threadIdx.x;
  const int cand0 = (blockIdx.x % cand_tiles) * BN;
  const int row_begin = (blockIdx.x / cand_tiles) * split_rows;
  const int row_end = min(n, row_begin + split_rows);
  const int groups = (row_end - row_begin + R * BM - 1) / (R * BM);
  const int items = groups * nslab;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full_bar(s), 1);
    for (int u = 0; u < MAX_SLOTS; ++u) {
      mbar_init(ready_bar(u), 1);  // one producer thread, after the unpack
      mbar_init(free_bar(u), 2);   // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < BN; i += THREADS) {
    const int c = cand0 + i;
    s_kv[i] = c < n_cand ? kvec[c] : -1;
    s_hits[i] = 0;
  }
  if (RESIDENT) {  // every thread unpacks the block's candidates once
    for (int q = tid; q < BN * w; q += THREADS) {
      const int c = q / w, j = q - c * w;
      const uint32_t word =
          cand0 + c < n_cand ? cpacked[(size_t)(cand0 + c) * w + j] : 0u;
      unpack_word(smem + (j / SLAB_WORDS) * B_BYTES, c, j % SLAB_WORDS, word);
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: TMA the packed words, unpack them into the slots ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const auto issue = [&](int i, int stage) {
      const int g = i / nslab, s = i - g * nslab;
      const uint32_t dst = base + stage_off + stage * STAGE_BYTES;
      mbar_expect_tx(full_bar(stage), STAGE_BYTES);
      tma_load(dst, &map_rows, s * SLAB_WORDS, row_begin + g * R * BM,
               full_bar(stage));
      if (!RESIDENT)
        tma_load(dst + ROWS_BYTES, &map_cands, s * SLAB_WORDS, cand0,
                 full_bar(stage));
    };
    if (tid == 0)
      for (int i = 0; i < STAGES && i < items; ++i) issue(i, i);
    int stage = 0, slot = 0;
    uint32_t stage_phase = 0, slot_phase = 0;
    for (int i = 0; i < items; ++i) {
      mbar_wait(full_bar(stage), stage_phase);
      mbar_wait(free_bar(slot), slot_phase ^ 1);
      const uint32_t* words =
          reinterpret_cast<const uint32_t*>(smem + stage_off + stage * STAGE_BYTES);
      uint8_t* dst = smem + slot_off + slot * SLOT_BYTES;
      // The R tiles' rows are one run of 128-byte lines: row r of the
      // group is line r of the slot.
#pragma unroll
      for (int q = tid; q < R * BM * SLAB_WORDS; q += 128)
        unpack_word(dst, q / SLAB_WORDS, q % SLAB_WORDS, words[q]);
      if (!RESIDENT) {
#pragma unroll
        for (int q = tid; q < BN * SLAB_WORDS; q += 128)
          unpack_word(dst + R * TILE_BYTES, q / SLAB_WORDS, q % SLAB_WORDS,
                      words[R * BM * SLAB_WORDS + q]);
      }
      fence_proxy_async();
      asm volatile("bar.sync 2, 128;" ::: "memory");  // the producer warpgroup
      if (tid == 0) {
        mbar_arrive(ready_bar(slot));
        if (i + STAGES < items) issue(i + STAGES, stage);  // stage now read
      }
      if (++stage == STAGES) {
        stage = 0;
        stage_phase ^= 1;
      }
      if (++slot == slots) {
        slot = 0;
        slot_phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns candidates [cw*128, cw*128 + 128) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int ctid = tid - 128;
  const int cw = ctid / 128;
  const int warp = (ctid % 128) / 32;
  const int lane = tid % 32;
  const int q = lane & 3;
  const uint32_t b_half = cw * HALF * BK;  // this half's rows of a slab
  const int* kv = s_kv + cw * HALF + 2 * q;

  int acc[R][64];
  uint32_t hits[HALF / 8];  // two 16-bit counters each: see flush_hits
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[r][i] = 0;
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j) hits[j] = 0;

  int slot = 0, prev = 0;
  uint32_t phase = 0;
  for (int g = 0; g < groups; ++g) {
    for (int s = 0; s < nslab; ++s) {
      mbar_wait(ready_bar(slot), phase);
      const uint32_t a = base + slot_off + slot * SLOT_BYTES;
      const uint32_t b =
          (RESIDENT ? base + s * B_BYTES : a + R * TILE_BYTES) + b_half;
      const uint64_t db = smem_desc(b);
#pragma unroll
      for (int r = 0; r < R; ++r) fence_acc(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint64_t da = smem_desc(a + r * TILE_BYTES);
#pragma unroll
        for (int kk = 0; kk < BK / WK; ++kk)  // +32 bytes = +2 in the descriptor
          wgmma_m64n128k32(acc[r], da + 2 * kk, db + 2 * kk, s > 0 || kk > 0);
      }
      wgmma_commit();
      if (s > 0) {  // the previous slab's wgmma has retired: free its slot
        wgmma_wait<1>();
        if (ctid % 128 == 0) mbar_arrive(free_bar(prev));
      }
      prev = slot;
      if (++slot == slots) {
        slot = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < R; ++r) fence_acc(acc[r]);
    if (ctid % 128 == 0) mbar_arrive(free_bar(prev));

    // Epilogue in registers.  Accumulator i of this thread holds row
    // 16*warp + lane/4 + 8*((i>>1)&1) of its tile and column
    // 8*(i>>2) + 2*q + (i&1).
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int tile_row = row_begin + (g * R + r) * BM;
      if (tile_row + BM <= row_end) {
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
          const int2 k = *reinterpret_cast<const int2*>(kv + 8 * j);
          hits[j] += (acc[r][4 * j] == k.x) + (acc[r][4 * j + 2] == k.x) +
                     (((acc[r][4 * j + 1] == k.y) + (acc[r][4 * j + 3] == k.y))
                      << 16);
        }
      } else {  // a ragged tile: rows at or past row_end never count
        const int row = tile_row + 16 * warp + lane / 4;
        const int va = row < row_end, vb = row + 8 < row_end;
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
          const int2 k = *reinterpret_cast<const int2*>(kv + 8 * j);
          hits[j] += ((acc[r][4 * j] == k.x) & va) +
                     ((acc[r][4 * j + 2] == k.x) & vb) +
                     ((((acc[r][4 * j + 1] == k.y) & va) +
                       ((acc[r][4 * j + 3] == k.y) & vb)) << 16);
        }
      }
    }
    if ((g + 1) % (FLUSH_TILES / R) == 0) flush_hits(hits, s_hits + cw * HALF, lane);
  }
  flush_hits(hits, s_hits + cw * HALF, lane);
  asm volatile("bar.sync 1, 256;" ::: "memory");  // the two consumer warpgroups
  const int c = cand0 + ctid;
  if (c < n_cand) {
    const int v = s_hits[ctid];
    if (!atomic_out) out[c] = v;
    else if (v) atomicAdd(&out[c], v);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The CUDA driver API's cuTensorMapEncodeTiled, reached through the
// runtime so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, words) uint32 row-major matrix, read in (box_rows x 4-word)
// tiles without swizzle; out-of-bounds rows and words read 0.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rows,
              int words, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)words, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)words * 4};
  const cuuint32_t box[2] = {(cuuint32_t)SLAB_WORDS, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int R>
cudaError_t launch(const CUtensorMap& map_rows, const CUtensorMap& map_cands,
                   const void* cpacked, const void* kvec, void* out, int n,
                   int n_cand, int w, int sms, cudaStream_t st) {
  constexpr bool RESIDENT = R == 1;
  constexpr int SLOT_BYTES = R * TILE_BYTES + (RESIDENT ? 0 : B_BYTES);
  constexpr int STAGE_BYTES =
      R * BM * PACKED_ROW + (RESIDENT ? 0 : BN * PACKED_ROW);
  // Fewer candidate tiles than SMs: split N into runs of whole row groups.
  const long long cand_tiles = (n_cand + BN - 1) / BN;
  const int row_groups = (n + R * BM - 1) / (R * BM);
  int splits = 1;
  if (cand_tiles < sms)
    splits = (int)(sms / cand_tiles) < row_groups ? (int)(sms / cand_tiles)
                                                  : row_groups;
  const int split_groups = (row_groups + splits - 1) / splits;
  splits = (row_groups + split_groups - 1) / split_groups;  // none empty
  if (cand_tiles * splits > INT_MAX) return cudaErrorInvalidValue;

  const int fixed = SMEM_FIXED + STAGES * STAGE_BYTES +
                    (RESIDENT ? (w / SLAB_WORDS) * B_BYTES : 0);
  const int room = (SMEM_LIMIT - fixed) / SLOT_BYTES;
  const int slots = room < MAX_SLOTS ? room : MAX_SLOTS;
  if (slots < 2) return cudaErrorInvalidValue;
  if (splits > 1) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)n_cand, st);
    if (err != cudaSuccess) return err;
  }
  packed_support_count_kernel<R>
      <<<(unsigned)(cand_tiles * splits), THREADS, fixed + slots * SLOT_BYTES,
         st>>>(map_rows, map_cands, static_cast<const uint32_t*>(cpacked),
               static_cast<const int32_t*>(kvec), static_cast<int32_t*>(out),
               n, n_cand, w, (int)cand_tiles, split_groups * R * BM, slots,
               splits > 1);
  return cudaGetLastError();
}

}  // namespace

// packed (n, w) and cpacked (n_cand, w): contiguous int32 device rows with
// w % 4 == 0 at 16-byte-aligned addresses; kvec (n_cand,) int32; out
// (n_cand,) int32, fully written (zeroed here first when N is split).
extern "C" int packed_support_count_launch(const void* packed,
                                           const void* cpacked,
                                           const void* kvec, void* out,
                                           int n, int n_cand, int w,
                                           void* stream) {
  if (n <= 0 || n_cand <= 0) return 0;
  if (w <= 0 || w % SLAB_WORDS || reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(cpacked) % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  // Per device, once: the SM count, and the shared-memory opt-in.
  static int sm_count[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(packed_support_count_kernel<1>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(packed_support_count_kernel<STREAM_TILES>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    sm_count[dev] = count;
  }
  const bool resident = w / SLAB_WORDS <= MAX_RESIDENT_SLABS;
  CUtensorMap map_rows, map_cands;
  if (!make_map(enc, &map_rows, packed, n, w, resident ? BM : STREAM_TILES * BM) ||
      !make_map(enc, &map_cands, cpacked, n_cand, w, BN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = resident ? launch<1>(map_rows, map_cands, cpacked, kvec, out, n,
                             n_cand, w, sm_count[dev], st)
                 : launch<STREAM_TILES>(map_rows, map_cands, cpacked, kvec,
                                        out, n, n_cand, w, sm_count[dev], st);
  return (int)err;
}

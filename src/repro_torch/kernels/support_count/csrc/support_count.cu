// Bitmap x k-hot support count on Hopper's tensor cores: int8 operands fed
// by TMA through an mbarrier ring, int8 wgmma with int32 accumulators in
// registers, and the "== k" compare and the per-candidate sum (the
// MapReduce combiner) fused into the epilogue.  Written by hand for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/support_count/kernel.py
// (support_count_pallas, body _kernel).  Same function:
//   out[c] = #{ n < N : dot(bitmap[n, :], khot[c, :]) == kvec[c] }
// The TPU kernel feeds bf16 to the MXU with f32 accumulation.  Here the
// operands are int8 and the sums int32, which is exact: the bitmap is {0,1}
// (int8 or uint8, the same bytes), k-hot entries are counts in [0, 127], and
// every dot is at most F * 127.  Pad candidates carry kvec = -1 and never
// match; one call may mix k.
//
// What bounds it on an H100: the tensor-core operations.  At the main
// path's shape (a 2,048-row block of T10I4D100K, F_pad = 512, 32,768
// candidates) the call does 2*N*C*F ~ 6.9e10 int8 operations and moves
// ~18 MB, so it is operation-bound: 8,192 int8 operations per clock per SM.
//
// What the design does about it.  Like the TPU kernel, which keeps its
// output block resident while N streams, each block owns BN = 256
// candidates and streams the rows past them:
// - The block's k-hot tile (256 x F bytes) is loaded ONCE by TMA into shared
//   memory, in 128-byte-deep k-slabs with the 128-byte swizzle, and stays
//   there while the block's rows stream through a ring of 64-row x 128-byte
//   TMA stages.  When 256 x F does not fit beside the ring (F > 640) the
//   k-hot slabs stream through the ring with the rows instead.
// - Warp-specialised: one producer thread issues every TMA load; two
//   consumer warpgroups each run m64n128k32 s8 wgmma on the same 64 rows
//   against their own half of the candidates (64 int32 accumulators per
//   thread), releasing each stage through an "empty" mbarrier as soon as
//   the wgmma that read it retires.
// - The epilogue stays in registers: each accumulator is compared with its
//   column's kvec (read from shared memory) and added to a per-thread hit
//   counter; rows at or past N (zero-filled by TMA) are masked.  Once per
//   block the counters are reduced by warp shuffles over the lanes sharing
//   a column, then across warps in shared memory.  No (N, C) dot ever
//   leaves registers.
// - Each candidate is written once per block: a plain store when the block
//   covered all N rows; when there are fewer candidate tiles than SMs the
//   host splits N across blocks, which meet by atomicAdd into a zeroed
//   output.
// The host builds both TMA descriptors on every launch (the engine passes
// a fresh row-block view each call); TMA needs rows of a multiple of 16
// bytes at 16-byte-aligned addresses, which the Python wrapper guarantees
// by zero-padding F where it must (zero columns add nothing to any dot).

#include <climits>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and the CUDA driver API's enums (types only)
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                  // rows per stage (one wgmma M)
constexpr int BN = 256;                 // candidates per block
constexpr int HALF = BN / 2;            // candidates per consumer warpgroup
constexpr int BK = 128;                 // k-slab depth: one 128-byte swizzle row
constexpr int WK = 32;                  // wgmma k depth for 8-bit operands
constexpr int A_BYTES = BM * BK;        // one row stage: 8 KB
constexpr int B_BYTES = BN * BK;        // one k-hot slab: 32 KB
constexpr int THREADS = 384;            // producer warpgroup + 2 consumers
constexpr int MAX_STAGES = 8;
constexpr int MAX_RESIDENT_SLABS = 5;   // F <= 640 keeps k-hot resident
constexpr int SMEM_LIMIT = 232448;      // per-block dynamic shared memory
constexpr int N_BARS = 2 * MAX_STAGES + MAX_RESIDENT_SLABS;
// 1 KB of alignment slack, the mbarriers, kvec and the hit counts.
constexpr int SMEM_FIXED = 1024 + N_BARS * 8 + 2 * BN * 4;
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

// One 2-D TMA tile (inner coordinate in bytes, then rows) into shared
// memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row),
      "r"(bar) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: 8-row x 128-byte atoms, 1,024 bytes apart (SBO); the
// leading offset is unused for swizzled K-major layouts.
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

// Grid: cand_tiles x splits blocks; block b owns candidates
// [(b % cand_tiles) * BN, +BN) and rows [(b / cand_tiles) * split_rows,
// +split_rows).  Shared memory, from a 1,024-byte-aligned base: the ring of
// ``stages`` stages (a 64 x 128 row slab, plus a 256 x 128 k-hot slab when
// not resident), the resident k-hot slabs, the mbarriers, kvec, the hits.
__global__ void __launch_bounds__(THREADS, 1)
support_count_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const int32_t* __restrict__ kvec,
                     int32_t* __restrict__ out, int n, int n_cand, int nslab,
                     int cand_tiles, int split_rows, int stages, int resident,
                     int atomic_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int stage_bytes = A_BYTES + (resident ? 0 : B_BYTES);
  const uint32_t ring = base;
  const uint32_t b_res = base + stages * stage_bytes;
  const int data_bytes = stages * stage_bytes + (resident ? nslab * B_BYTES : 0);
  const uint32_t bars = base + data_bytes;
  const auto full_bar = [&](int s) { return bars + 8u * s; };
  const auto empty_bar = [&](int s) { return bars + 8u * (MAX_STAGES + s); };
  const auto slab_bar = [&](int s) { return bars + 8u * (2 * MAX_STAGES + s); };
  int* s_kv = reinterpret_cast<int*>(smem + data_bytes + N_BARS * 8);
  int* s_hits = s_kv + BN;

  const int tid = threadIdx.x;
  const int cand0 = (blockIdx.x % cand_tiles) * BN;
  const int row_begin = (blockIdx.x / cand_tiles) * split_rows;
  const int row_end = min(n, row_begin + split_rows);
  const int tiles = (row_end - row_begin + BM - 1) / BM;

  if (tid == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_init(full_bar(s), 1);   // the producer's arrive + TMA bytes
      mbar_init(empty_bar(s), 2);  // one arrive per consumer warpgroup
    }
    for (int s = 0; s < MAX_RESIDENT_SLABS; ++s) mbar_init(slab_bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < BN; i += THREADS) {
    const int c = cand0 + i;
    s_kv[i] = c < n_cand ? kvec[c] : -1;
    s_hits[i] = 0;
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread issues every TMA load --------------------
    if (tid != 0) return;
    if (resident) {
      for (int s = 0; s < nslab; ++s) {
        mbar_expect_tx(slab_bar(s), B_BYTES);
        tma_load(b_res + s * B_BYTES, &map_b, s * BK, cand0, slab_bar(s));
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < tiles; ++t) {
      const int row = row_begin + t * BM;
      for (int s = 0; s < nslab; ++s) {
        mbar_wait(empty_bar(stage), phase ^ 1);
        const uint32_t dst = ring + stage * stage_bytes;
        mbar_expect_tx(full_bar(stage), stage_bytes);
        tma_load(dst, &map_a, s * BK, row, full_bar(stage));
        if (!resident)
          tma_load(dst + A_BYTES, &map_b, s * BK, cand0, full_bar(stage));
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns candidates [cw*128, cw*128 + 128) ----
  const int ctid = tid - 128;
  const int cw = ctid / 128;
  const int warp = (ctid % 128) / 32;
  const int lane = tid % 32;
  const int q = lane & 3;
  const uint32_t b_half = cw * HALF * BK;  // this half's rows of a k-hot slab
  const int* kv = s_kv + cw * HALF + 2 * q;

  int acc[64];
  int hits[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) hits[i] = 0;

  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int t = 0; t < tiles; ++t) {
    for (int s = 0; s < nslab; ++s) {
      if (resident && t == 0) mbar_wait(slab_bar(s), 0);
      mbar_wait(full_bar(stage), phase);
      const uint32_t a = ring + stage * stage_bytes;
      const uint32_t b = (resident ? b_res + s * B_BYTES : a + A_BYTES) + b_half;
      const uint64_t da = smem_desc(a), db = smem_desc(b);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / WK; ++kk)  // +32 bytes = +2 in the descriptor
        wgmma_m64n128k32(acc, da + 2 * kk, db + 2 * kk, s > 0 || kk > 0);
      wgmma_commit();
      if (s > 0) {  // the previous slab's wgmma has retired: free its stage
        wgmma_wait<1>();
        if (ctid % 128 == 0) mbar_arrive(empty_bar(prev));
      }
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (ctid % 128 == 0) mbar_arrive(empty_bar(prev));

    // Epilogue in registers.  Accumulator i of this thread holds row
    // 16*warp + lane/4 + 8*((i>>1)&1) and column 8*(i>>2) + 2*q + (i&1).
    const int tile_row = row_begin + t * BM;
    if (tile_row + BM <= n) {
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j) {
        const int2 k = *reinterpret_cast<const int2*>(kv + 8 * j);
        hits[2 * j] += (acc[4 * j] == k.x) + (acc[4 * j + 2] == k.x);
        hits[2 * j + 1] += (acc[4 * j + 1] == k.y) + (acc[4 * j + 3] == k.y);
      }
    } else {  // the ragged last tile: TMA zero-filled rows >= n never count
      const int r = tile_row + 16 * warp + lane / 4;
      const int va = r < n, vb = r + 8 < n;
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j) {
        const int2 k = *reinterpret_cast<const int2*>(kv + 8 * j);
        hits[2 * j] += ((acc[4 * j] == k.x) & va) + ((acc[4 * j + 2] == k.x) & vb);
        hits[2 * j + 1] +=
            ((acc[4 * j + 1] == k.y) & va) + ((acc[4 * j + 3] == k.y) & vb);
      }
    }
  }

  // Reduce over the 8 lanes that share a column, then over the 4 warps.
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int v = hits[i];
    v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
    v += __shfl_xor_sync(0xFFFFFFFFu, v, 8);
    v += __shfl_xor_sync(0xFFFFFFFFu, v, 16);
    if (lane < 4 && v) atomicAdd(&s_hits[cw * HALF + 8 * (i >> 1) + 2 * q + (i & 1)], v);
  }
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

// A (rows, cols) uint8 row-major matrix, read in (box_rows x 128-byte)
// tiles with the 128-byte swizzle; out-of-bounds rows and columns read 0.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rows,
              int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// bitmap (n, f) and khot (n_cand, f): contiguous int8/uint8 device rows with
// f % 16 == 0 at 16-byte-aligned addresses; kvec (n_cand,) int32; out
// (n_cand,) int32, fully written (zeroed here first when N is split).
extern "C" int support_count_launch(const void* bitmap, const void* khot,
                                    const void* kvec, void* out, int n,
                                    int n_cand, int f, void* stream) {
  if (n <= 0 || n_cand <= 0) return 0;
  if (f <= 0 || f % 16 || reinterpret_cast<uintptr_t>(bitmap) % 16 ||
      reinterpret_cast<uintptr_t>(khot) % 16)
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
      err = cudaFuncSetAttribute(support_count_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    sm_count[dev] = count;
  }
  const int sms = sm_count[dev];

  // Fewer candidate tiles than SMs: split N into runs of whole 64-row tiles.
  const long long cand_tiles = (n_cand + BN - 1) / BN;
  const int row_tiles = (n + BM - 1) / BM;
  int splits = 1;
  if (cand_tiles < sms)
    splits = (int)(sms / cand_tiles) < row_tiles ? (int)(sms / cand_tiles)
                                                 : row_tiles;
  const int split_tiles = (row_tiles + splits - 1) / splits;
  splits = (row_tiles + split_tiles - 1) / split_tiles;  // none empty
  if (cand_tiles * splits > INT_MAX) return (int)cudaErrorInvalidValue;

  const int nslab = (f + BK - 1) / BK;
  const int resident = nslab <= MAX_RESIDENT_SLABS;
  const int stage_bytes = A_BYTES + (resident ? 0 : B_BYTES);
  const int room = SMEM_LIMIT - SMEM_FIXED - (resident ? nslab * B_BYTES : 0);
  const int stages = room / stage_bytes < MAX_STAGES ? room / stage_bytes
                                                     : MAX_STAGES;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = SMEM_FIXED + stages * stage_bytes +
                   (resident ? nslab * B_BYTES : 0);

  CUtensorMap map_a, map_b;
  if (!make_map(enc, &map_a, bitmap, n, f, BM) ||
      !make_map(enc, &map_b, khot, n_cand, f, BN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    err = cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)n_cand, st);
    if (err != cudaSuccess) return (int)err;
  }
  support_count_kernel<<<(unsigned)(cand_tiles * splits), THREADS, smem, st>>>(
      map_a, map_b, static_cast<const int32_t*>(kvec),
      static_cast<int32_t*>(out), n, n_cand, nslab, (int)cand_tiles,
      split_tiles * BM, stages, resident, splits > 1);
  return (int)cudaGetLastError();
}

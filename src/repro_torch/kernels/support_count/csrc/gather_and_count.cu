// Gather-AND-popcount support count of the perfect_hash store (the paper's
// hash-table trie): for each candidate, the number of a block's rows in
// which all of its k item columns are set.  Written by hand for sm_90a.
//
// Replaces no TPU kernel: the JAX package counts this store with plain
// gathers (src/repro/core/stores/perfect_hash.py, count_block).  Same
// function as those gathers, which the port keeps as its plain version,
// ref.py's gather_and_count_ref:
//   out[c] = #{ n : bitmap[n, cand[c, j]] != 0 for every j < k }
// over a (Nb, F) row-major block of {0,1} bytes and (C, k) int32 item ids.
//
// What bounds it.  The plain path builds a (Nb, C) byte mask for each of
// the k items, ANDs them and sums the mask through an int32 copy: about
// 384 MB of device-memory traffic for a 2,048-row block of 32,768 pairs.
// The count needs the rows once (2 MB at Nb 2,048, F 1,024; 1.07 GB over
// the 2^20 rows of a whole chunk) and, per candidate, k columns of Nb bits
// (256 B each at Nb 2,048, 128 KB at 2^20 rows).  The rows come from device
// memory once; the column words are read C k times over, so they have to
// come from L2, and at 2^20 rows the packed columns (128 MB) do not fit in
// its 50 MB.  So the kernel is bound by bytes: the rows from device memory
// and the column words from L2.
//
// What the design does about it.  Two C entries, each one kernel on the
// caller's stream, over any number of rows (the engine hands the count all
// of a chunk's rows at once):
// - Pack (gather_and_count_pack_launch): the rows' columns become bits, an
//   (F, 4 ceil(Nb/128)) uint32 array, word w of column f holding rows
//   32 w .. 32 w + 31, each column a whole number of 16-byte vectors.  A
//   thread owns one column and one word: it reads its column's byte in 32
//   consecutive rows (a warp reads 32 neighbouring bytes of a row, one
//   32-byte sector, coalesced) and writes one word.  Rows at or past Nb
//   give zero bits, so no count needs a mask.  The rows do not change
//   between counts, so the store packs them once, when it builds its
//   tensors, and keeps the words resident: a count call reads only them.
// - Count (gather_and_count_count_launch): the columns are cut into row
//   tiles, each sized from F so that one tile of every column (F x tile x
//   16 B) takes about 16 MB of L2, and the grid is (candidate blocks x row tiles), candidate blocks fastest:
//   the blocks resident at once share one tile, which stays in L2 while
//   every candidate reads it.  A group of G lanes (G the next power of two
//   >= the tile's vectors, at most 32) owns one candidate in one tile.  Its
//   lanes stride over the tile's 16-byte vectors: each loads the k column
//   vectors (whole 128-byte lines across the group), ANDs them and adds
//   their popcount; shuffles sum the group.  With one tile lane 0 writes
//   the candidate's count with a plain store; with several the counts are
//   zeroed on the stream first and lane 0 adds its tile's count with one
//   atomicAdd (integer sums are exact in any order).  k up to 8 is
//   unrolled with the column pointers in registers; larger k reads its ids
//   in a loop.
// An item id outside [0, F) traps (the plain path's index_select raises):
// a wrong id ends the launch with an error instead of reading past the
// words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PACK_THREADS = 128;   // columns per pack block
constexpr int COUNT_THREADS = 256;  // lanes per count block
constexpr int MAX_GRID_Y = 65535;
constexpr long long TILE_BYTES = 16ll << 20;  // one tile of every column
constexpr int MIN_TILE_VECS = 32;   // a whole group's stride, at any F

__global__ void __launch_bounds__(PACK_THREADS)
gather_and_count_pack_kernel(const uint8_t* __restrict__ bitmap,
                             uint32_t* __restrict__ bits, int n, int f,
                             int words) {
  const int col = blockIdx.x * PACK_THREADS + threadIdx.x;
  if (col >= f) return;
  for (int w = blockIdx.y; w < words; w += gridDim.y) {
    const uint8_t* p = bitmap + (size_t)w * 32 * f + col;
    const int rows = min(32, n - w * 32);  // <= 0 past the last row
    uint32_t word = 0;
    if (rows == 32) {
#pragma unroll
      for (int r = 0; r < 32; ++r)
        word |= (uint32_t)(__ldg(p + (size_t)r * f) != 0) << r;
    } else {
      for (int r = 0; r < rows; ++r)
        word |= (uint32_t)(__ldg(p + (size_t)r * f) != 0) << r;
    }
    bits[(size_t)col * words + w] = word;
  }
}

__device__ __forceinline__ int checked(int id, int f) {
  if ((unsigned)id >= (unsigned)f) __trap();
  return id;
}

__device__ __forceinline__ void and_into(uint4& acc, const uint4 x) {
  acc.x &= x.x;
  acc.y &= x.y;
  acc.z &= x.z;
  acc.w &= x.w;
}

__device__ __forceinline__ int popc4(const uint4 x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

// K > 0: exactly K items a candidate, unrolled; K == 0: any k, looped.
// Block b counts candidate block b % cand_blocks over row tile
// b / cand_blocks, whose vectors are [tile * tile_vecs, + tile_vecs).
template <int K>
__global__ void __launch_bounds__(COUNT_THREADS)
gather_and_count_popc_kernel(const uint4* __restrict__ bits,
                             const int32_t* __restrict__ cand,
                             int32_t* __restrict__ out, int n_cand, int k,
                             int f, int vecs, int tile_vecs, int cand_blocks,
                             int log_g) {
  const int tile = blockIdx.x / cand_blocks;
  const int block = blockIdx.x - tile * cand_blocks;
  const long long c =
      ((long long)block * COUNT_THREADS + threadIdx.x) >> log_g;
  const int g = 1 << log_g;
  const int lane = threadIdx.x & (g - 1);
  const int lo = tile * tile_vecs;
  const int hi = min(vecs, lo + tile_vecs);
  int hits = 0;
  if (c < n_cand) {
    if constexpr (K > 0) {
      const int32_t* ids = cand + c * K;
      const uint4* col[K];
#pragma unroll
      for (int j = 0; j < K; ++j)
        col[j] = bits + (size_t)checked(__ldg(ids + j), f) * vecs;
#pragma unroll 4
      for (int v = lo + lane; v < hi; v += g) {
        uint4 acc = __ldg(col[0] + v);
#pragma unroll
        for (int j = 1; j < K; ++j) and_into(acc, __ldg(col[j] + v));
        hits += popc4(acc);
      }
    } else {
      const int32_t* ids = cand + c * k;
      for (int j = 0; j < k; ++j) checked(__ldg(ids + j), f);
      for (int v = lo + lane; v < hi; v += g) {
        uint4 acc = __ldg(bits + (size_t)__ldg(ids) * vecs + v);
        for (int j = 1; j < k; ++j)
          and_into(acc, __ldg(bits + (size_t)__ldg(ids + j) * vecs + v));
        hits += popc4(acc);
      }
    }
  }
  // Every lane of the warp reaches the shuffles (the grid is whole warps);
  // offsets below g stay inside a candidate's group.
  for (int off = g >> 1; off > 0; off >>= 1)
    hits += __shfl_xor_sync(0xFFFFFFFFu, hits, off);
  if (c < n_cand && lane == 0) {
    if (gridDim.x > (unsigned)cand_blocks)
      atomicAdd(out + c, hits);  // one of several tiles: zeroed first
    else
      out[c] = hits;
  }
}

template <int K>
void launch_count(const uint4* bits, const int32_t* cand, int32_t* out,
                  int n_cand, int k, int f, int vecs, int tile_vecs,
                  int cand_blocks, int tiles, int log_g, cudaStream_t st) {
  gather_and_count_popc_kernel<K>
      <<<(unsigned)cand_blocks * tiles, COUNT_THREADS, 0, st>>>(
          bits, cand, out, n_cand, k, f, vecs, tile_vecs, cand_blocks, log_g);
}

}  // namespace

// bitmap (n, f): contiguous uint8/int8 {0,1} rows at any address; bits:
// f * 4 * ceil(n / 128) uint32 words at a 16-byte aligned address, fully
// written here.  On the current device, launched on ``stream``.
extern "C" int gather_and_count_pack_launch(const void* bitmap, void* bits,
                                            int n, int f, void* stream) {
  if (n <= 0) return 0;
  if (f <= 0) return (int)cudaErrorInvalidValue;
  const int words = 4 * ((n + 127) / 128);
  const dim3 grid((f + PACK_THREADS - 1) / PACK_THREADS,
                  words < MAX_GRID_Y ? words : MAX_GRID_Y);
  gather_and_count_pack_kernel<<<grid, PACK_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bitmap), static_cast<uint32_t*>(bits), n,
      f, words);
  return (int)cudaGetLastError();
}

// bits: the words gather_and_count_pack_launch wrote for n rows of f
// columns; cand (n_cand, k) contiguous int32 item ids in [0, f); out
// (n_cand,) int32, fully written.  On the current device, launched on
// ``stream``.
extern "C" int gather_and_count_count_launch(const void* bits,
                                             const void* cand, void* out,
                                             int n, int f, int n_cand, int k,
                                             void* stream) {
  if (n <= 0 || n_cand <= 0) return 0;
  if (f <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const int vecs = (n + 127) / 128;  // 16-byte vectors a column
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  long long tile = TILE_BYTES / (16ll * f);
  if (tile < MIN_TILE_VECS) tile = MIN_TILE_VECS;
  const int tile_vecs = tile < vecs ? (int)tile : vecs;
  const int tiles = (vecs + tile_vecs - 1) / tile_vecs;
  int log_g = 0;
  while ((1 << log_g) < tile_vecs && log_g < 5) ++log_g;
  const long long lanes = (long long)n_cand << log_g;
  const long long cand_blocks = (lanes + COUNT_THREADS - 1) / COUNT_THREADS;
  if (cand_blocks * tiles > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidConfiguration;
  auto* counts = static_cast<int32_t*>(out);
  if (tiles > 1) {
    const cudaError_t err =
        cudaMemsetAsync(counts, 0, sizeof(int32_t) * (size_t)n_cand, st);
    if (err != cudaSuccess) return (int)err;
  }
  const auto* vbits = static_cast<const uint4*>(bits);
  const auto* ids = static_cast<const int32_t*>(cand);
  switch (k) {
#define GAC_CASE(K)                                                        \
  case K:                                                                  \
    launch_count<K>(vbits, ids, counts, n_cand, k, f, vecs, tile_vecs,     \
                    (int)cand_blocks, tiles, log_g, st);                   \
    break;
    GAC_CASE(1) GAC_CASE(2) GAC_CASE(3) GAC_CASE(4)
    GAC_CASE(5) GAC_CASE(6) GAC_CASE(7) GAC_CASE(8)
#undef GAC_CASE
    default:
      launch_count<0>(vbits, ids, counts, n_cand, k, f, vecs, tile_vecs,
                      (int)cand_blocks, tiles, log_g, st);
  }
  return (int)cudaGetLastError();
}

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
// The count needs the block's rows once (2 MB at Nb 2,048, F 1,024) and,
// per candidate, k columns of Nb bits (256 B each at Nb 2,048): the rows
// come from device memory and the columns, 256 KB for the whole block,
// stay in L2.  So the kernel is bound by bytes, a few microseconds a call.
//
// What the design does about it.  Two kernels on the caller's stream from
// one C entry:
// - Pack: the block's columns become bits once, an (F, ceil(Nb/32)) uint32
//   scratch that the wrapper allocates, word w of column f holding rows
//   32 w .. 32 w + 31.  A thread owns one column and one word: it reads its
//   column's byte in 32 consecutive rows (a warp reads 32 neighbouring
//   bytes of a row, one 32-byte sector, coalesced) and writes one word.
//   Rows at or past Nb give zero bits, so no count needs a mask.
// - Count: a group of G lanes (G the next power of two >= the words per
//   column, at most 32) owns one candidate.  Its lanes stride over the
//   words: each loads the k column words (whole 128-byte lines across the
//   group when G is 32), ANDs them and adds their popcount; shuffles sum
//   the group, and lane 0 writes the candidate's count with one plain
//   store: no atomics and no zero-fill.  k up to 8 is unrolled with the
//   column pointers in registers; larger k reads its ids in a loop.
// An item id outside [0, F) traps (the plain path's index_select raises):
// a wrong id ends the launch with an error instead of reading past the
// scratch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PACK_THREADS = 128;   // columns per pack block
constexpr int COUNT_THREADS = 256;  // lanes per count block
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(PACK_THREADS)
gather_and_count_pack_kernel(const uint8_t* __restrict__ bitmap,
                             uint32_t* __restrict__ bits, int n, int f,
                             int words) {
  const int col = blockIdx.x * PACK_THREADS + threadIdx.x;
  if (col >= f) return;
  for (int w = blockIdx.y; w < words; w += gridDim.y) {
    const uint8_t* p = bitmap + (size_t)w * 32 * f + col;
    const int rows = min(32, n - w * 32);
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

// K > 0: exactly K items a candidate, unrolled; K == 0: any k, looped.
template <int K>
__global__ void __launch_bounds__(COUNT_THREADS)
gather_and_count_popc_kernel(const uint32_t* __restrict__ bits,
                             const int32_t* __restrict__ cand,
                             int32_t* __restrict__ out, int n_cand, int k,
                             int f, int words, int log_g) {
  const long long t = (long long)blockIdx.x * COUNT_THREADS + threadIdx.x;
  const long long c = t >> log_g;
  const int g = 1 << log_g;
  const int lane = (int)(t & (g - 1));
  int hits = 0;
  if (c < n_cand) {
    if constexpr (K > 0) {
      const int32_t* ids = cand + c * K;
      const uint32_t* col[K];
#pragma unroll
      for (int j = 0; j < K; ++j)
        col[j] = bits + (size_t)checked(__ldg(ids + j), f) * words;
      for (int w = lane; w < words; w += g) {
        uint32_t acc = __ldg(col[0] + w);
#pragma unroll
        for (int j = 1; j < K; ++j) acc &= __ldg(col[j] + w);
        hits += __popc(acc);
      }
    } else {
      const int32_t* ids = cand + c * k;
      for (int j = 0; j < k; ++j) checked(__ldg(ids + j), f);
      for (int w = lane; w < words; w += g) {
        uint32_t acc = 0xFFFFFFFFu;
        for (int j = 0; j < k; ++j)
          acc &= __ldg(bits + (size_t)__ldg(ids + j) * words + w);
        hits += __popc(acc);
      }
    }
  }
  // Every lane of the warp reaches the shuffles (the grid is whole warps);
  // offsets below g stay inside a candidate's group.
  for (int off = g >> 1; off > 0; off >>= 1)
    hits += __shfl_xor_sync(0xFFFFFFFFu, hits, off);
  if (c < n_cand && lane == 0) out[c] = hits;
}

template <int K>
void launch_count(const uint32_t* bits, const int32_t* cand, int32_t* out,
                  int n_cand, int k, int f, int words, int log_g,
                  cudaStream_t st) {
  const long long lanes = (long long)n_cand << log_g;
  const unsigned blocks =
      (unsigned)((lanes + COUNT_THREADS - 1) / COUNT_THREADS);
  gather_and_count_popc_kernel<K><<<blocks, COUNT_THREADS, 0, st>>>(
      bits, cand, out, n_cand, k, f, words, log_g);
}

}  // namespace

// bitmap (n, f): contiguous uint8/int8 {0,1} rows at any address; cand
// (n_cand, k) contiguous int32 item ids in [0, f); bits: a scratch of
// f * ceil(n / 32) uint32 words at a 4-byte aligned address, fully written
// here; out (n_cand,) int32, fully written.  All on the current device,
// launched on ``stream``.
extern "C" int gather_and_count_launch(const void* bitmap, const void* cand,
                                       void* bits, void* out, int n, int f,
                                       int n_cand, int k, void* stream) {
  if (n <= 0 || n_cand <= 0) return 0;
  if (f <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const int words = (n + 31) / 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* scratch = static_cast<uint32_t*>(bits);

  const dim3 pack_grid((f + PACK_THREADS - 1) / PACK_THREADS,
                       words < MAX_GRID_Y ? words : MAX_GRID_Y);
  gather_and_count_pack_kernel<<<pack_grid, PACK_THREADS, 0, st>>>(
      static_cast<const uint8_t*>(bitmap), scratch, n, f, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int log_g = 0;
  while ((1 << log_g) < words && log_g < 5) ++log_g;
  const auto* ids = static_cast<const int32_t*>(cand);
  auto* counts = static_cast<int32_t*>(out);
  switch (k) {
#define GAC_CASE(K)                                                      \
  case K:                                                                \
    launch_count<K>(scratch, ids, counts, n_cand, k, f, words, log_g, st); \
    break;
    GAC_CASE(1) GAC_CASE(2) GAC_CASE(3) GAC_CASE(4)
    GAC_CASE(5) GAC_CASE(6) GAC_CASE(7) GAC_CASE(8)
#undef GAC_CASE
    default:
      launch_count<0>(scratch, ids, counts, n_cand, k, f, words, log_g, st);
  }
  return (int)cudaGetLastError();
}

// Packed-bitmap support count: AND + popcount over 32-item words, with the
// "== k" compare and the per-candidate sum (the MapReduce combiner) fused
// into the epilogue.  Written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/support_count/packed.py
// (packed_support_count_pallas, body _kernel).  Same function:
//   out[c] = #{ n : sum_w popcount(t[n, w] & cand[c, w]) == kvec[c] }
// Words arrive as int32 tensors carrying the uint32 bit pattern and are read
// as unsigned here.  Pad candidates carry kvec = -1 and never match; every
// candidate reads its own kvec, so one call may mix k (combined waves).
//
// What bounds it on an H100: the popcounts.  At the main path's shapes (a
// 2,048-row block of T10I4D100K, W = 16 words, 32,768 candidates) the call
// moves ~2.5 MB but issues N*C*W ~ 1.1e9 popcounts, and POPC issues at 16
// per clock per SM on compute capability 9.0 (a quarter of the LOP/IADD
// rate), so it is bound by operations, not bytes, by two orders of
// magnitude.
//
// What the design does about it: each 256-thread block owns a 64-row x
// 64-candidate tile and keeps a 16-word slab of both operands in shared
// memory, so every word loaded from device memory is reused 64 times and
// the inner loop is register-only LOP/POPC/IADD over a 4 x 4 register tile
// per thread.  W is tiled, so any vocabulary width fits (W ~ 625 words for a
// 20K-item vocabulary).  Ragged N, C and W edges are masked in the loads
// (zero words) and in the epilogue (rows past N never count).  The (N, C)
// shared-count matrix never leaves registers: the compare with kvec and the
// sum over the tile's rows happen in the epilogue, and the row tiles of one
// candidate tile meet by int32 atomicAdd into the zeroed output (exact:
// integer adds commute).  The TPU grid's sequential N accumulation has no
// counterpart here; blocks run in any order.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                    // transaction rows per block tile
constexpr int BN = 64;                    // candidates per block tile
constexpr int BK = 16;                    // words per step over W
constexpr int TM = 4;                     // rows per thread
constexpr int TN = 4;                     // candidates per thread
constexpr int LANES_N = BN / TN;          // 16 candidate lanes
constexpr int LANES_M = BM / TM;          // 16 row lanes
constexpr int THREADS = LANES_M * LANES_N;  // 256

__global__ void __launch_bounds__(THREADS)
packed_support_count_kernel(const uint32_t* __restrict__ t,
                            const uint32_t* __restrict__ c,
                            const int32_t* __restrict__ kvec,
                            int32_t* __restrict__ out,
                            int n, int n_cand, int w, int cand_tiles) {
  // Word-major slabs (+1 pad: the transposing stores hit distinct banks).
  __shared__ uint32_t ts[BK][BM + 1];
  __shared__ uint32_t cs[BK][BN + 1];
  __shared__ int hits[BN];

  const int tid = threadIdx.x;
  const int tx = tid % LANES_N;
  const int ty = tid / LANES_N;
  const int cand0 = (blockIdx.x % cand_tiles) * BN;
  const int row0 = (blockIdx.x / cand_tiles) * BM;

  if (tid < BN) hits[tid] = 0;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < w; k0 += BK) {
    // Consecutive threads read consecutive words of a row: coalesced.
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      ts[kk][r] = (gr < n && gk < w) ? t[(size_t)gr * w + gk] : 0u;
    }
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gc = cand0 + r, gk = k0 + kk;
      cs[kk][r] = (gc < n_cand && gk < w) ? c[(size_t)gc * w + gk] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ts[kk][ty + i * LANES_M];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = cs[kk][tx + j * LANES_N];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += __popc(a[i] & b[j]);
    }
    __syncthreads();
  }

  // Epilogue: compare with k and count this tile's matching rows.
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = tx + j * LANES_N;
    if (cand0 + col < n_cand) {
      const int k = kvec[cand0 + col];
      int h = 0;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        h += (row0 + ty + i * LANES_M < n) && (acc[i][j] == k);
      if (h) atomicAdd(&hits[col], h);
    }
  }
  __syncthreads();
  if (tid < BN && hits[tid]) atomicAdd(&out[cand0 + tid], hits[tid]);
}

}  // namespace

// out must hold n_cand zeroed int32; all pointers are device pointers of
// contiguous tensors: packed (n, w), cpacked (n_cand, w), kvec (n_cand,).
extern "C" int packed_support_count_launch(const void* packed,
                                           const void* cpacked,
                                           const void* kvec, void* out,
                                           int n, int n_cand, int w,
                                           void* stream) {
  if (n <= 0 || n_cand <= 0) return 0;
  const long long cand_tiles = (n_cand + BN - 1) / BN;
  const long long blocks = cand_tiles * ((n + BM - 1) / BM);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  packed_support_count_kernel<<<(unsigned)blocks, THREADS, 0,
                                (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(packed),
      static_cast<const uint32_t*>(cpacked),
      static_cast<const int32_t*>(kvec), static_cast<int32_t*>(out), n,
      n_cand, w, (int)cand_tiles);
  return (int)cudaGetLastError();
}

// Bitmap x k-hot support count on the tensor cores: int8 operands, int32
// accumulation, with the "== k" compare and the per-candidate sum (the
// MapReduce combiner) fused into the epilogue.  Written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/support_count/kernel.py
// (support_count_pallas, body _kernel).  Same function:
//   out[c] = #{ n : dot(bitmap[n, :], khot[c, :]) == kvec[c] }
// The TPU kernel feeds bf16 to the MXU with f32 accumulation.  Here the
// operands are int8 and the sums int32, which is exact: the bitmap is {0,1},
// k-hot entries are counts <= k (<= 16 on the mining path; the kernel takes
// any value in [0, 127]), and every dot is <= F * 127.  Pad candidates
// carry kvec = -1 and never match; one call may mix k.
//
// What bounds it on an H100: the tensor-core operations.  At the main
// path's shapes (a 2,048-row block of T10I4D100K, F_pad = 512, 32,768
// candidates) the call does 2*N*C*F ~ 6.9e10 int8 operations and moves
// ~18 MB, so it is operation-bound at the 1,979 TOP/s dense int8 rate.
//
// What the design does about it: each 128-thread block (4 warps) owns a
// 64-row x 64-candidate tile, stages 32-deep k-slabs of both operands in
// shared memory and runs 16x16x16 int8 WMMA (mma.sync) fragments, 2 x 2
// per warp, with int32 accumulators held in registers across the whole F
// loop.  The accumulators are staged once through shared memory for the
// epilogue, which compares with kvec and sums the tile's rows per
// candidate: the (N, C) dot matrix is never written to device memory.  Row
// tiles of one candidate tile meet by int32 atomicAdd into the zeroed
// output.  Ragged N, C and F edges are zero-filled in shared memory (a zero
// row or column adds nothing to any dot) and rows past N never count.  This
// is the simple, correct first version: no cp.async/TMA pipeline and no
// wgmma yet, so it runs well below the tensor-core peak.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;          // transaction rows per block tile
constexpr int BN = 64;          // candidates per block tile
constexpr int BK = 32;          // k-slab depth (two 16-deep WMMA steps)
constexpr int FK = 16;          // WMMA k depth
constexpr int THREADS = 128;    // 4 warps in a 2 x 2 layout, 32 x 32 each

// One 16-byte chunk of row ``row`` starting at column ``col`` into smem,
// zero-filled past the ragged edges.
__device__ __forceinline__ void load16(int8_t* dst, const int8_t* src,
                                       int row, int nrows, int col, int ncols,
                                       bool vec16) {
  if (row < nrows && vec16 && col + 16 <= ncols) {
    *reinterpret_cast<int4*>(dst) =
        *reinterpret_cast<const int4*>(src + (size_t)row * ncols + col);
    return;
  }
#pragma unroll
  for (int b = 0; b < 16; ++b)
    dst[b] = (row < nrows && col + b < ncols)
                 ? src[(size_t)row * ncols + col + b] : (int8_t)0;
}

__global__ void __launch_bounds__(THREADS)
support_count_kernel(const int8_t* __restrict__ bitmap,
                     const int8_t* __restrict__ khot,
                     const int32_t* __restrict__ kvec,
                     int32_t* __restrict__ out,
                     int n, int n_cand, int f, int cand_tiles, int vec16) {
  // Each k-slab is stored as two 16-deep planes of 16-byte rows, so every
  // WMMA fragment pointer is 256-bit aligned with a 16-element stride.
  __shared__ __align__(128) int8_t as[BK / FK][BM * FK];
  __shared__ __align__(128) int8_t bs[BK / FK][BN * FK];
  __shared__ __align__(128) int32_t dots[BM * BN];
  __shared__ int hits[BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int cand0 = (blockIdx.x % cand_tiles) * BN;
  const int row0 = (blockIdx.x / cand_tiles) * BM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  // 128 threads x 16 bytes = one 64 x 32 slab of each operand.
  const int lr = tid / 2, plane = tid % 2;
  for (int k0 = 0; k0 < f; k0 += BK) {
    load16(&as[plane][lr * FK], bitmap, row0 + lr, n, k0 + plane * FK, f,
           vec16);
    load16(&bs[plane][lr * FK], khot, cand0 + lr, n_cand, k0 + plane * FK, f,
           vec16);
    __syncthreads();
#pragma unroll
    for (int p = 0; p < BK / FK; ++p) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major>
          b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &as[p][(wm * 32 + i * 16) * FK], FK);
#pragma unroll
      for (int j = 0; j < 2; ++j)  // khot row-major (C, F) == B col-major
        wmma::load_matrix_sync(b[j], &bs[p][(wn * 32 + j * 16) * FK], FK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&dots[(wm * 32 + i * 16) * BN + wn * 32 + j * 16],
                              acc[i][j], BN, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: thread (half, col) compares 32 rows of one candidate column.
  const int col = tid % BN, half = tid / BN;
  const int cidx = cand0 + col;
  int h = 0;
  if (cidx < n_cand) {
    const int k = kvec[cidx];
    for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r)
      h += (row0 + r < n) && (dots[r * BN + col] == k);
  }
  if (half == 1) hits[col] = h;
  __syncthreads();
  if (half == 0 && cidx < n_cand) {
    h += hits[col];
    if (h) atomicAdd(&out[cidx], h);
  }
}

}  // namespace

// out must hold n_cand zeroed int32; all pointers are device pointers of
// contiguous tensors: bitmap (n, f) int8, khot (n_cand, f) int8, kvec
// (n_cand,) int32.  vec16 != 0 promises f % 16 == 0 and 16-byte aligned
// bitmap and khot, enabling 16-byte loads.
extern "C" int support_count_launch(const void* bitmap, const void* khot,
                                    const void* kvec, void* out, int n,
                                    int n_cand, int f, int vec16,
                                    void* stream) {
  if (n <= 0 || n_cand <= 0) return 0;
  const long long cand_tiles = (n_cand + BN - 1) / BN;
  const long long blocks = cand_tiles * ((n + BM - 1) / BM);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  support_count_kernel<<<(unsigned)blocks, THREADS, 0,
                         (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(bitmap), static_cast<const int8_t*>(khot),
      static_cast<const int32_t*>(kvec), static_cast<int32_t*>(out), n,
      n_cand, f, (int)cand_tiles, vec16);
  return (int)cudaGetLastError();
}

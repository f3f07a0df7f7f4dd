// K-SF: bin-ordered staged BLS fold for Hopper (sm_90a).
//
// Replaces the reference's XLA fold before its window scans,
// lightkurve_tpu/ops/bls.py:340-373: per 128-row tile a one-hot (C, 128, n)
// product with the columns, then a cumulative sum over the rows; the same
// form in torch, a one-hot GEMM and a cumsum, is this kernel's yardstick
// (ops/bls_fused.uniform_fold, ops/bls_fused_weighted.weighted_fold).
//
// Input: X (n, cols), contiguous, the columns to fold (the mean-shifted flux
// of B curves, or [w | w*y] of B curves); per period c the deposit sources
// sorted by row, src[c, 0..m_c) (the sample of each deposit), and
// row_start[c, 0..npad] (the first deposit of each row; row_start[c, npad]
// = m_c), both made in torch by ops/bls_staged_fold.fold_deposits.  Output:
// out (C, npad, cols), the inclusive prefix rows of the fold,
//   out[c, r, j] = sum of X[src[c, d], j] over d < row_start[c, r + 1].
//
// What bounds it on the H100: bytes.  Per period it reads the row of X of
// every deposit once (m_c x cols values: each sample once, the samples of
// the first npad - nbins_p rows twice in wrap mode) and writes npad x cols
// values, with one add per value read -- far below the card's operation
// rate.  The one-hot product it replaces did npad x n x cols multiply-adds
// per period and held an (npad, n) operand, which capped the rows x
// cadences a call could fold.
//
// Design: a thread owns one column and a warp 32 adjacent columns of one
// period, so each deposit is one 128-byte row segment load for the warp.
// The deposit sources and row ends are the same for every lane: each warp
// stages them in tiles through its own slice of shared memory, then walks
// the deposits in order with kUnroll loads in flight ahead of the dependent
// adds, writing the running sum of each row as the deposits pass its end.
// A launch of few periods (the staged route folds 8 per call) has too few
// such chains to fill the card, so the caller may cut each period's rows
// into G segments (blockIdx.z): each segment's chain starts at 0 and
// leaves its total in `totals`, and a second kernel adds to every row of
// segment g the carry of segments 0..g-1, summed in that order.  All sums
// are sequential, with no atomics: two runs give the same bits, and an
// empty row repeats the row before it bit for bit, across a segment's
// edge too (the exact ties of the astropy edge mode's truncated windows).
// Launched on the caller's stream; no allocation.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;       // warps per block: column tiles of one period
constexpr int kSrcTile = 256;   // deposit sources a warp stages at a time
constexpr int kEndTile = 256;   // row ends a warp stages at a time
constexpr int kUnroll = 8;      // loads in flight per thread

// The rows [*lo, *hi) of segment g of G.
__device__ __forceinline__ void segment_rows(int g, int G, int npad, int* lo,
                                             int* hi) {
  const int seg = (npad + G - 1) / G;
  *lo = min(g * seg, npad);
  *hi = min(*lo + seg, npad);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
staged_fold_kernel(const T* __restrict__ X, const int* __restrict__ src,
                   const int* __restrict__ row_start, int M, int npad,
                   int cols, T* __restrict__ totals, T* __restrict__ out) {
  __shared__ int s_src[kWarps][kSrcTile];
  __shared__ int s_end[kWarps][kEndTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.y;
  const int col0 = (blockIdx.x * kWarps + warp) * 32;
  if (col0 >= cols) return;  // the whole warp is past the last column
  const int col = col0 + lane;
  const bool active = col < cols;
  const int* sc = src + (size_t)c * M;
  const int* rs = row_start + (size_t)c * (npad + 1);
  const T* x = X + (active ? col : 0);
  T* o = out + (size_t)c * npad * cols + (active ? col : 0);
  int* ssrc = s_src[warp];
  int* send = s_end[warp];
  int r_lo, r_hi;
  segment_rows(blockIdx.z, gridDim.z, npad, &r_lo, &r_hi);
  const int d_hi = rs[r_hi];

  // row ends [base, base + kEndTile): send[i] = row_start[base + i + 1];
  // rows at or past npad never end inside the deposits
  int end_base = r_lo;
  for (int i = lane; i < kEndTile; i += 32)
    send[i] = r_lo + i < npad ? rs[r_lo + i + 1] : INT_MAX;
  __syncwarp();

  T acc = (T)0;
  int r = r_lo;  // the first row not yet written
  for (int d0 = rs[r_lo]; d0 < d_hi; d0 += kSrcTile) {
    const int cnt = min(kSrcTile, d_hi - d0);
    __syncwarp();
    for (int i = lane; i < cnt; i += 32) ssrc[i] = sc[d0 + i];
    __syncwarp();
    for (int dd = 0; dd < cnt; dd += kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = (active && dd + u < cnt) ? x[(size_t)ssrc[dd + u] * cols]
                                        : (T)0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (dd + u >= cnt) break;
        const int d = d0 + dd + u;
        // write every row that ends at or before deposit d
        for (;;) {
          if (r - end_base >= kEndTile) {
            end_base = r;
            __syncwarp();
            for (int i = lane; i < kEndTile; i += 32)
              send[i] = end_base + i < npad ? rs[end_base + i + 1] : INT_MAX;
            __syncwarp();
          }
          if (send[r - end_base] > d) break;
          if (active) o[(size_t)r * cols] = acc;
          ++r;
        }
        acc += v[u];
      }
    }
  }
  for (; r < r_hi; ++r)
    if (active) o[(size_t)r * cols] = acc;
  if (gridDim.z > 1 && active)
    totals[((size_t)c * gridDim.z + blockIdx.z) * cols + col] = acc;
}

// Add to every row of segment g >= 1 (blockIdx.z + 1) the carry of
// segments 0..g-1: their totals summed in order from 0.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
staged_fold_carry_kernel(const T* __restrict__ totals, int npad, int cols,
                         int G, T* __restrict__ out) {
  const int col = blockIdx.x * kWarps * 32 + threadIdx.x;
  if (col >= cols) return;
  const int c = blockIdx.y, g = blockIdx.z + 1;
  const T* t = totals + (size_t)c * G * cols + col;
  T carry = (T)0;
  for (int h = 0; h < g; ++h) carry += t[(size_t)h * cols];
  int r_lo, r_hi;
  segment_rows(g, G, npad, &r_lo, &r_hi);
  T* o = out + (size_t)c * npad * cols + col;
#pragma unroll 8
  for (int r = r_lo; r < r_hi; ++r) o[(size_t)r * cols] += carry;
}

template <typename T>
int launch(const T* X, const int* src, const int* row_start, int C, int M,
           int npad, int cols, int G, T* totals, T* out, void* stream) {
  if (C < 1 || M < 1 || npad < 1 || cols < 1 || G < 1 || G > npad ||
      C > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((cols + kWarps * 32 - 1) / (kWarps * 32), C, G);
  staged_fold_kernel<T><<<grid, kWarps * 32, 0, s>>>(
      X, src, row_start, M, npad, cols, totals, out);
  int code = (int)cudaGetLastError();
  if (code != 0 || G == 1) return code;
  grid.z = G - 1;
  staged_fold_carry_kernel<T><<<grid, kWarps * 32, 0, s>>>(totals, npad,
                                                          cols, G, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lk_bls_staged_fold_f32(const float* X, const int* src,
                           const int* row_start, int C, int M, int npad,
                           int cols, int G, float* totals, float* out,
                           void* stream) {
  return launch<float>(X, src, row_start, C, M, npad, cols, G, totals, out,
                       stream);
}

int lk_bls_staged_fold_f64(const double* X, const int* src,
                           const int* row_start, int C, int M, int npad,
                           int cols, int G, double* totals, double* out,
                           void* stream) {
  return launch<double>(X, src, row_start, C, M, npad, cols, G, totals, out,
                        stream);
}

}  // extern "C"

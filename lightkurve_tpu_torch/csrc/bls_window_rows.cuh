// One-pass duration-window scans over bin prefix sums: the row tiles, the
// per-duration running bests and the split combine shared by K-U
// (bls_window_uniform.cu) and K-W (bls_window.cu).
//
// A block holds 32 curves of one period (lane = threadIdx.x, the fastest
// axis of the prefix sums) and kLkRowSplits threads per curve
// (threadIdx.y).  The block walks the period's start rows r < nbins_p in
// tiles of row_tile rows.  For each tile it stages the prefix rows the
// tile's windows read -- rows r0 - 1 .. r0 + row_tile + k_max - 2 of each
// of its curves' columns -- into shared memory ([row][column][lane], so a
// warp's accesses never share a bank), and each thread then takes one
// contiguous run of the tile's start rows and evaluates EVERY duration at
// each of them.  So each prefix value is read from device memory about
// once (the k_max halo rows of a tile once more, from L2), where a
// duration-outer loop streamed the column once per duration.
//
// Tie rules, those of the staged scans: a thread visits its rows in
// ascending order with strict >, so it keeps the first maximum of its
// rows; threads combine per duration by the larger value and, on equal
// values, the lower start row, which is the first maximum over all rows;
// over durations a later one wins only if strictly greater (the caller's
// finish).  When a tile of rows does not fit the shared-memory budget
// (very long durations), the block reads its rows from global memory
// instead, in the same order (kStaged = false).
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bls_window_body.cuh"

constexpr int kLkRowLanes = 32;    // curves per block
constexpr int kLkRowSplits = 8;    // threads per curve
// shared memory a scan block may take: two blocks fit one SM
constexpr size_t kLkRowsSmemBudget = 112 * 1024;

// The prefix rows of one tile: row i is prefix row r0 - 1 + i of column q
// of this thread's curve; prefix row -1 is 0.
template <typename T, int NCOL, bool kStaged>
struct LkTileRows {
  const T* tile;        // shared, [i][q][lane]
  const T* col[NCOL];   // global, the block's first curve's columns, row r
                        // at [r * stride] (the thread's curve at + lane)
  int stride;
  int r0;

  __device__ __forceinline__ T get(int i, int q) const {
    if (kStaged) return tile[(i * NCOL + q) * kLkRowLanes + threadIdx.x];
    const int r = r0 - 1 + i;
    return r >= 0 ? col[q][(size_t)r * stride + threadIdx.x] : (T)0;
  }

  // Start copying the n_rows prefix rows of the tile that starts at row
  // r_first (its row i is prefix row r_first - 1 + i) of the block's
  // n_curves curves into smem_tile, all loads in flight at once
  // (asynchronous copies, 16 bytes each where the rows allow; rows past
  // npad, which no valid window reads, and curves past the last are 0).
  // lk_stage_wait() completes them; call between barriers.
  __device__ __forceinline__ void stage(T* smem_tile, int r_first,
                                        int n_curves, int n_rows,
                                        int npad) const {
    constexpr int kVec = 16 / sizeof(T);              // values per copy
    constexpr int kCopies = NCOL * kLkRowLanes / kVec;  // copies per row
    const int tid = threadIdx.y * kLkRowLanes + threadIdx.x;
    bool vec = n_curves == kLkRowLanes && (stride * sizeof(T)) % 16 == 0;
#pragma unroll
    for (int q = 0; q < NCOL; ++q)
      vec = vec && reinterpret_cast<size_t>(col[q]) % 16 == 0;
    if (vec) {
      for (int e = tid; e < n_rows * kCopies;
           e += kLkRowLanes * kLkRowSplits) {
        const int i = e / kCopies, c = e - i * kCopies;
        const int q = c / (kCopies / NCOL);
        const int l0 = (c - q * (kCopies / NCOL)) * kVec;
        const int r = r_first - 1 + i;
        T* dst = &smem_tile[(i * NCOL + q) * kLkRowLanes + l0];
        if (r >= 0 && r < npad) {
          __pipeline_memcpy_async(dst, &col[q][(size_t)r * stride + l0], 16);
        } else {
#pragma unroll
          for (int u = 0; u < kVec; ++u) dst[u] = (T)0;
        }
      }
      return;
    }
    const bool active = (int)threadIdx.x < n_curves;
    for (int i = threadIdx.y; i < n_rows; i += kLkRowSplits) {
      const int r = r_first - 1 + i;
      const bool in = active && r >= 0 && r < npad;
#pragma unroll
      for (int q = 0; q < NCOL; ++q) {
        T* dst = &smem_tile[(i * NCOL + q) * kLkRowLanes + threadIdx.x];
        if (in)
          __pipeline_memcpy_async(
              dst, &col[q][(size_t)r * stride + threadIdx.x], sizeof(T));
        else
          *dst = (T)0;
      }
    }
  }
};

// Complete this thread's asynchronous copies (a barrier must follow before
// other threads read them).
__device__ __forceinline__ void lk_stage_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// The contiguous run [*lo, *hi) of a tile's n_start start rows that this
// thread scans.
__device__ __forceinline__ void lk_split_run(int n_start, int* lo, int* hi) {
  const int per = (n_start + kLkRowSplits - 1) / kLkRowSplits;
  *lo = min((int)threadIdx.y * per, n_start);
  *hi = min(*lo + per, n_start);
}

template <typename T, int DMAX>
__device__ __forceinline__ void lk_best_init(T (&v)[DMAX], int (&arg)[DMAX]) {
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    v[j] = lk_neg_inf<T>();
    arg[j] = 0;
  }
}

// Combine the kLkRowSplits threads of each curve into split 0, per
// duration: the larger value wins, on equal values the lower start row.
// scratch: kLkRowSplits x 32 values then as many ints.
template <typename T, int DMAX>
__device__ void lk_combine_splits(T (&v)[DMAX], int (&arg)[DMAX], int nd,
                                  unsigned char* scratch) {
  T* sv = reinterpret_cast<T*>(scratch);
  int* sa = reinterpret_cast<int*>(sv + kLkRowSplits * kLkRowLanes);
  const int lane = threadIdx.x, split = threadIdx.y;
  const int me = split * kLkRowLanes + lane;
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j >= nd) break;
    __syncthreads();
    sv[me] = v[j];
    sa[me] = arg[j];
    __syncthreads();
    if (split == 0) {
      for (int s = 1; s < kLkRowSplits; ++s) {
        const T o = sv[s * kLkRowLanes + lane];
        const int a = sa[s * kLkRowLanes + lane];
        if (o > v[j] || (o == v[j] && a < arg[j])) {
          v[j] = o;
          arg[j] = a;
        }
      }
    }
  }
}

// The launch plan of a scan: the largest tile of start rows (128, 64 or
// 32) whose staged prefix rows (tile + k_max rows of ncol columns of 32
// curves, and shared_per_row bytes more per staged row) and per-row table
// (table_per_row bytes a start row) fit kLkRowsSmemBudget; past that, a
// 32-row tile read from global memory.
struct LkRowsPlan {
  int row_tile;
  bool staged;
  size_t smem;
};

inline LkRowsPlan lk_rows_plan(int k_max, int ncol, size_t item,
                               size_t table_per_row, size_t shared_per_row) {
  const size_t scratch =
      (size_t)kLkRowSplits * kLkRowLanes * (item + sizeof(int));
  for (int rt = 128; rt >= 32; rt /= 2) {
    const size_t bytes =
        rt * table_per_row +
        (size_t)(rt + k_max) * (ncol * kLkRowLanes * item + shared_per_row);
    if (bytes <= kLkRowsSmemBudget)
      return {rt, true, bytes > scratch ? bytes : scratch};
  }
  const size_t bytes = 32 * table_per_row;
  return {32, false, bytes > scratch ? bytes : scratch};
}

// Let `kernel` take `smem` bytes of dynamic shared memory.
template <typename K>
inline int lk_allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The warp-per-curve fold shared by the fused BLS kernels K-F
// (bls_fused.cu, uniform weights) and K-WF (bls_weighted_fused.cu,
// per-sample weights).
//
// A block holds ONE trial period and W curves, one warp each, and keeps in
// shared memory each curve's prefix columns of rows_cap values (one for
// K-F, Sigma w and Sigma w*y for K-WF), plus a staged tile of fold ids.
//
//   * Fold ids.  For a tile of samples the whole block computes the ids
//     once, for all its warps: exact fmod, the product with the
//     dtype-rounded 1/d_phase, a truncating cast, a clip to nbins - 1.  In
//     each aligned run of 32 samples the lanes that share an id are found
//     with __match_any_sync.  Equal ids need not be adjacent (a period
//     shorter than 32 cadences, or an unsorted time grid), so a run is
//     staged one of two ways: when every group is a contiguous range of
//     lanes, by where each group starts; otherwise by each group's lowest
//     lane (its leader) and the mask of the others.
//   * Deposits.  Each warp reads 32 consecutive samples of its curve (the
//     curves are rows of a (B, n) array, so one 128-byte segment in
//     float32), sums each group -- by a segmented warp scan in a run of
//     contiguous groups, else on the leader in ascending lane order -- and
//     one lane per group adds the sum to the row.  No float atomics, and
//     the order of every sum is fixed, so the result is the same from run
//     to run.
//   * Prefix.  A warp scan turns the column into inclusive prefix sums P0
//     of the single-deposit fold; in wrap mode the extension rows
//     r in [nbp, nbp + k_max - 1) then become P0[r] + P0[r - nbp], which is
//     exactly the prefix of the circular double-deposit fold (every sample
//     again nbp rows on); in astropy edge mode they keep P0, the saturated
//     total.
//   * Window scan.  The lanes take contiguous runs of start bins (of odd
//     length, so the 32 lanes read 32 distinct banks) and their first
//     maxima are combined in ascending order with strict >, which is the
//     first maximum of one sequential pass.
//
// The block width W is chosen at launch among the widths whose shared
// memory fits the device's opt-in limit: the one with the most resident
// warps per SM by the occupancy calculator (registers included), the
// widest on ties.
#pragma once

#include <cuda_runtime.h>

#include "bls_window_body.cuh"

#define LK_FULL_MASK 0xffffffffu

constexpr int kLkMaxWarps = 32;   // curves (warps) per block at most
constexpr int kLkIdTile = 512;    // samples whose fold ids are staged at once
constexpr int kLkBatch = 4;       // runs of 32 samples loaded ahead

// Shared memory of one fused block: ``per_warp_row`` bytes per row for
// each of ``warps`` curves, ``shared_row`` bytes per row for the block
// (K-F's count column), and the staged ids, lane masks and run flags.
// The same formula is ops/bls_fused.fused_smem_bytes on the host.
inline size_t lk_fold_smem_bytes(int rows_cap, int warps, size_t per_warp_row,
                                 size_t shared_row) {
  return (size_t)rows_cap * (warps * per_warp_row + shared_row) +
         (size_t)kLkIdTile * (sizeof(int) + sizeof(unsigned)) +
         (size_t)(kLkIdTile / 32) * sizeof(int);
}

inline int lk_shared_optin(int dev) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

// The block width (warps) for ``kernel`` at ``rows_cap`` rows: among the
// widths that fit the opt-in limit, the one with the most resident warps
// per SM, the widest on ties.  Sets the kernel's dynamic shared memory
// limit and returns the width and its resident blocks per SM (an error if
// not even one warp fits).
template <typename Kernel>
cudaError_t lk_fold_block(Kernel kernel, int rows_cap, size_t per_warp_row,
                          size_t shared_row, int* warps_out,
                          int* blocks_out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int optin = lk_shared_optin(dev);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int best_w = 0, best_blocks = 0;
  for (int w = kLkMaxWarps; w >= 1; --w) {
    const size_t smem = lk_fold_smem_bytes(rows_cap, w, per_warp_row,
                                           shared_row);
    if (smem > (size_t)optin) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        32 * w, smem);
    if (err != cudaSuccess) return err;
    if (blocks * w > best_blocks * best_w) {
      best_w = w;
      best_blocks = blocks;
    }
  }
  *warps_out = best_w;
  *blocks_out = best_blocks;
  return best_w > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

// Stage the fold ids of samples [i0, i0 + m) of one period (m <= kLkIdTile)
// for the whole block, per aligned run of 32 samples.  When every group of
// equal ids in the run is a contiguous range of lanes (the usual case: a
// sorted time grid at periods longer than 32 cadences), srun[run] is 1,
// the group's LAST lane deposits (sid[i] = id, -1 on the others) and
// speer[i] holds the lane where its group starts.  Otherwise srun[run] is
// 0, the group's lowest lane (its leader) deposits and speer[i] holds the
// leader's other lanes, ascending.  Ids outside the ``rows`` rows are -1.
// ``cnt`` (or nullptr) gets each group's size added at its id (integer
// shared atomics: exact, so order-free).  The tail up to a multiple of 32
// is staged as -1.
template <typename T>
__device__ __forceinline__ void lk_stage_fold_ids(
    const T* __restrict__ ts, int m, T period, T inv_d_phase, int nbins,
    int rows, int* sid, unsigned* speer, int* srun, int* cnt) {
  const int lane = threadIdx.x & 31;
  const int m32 = (m + 31) & ~31;
  for (int i = threadIdx.x; i < m32; i += blockDim.x) {
    int id = -1;
    if (i < m) {
      const T phase = fmod(ts[i], period);
      // 1/d_phase is rounded in T on the host: the reference computes the
      // bin position as this product, not as a division
      id = (int)lk_mul(phase, inv_d_phase);   // truncating cast
      id = min(max(id, 0), nbins - 1);
    }
    const unsigned peers = __match_any_sync(LK_FULL_MASK, id);
    const int first = __ffs(peers) - 1;
    const int last = 31 - __clz(peers);
    const bool contig = __all_sync(
        LK_FULL_MASK,
        peers == ((LK_FULL_MASK >> (31 - last)) & (LK_FULL_MASK << first)));
    const bool dep = lane == (contig ? last : first) && id >= 0 && id < rows;
    sid[i] = dep ? id : -1;
    speer[i] = contig ? (unsigned)first
                      : (dep ? (peers & (peers - 1u)) : 0u);
    if (lane == 0) srun[i / 32] = contig;
    if (cnt != nullptr && dep) atomicAdd(&cnt[id], __popc(peers));
  }
}

// One warp deposits samples [0, m) of its curve (``src0``, and ``src1``
// when NV == 2, already offset to the tile) into its columns.  A run whose
// groups are contiguous sums each group by a segmented warp scan (a fixed
// tree order; the sum lands on the group's last lane); any other run sums
// each group on its leader in ascending lane order.  Then one lane per
// group adds the sum to the row.
template <typename T, int NV>
__device__ __forceinline__ void lk_deposit_tile(
    const T* __restrict__ src0, const T* __restrict__ src1, int m,
    const int* sid, const unsigned* speer, const int* srun, T* col0,
    T* col1) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < m; c0 += 32 * kLkBatch) {
    T v[kLkBatch][NV];
#pragma unroll
    for (int u = 0; u < kLkBatch; ++u) {
      const int i = c0 + 32 * u + lane;
      v[u][0] = i < m ? src0[i] : (T)0;
      if (NV == 2) v[u][NV - 1] = i < m ? src1[i] : (T)0;
    }
#pragma unroll
    for (int u = 0; u < kLkBatch; ++u) {
      const int c = c0 + 32 * u;
      if (c >= m) break;                      // the same for the warp
      const int i = c + lane;
      const int id = sid[i];
      const unsigned info = speer[i];
      T s[NV];
#pragma unroll
      for (int q = 0; q < NV; ++q) s[q] = v[u][q];
      if (srun[c / 32]) {                     // the same for the warp
        const int first = (int)info;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const T o = __shfl_up_sync(LK_FULL_MASK, s[q], off);
            if (lane - off >= first) s[q] += o;
          }
        }
      } else {
        unsigned rest = info;
        while (__any_sync(LK_FULL_MASK, rest != 0u)) {
          const int from = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const T o = __shfl_sync(LK_FULL_MASK, v[u][q], from);
            if (rest) s[q] += o;
          }
          rest &= rest - 1u;
        }
      }
      if (id >= 0) {
        col0[id] += s[0];
        if (NV == 2) col1[id] += s[NV - 1];
      }
    }
  }
}

// Inclusive prefix sums of col[0, rows) by one warp, 32 rows per step.  A
// row that adds nothing repeats the last row that did, bit for bit, as a
// sequential prefix does (the tree's own association would differ in the
// last bit): the saturated rows of astropy edge mode then stay exact
// copies, and truncated windows of equal content tie exactly, so the
// first duration wins them as in the staged scan.
template <typename V>
__device__ __forceinline__ void lk_warp_prefix(V* col, int rows) {
  const int lane = threadIdx.x & 31;
  V carry = (V)0;
  for (int r0 = 0; r0 < rows; r0 += 32) {
    const int r = r0 + lane;
    const V v = r < rows ? col[r] : (V)0;
    V x = v;
    int last = v != (V)0 ? lane : -1;        // last lane <= this one adding
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const V y = __shfl_up_sync(LK_FULL_MASK, x, off);
      const int l = __shfl_up_sync(LK_FULL_MASK, last, off);
      if (lane >= off) {
        x += y;
        last = max(last, l);
      }
    }
    x = __shfl_sync(LK_FULL_MASK, x, last >= 0 ? last : lane);
    x = last >= 0 ? x + carry : carry;
    if (r < rows) col[r] = x;
    carry = __shfl_sync(LK_FULL_MASK, x, 31);
  }
}

// Wrap mode: rows r in [nbp, rows) become P0[r] + P0[r - nbp] (the
// circular double-deposit fold's prefix).  Runs of 32 rows from the top
// down, reads before writes, so every source row is still P0 when read
// (a source r - nbp may itself be an extension row when k_max - 1 > nbp).
template <typename V>
__device__ __forceinline__ void lk_wrap_rows(V* col, int nbp, int rows) {
  const int lane = threadIdx.x & 31;
  const int ext = rows - nbp;
  for (int e0 = ((ext - 1) / 32) * 32; e0 >= 0 && ext > 0; e0 -= 32) {
    const int e = e0 + lane;
    const V add = e < ext ? col[e] : (V)0;
    __syncwarp();
    if (e < ext) col[nbp + e] += add;
    __syncwarp();
  }
}

// This lane's run of start bins [lo, hi) out of [0, r_end): runs of an
// odd length, so the lanes' rows fall in distinct shared-memory banks.
__device__ __forceinline__ void lk_lane_range(int r_end, int* lo, int* hi) {
  const int seg = ((r_end + 31) / 32) | 1;
  *lo = min((threadIdx.x & 31) * seg, r_end);
  *hi = min(*lo + seg, r_end);
}

// Combine the lanes' first maxima of contiguous ascending runs: a later
// run wins only if strictly greater, so lane 0 ends with the first maximum
// of the whole range (the other lanes hold partial results).
template <typename T>
__device__ __forceinline__ void lk_warp_first_max(T* v, int* arg) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T ov = __shfl_down_sync(LK_FULL_MASK, *v, off);
    const int oa = __shfl_down_sync(LK_FULL_MASK, *arg, off);
    if ((lane & (2 * off - 1)) == 0 && ov > *v) {
      *v = ov;
      *arg = oa;
    }
  }
}

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
//     lanes, by where each group starts (in the lane's id word) and the
//     scan rounds its widest group needs; otherwise by each group's lowest
//     lane (its leader) and the mask of the others.
//   * Deposits.  Each warp reads 32 consecutive samples of its curve (the
//     curves are rows of a (B, n) array, so one 128-byte segment in
//     float32), sums each group -- by a segmented warp scan in a run of
//     contiguous groups, else on the leader in ascending lane order -- and
//     one lane per group adds the sum to the row.  The scan runs only the
//     rounds that the run's widest group needs (staged with the ids):
//     none where every sample has a bin of its own, as at a cadence
//     longer than the bin width, two for groups of 3-4 samples.  A round
//     past the widest group adds nothing to any depositing lane, so the
//     sums are those of the full 5-round scan, bit for bit.  No float
//     atomics, and the order of every sum is fixed, so the result is the
//     same from run to run.
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
//
// What bounds the fold on the H100: per run of 32 samples a warp sends NV
// global loads, 2 shared loads of staged words (the run's rounds and the
// lane's id word; a scattered run also its leader's mask), NV shuffles a
// scan round and 2 x NV shared loads and stores for the deposit, all on
// the SM's shared-memory and shuffle pipe (MIO), one per clock.
// With NV = 2 (K-WF) that is 8 at a cadence longer than the bin width (no
// round) and 12 for groups of 3-4 samples (two rounds), where a fixed
// 5-round scan that read 3 staged words sent 19; the L2 traffic (8
// bytes a sample, curve and period) stays below what the card delivers,
// so the MIO pipe, not L2, sets the fold's pace at the block widths that
// keep many warps resident.  Where few are (long periods), the latency of
// each run's chain of loads and shuffles does: the deposit starts a whole
// batch's staged loads before its first shuffle.
#pragma once

#include <cuda_runtime.h>

#include "bls_window_body.cuh"

#define LK_FULL_MASK 0xffffffffu

constexpr int kLkMaxWarps = 32;   // curves (warps) per block at most
constexpr int kLkIdTile = 512;    // samples whose fold ids are staged at once
constexpr int kLkBatch = 4;       // runs of 32 samples loaded ahead

// A staged run's word: the scan rounds its contiguous groups need (0-5),
// or kLkScattered where a group is not a contiguous range of lanes.
constexpr signed char kLkScattered = -1;
// A staged id word's low 16 bits where its lane does not deposit (rows stay
// below it: a block's shared memory holds fewer than 2^16 rows).
constexpr int kLkNoId = 0xFFFF;
// Kinds of staged runs a launch counts: runs at 0-5 rounds, scattered runs.
constexpr int kLkRunKinds = 7;
// The block's run region: a word per run of a tile, then kLkRunKinds
// counts of the runs the block staged.
constexpr size_t kLkRunBytes = (kLkIdTile / 32) * sizeof(int);
static_assert(kLkIdTile / 32 + kLkRunKinds * sizeof(int) <= kLkRunBytes,
              "the run words and counts outgrow their region");

// Shared memory of one fused block: ``per_warp_row`` bytes per row for
// each of ``warps`` curves, ``shared_row`` bytes per row for the block
// (K-F's count column), the staged ids and lane masks, and the run region.
// The same formula is ops/bls_fused.fused_smem_bytes on the host.
inline size_t lk_fold_smem_bytes(int rows_cap, int warps, size_t per_warp_row,
                                 size_t shared_row) {
  return (size_t)rows_cap * (warps * per_warp_row + shared_row) +
         (size_t)kLkIdTile * (sizeof(int) + sizeof(unsigned)) + kLkRunBytes;
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

// The block's counts of staged runs, by kind, after the run words.
__device__ __forceinline__ int* lk_run_kinds(signed char* srun) {
  return reinterpret_cast<int*>(srun + kLkIdTile / 32);
}

// Stage the fold ids of samples [i0, i0 + m) of one period (m <= kLkIdTile)
// for the whole block, per aligned run of 32 samples.  The low 16 bits of
// sid[i] hold the id where lane i deposits, kLkNoId elsewhere.  When every
// group of equal ids in the run is a contiguous range of lanes (the usual
// case: a sorted time grid at periods longer than 32 cadences), srun[run]
// holds the scan rounds its widest depositing group needs,
// ceil(log2(width)), the group's LAST lane deposits and the bits of sid[i]
// above the id hold the lane where its group starts.  Otherwise srun[run]
// is kLkScattered, the group's lowest lane (its leader) deposits and
// speer[i] holds the leader's other lanes, ascending.  Ids outside the
// ``rows`` rows (and the tail up to a multiple of 32) deposit nowhere.
// ``cnt`` (or nullptr) gets each group's size added at its id and, when
// the launch counts (``run_counts`` not nullptr), the block's count of the
// run's kind one (integer shared atomics: exact, so order-free).
template <typename T>
__device__ __forceinline__ void lk_stage_fold_ids(
    const T* __restrict__ ts, int m, T period, T inv_d_phase, int nbins,
    int rows, int* sid, unsigned* speer, signed char* srun, int* cnt,
    const unsigned long long* run_counts) {
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
    const bool kept = id >= 0 && id < rows;
    const bool dep = lane == (contig ? last : first) && kept;
    const int widest = __reduce_max_sync(LK_FULL_MASK,
                                         kept ? __popc(peers) : 1);
    const int rounds = widest > 1 ? 32 - __clz(widest - 1) : 0;
    // the lane's word: its id where it deposits, else kLkNoId, and in a
    // contiguous run the lane where its group starts above it
    sid[i] = (dep ? id : kLkNoId) | (contig ? first << 16 : 0);
    if (!contig) speer[i] = dep ? (peers & (peers - 1u)) : 0u;
    if (lane == 0) {
      srun[i / 32] = contig ? (signed char)rounds : kLkScattered;
      if (run_counts != nullptr)
        atomicAdd(lk_run_kinds(srun) + (contig ? rounds : kLkRunKinds - 1),
                  1);
    }
    if (cnt != nullptr && dep) atomicAdd(&cnt[id], __popc(peers));
  }
}

// One warp deposits samples [0, m) of its curve (``src0``, and ``src1``
// when NV == 2, already offset to the tile) into its columns, kLkBatch
// runs at a time, their values and staged words loaded first.  A run whose
// groups are contiguous sums each group by a segmented warp scan of the
// run's staged rounds (a fixed tree order; the sum lands on the group's
// last lane; no round where every group is one lane); any other run sums
// each group on its leader in ascending lane order.  Then one lane per
// group adds the sum to the row.
template <typename T, int NV>
__device__ __forceinline__ void lk_deposit_tile(
    const T* __restrict__ src0, const T* __restrict__ src1, int m,
    const int* sid, const unsigned* speer, const signed char* srun, T* col0,
    T* col1) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < m; c0 += 32 * kLkBatch) {
    T v[kLkBatch][NV];
    int words[kLkBatch], runs[kLkBatch];
#pragma unroll
    for (int u = 0; u < kLkBatch; ++u) {
      const int i = c0 + 32 * u + lane;
      v[u][0] = i < m ? src0[i] : (T)0;
      if (NV == 2) v[u][NV - 1] = i < m ? src1[i] : (T)0;
      words[u] = sid[i];                      // i < kLkIdTile; past m unused
      runs[u] = srun[c0 / 32 + u];
    }
#pragma unroll
    for (int u = 0; u < kLkBatch; ++u) {
      const int c = c0 + 32 * u;
      if (c >= m) break;                      // the same for the warp
      const int i = c + lane;
      const int word = words[u];
      const int id = word & kLkNoId;
      const int rounds = runs[u];             // the same for the warp
      T s[NV];
#pragma unroll
      for (int q = 0; q < NV; ++q) s[q] = v[u][q];
      if (rounds > 0) {
        // a round adds the value ``off`` lanes down while that lane is in
        // the group; rounds with off >= 2^rounds would add nothing to a
        // depositing lane
        const int first = word >> 16;
        const int span = 1 << rounds;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          if (off >= span) break;             // the same for the warp
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const T o = __shfl_up_sync(LK_FULL_MASK, s[q], off);
            if (lane - off >= first) s[q] += o;
          }
        }
      } else if (rounds == kLkScattered) {
        unsigned rest = speer[i];
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
      if (id != kLkNoId) {
        col0[id] += s[0];
        if (NV == 2) col1[id] += s[NV - 1];
      }
    }
  }
}

// Zero the block's run counts when the launch counts (``run_counts`` not
// nullptr); the caller syncs the block before the first staging.
__device__ __forceinline__ void lk_zero_run_kinds(
    signed char* srun, const unsigned long long* run_counts) {
  if (run_counts != nullptr && threadIdx.x < kLkRunKinds)
    lk_run_kinds(srun)[threadIdx.x] = 0;
}

// Add the block's run counts to the launch's ``run_counts`` (one integer
// atomic per kind: exact in any order), after the last staging's barrier.
__device__ __forceinline__ void lk_flush_run_kinds(
    signed char* srun, unsigned long long* run_counts) {
  if (run_counts == nullptr || threadIdx.x >= kLkRunKinds) return;
  const int n = lk_run_kinds(srun)[threadIdx.x];
  if (n != 0) atomicAdd(&run_counts[threadIdx.x], (unsigned long long)n);
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

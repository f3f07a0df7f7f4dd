// K-W: weighted BLS duration-window scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel window_scan_pallas / _make_kernel in
// lightkurve_tpu/ops/bls_window_pallas.py (pl.pallas_call at :316).
//
// Input: csum (C, npad, 2B), inclusive bin prefix sums of [sum w | sum w*y]
// over the circular double-deposit fold (made by K-SF, ops/bls_staged_fold),
// totals (2B,), per-period bin counts nbins_p (C,) and periods pc (C,).
// Output: five (C, B) arrays -- power, depth, raw w_in, transit time and
// duration of each (period, curve) winner.
//
// What bounds it on the H100: bytes, one pass over csum, with 12 operations
// per window and curve (three of them divisions) close behind.  The first
// design gave one thread to each (period, curve) in blocks of 128 and
// looped over durations outside, start rows inside: four prefix reads per
// window, the column streamed once per duration, and at the staged route's
// 8 periods per call 8 x B/128 blocks of 4 warps -- under one block per SM.
// That ran at 12x the one-pass bound.
//
// Design (bls_window_rows.cuh): a block holds 32 curves of one period and 8
// threads per curve, so 8 periods of 2048 curves are 512 blocks of 8
// warps.  The block walks the start rows in tiles, staging the prefix rows
// of each tile (w and w*y of its 32 curves) in shared memory; each thread
// takes a contiguous run of the tile's start rows and evaluates every
// duration there: the row's two lower prefix values are read once for all
// durations.  The winner's statistics are reconstructed by
// lk_weighted_window_keep, as K-WF does.  What holds it now is instructions: the two
// IEEE divisions of every window and curve, times the durations, on top
// of the tile's row copies, at about four times the one-pass bound.  A
// period whose windows would reach past its npad rows gets NaN statistics
// instead of a read past its slab.  No atomics, no allocation; launched on
// the caller's stream.
#include <cuda_runtime.h>

#include "bls_window_body.cuh"
#include "bls_window_rows.cuh"

namespace {

template <typename T, int DMAX, bool kStaged>
__global__ void __launch_bounds__(kLkRowLanes * kLkRowSplits)
weighted_window_kernel(const T* __restrict__ csum,
                       const int* __restrict__ nbins_p,
                       const T* __restrict__ pc, const T* __restrict__ total,
                       int npad, int B, int k_max, int row_tile,
                       LkDurations durs, T d_phase, int likelihood, T* power,
                       T* depth, T* w_in_out, T* t0, T* dur) {
  extern __shared__ __align__(16) unsigned char lk_smem[];
  const int c = blockIdx.y;
  const int lane = threadIdx.x, split = threadIdx.y;
  const int b = blockIdx.x * kLkRowLanes + lane;
  const bool active = b < B;
  const size_t o = (size_t)c * B + b;
  const int nbp = nbins_p[c];
  if (nbp + min(k_max, nbp) - 1 > npad) {
    // a window would read past this period's npad rows: NaN, never a read
    // into the next period's slab (the same for the whole block)
    if (active && split == 0)
      power[o] = depth[o] = w_in_out[o] = t0[o] = dur[o] = (T)NAN;
    return;
  }
  const int nd = durs.n;
  const int b0 = blockIdx.x * kLkRowLanes;
  const T* base = csum + (size_t)c * npad * 2 * B + b0;
  const T* cw = base + (active ? lane : 0);
  const T* cwy = base + B + (active ? lane : 0);
  const T tw = active ? total[b] : (T)0;
  const T twy = active ? total[B + b] : (T)0;
  const bool like = likelihood != 0;
  T* tile = reinterpret_cast<T*>(lk_smem);
  LkTileRows<T, 2, kStaged> rows{tile, {base, base + B}, 2 * B, 0};
  T v[DMAX];
  int arg[DMAX];
  lk_best_init<T, DMAX>(v, arg);
  for (int r0 = 0; r0 < nbp; r0 += row_tile) {
    const int n_start = min(row_tile, nbp - r0);
    rows.r0 = r0;
    if (kStaged) {
      __syncthreads();  // the previous tile is consumed
      rows.stage(tile, r0, min(kLkRowLanes, B - b0), n_start + k_max, npad);
      lk_stage_wait();
      __syncthreads();
    }
    int lo, hi;
    lk_split_run(n_start, &lo, &hi);
    for (int i = lo; active && i < hi; ++i) {
      const T lo_w = rows.get(i, 0), lo_wy = rows.get(i, 1);
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < nd && durs.k[j] <= nbp) {
          const int k = durs.k[j];
          const T w_in = rows.get(i + k, 0) - lo_w;
          const T w_out = tw - w_in;
          if (w_in > (T)0 && w_out > (T)0) {
            const T wy_in = rows.get(i + k, 1) - lo_wy;
            const T wy_out = twy - wy_in;
            const T dep = wy_out / w_out - wy_in / w_in;
            const T obj = like ? ((T)0.5 * w_in) * dep * dep
                               : dep * lk_rsqrt((T)1 / w_in + (T)1 / w_out);
            if (obj > v[j]) {
              v[j] = obj;
              arg[j] = r0 + i;
            }
          }
        }
      }
    }
  }
  lk_combine_splits<T, DMAX>(v, arg, nd, lk_smem);
  if (split != 0 || !active) return;
  LkWeightedBest<T> best = {lk_neg_inf<T>(), 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < nd)
      lk_weighted_window_keep<T>(cw, cwy, 2 * B, nbp, durs.k[j], j == 0, v[j],
                                 arg[j], tw, twy, pc[c], d_phase,
                                 (T)durs.value[j], &best);
  }
  power[o] = best.v;
  depth[o] = best.depth;
  w_in_out[o] = best.w_in;
  t0[o] = best.t0;
  dur[o] = best.dur;
}

template <typename T, int DMAX, bool kStaged>
int launch_kernel(const LkRowsPlan& plan, dim3 grid, dim3 block,
                  cudaStream_t stream, const T* csum, const int* nbins_p,
                  const T* pc, const T* total, int npad, int B, int k_max,
                  const LkDurations& durs, T d_phase, int likelihood,
                  T* power, T* depth, T* w_in, T* t0, T* dur) {
  auto kernel = weighted_window_kernel<T, DMAX, kStaged>;
  const int code = lk_allow_smem(kernel, plan.smem);
  if (code != 0) return code;
  kernel<<<grid, block, plan.smem, stream>>>(
      csum, nbins_p, pc, total, npad, B, k_max, plan.row_tile, durs, d_phase,
      likelihood, power, depth, w_in, t0, dur);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* csum, const int* nbins_p, const T* pc, const T* total,
           int C, int npad, int B, const int* k_durs, const double* dur_values,
           int n_durs, double d_phase, int likelihood, T* power, T* depth,
           T* w_in, T* t0, T* dur, void* stream) {
  if (n_durs < 1 || n_durs > LK_MAX_DURS || C < 1 || C > 65535 || B < 1 ||
      npad < 1)
    return (int)cudaErrorInvalidValue;
  LkDurations durs;
  durs.n = n_durs;
  int k_max = 1;
  for (int j = 0; j < n_durs; ++j) {
    durs.k[j] = k_durs[j];
    durs.value[j] = dur_values[j];
    k_max = max(k_max, k_durs[j]);
  }
  if (k_max > npad) return (int)cudaErrorInvalidValue;
  const LkRowsPlan plan = lk_rows_plan(k_max, 2, sizeof(T), 0, 0);
  // the curve tiles of one period run side by side: together they read
  // whole rows of the prefix sums
  dim3 grid((B + kLkRowLanes - 1) / kLkRowLanes, C);
  dim3 block(kLkRowLanes, kLkRowSplits);
  cudaStream_t s = (cudaStream_t)stream;
#define LK_LAUNCH(DMAX, STAGED)                                               \
  launch_kernel<T, DMAX, STAGED>(plan, grid, block, s, csum, nbins_p, pc,    \
                                 total, npad, B, k_max, durs, (T)d_phase,    \
                                 likelihood, power, depth, w_in, t0, dur)
  if (n_durs <= 8)
    return plan.staged ? LK_LAUNCH(8, true) : LK_LAUNCH(8, false);
  return plan.staged ? LK_LAUNCH(LK_MAX_DURS, true)
                     : LK_LAUNCH(LK_MAX_DURS, false);
#undef LK_LAUNCH
}

}  // namespace

extern "C" {

int lk_bls_window_weighted_f32(const float* csum, const int* nbins_p,
                               const float* pc, const float* total, int C,
                               int npad, int B, const int* k_durs,
                               const double* dur_values, int n_durs,
                               double d_phase, int likelihood, float* power,
                               float* depth, float* w_in, float* t0,
                               float* dur, void* stream) {
  return launch<float>(csum, nbins_p, pc, total, C, npad, B, k_durs,
                       dur_values, n_durs, d_phase, likelihood, power, depth,
                       w_in, t0, dur, stream);
}

int lk_bls_window_weighted_f64(const double* csum, const int* nbins_p,
                               const double* pc, const double* total, int C,
                               int npad, int B, const int* k_durs,
                               const double* dur_values, int n_durs,
                               double d_phase, int likelihood, double* power,
                               double* depth, double* w_in, double* t0,
                               double* dur, void* stream) {
  return launch<double>(csum, nbins_p, pc, total, C, npad, B, k_durs,
                        dur_values, n_durs, d_phase, likelihood, power, depth,
                        w_in, t0, dur, stream);
}

const char* lk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

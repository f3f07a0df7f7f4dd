// K-U: uniform-weight BLS duration-window scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel window_scan_pallas_uniform /
// _make_kernel_uniform / _uniform_window_body in
// lightkurve_tpu/ops/bls_window_pallas.py (pl.pallas_call at :253).
//
// Input: cs_y (C, npad, B), inclusive bin prefix sums of the mean-shifted
// flux over the circular double-deposit fold; cs_n (C, npad), the count
// prefix shared by every curve (both made by K-SF, ops/bls_staged_fold);
// per-period bin counts nbins_p (C,), periods pc (C,), per-curve totals
// tot_y (B,).  Output: five (C, B) arrays -- power, depth, n_in, transit
// time and duration of each (period, curve) winner, COUNT-based (the caller
// rescales by the curve weight).
//
// What bounds it on the H100: bytes, one pass over cs_y (C x npad x B
// values; the count column is shared by all curves).  The first design
// looped over durations outside and start rows inside, so each thread
// streamed its curve's column once per duration and read two prefix values
// per window: a block's 475 KB slab crossed L2 and device memory ~2 x D
// times, and every thread recomputed the count terms (two divisions) of
// every window for its own curve.  That ran at 17x the one-pass bound.
//
// Design (bls_window_rows.cuh): a block holds 32 curves of one period and 8
// threads per curve, and walks the start rows in tiles.  Per tile it
// stages the prefix rows the tile reads into shared memory, and computes
// the count terms of each (start row, duration) once for all its curves
// (1/n_out, 1/n_in + 1/n_out, and 0.5 n_in or its reciprocal square root;
// NaN for an invalid window, which then never wins).  Each thread then
// takes a contiguous run of the tile's start rows and evaluates every
// duration at each row: one prefix read, a difference, two products and a
// compare per window and curve.  What holds it now is instructions, not
// bytes: that window arithmetic times the durations, and a per-tile cost
// (the row copies, the count terms, the barriers) as large as one
// duration's windows, run at about four times the one-pass bound.  A
// period whose windows would reach past its npad rows gets NaN statistics.
// No atomics, no allocation; launched on the caller's stream.
#include <cuda_runtime.h>

#include "bls_window_body.cuh"
#include "bls_window_rows.cuh"

namespace {

// The count terms of one (start row, duration), shared by all curves.
template <typename T>
struct __align__(4 * sizeof(T)) LkCounts {
  T inv_out, s, m, pad;
};

template <typename T, int DMAX, bool kStaged>
__global__ void __launch_bounds__(kLkRowLanes * kLkRowSplits)
uniform_window_kernel(const T* __restrict__ cs_y, const T* __restrict__ cs_n,
                      const int* __restrict__ nbins_p,
                      const T* __restrict__ pc, const T* __restrict__ tot_y,
                      int npad, int B, int k_max, int row_tile,
                      LkDurations durs, T d_phase, T n_total, int likelihood,
                      T* power, T* depth, T* n_in, T* t0, T* dur) {
  extern __shared__ __align__(32) unsigned char lk_smem[];
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
      power[o] = depth[o] = n_in[o] = t0[o] = dur[o] = (T)NAN;
    return;
  }
  const int nd = durs.n;
  const int b0 = blockIdx.x * kLkRowLanes;
  const T* cy0 = cs_y + (size_t)c * npad * B + b0;
  const T* cy = cy0 + (active ? lane : 0);
  const T* cn = cs_n + (size_t)c * npad;
  const T ty = active ? tot_y[b] : (T)0;
  const bool like = likelihood != 0;
  LkCounts<T>* counts = reinterpret_cast<LkCounts<T>*>(lk_smem);
  T* tile = reinterpret_cast<T*>(counts + row_tile * nd);
  // the count prefix rows of the tile, staged with the flux rows
  T* cn_tile = tile + (row_tile + k_max) * kLkRowLanes;
  LkTileRows<T, 1, kStaged> rows{tile, {cy0}, B, 0};
  const int tid = split * kLkRowLanes + lane;
  T v[DMAX];
  int arg[DMAX];
  lk_best_init<T, DMAX>(v, arg);
  for (int r0 = 0; r0 < nbp; r0 += row_tile) {
    const int n_start = min(row_tile, nbp - r0);
    rows.r0 = r0;
    __syncthreads();  // the previous tile is consumed
    if (kStaged) {
      const int n_rows = n_start + k_max;
      rows.stage(tile, r0, min(kLkRowLanes, B - b0), n_rows, npad);
      for (int i = tid; i < n_rows; i += kLkRowLanes * kLkRowSplits) {
        const int r = r0 - 1 + i;
        if (r >= 0 && r < npad)
          __pipeline_memcpy_async(&cn_tile[i], &cn[r], sizeof(T));
        else
          cn_tile[i] = (T)0;
      }
      lk_stage_wait();
      __syncthreads();
    }
    for (int e = tid; e < n_start * nd; e += kLkRowLanes * kLkRowSplits) {
      const int i = e / nd, j = e - i * nd;
      const int r = r0 + i, k = durs.k[j];
      LkCounts<T> q = {(T)NAN, (T)NAN, (T)NAN, (T)0};
      if (k <= nbp) {
        // prefix rows r - 1 and r + k - 1 (row -1 is 0)
        const T lo_n = kStaged ? cn_tile[i] : (r > 0 ? cn[r - 1] : (T)0);
        const T hi_n = kStaged ? cn_tile[i + k] : cn[r + k - 1];
        const T n_in_w = hi_n - lo_n;
        const T n_out_w = n_total - n_in_w;
        if (n_in_w > (T)0 && n_out_w > (T)0) {
          const T inv_in = (T)1 / n_in_w;
          const T inv_out = (T)1 / n_out_w;
          const T s = inv_in + inv_out;
          q = {inv_out, s, like ? (T)0.5 * n_in_w : lk_rsqrt(s), (T)0};
        }
      }
      counts[i * nd + j] = q;
    }
    __syncthreads();
    int lo, hi;
    lk_split_run(n_start, &lo, &hi);
    for (int i = lo; active && i < hi; ++i) {
      const T lo_y = rows.get(i, 0);
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < nd && durs.k[j] <= nbp) {
          const LkCounts<T> q = counts[i * nd + j];
          const T y_in = rows.get(i + durs.k[j], 0) - lo_y;
          const T dep = ty * q.inv_out - y_in * q.s;
          const T obj = like ? q.m * dep * dep : dep * q.m;
          if (obj > v[j]) {
            v[j] = obj;
            arg[j] = r0 + i;
          }
        }
      }
    }
  }
  lk_combine_splits<T, DMAX>(v, arg, nd, lk_smem);
  if (split != 0 || !active) return;
  T best_v = v[0];
  int best_arg = arg[0], best_j = 0;
#pragma unroll
  for (int j = 1; j < DMAX; ++j) {
    if (j < nd && v[j] > best_v) {
      best_v = v[j];
      best_arg = arg[j];
      best_j = j;
    }
  }
  lk_uniform_window_finish<T, T>(cy, B, cn, best_v, best_arg, best_j, pc[c],
                                 ty, n_total, durs, d_phase, power + o,
                                 depth + o, n_in + o, t0 + o, dur + o);
}

template <typename T, int DMAX, bool kStaged>
int launch_kernel(const LkRowsPlan& plan, dim3 grid, dim3 block,
                  cudaStream_t stream, const T* cs_y, const T* cs_n,
                  const int* nbins_p, const T* pc, const T* tot_y, int npad,
                  int B, int k_max, const LkDurations& durs, T d_phase,
                  T n_total, int likelihood, T* power, T* depth, T* n_in,
                  T* t0, T* dur) {
  auto kernel = uniform_window_kernel<T, DMAX, kStaged>;
  const int code = lk_allow_smem(kernel, plan.smem);
  if (code != 0) return code;
  kernel<<<grid, block, plan.smem, stream>>>(
      cs_y, cs_n, nbins_p, pc, tot_y, npad, B, k_max, plan.row_tile, durs,
      d_phase, n_total, likelihood, power, depth, n_in, t0, dur);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* cs_y, const T* cs_n, const int* nbins_p, const T* pc,
           const T* tot_y, int C, int npad, int B, const int* k_durs,
           const double* dur_values, int n_durs, double d_phase,
           double n_total, int likelihood, T* power, T* depth, T* n_in,
           T* t0, T* dur, void* stream) {
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
  const LkRowsPlan plan = lk_rows_plan(
      k_max, 1, sizeof(T), n_durs * sizeof(LkCounts<T>), sizeof(T));
  // the curve tiles of one period run side by side: together they read
  // whole rows of the prefix sums
  dim3 grid((B + kLkRowLanes - 1) / kLkRowLanes, C);
  dim3 block(kLkRowLanes, kLkRowSplits);
  cudaStream_t s = (cudaStream_t)stream;
#define LK_LAUNCH(DMAX, STAGED)                                              \
  launch_kernel<T, DMAX, STAGED>(plan, grid, block, s, cs_y, cs_n, nbins_p, \
                                 pc, tot_y, npad, B, k_max, durs,           \
                                 (T)d_phase, (T)n_total, likelihood, power, \
                                 depth, n_in, t0, dur)
  if (n_durs <= 8)
    return plan.staged ? LK_LAUNCH(8, true) : LK_LAUNCH(8, false);
  return plan.staged ? LK_LAUNCH(LK_MAX_DURS, true)
                     : LK_LAUNCH(LK_MAX_DURS, false);
#undef LK_LAUNCH
}

}  // namespace

extern "C" {

int lk_bls_window_uniform_f32(const float* cs_y, const float* cs_n,
                              const int* nbins_p, const float* pc,
                              const float* tot_y, int C, int npad, int B,
                              const int* k_durs, const double* dur_values,
                              int n_durs, double d_phase, double n_total,
                              int likelihood, float* power, float* depth,
                              float* n_in, float* t0, float* dur,
                              void* stream) {
  return launch<float>(cs_y, cs_n, nbins_p, pc, tot_y, C, npad, B, k_durs,
                       dur_values, n_durs, d_phase, n_total, likelihood,
                       power, depth, n_in, t0, dur, stream);
}

int lk_bls_window_uniform_f64(const double* cs_y, const double* cs_n,
                              const int* nbins_p, const double* pc,
                              const double* tot_y, int C, int npad, int B,
                              const int* k_durs, const double* dur_values,
                              int n_durs, double d_phase, double n_total,
                              int likelihood, double* power, double* depth,
                              double* n_in, double* t0, double* dur,
                              void* stream) {
  return launch<double>(cs_y, cs_n, nbins_p, pc, tot_y, C, npad, B, k_durs,
                        dur_values, n_durs, d_phase, n_total, likelihood,
                        power, depth, n_in, t0, dur, stream);
}

}  // extern "C"

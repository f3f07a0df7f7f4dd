// Duration-window scan bodies shared by the BLS kernels.
//
// The window search of ONE (trial period, curve) pair covers every start
// bin r < nbp and every duration k <= nbp in the static duration list,
// over inclusive bin prefix sums whose circular wrap extension rows
// [nbp, nbp + k_max - 1) are already filled in.  Each regime has its
// per-duration range search (the fused kernels split it over lanes) and
// its winner reconstruction (shared with the one-pass scans of
// bls_window_rows.cuh).
//
// Semantics are those of the staged scans in lightkurve_tpu/ops/bls.py
// (_bls_shared_scan_uniform for counts, _bls_shared_scan for weights):
//   * over r the FIRST maximum wins (strict > in a sequential loop);
//   * over k a later duration wins only if it is strictly greater;
//   * an invalid window is -inf, never 0;
//   * transit times use the floor form t0 - floor(t0/P)*P in the output
//     dtype, with round-to-nearest intrinsics so the compiler cannot fuse
//     them into an fma (the plain torch version rounds every op).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define LK_MAX_DURS 32

struct LkDurations {
  int n;
  int k[LK_MAX_DURS];
  double value[LK_MAX_DURS];
};

__device__ __forceinline__ float lk_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double lk_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float lk_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double lk_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float lk_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double lk_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float lk_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double lk_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float lk_rsqrt(float a) { return rsqrtf(a); }
__device__ __forceinline__ double lk_rsqrt(double a) { return rsqrt(a); }

template <typename T>
__device__ __forceinline__ T lk_neg_inf() { return -INFINITY; }

// t0 = (arg + k/2) * d_phase, folded into [0, period) by the floor form.
template <typename T>
__device__ __forceinline__ T lk_transit_time(int arg, int k, T d_phase, T period) {
  T t0 = lk_mul(lk_add((T)arg, lk_mul((T)0.5, (T)k)), d_phase);
  return lk_sub(t0, lk_mul(floor(lk_div(t0, period)), period));
}

// Uniform (per-curve constant) weights.  cy[r * stride] is the prefix of
// sum(y - mu) for this curve; cn[r] the count prefix shared by all curves.
//
// lk_uniform_window_best: the windows of ONE duration k starting at bins
// [r_lo, r_hi); *v / *arg hold the first maximum of the count-based
// objective (strict >), or -inf / 0 when no window in the range is valid.
// Contiguous ranges combined in ascending order with strict > give the
// same winner as one sequential pass.
template <typename T, typename CountT>
__device__ __forceinline__ void lk_uniform_window_best(
    const T* cy, int stride, const CountT* cn, int k, int r_lo, int r_hi,
    T tot_y, T n_total, bool likelihood, T* v_out, int* arg_out) {
  T v = lk_neg_inf<T>();
  int arg = 0;
  for (int r = r_lo; r < r_hi; ++r) {
    const T lo_n = r > 0 ? (T)cn[r - 1] : (T)0;
    const T n_in = (T)cn[r + k - 1] - lo_n;
    const T n_out = n_total - n_in;
    if (!(n_in > (T)0 && n_out > (T)0)) continue;
    const T inv_in = (T)1 / n_in;
    const T inv_out = (T)1 / n_out;
    const T s = inv_in + inv_out;
    const T lo_y = r > 0 ? cy[(size_t)(r - 1) * stride] : (T)0;
    const T y_in = cy[(size_t)(r + k - 1) * stride] - lo_y;
    const T depth = tot_y * inv_out - y_in * s;
    const T obj = likelihood ? ((T)0.5 * n_in) * depth * depth
                             : depth * lk_rsqrt(s);
    if (obj > v) { v = obj; arg = r; }
  }
  *v_out = v;
  *arg_out = arg;
}

// lk_uniform_window_finish: the winner's statistics from the prefix sums,
// as the staged scan reconstructs them: when no window was valid
// (best_v = -inf) they fall back to n_in = 1 and n_out = 1 at bin 0 of
// the first duration.  Outputs the COUNT-based winner: power (objective),
// depth, n_in, transit time and duration; the caller rescales by the
// curve weight.
template <typename T, typename CountT>
__device__ __forceinline__ void lk_uniform_window_finish(
    const T* cy, int stride, const CountT* cn, T best_v, int best_arg,
    int best_j, T period, T tot_y, T n_total, const LkDurations& durs,
    T d_phase, T* out_power, T* out_depth, T* out_n_in, T* out_t0,
    T* out_dur) {
  const int kb = durs.k[best_j];
  const int hi = best_arg + kb - 1;
  const T lo_y = best_arg > 0 ? cy[(size_t)(best_arg - 1) * stride] : (T)0;
  const T y_in_b = cy[(size_t)hi * stride] - lo_y;
  const T lo_n = best_arg > 0 ? (T)cn[best_arg - 1] : (T)0;
  const T n_in_w = (T)cn[hi] - lo_n;
  const bool ok = isfinite(best_v);
  const T n_in_b = ok ? n_in_w : (T)1;
  const T inv_out_w = (T)1 / (ok ? n_total - n_in_w : (T)1);
  const T s_w = (T)1 / n_in_b + inv_out_w;
  *out_power = best_v;
  *out_depth = tot_y * inv_out_w - y_in_b * s_w;
  *out_n_in = n_in_b;
  *out_t0 = lk_transit_time<T>(best_arg, kb, d_phase, period);
  *out_dur = (T)durs.value[best_j];
}

// Per-sample weights.  cw / cwy: prefixes of sum(w) and sum(w*y) for this
// curve, row r at [r * stride]; tw / twy: the curve's totals.  Outputs
// power, depth and the RAW w_in at each duration's first argmax (depth
// uses the substituted weights 1 where the window is invalid), as the
// staged scan picks them.  Split, as the uniform body is, into the range
// search of one duration and the per-duration keep, so several threads
// can share one (period, curve).
//
// lk_weighted_window_best: the windows of ONE duration k starting at bins
// [r_lo, r_hi); *v / *arg hold the first maximum (strict >), or -inf / 0.
template <typename T>
__device__ __forceinline__ void lk_weighted_window_best(
    const T* cw, const T* cwy, int stride, int k, int r_lo, int r_hi, T tw,
    T twy, bool likelihood, T* v_out, int* arg_out) {
  T v = lk_neg_inf<T>();
  int arg = 0;
  for (int r = r_lo; r < r_hi; ++r) {
    const size_t hi = (size_t)(r + k - 1) * stride;
    const T w_in = cw[hi] - (r > 0 ? cw[(size_t)(r - 1) * stride] : (T)0);
    const T w_out = tw - w_in;
    if (!(w_in > (T)0 && w_out > (T)0)) continue;
    const T wy_in = cwy[hi] - (r > 0 ? cwy[(size_t)(r - 1) * stride] : (T)0);
    const T wy_out = twy - wy_in;
    const T depth = wy_out / w_out - wy_in / w_in;
    const T obj = likelihood ? ((T)0.5 * w_in) * depth * depth
                             : depth * lk_rsqrt((T)1 / w_in + (T)1 / w_out);
    if (obj > v) { v = obj; arg = r; }
  }
  *v_out = v;
  *arg_out = arg;
}

// The running best over durations: duration j (k bins, first maximum v at
// start bin arg) replaces the best when it is the first or strictly
// greater; its statistics are reconstructed from the prefix sums.
template <typename T>
struct LkWeightedBest {
  T v, depth, w_in, t0, dur;
};

template <typename T>
__device__ __forceinline__ void lk_weighted_window_keep(
    const T* cw, const T* cwy, int stride, int nbp, int k, bool first, T v,
    int arg, T tw, T twy, T period, T d_phase, T dur_value,
    LkWeightedBest<T>* best) {
  if (!(first || v > best->v)) return;
  const size_t hi = (size_t)(arg + k - 1) * stride;
  const T w_in = cw[hi] - (arg > 0 ? cw[(size_t)(arg - 1) * stride] : (T)0);
  const T wy_in = cwy[hi] - (arg > 0 ? cwy[(size_t)(arg - 1) * stride] : (T)0);
  const T w_out = tw - w_in;
  const T wy_out = twy - wy_in;
  const bool ok = arg < nbp && k <= nbp && w_in > (T)0 && w_out > (T)0;
  best->v = v;
  best->depth = wy_out / (ok ? w_out : (T)1) - wy_in / (ok ? w_in : (T)1);
  best->w_in = w_in;
  best->t0 = lk_transit_time<T>(arg, k, d_phase, period);
  best->dur = dur_value;
}

// K-U: uniform-weight BLS duration-window scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel window_scan_pallas_uniform /
// _make_kernel_uniform / _uniform_window_body in
// lightkurve_tpu/ops/bls_window_pallas.py (pl.pallas_call at :253).
//
// Input: cs_y (C, npad, B), inclusive bin prefix sums of the mean-shifted
// flux over the circular double-deposit fold; cs_n (C, npad), the count
// prefix shared by every curve (both made by ops.bls_fused.uniform_fold:
// one-hot product, compare-and-sum, cumsum); per-period bin counts
// nbins_p (C,), periods pc (C,), per-curve totals tot_y (B,).  Output: five
// (C, B) arrays -- power, depth, n_in, transit time and duration of each
// (period, curve) winner, COUNT-based (the caller rescales by the curve
// weight).
//
// What bounds it on the H100: bytes.  Every prefix value is needed once
// (cs_y is C x npad x B values, the count column is shared by all curves),
// and the window arithmetic is ~12 operations per (start bin, duration,
// curve), which at D = 6 durations puts the ridge near 18 operations per
// byte -- below the card's 20 f32 operations per byte, so the floor is the
// one pass over cs_y.  The window loop re-reads each prefix value 2 x D
// times; those re-reads hit L1/L2 because a warp's 32 lanes read 32
// adjacent curves of one row (one 128-byte segment per load).
//
// Design: a block holds 32 curves of one period (lane = threadIdx.x, the
// fastest axis of cs_y) and kSplits threads per curve (threadIdx.y), each
// scanning one contiguous run of start bins for every duration.  Per
// duration the runs are combined in ascending order with strict >, so the
// first maximum wins exactly as the staged scan's argmax does; over
// durations a later one wins only if strictly greater.  The split makes a
// launch of SweepRunner's 8 periods 8 x B/32 blocks of 256 threads rather
// than the 8 x B/128 blocks of 128 threads one thread per (period, curve)
// would give (K-W's starvation at that width).  A period whose windows
// would reach past its npad rows gets NaN statistics.  No dynamic shared
// memory, no atomics, no allocation; launched on the caller's stream.
#include <cuda_runtime.h>

#include "bls_window_body.cuh"

namespace {

constexpr int kLanes = 32;    // curves per block
constexpr int kSplits = 8;    // threads per (period, curve)

template <typename T>
__global__ void __launch_bounds__(kLanes * kSplits)
uniform_window_kernel(const T* __restrict__ cs_y, const T* __restrict__ cs_n,
                      const int* __restrict__ nbins_p,
                      const T* __restrict__ pc, const T* __restrict__ tot_y,
                      int npad, int B, int k_max, LkDurations durs,
                      T d_phase, T n_total, int likelihood, T* power,
                      T* depth, T* n_in, T* t0, T* dur) {
  __shared__ T part_v[kSplits][kLanes];
  __shared__ int part_arg[kSplits][kLanes];
  const int c = blockIdx.x;
  const int lane = threadIdx.x, split = threadIdx.y;
  const int b = blockIdx.y * kLanes + lane;
  const bool active = b < B;
  const size_t o = (size_t)c * B + b;
  const int nbp = nbins_p[c];
  if (nbp + min(k_max, nbp) - 1 > npad) {
    // a window would read past this period's npad rows: NaN, never a read
    // into the next period's slab (the test is the same for the whole
    // block, before any barrier)
    if (active && split == 0)
      power[o] = depth[o] = n_in[o] = t0[o] = dur[o] = (T)NAN;
    return;
  }
  const T* cy = cs_y + (size_t)c * npad * B + (active ? b : 0);
  const T* cn = cs_n + (size_t)c * npad;
  const T ty = active ? tot_y[b] : (T)0;
  const bool like = likelihood != 0;
  T best_v = lk_neg_inf<T>();
  int best_arg = 0, best_j = 0;
  for (int j = 0; j < durs.n; ++j) {
    const int k = durs.k[j];
    T v = lk_neg_inf<T>();
    int arg = 0;
    if (active && k <= nbp) {
      const int r_end = min(nbp, npad - k + 1);
      const int per = (r_end + kSplits - 1) / kSplits;
      const int lo = min(split * per, r_end), hi = min(lo + per, r_end);
      lk_uniform_window_best<T, T>(cy, B, cn, k, lo, hi, ty, n_total, like,
                                   &v, &arg);
    }
    part_v[split][lane] = v;
    part_arg[split][lane] = arg;
    __syncthreads();
    if (split == 0) {
      for (int s = 1; s < kSplits; ++s) {
        if (part_v[s][lane] > v) { v = part_v[s][lane]; arg = part_arg[s][lane]; }
      }
      if (j == 0 || v > best_v) { best_v = v; best_arg = arg; best_j = j; }
    }
    __syncthreads();
  }
  if (split != 0 || !active) return;
  lk_uniform_window_finish<T, T>(cy, B, cn, best_v, best_arg, best_j, pc[c],
                                 ty, n_total, durs, d_phase, power + o,
                                 depth + o, n_in + o, t0 + o, dur + o);
}

template <typename T>
int launch(const T* cs_y, const T* cs_n, const int* nbins_p, const T* pc,
           const T* tot_y, int C, int npad, int B, const int* k_durs,
           const double* dur_values, int n_durs, double d_phase,
           double n_total, int likelihood, T* power, T* depth, T* n_in,
           T* t0, T* dur, void* stream) {
  if (n_durs < 1 || n_durs > LK_MAX_DURS || C < 1 || B < 1 || npad < 1)
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
  dim3 grid(C, (B + kLanes - 1) / kLanes);
  dim3 block(kLanes, kSplits);
  uniform_window_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      cs_y, cs_n, nbins_p, pc, tot_y, npad, B, k_max, durs, (T)d_phase,
      (T)n_total, likelihood, power, depth, n_in, t0, dur);
  return (int)cudaGetLastError();
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

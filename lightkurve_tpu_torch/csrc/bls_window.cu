// K-W: weighted BLS duration-window scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel window_scan_pallas / _make_kernel in
// lightkurve_tpu/ops/bls_window_pallas.py (pl.pallas_call at :316).
//
// Input: csum (C, npad, 2B), inclusive bin prefix sums of [sum w | sum w*y]
// over the circular double-deposit fold (made by torch.matmul + cumsum),
// totals (2B,), per-period bin counts nbins_p (C,) and periods pc (C,).
// Output: five (C, B) arrays -- power, depth, raw w_in, transit time and
// duration of each (period, curve) winner.
//
// What bounds it on the H100: the scan reads 4 prefix values per window
// (w and w*y at both window ends) for D durations x nbins_p start bins,
// i.e. about 4*D reads of each csum element, and does 3 divisions and a
// reciprocal square root per window.  With D = 6 and npad ~ 900 that is
// ~1e5 loads per thread over data that is 2 x npad x 4 bytes per curve:
// the loads hit L1/L2 (a block's 128 curves read 128 adjacent columns, so
// every load instruction is one coalesced 512-byte row segment), and the
// bound is the dependent load -> divide chain of one thread.
//
// Design: one thread per (period, curve), blocks of 128 curves of one
// period, a sequential loop over (duration, start bin) with strict > so
// the first maximum wins exactly as the staged scan's argmax does.  A
// period whose windows would reach past its npad rows (nbins_p larger than
// the fold was sized for) gets NaN statistics instead of a read past its
// slab.  No
// shared memory, no atomics, no allocation; launched on the caller's
// stream.  Later work: split r across a warp with a first-index argmax
// reduction, and share 1/w across durations.
#include <cuda_runtime.h>

#include "bls_window_body.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
weighted_window_kernel(const T* __restrict__ csum, const int* __restrict__ nbins_p,
                       const T* __restrict__ pc, const T* __restrict__ total,
                       int npad, int B, int k_max, LkDurations durs, T d_phase,
                       int likelihood, T* power, T* depth, T* w_in, T* t0, T* dur) {
  const int c = blockIdx.x;
  const int b = blockIdx.y * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t o = (size_t)c * B + b;
  const int nbp = nbins_p[c];
  if (nbp + min(k_max, nbp) - 1 > npad) {
    // a window would read past this period's npad rows: NaN, never a read
    // into the next period's slab
    power[o] = depth[o] = w_in[o] = t0[o] = dur[o] = (T)NAN;
    return;
  }
  const T* base = csum + (size_t)c * npad * 2 * B;
  lk_weighted_window_scan<T>(base + b, base + B + b, 2 * B, nbp, pc[c],
                             total[b], total[B + b], durs, d_phase,
                             likelihood != 0, power + o, depth + o, w_in + o,
                             t0 + o, dur + o);
}

template <typename T>
int launch(const T* csum, const int* nbins_p, const T* pc, const T* total,
           int C, int npad, int B, const int* k_durs, const double* dur_values,
           int n_durs, double d_phase, int likelihood, T* power, T* depth,
           T* w_in, T* t0, T* dur, void* stream) {
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
  dim3 grid(C, (B + kThreads - 1) / kThreads);
  weighted_window_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      csum, nbins_p, pc, total, npad, B, k_max, durs, (T)d_phase, likelihood,
      power, depth, w_in, t0, dur);
  return (int)cudaGetLastError();
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

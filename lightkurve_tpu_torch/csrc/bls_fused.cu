// K-F: fused uniform-weight BLS (fold + prefix + window scan) for Hopper.
//
// Replaces the Pallas kernel bls_fused_scan_uniform / _fused_call /
// _make_fused_kernel in lightkurve_tpu/ops/bls_fused_pallas.py
// (pl.pallas_call at :190).
//
// For each (trial period, curve) it computes fold bins
// ids = clip(trunc(fmod(t, P) * inv_d_phase), 0, nbins - 1), the inclusive bin
// prefix sums of the mean-shifted flux with the circular wrap extension
// (each sample deposited at ids and, in wrap mode, again at ids + nbp), the
// shared count prefix, then the duration-window scan of
// bls_window_body.cuh.  Nothing but the five (P, B) winner statistics
// touches device memory.
//
// What bounds it on the H100: shared memory.  A block keeps one prefix
// column of rows = nbp + k_max - 1 values per curve, so a 32-curve tile at
// the bench grid (about 900 rows in f32) takes ~115 KB of the 227 KB a
// block may use: one or two warps per SM, and the fold loop (one global
// load and one shared read-modify-write per sample and curve, in sample
// order) is latency-bound rather than bandwidth- or FLOP-bound.  Reading
// the flux costs n x B x 4 bytes per period, served from L2 because the
// period index is the fastest grid axis and concurrently resident blocks
// share one curve tile.
//
// Design: grid (periods, curve tiles); the block computes the period's
// fold ids for a tile of samples into shared memory once, then each thread
// owns one curve and deposits its samples into its own shared column in
// sample order: deterministic, no float atomics.  Counts use integer
// shared atomics (exact, so order-free).  Each thread then takes its
// column's prefix sum and runs the window scan sequentially.  The tile
// width halves (32, 16, ...) until the block fits in shared memory, and
// the kernel masks the ragged edge of B and n itself.  The block's rows
// are sized from the caller's host bound on nbins_p (rows_cap); a period
// whose nbins_p exceeds it gets NaN statistics, never a silent clamp.
//
// Later work: the step-matrix product cs = A.Y on the tensor cores (wgmma,
// TMA loads, Y resident in shared memory across a persistent period loop),
// which turns the fold from a latency-bound scatter into a dense product.
#include <cuda_runtime.h>

#include "bls_window_body.cuh"

namespace {

constexpr int kMaxTile = 32;
constexpr int kIdTile = 512;    // samples whose fold ids are staged at once

template <typename T>
size_t smem_bytes(int rows_cap, int tb) {
  return (size_t)rows_cap * tb * sizeof(T) + (size_t)rows_cap * sizeof(int) +
         (size_t)kIdTile * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kMaxTile)
fused_uniform_kernel(const T* __restrict__ ts, const T* __restrict__ Y,
                     const T* __restrict__ tot_y, const T* __restrict__ pc,
                     const int* __restrict__ nbins_p, int n, int B, int nbins,
                     int k_max, int rows_cap, LkDurations durs, T d_phase,
                     T inv_d_phase, T n_total, int likelihood, int wrap,
                     T* power, T* depth,
                     T* n_in, T* t0, T* dur) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tb = blockDim.x;
  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  const int b = blockIdx.y * tb + tid;
  const bool active = b < B;
  const int nbp = nbins_p[p];
  const T period = pc[p];
  const int rows = nbp + k_max - 1;
  if (rows > rows_cap) {
    // the caller's bound on nbins_p was too low: windows would reach past
    // the shared rows, so give NaN rather than a truncated search (the
    // test is the same for the whole block, before any barrier)
    if (active) {
      const size_t o = (size_t)p * B + b;
      power[o] = depth[o] = n_in[o] = t0[o] = dur[o] = (T)NAN;
    }
    return;
  }

  T* hist = reinterpret_cast<T*>(smem_raw);             // [rows_cap][tb]
  int* cnt = reinterpret_cast<int*>(hist + (size_t)rows_cap * tb);
  int* sid = cnt + rows_cap;                             // [kIdTile]
  __shared__ int seg_total[kMaxTile];

  for (int r = 0; r < rows; ++r) hist[(size_t)r * tb + tid] = (T)0;
  for (int r = tid; r < rows; r += tb) cnt[r] = 0;
  __syncthreads();

  for (int i0 = 0; i0 < n; i0 += kIdTile) {
    const int m = min(kIdTile, n - i0);
    for (int i = tid; i < m; i += tb) {
      const T phase = fmod(ts[i0 + i], period);
      // 1/d_phase is rounded in T on the host: the reference computes the
      // bin position as this product, not as a division
      int id = (int)lk_mul(phase, inv_d_phase);   // truncating cast
      id = min(max(id, 0), nbins - 1);
      sid[i] = id;
      if (id < rows) atomicAdd(&cnt[id], 1);
      if (wrap && id + nbp < rows) atomicAdd(&cnt[id + nbp], 1);
    }
    __syncthreads();
    if (active) {
      const T* y = Y + (size_t)i0 * B + b;
#pragma unroll 8
      for (int i = 0; i < m; ++i) {
        const int id = sid[i];
        const T v = y[(size_t)i * B];
        if (id < rows) hist[(size_t)id * tb + tid] += v;
        if (wrap && id + nbp < rows) hist[(size_t)(id + nbp) * tb + tid] += v;
      }
    }
    __syncthreads();
  }

  // count prefix: each thread scans one segment, thread 0 scans the totals
  const int seg = (rows + tb - 1) / tb;
  const int lo = min(tid * seg, rows), hi = min(lo + seg, rows);
  int acc = 0;
  for (int r = lo; r < hi; ++r) { acc += cnt[r]; cnt[r] = acc; }
  seg_total[tid] = acc;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int s = 0; s < tb; ++s) { const int v = seg_total[s]; seg_total[s] = run; run += v; }
  }
  __syncthreads();
  for (int r = lo; r < hi; ++r) cnt[r] += seg_total[tid];
  __syncthreads();

  if (!active) return;
  T run = (T)0;
  for (int r = 0; r < rows; ++r) {
    run += hist[(size_t)r * tb + tid];
    hist[(size_t)r * tb + tid] = run;
  }
  const size_t o = (size_t)p * B + b;
  lk_uniform_window_scan<T, int>(hist + tid, tb, cnt, nbp, rows, period,
                                 tot_y[b], n_total, durs, d_phase,
                                 likelihood != 0, power + o, depth + o,
                                 n_in + o, t0 + o, dur + o);
}

int max_shared_optin(int dev) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

int current_shared_optin() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return max_shared_optin(dev);
}

template <typename T>
int launch(const T* ts, const T* Y, const T* tot_y, const T* pc,
           const int* nbins_p, int n, int B, int P, int nbins, int k_max,
           int rows_cap, const int* k_durs, const double* dur_values,
           int n_durs, double d_phase, double inv_d_phase, int likelihood,
           int wrap, T* power, T* depth, T* n_in, T* t0, T* dur,
           void* stream) {
  if (n_durs < 1 || n_durs > LK_MAX_DURS || n < 1 || B < 1 || P < 1 ||
      nbins < 1 || k_max < 1 || rows_cap < 1)
    return (int)cudaErrorInvalidValue;
  LkDurations durs;
  durs.n = n_durs;
  for (int j = 0; j < n_durs; ++j) {
    durs.k[j] = k_durs[j];
    durs.value[j] = dur_values[j];
  }
  const size_t limit = (size_t)current_shared_optin();
  int tb = kMaxTile;
  while (tb > 1 && smem_bytes<T>(rows_cap, tb) > limit) tb /= 2;
  const size_t smem = smem_bytes<T>(rows_cap, tb);
  if (smem > limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_uniform_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(P, (B + tb - 1) / tb);
  fused_uniform_kernel<T><<<grid, tb, smem, (cudaStream_t)stream>>>(
      ts, Y, tot_y, pc, nbins_p, n, B, nbins, k_max, rows_cap, durs,
      (T)d_phase, (T)inv_d_phase, (T)n, likelihood, wrap, power, depth, n_in,
      t0, dur);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a block may opt in to on device ``dev`` (bytes; 0 on
// error): the limit the launch below sizes its tile against, for the
// host's choice between this kernel and the staged route.
int lk_max_shared_optin(int dev) { return max_shared_optin(dev); }

int lk_bls_fused_uniform_f32(const float* ts, const float* Y,
                             const float* tot_y, const float* pc,
                             const int* nbins_p, int n, int B, int P,
                             int nbins, int k_max, int rows_cap,
                             const int* k_durs, const double* dur_values,
                             int n_durs, double d_phase,
                             double inv_d_phase, int likelihood,
                             int wrap, float* power, float* depth,
                             float* n_in, float* t0, float* dur,
                             void* stream) {
  return launch<float>(ts, Y, tot_y, pc, nbins_p, n, B, P, nbins, k_max,
                       rows_cap, k_durs, dur_values, n_durs, d_phase,
                       inv_d_phase, likelihood, wrap, power, depth, n_in, t0,
                       dur, stream);
}

int lk_bls_fused_uniform_f64(const double* ts, const double* Y,
                             const double* tot_y, const double* pc,
                             const int* nbins_p, int n, int B, int P,
                             int nbins, int k_max, int rows_cap,
                             const int* k_durs, const double* dur_values,
                             int n_durs, double d_phase,
                             double inv_d_phase, int likelihood,
                             int wrap, double* power, double* depth,
                             double* n_in, double* t0, double* dur,
                             void* stream) {
  return launch<double>(ts, Y, tot_y, pc, nbins_p, n, B, P, nbins, k_max,
                        rows_cap, k_durs, dur_values, n_durs, d_phase,
                        inv_d_phase, likelihood, wrap, power, depth, n_in,
                        t0, dur, stream);
}

}  // extern "C"

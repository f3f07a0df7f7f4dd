// K-F: fused uniform-weight BLS (fold + prefix + window scan) for Hopper.
//
// Replaces the Pallas kernel bls_fused_scan_uniform / _fused_call /
// _make_fused_kernel in lightkurve_tpu/ops/bls_fused_pallas.py
// (pl.pallas_call at :190).
//
// For each (trial period, curve) it computes fold bins
// ids = clip(trunc(fmod(t, P) * inv_d_phase), 0, nbins - 1), the inclusive bin
// prefix sums of the mean-shifted flux with the circular wrap extension
// (in wrap mode every sample counts again nbp rows on), the shared count
// prefix, then the duration-window scan of bls_window_body.cuh.  Nothing
// but the five (P, B) winner statistics touches device memory.
//
// Design (bls_fold_warp.cuh): one block per (period, W curves), one warp
// per curve, the fold ids and their lane groups staged once per block for
// all its warps; each warp deposits 32 consecutive samples at a time into
// its own prefix column (each group of equal ids summed in a fixed order,
// then added by one lane: no float atomics), scans it, fills the wrap rows
// and splits the window scan's start bins over its lanes.  The count
// column is shared by the block's curves: integer shared atomics on the
// staged ids, then one warp's scan.  A period whose rows (nbins_p + k_max
// - 1) exceed rows_cap -- the caller's host bound on nbins_p -- gets NaN
// statistics, never a silent clamp.  With ``run_counts`` (7 int64, or
// nullptr) each block adds the runs of 32 samples it staged, by kind: at
// 0-5 scan rounds, scattered.
//
// What bounds it on the H100: the bound chip_smoke.py computes is the
// count-based window arithmetic (~7 operations per window and curve) and
// one add per deposit; the kernel is far from it.  Most of its time is the
// fold: every period re-reads its curves' flux (n x B values, from L2: the
// period index is the fastest grid axis, so concurrently resident blocks
// share one curve tile) and does a shared read-modify-write per group of
// equal ids, its segmented scan running only the rounds the run's groups
// need (bls_fold_warp.cuh: per run of 32 samples of one value, 5 MIO
// instructions at no round, 7 at two, 11 with a fixed 5-round scan); the
// rest is the window scan, whose count terms every warp of a block
// recomputes.  Each curve's prefix column lives in shared memory, so the
// block narrows as the rows grow (PERF.md).
#include <cuda_runtime.h>

#include "bls_fold_warp.cuh"

namespace {

// At most 40 registers in float32: left to itself the compiler takes about
// 55 for the deposit's branches on its scan rounds, which keeps 36 warps
// resident per SM where 40 keep 48 (824 rows); 64 in float64, as a block
// of 1024 threads needs.
template <typename T>
__global__ void __maxnreg__(sizeof(T) == 4 ? 40 : 64)
fused_uniform_kernel(const T* __restrict__ ts, const T* __restrict__ Yt,
                     const T* __restrict__ tot_y, const T* __restrict__ pc,
                     const int* __restrict__ nbins_p, int n, int B, int nbins,
                     int k_max, int rows_cap, LkDurations durs, T d_phase,
                     T inv_d_phase, T n_total, int likelihood, int wrap,
                     T* power, T* depth, T* n_in, T* t0, T* dur,
                     unsigned long long* run_counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int p = blockIdx.x;
  const int b = blockIdx.y * warps + warp;
  const bool active = b < B;
  const size_t o = (size_t)p * B + b;
  const int nbp = nbins_p[p];
  const T period = pc[p];
  const int rows = nbp + k_max - 1;
  if (rows > rows_cap) {
    // the caller's bound on nbins_p was too low: windows would reach past
    // the shared rows, so give NaN rather than a truncated search (the
    // test is the same for the whole block, before any barrier)
    if (active && lane == 0)
      power[o] = depth[o] = n_in[o] = t0[o] = dur[o] = (T)NAN;
    return;
  }

  T* col = reinterpret_cast<T*>(smem_raw) + (size_t)warp * rows_cap;
  int* cnt = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw) +
                                    (size_t)warps * rows_cap);
  int* sid = cnt + rows_cap;                                // [kLkIdTile]
  unsigned* speer = reinterpret_cast<unsigned*>(sid + kLkIdTile);
  signed char* srun = reinterpret_cast<signed char*>(speer + kLkIdTile);

  for (int r = lane; r < rows; r += 32) col[r] = (T)0;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) cnt[r] = 0;
  lk_zero_run_kinds(srun, run_counts);
  __syncthreads();

  const T* y = Yt + (size_t)(active ? b : 0) * n;
  for (int i0 = 0; i0 < n; i0 += kLkIdTile) {
    const int m = min(kLkIdTile, n - i0);
    lk_stage_fold_ids<T>(ts + i0, m, period, inv_d_phase, nbins, rows, sid,
                         speer, srun, cnt, run_counts);
    __syncthreads();
    if (active)
      lk_deposit_tile<T, 1>(y + i0, nullptr, m, sid, speer, srun, col,
                            nullptr);
    __syncthreads();
  }
  lk_flush_run_kinds(srun, run_counts);

  if (warp == 0) {
    lk_warp_prefix<int>(cnt, rows);
    if (wrap) lk_wrap_rows<int>(cnt, nbp, rows);
  }
  if (active) {
    lk_warp_prefix<T>(col, rows);
    if (wrap) lk_wrap_rows<T>(col, nbp, rows);
  }
  __syncthreads();
  if (!active) return;

  const T ty = tot_y[b];
  const bool like = likelihood != 0;
  T best_v = lk_neg_inf<T>();
  int best_arg = 0, best_j = 0;
  for (int j = 0; j < durs.n; ++j) {
    const int k = durs.k[j];
    T v = lk_neg_inf<T>();
    int arg = 0;
    if (k <= nbp) {
      int lo, hi;
      lk_lane_range(nbp, &lo, &hi);
      lk_uniform_window_best<T, int>(col, 1, cnt, k, lo, hi, ty, n_total,
                                     like, &v, &arg);
    }
    lk_warp_first_max<T>(&v, &arg);
    if (j == 0 || v > best_v) { best_v = v; best_arg = arg; best_j = j; }
  }
  if (lane == 0)
    lk_uniform_window_finish<T, int>(col, 1, cnt, best_v, best_arg, best_j,
                                     period, ty, n_total, durs, d_phase,
                                     power + o, depth + o, n_in + o, t0 + o,
                                     dur + o);
}

template <typename T>
cudaError_t block_of(int rows_cap, int* warps, int* blocks) {
  return lk_fold_block(fused_uniform_kernel<T>, rows_cap, sizeof(T),
                       sizeof(int), warps, blocks);
}

template <typename T>
int launch(const T* ts, const T* Yt, const T* tot_y, const T* pc,
           const int* nbins_p, int n, int B, int P, int nbins, int k_max,
           int rows_cap, const int* k_durs, const double* dur_values,
           int n_durs, double d_phase, double inv_d_phase, int likelihood,
           int wrap, T* power, T* depth, T* n_in, T* t0, T* dur,
           unsigned long long* run_counts, void* stream) {
  if (n_durs < 1 || n_durs > LK_MAX_DURS || n < 1 || B < 1 || P < 1 ||
      nbins < 1 || k_max < 1 || rows_cap < 1 || rows_cap >= kLkNoId)
    return (int)cudaErrorInvalidValue;
  LkDurations durs;
  durs.n = n_durs;
  for (int j = 0; j < n_durs; ++j) {
    durs.k[j] = k_durs[j];
    durs.value[j] = dur_values[j];
  }
  int warps = 0, blocks = 0;
  cudaError_t err = block_of<T>(rows_cap, &warps, &blocks);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = lk_fold_smem_bytes(rows_cap, warps, sizeof(T),
                                         sizeof(int));
  dim3 grid(P, (B + warps - 1) / warps);
  fused_uniform_kernel<T><<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      ts, Yt, tot_y, pc, nbins_p, n, B, nbins, k_max, rows_cap, durs,
      (T)d_phase, (T)inv_d_phase, (T)n, likelihood, wrap, power, depth, n_in,
      t0, dur, run_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a block may opt in to on device ``dev`` (bytes; 0 on
// error): the limit the fused kernels size their blocks against, for the
// host's choice between them and the staged routes.
int lk_max_shared_optin(int dev) { return lk_shared_optin(dev); }

// The block K-F launches with at ``rows_cap`` rows (``f64``: the double
// kernel): its width in warps and its resident blocks per SM by the
// occupancy calculator.
int lk_bls_fused_uniform_block(int f64, int rows_cap, int* warps,
                               int* blocks) {
  return (int)(f64 ? block_of<double>(rows_cap, warps, blocks)
                   : block_of<float>(rows_cap, warps, blocks));
}

// ``Yt`` is the mean-shifted flux as (B, n), one curve per row;
// ``run_counts``: 7 int64 the launch adds its staged runs to, or nullptr.
int lk_bls_fused_uniform_f32(const float* ts, const float* Yt,
                             const float* tot_y, const float* pc,
                             const int* nbins_p, int n, int B, int P,
                             int nbins, int k_max, int rows_cap,
                             const int* k_durs, const double* dur_values,
                             int n_durs, double d_phase,
                             double inv_d_phase, int likelihood,
                             int wrap, float* power, float* depth,
                             float* n_in, float* t0, float* dur,
                             unsigned long long* run_counts,
                             void* stream) {
  return launch<float>(ts, Yt, tot_y, pc, nbins_p, n, B, P, nbins, k_max,
                       rows_cap, k_durs, dur_values, n_durs, d_phase,
                       inv_d_phase, likelihood, wrap, power, depth,
                       n_in, t0, dur, run_counts, stream);
}

int lk_bls_fused_uniform_f64(const double* ts, const double* Yt,
                             const double* tot_y, const double* pc,
                             const int* nbins_p, int n, int B, int P,
                             int nbins, int k_max, int rows_cap,
                             const int* k_durs, const double* dur_values,
                             int n_durs, double d_phase,
                             double inv_d_phase, int likelihood,
                             int wrap, double* power, double* depth,
                             double* n_in, double* t0, double* dur,
                             unsigned long long* run_counts,
                             void* stream) {
  return launch<double>(ts, Yt, tot_y, pc, nbins_p, n, B, P, nbins, k_max,
                        rows_cap, k_durs, dur_values, n_durs, d_phase,
                        inv_d_phase, likelihood, wrap, power, depth,
                        n_in, t0, dur, run_counts, stream);
}

}  // extern "C"

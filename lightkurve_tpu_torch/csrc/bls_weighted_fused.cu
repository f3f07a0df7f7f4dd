// K-WF: fused weighted BLS (fold + prefix + window scan) for Hopper.
//
// Replaces, in one kernel, the weighted regime's fold and window scan:
// the reference's XLA fold in _bls_shared_scan (lightkurve_tpu/ops/bls.py,
// the one-hot product of [w | w*y] with the double deposit and its cumsum)
// and the Pallas kernel window_scan_pallas / _make_kernel in
// lightkurve_tpu/ops/bls_window_pallas.py (pl.pallas_call at :316), whose
// port K-W (bls_window.cu) stays on the staged route.
//
// Input: shared times ts (n,), per-sample weights Wt and weighted
// mean-shifted flux WYt as (B, n) (one curve per row; masked samples have
// weight 0), the curves' totals, the periods, their bin counts.  Output:
// five (P, B) arrays -- power, depth, RAW w_in at each duration's first
// argmax, transit time and duration -- as the staged scan (_weighted_fold
// then window_scan_plain) defines them.
//
// Design (bls_fold_warp.cuh): one block per (period, W curves), one warp
// per curve with two shared prefix columns (Sigma w, Sigma w*y); the fold
// ids and their lane groups are staged once per block; deposits sum each
// group of equal ids in a fixed order (no float atomics); a warp scan and
// the wrap rows make the prefix of the circular double-deposit fold; the
// window scan splits start bins over the lanes (lk_weighted_window_best)
// and keeps, per duration, the first maximum (lk_weighted_window_keep).
// One launch covers every period of a call: a whole SweepRunner chunk,
// where the staged route takes a GEMM, a cumsum and a K-W launch per 8
// periods.  A period whose rows (nbins_p + k_max - 1) exceed rows_cap gets
// NaN.  With ``run_counts`` (7 int64, or nullptr) each block adds the
// runs of 32 samples it staged, by kind: at 0-5 scan rounds, scattered.
//
// What bounds it on the H100: the bound chip_smoke.py computes is the
// window scan (~12 operations per window and curve, three of them
// divisions) and two adds per deposit; the kernel is far from it, and
// most of its time is the fold: per period both inputs are re-read from
// L2 and every sample goes into two columns.  The fold's pace is set by
// the MIO pipe, not L2 (bls_fold_warp.cuh): per run of 32 samples a warp
// sends 19 MIO instructions with a fixed 5-round scan, 12 at two rounds
// (groups of 3-4 samples, TESS's 2-min cadence in 7.2-min bins) and 8 at
// none (Kepler's 29.4-min cadence), now that the scan runs only the
// rounds its groups need; on an H100 at 700 W that took a TESS sector's
// first sweep chunk (2048 curves, 652 periods) from 80.7 to 68.3 ms and a
// Kepler archive's (1,250 periods) from 621 to 385 ms, the bytes read
// from L2 unchanged.  The per-curve weights leave no count column to
// share, so a block of W curves needs 2 x W columns and fewer warps fit
// an SM than in K-F (PERF.md).
#include <cuda_runtime.h>

#include "bls_fold_warp.cuh"

namespace {

// At most 48 registers in float32 (left to itself the compiler takes about
// 53): 42 warps resident per SM where the rows leave shared memory to
// spare (a TESS sector's short periods), not 36; 64 in float64, as a block
// of 1024 threads needs.
template <typename T>
__global__ void __maxnreg__(sizeof(T) == 4 ? 48 : 64)
fused_weighted_kernel(const T* __restrict__ ts, const T* __restrict__ Wt,
                      const T* __restrict__ WYt, const T* __restrict__ tot_w,
                      const T* __restrict__ tot_wy, const T* __restrict__ pc,
                      const int* __restrict__ nbins_p, int n, int B,
                      int nbins, int k_max, int rows_cap, LkDurations durs,
                      T d_phase, T inv_d_phase, int likelihood, int wrap,
                      T* power, T* depth, T* w_in, T* t0, T* dur,
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
    // NaN rather than a truncated search (the same for the whole block,
    // before any barrier)
    if (active && lane == 0)
      power[o] = depth[o] = w_in[o] = t0[o] = dur[o] = (T)NAN;
    return;
  }

  T* cw = reinterpret_cast<T*>(smem_raw) + (size_t)2 * warp * rows_cap;
  T* cwy = cw + rows_cap;
  int* sid = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw) +
                                    (size_t)2 * warps * rows_cap);
  unsigned* speer = reinterpret_cast<unsigned*>(sid + kLkIdTile);
  signed char* srun = reinterpret_cast<signed char*>(speer + kLkIdTile);

  for (int r = lane; r < rows; r += 32) cw[r] = cwy[r] = (T)0;
  if (run_counts != nullptr) {
    lk_zero_run_kinds(srun, run_counts);
    __syncthreads();
  }

  const size_t row0 = (size_t)(active ? b : 0) * n;
  for (int i0 = 0; i0 < n; i0 += kLkIdTile) {
    const int m = min(kLkIdTile, n - i0);
    lk_stage_fold_ids<T>(ts + i0, m, period, inv_d_phase, nbins, rows, sid,
                         speer, srun, nullptr, run_counts);
    __syncthreads();
    if (active)
      lk_deposit_tile<T, 2>(Wt + row0 + i0, WYt + row0 + i0, m, sid, speer,
                            srun, cw, cwy);
    __syncthreads();
  }
  lk_flush_run_kinds(srun, run_counts);
  if (!active) return;
  lk_warp_prefix<T>(cw, rows);
  lk_warp_prefix<T>(cwy, rows);
  if (wrap) {
    lk_wrap_rows<T>(cw, nbp, rows);
    lk_wrap_rows<T>(cwy, nbp, rows);
  }
  __syncwarp();

  const T tw = tot_w[b], twy = tot_wy[b];
  const bool like = likelihood != 0;
  LkWeightedBest<T> best = {lk_neg_inf<T>(), 0, 0, 0, 0};
  for (int j = 0; j < durs.n; ++j) {
    const int k = durs.k[j];
    T v = lk_neg_inf<T>();
    int arg = 0;
    if (k <= nbp) {
      int lo, hi;
      lk_lane_range(nbp, &lo, &hi);
      lk_weighted_window_best<T>(cw, cwy, 1, k, lo, hi, tw, twy, like, &v,
                                 &arg);
    }
    lk_warp_first_max<T>(&v, &arg);
    if (lane == 0)
      lk_weighted_window_keep<T>(cw, cwy, 1, nbp, k, j == 0, v, arg, tw, twy,
                                 period, d_phase, (T)durs.value[j], &best);
  }
  if (lane == 0) {
    power[o] = best.v;
    depth[o] = best.depth;
    w_in[o] = best.w_in;
    t0[o] = best.t0;
    dur[o] = best.dur;
  }
}

template <typename T>
cudaError_t block_of(int rows_cap, int* warps, int* blocks) {
  return lk_fold_block(fused_weighted_kernel<T>, rows_cap, 2 * sizeof(T), 0,
                       warps, blocks);
}

template <typename T>
int launch(const T* ts, const T* Wt, const T* WYt, const T* tot_w,
           const T* tot_wy, const T* pc, const int* nbins_p, int n, int B,
           int P, int nbins, int k_max, int rows_cap, const int* k_durs,
           const double* dur_values, int n_durs, double d_phase,
           double inv_d_phase, int likelihood, int wrap, T* power, T* depth,
           T* w_in, T* t0, T* dur, unsigned long long* run_counts,
           void* stream) {
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
  const size_t smem = lk_fold_smem_bytes(rows_cap, warps, 2 * sizeof(T), 0);
  dim3 grid(P, (B + warps - 1) / warps);
  fused_weighted_kernel<T><<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      ts, Wt, WYt, tot_w, tot_wy, pc, nbins_p, n, B, nbins, k_max, rows_cap,
      durs, (T)d_phase, (T)inv_d_phase, likelihood, wrap, power, depth, w_in,
      t0, dur, run_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The block K-WF launches with at ``rows_cap`` rows (``f64``: the double
// kernel): its width in warps and its resident blocks per SM.
int lk_bls_fused_weighted_block(int f64, int rows_cap, int* warps,
                                int* blocks) {
  return (int)(f64 ? block_of<double>(rows_cap, warps, blocks)
                   : block_of<float>(rows_cap, warps, blocks));
}

// ``Wt`` / ``WYt``: weights and weighted mean-shifted flux as (B, n);
// ``run_counts``: 7 int64 the launch adds its staged runs to, or nullptr.
int lk_bls_fused_weighted_f32(const float* ts, const float* Wt,
                              const float* WYt, const float* tot_w,
                              const float* tot_wy, const float* pc,
                              const int* nbins_p, int n, int B, int P,
                              int nbins, int k_max, int rows_cap,
                              const int* k_durs, const double* dur_values,
                              int n_durs, double d_phase,
                              double inv_d_phase, int likelihood, int wrap,
                              float* power, float* depth,
                              float* w_in, float* t0, float* dur,
                              unsigned long long* run_counts,
                              void* stream) {
  return launch<float>(ts, Wt, WYt, tot_w, tot_wy, pc, nbins_p, n, B, P,
                       nbins, k_max, rows_cap, k_durs, dur_values, n_durs,
                       d_phase, inv_d_phase, likelihood, wrap, power,
                       depth, w_in, t0, dur, run_counts, stream);
}

int lk_bls_fused_weighted_f64(const double* ts, const double* Wt,
                              const double* WYt, const double* tot_w,
                              const double* tot_wy, const double* pc,
                              const int* nbins_p, int n, int B, int P,
                              int nbins, int k_max, int rows_cap,
                              const int* k_durs, const double* dur_values,
                              int n_durs, double d_phase,
                              double inv_d_phase, int likelihood, int wrap,
                              double* power, double* depth,
                              double* w_in, double* t0, double* dur,
                              unsigned long long* run_counts,
                              void* stream) {
  return launch<double>(ts, Wt, WYt, tot_w, tot_wy, pc, nbins_p, n, B, P,
                        nbins, k_max, rows_cap, k_durs, dur_values, n_durs,
                        d_phase, inv_d_phase, likelihood, wrap, power,
                        depth, w_in, t0, dur, run_counts, stream);
}

}  // extern "C"

// K-PC: the per-curve binned BLS search (fold, prefix sums, window scan)
// in one launch, for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves its per-curve binned
// search (_bls_one_period_binned and _bls_scan_binned in
// lightkurve_tpu/ops/bls.py) to XLA.  The port's plain version
// (ops/bls_curve.curve_scan_plain) builds, per chunk of periods, a float64
// phase and an int64 bin id for every (curve, period, sample), sorts the
// ids, gathers and cumsums both weight columns and gathers every window's
// sums: tens of GB of device-memory traffic for a single TESS curve's
// 4,564 periods, ~80% of a vet (PERF.md).  K-PC keeps all of it on chip
// and writes only each (curve, period)'s winner.
//
// Inputs: per-curve float64 times ts (B, n) from each curve's first sample,
// weights w and weighted fluxes wy (B, n) in the data dtype (masked samples
// have weight 0), float64 periods (P,), the durations in bins (D,).
// Output, per (curve, period): the winner's power, depth, depth_err,
// depth_snr and log_likelihood (float64) and its flat index start * D + j
// (int32), as curve_scan_plain defines them.
//
// Design: one warp per (curve, period), with its own two float64 columns in
// shared memory, the exclusive bin prefix sums of Sigma w and Sigma w*y, of
// the rows its windows read (its bins plus the longest duration, at most
// nbins, plus the leading 0).  Every curve has its own times, so no warp
// shares fold ids with another and none waits at a block barrier.  A block
// holds a run of consecutive periods of one curve, packed on the host
// (ops/bls_curve.curve_plan) into its shared memory by their own rows: a
// TESS sector's grid needs 300 rows a period on average and 1,867 at its
// longest, so where a block sized for the longest period held one warp (7
// resident an SM), a block of 8 holds 8 short periods (24 resident).
// A period whose columns do not fit a block's opt-in shared memory (past
// 14,527 bins on an H100: periods past ~72 d at lightkurve's default bins,
// as a Kepler or multi-sector curve's grid reaches) goes to a second
// kernel of the same body, launched after the first on the same stream,
// whose warps each own two columns in a global workspace (L2 as far as it
// holds them) and take such (curve, period) items in turn.
//   * Fold ids, bit for bit as the plain version: the exact float64 x mod
//     P (the remainder from the quotient by the rounded 1/P, corrected,
//     below), then the correctly rounded division by d_phase (taken from
//     the product with the rounded 1/d_phase away from bin edges), or the
//     product with the float64-rounded 1/d_phase (``reciprocal``), a
//     truncating cast and a clip to [0, nbins - 1].
//   * Deposits: each run of 32 samples sums its lanes of equal id, by a
//     segmented warp scan of the rounds its widest group needs where the
//     groups are contiguous lane ranges (found from the neighbours' ids
//     where they do not decrease, by __match_any_sync otherwise), else on
//     the group's lowest lane in ascending lane order; one lane per group
//     adds the sum to the bin.  float64 adds in a fixed order, no float
//     atomics: the same bits from run to run (ROADMAP C3, C8).
//   * Prefix: the warp scan of bls_fold_warp.cuh over the period's rows (an
//     empty row repeats the row before it bit for bit, so windows of equal
//     content tie exactly, as in the plain version's gathers).
//   * Window scan: every start bin below nbins_p times every duration of at
//     most nbins_p bins, with the plain version's float64 expressions in
//     round-to-nearest intrinsics (no fma contraction): a wrapped window is
//     (total - c[start]) + c[end - nbins_p]; in astropy edge mode a window
//     reads c[min(end, nbins)], so edge windows truncate against empty rows.
//     The lanes take contiguous runs of start bins and are combined in
//     ascending order with a strict test (NaN above every number, as
//     torch.argmax ranks it): the first maximum of the plain version's
//     flattened (start, duration) order.
//
// What bounds it on the H100 (variants that drop one part each, on a TESS
// sector's curve and grid): the deposits' shuffles and shared-memory
// updates, ~45% of the time, on the MIO pipe; then the curve's re-reads
// from L2 (16 bytes a sample and period in float32: time, w, w*y; 1.4 GB
// a search, ~6 TB/s when nothing else runs), the ids' float64 arithmetic
// and the window scan.  The least time the benchmark counts
// (perfbench/roofline.py: the window scan's operations) is far below it.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "bls_fold_warp.cuh"

namespace {

constexpr int kPcBatch = 4;   // runs of 32 samples loaded ahead

// x mod p as the plain version's _mod computes it (torch.fmod, moved into
// the divisor's sign).  For x >= 0 and p > 0 (times from a curve's first
// sample) the truncated correctly rounded quotient q is the true quotient
// or one more (rounding is monotone), so fma(-q, p, x) is the exact
// remainder or the exact remainder minus p (both representable: |r| < p,
// on p's grid) and one add of p restores it exactly.  Anything else, and
// quotients past 2^52, takes fmod itself.
__device__ __noinline__ double pc_mod_exact(double x, double p) {
  const double q = trunc(__ddiv_rn(x, p));
  if (x >= 0.0 && p > 0.0 && q < 4503599627370496.0) {
    const double r = __fma_rn(-q, p, x);
    return r < 0.0 ? __dadd_rn(r, p) : r;
  }
  const double r = fmod(x, p);
  return (r != 0.0 && ((r < 0.0) != (p < 0.0))) ? __dadd_rn(r, p) : r;
}

// pc_mod_exact without its division: q from the product with ``rp``, the
// rounded 1/p, is off the true quotient by at most one either way.  One
// more, or the true one, leaves the exact remainder as above; one less
// leaves r >= p, possibly rounded, and only then the division runs.
__device__ __forceinline__ double pc_mod(double x, double p, double rp) {
  if (x >= 0.0 && p > 0.0) {
    const double q = trunc(__dmul_rn(x, rp));
    if (q < 4503599627370496.0) {
      const double r = __fma_rn(-q, p, x);
      if (r < 0.0) return __dadd_rn(r, p);
      if (r < p) return r;
    }
  }
  return pc_mod_exact(x, p);
}

// Bins of one period: ceil(period / d_phase), at most nbins (at least 0,
// so that no row below the columns is read).
__device__ __forceinline__ int pc_bins(double period, double d_phase,
                                       int nbins) {
  const double q = ceil(__ddiv_rn(period, d_phase));
  return q >= (double)nbins ? nbins : (q > 0.0 ? (int)q : 0);
}

// The fold bin of time t: clip(trunc(pos), 0, nbins - 1), pos the phase
// times the rounded 1/d_phase (``reciprocal``) or divided by d_phase; the
// cast is torch's (truncation, saturating).  The division's truncation is
// the product's wherever the product lies farther than 2^-49 of itself
// from a whole number: the two differ by at most 1.5 float64 roundings of
// it.  Only nearer (a sample on or next to a bin edge) does the division
// run.
__device__ __forceinline__ int pc_fold_id(double t, double period,
                                          double inv_period, double d_phase,
                                          double inv_d_phase, bool reciprocal,
                                          int nbins) {
  const double ph = pc_mod(t, period, inv_period);
  double pos = __dmul_rn(ph, inv_d_phase);
  if (!reciprocal) {
    const double f = pos - floor(pos);
    const double tol = pos * 0x1p-49;
    if (f <= tol || f >= 1.0 - tol) pos = __ddiv_rn(ph, d_phase);
  }
  const long long id = __double2ll_rz(pos);
  return (int)min(max(id, 0LL), (long long)(nbins - 1));
}

// The tail's id: lanes past the curve's end, which deposit nothing (above
// every bin, so that a sorted run stays non-decreasing).
constexpr int kPcNoId = 0x7fffffff;

// One run of 32 samples into the exclusive prefix columns: bin b's sum
// goes to row b + 1.  Where the run's ids do not decrease (sorted times
// within a cycle) each group is a range of lanes found from its
// neighbours; otherwise __match_any_sync finds them.
__device__ __forceinline__ void pc_deposit_run(int id, double a, double c,
                                               double* cw, double* cwy) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(LK_FULL_MASK, id, 1);
  const int next = __shfl_down_sync(LK_FULL_MASK, id, 1);
  int first, last;
  unsigned peers = 0u;
  bool contig = __all_sync(LK_FULL_MASK, lane == 31 || next >= id);
  if (contig) {
    const unsigned heads = __ballot_sync(LK_FULL_MASK,
                                         lane == 0 || prev != id);
    const unsigned tails = __ballot_sync(LK_FULL_MASK,
                                         lane == 31 || next != id);
    first = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
    last = __ffs(tails & (0xffffffffu << lane)) - 1;
  } else {
    peers = __match_any_sync(LK_FULL_MASK, id);
    first = __ffs(peers) - 1;
    last = 31 - __clz(peers);
    contig = __all_sync(
        LK_FULL_MASK,
        peers == ((LK_FULL_MASK >> (31 - last)) & (LK_FULL_MASK << first)));
  }
  const bool kept = id != kPcNoId;
  double s0 = a, s1 = c;
  bool dep;
  if (contig) {
    // a round adds the value ``off`` lanes down while that lane is in the
    // group; the tail's group deposits nothing and sets no round
    const int widest = __reduce_max_sync(LK_FULL_MASK,
                                         kept ? last - first + 1 : 1);
    for (int off = 1; off < widest; off <<= 1) {
      const double o0 = __shfl_up_sync(LK_FULL_MASK, s0, off);
      const double o1 = __shfl_up_sync(LK_FULL_MASK, s1, off);
      if (lane - off >= first) {
        s0 = __dadd_rn(s0, o0);
        s1 = __dadd_rn(s1, o1);
      }
    }
    dep = lane == last;
  } else {
    // each group's lowest lane sums the others in ascending lane order
    unsigned rest = lane == first ? (peers & (peers - 1u)) : 0u;
    while (__any_sync(LK_FULL_MASK, rest != 0u)) {
      const int from = rest ? __ffs(rest) - 1 : lane;
      const double o0 = __shfl_sync(LK_FULL_MASK, a, from);
      const double o1 = __shfl_sync(LK_FULL_MASK, c, from);
      if (rest) {
        s0 = __dadd_rn(s0, o0);
        s1 = __dadd_rn(s1, o1);
      }
      rest &= rest - 1u;
    }
    dep = lane == first;
  }
  if (dep && kept) {
    cw[id + 1] = __dadd_rn(cw[id + 1], s0);
    cwy[id + 1] = __dadd_rn(cwy[id + 1], s1);
  }
  __syncwarp();   // the next run's deposits read these rows
}

// Sums of the window of k bins from start bin s, as the plain version
// gathers them (indices clamped to [0, nbins], which only windows it masks
// invalid reach).
__device__ __forceinline__ void pc_window(const double* cw, const double* cwy,
                                          int s, int k, int nbp, int nbins,
                                          bool wrap, double tw, double twy,
                                          double* w_in, double* wy_in) {
  int e = s + k;
  if (wrap && e > nbp) {
    e = min(max(e - nbp, 0), nbins);
    *w_in = __dadd_rn(__dsub_rn(tw, cw[s]), cw[e]);
    *wy_in = __dadd_rn(__dsub_rn(twy, cwy[s]), cwy[e]);
  } else {
    e = min(e, nbins);
    *w_in = __dsub_rn(cw[e], cw[s]);
    *wy_in = __dsub_rn(cwy[e], cwy[s]);
  }
}

__device__ __forceinline__ double pc_depth(double w_in, double wy_in,
                                           double w_out, double wy_out) {
  return __dsub_rn(__ddiv_rn(wy_out, w_out), __ddiv_rn(wy_in, w_in));
}

__device__ __forceinline__ double pc_err(double w_in, double w_out) {
  return __dsqrt_rn(__dadd_rn(__ddiv_rn(1.0, w_in), __ddiv_rn(1.0, w_out)));
}

__device__ __forceinline__ double pc_loglike(double w_in, double depth) {
  return __dmul_rn(__dmul_rn(__dmul_rn(0.5, w_in), depth), depth);
}

// a replaces b in a first-maximum pass: strictly greater, and NaN above
// every number (torch.argmax's order)
__device__ __forceinline__ bool pc_better(double a, double b) {
  return a > b || (isnan(a) && !isnan(b));
}

// A launch's arguments, the same for both kernels.  ``plan`` (int32): the
// durations in bins (n_durs), the first period of each of the n_groups
// blocks of the shared-memory kernel and the end (n_groups + 1), each
// period's first row in its block's shared memory (P) and its rows (P; 0
// for a period of the L2 kernel), then the periods of the L2 kernel
// (n_long), as ops/bls_curve.curve_plan lays them out.
template <typename T>
struct PcArgs {
  const double* ts;
  const T* w;
  const T* wy;
  const double* pc;
  const int* plan;
  int n_durs, n, B, P, n_groups, n_long, nbins;
  double d_phase, inv_d_phase;
  bool reciprocal, likelihood, wrap;
  double *power, *depth, *depth_err, *depth_snr, *loglike;
  int* best;
};

// The search of curve b at period p on its two columns cw and cwy of
// ``cap`` rows each, in shared or in global memory: the fold, the prefix
// and the window scan; lane 0 writes the winner.
template <typename T>
__device__ __forceinline__ void pc_search(const PcArgs<T>& a, int b, int p,
                                          double* cw, double* cwy, int cap) {
  const int lane = threadIdx.x & 31;
  const int* k_durs = a.plan;
  const int n_durs = a.n_durs, nbins = a.nbins;
  const size_t o = (size_t)b * a.P + p;
  const double period = a.pc[p];
  const double inv_period = __ddiv_rn(1.0, period);
  const int nbp = pc_bins(period, a.d_phase, nbins);
  int k_max = 1;
  for (int j = 0; j < n_durs; ++j) k_max = max(k_max, __ldg(k_durs + j));
  // the rows any window of this period reads: [0, last]; the plan's rows
  // for it hold them (else NaN, which no plan from the host gives)
  const int last = min(nbins, nbp + k_max);
  if (last + 1 > cap) {
    if (lane == 0) {
      a.power[o] = a.depth[o] = a.depth_err[o] = a.depth_snr[o] =
          a.loglike[o] = NAN;
      a.best[o] = 0;
    }
    return;
  }
  for (int r = lane; r <= last; r += 32) cw[r] = cwy[r] = 0.0;
  __syncwarp();

  const double* t_row = a.ts + (size_t)b * a.n;
  const T* w_row = a.w + (size_t)b * a.n;
  const T* wy_row = a.wy + (size_t)b * a.n;
  const int n = a.n;
  for (int c0 = 0; c0 < n; c0 += 32 * kPcBatch) {
    int ids[kPcBatch];
    double v0[kPcBatch], v1[kPcBatch];
#pragma unroll
    for (int u = 0; u < kPcBatch; ++u) {
      const int i = c0 + 32 * u + lane;
      ids[u] = kPcNoId;
      v0[u] = v1[u] = 0.0;
      if (i < n) {
        v0[u] = (double)w_row[i];
        v1[u] = (double)wy_row[i];
        ids[u] = pc_fold_id(t_row[i], period, inv_period, a.d_phase,
                            a.inv_d_phase, a.reciprocal, nbins);
      }
    }
#pragma unroll
    for (int u = 0; u < kPcBatch; ++u) {
      if (c0 + 32 * u >= n) break;   // the same for the warp
      pc_deposit_run(ids[u], v0[u], v1[u], cw, cwy);
    }
  }
  lk_warp_prefix<double>(cw, last + 1);
  lk_warp_prefix<double>(cwy, last + 1);
  __syncwarp();

  const double tw = cw[nbp], twy = cwy[nbp];
  const bool like = a.likelihood, wr = a.wrap;
  double bv = -INFINITY;
  int bi = 0;
  int lo, hi;
  lk_lane_range(nbp, &lo, &hi);
  for (int s = lo; s < hi; ++s) {
    for (int j = 0; j < n_durs; ++j) {
      const int k = __ldg(k_durs + j);
      if (k > nbp) continue;
      double w_in, wy_in;
      pc_window(cw, cwy, s, k, nbp, nbins, wr, tw, twy, &w_in, &wy_in);
      const double w_out = __dsub_rn(tw, w_in);
      if (!(w_in > 0.0 && w_out > 0.0)) continue;
      const double d = pc_depth(w_in, wy_in, w_out, __dsub_rn(twy, wy_in));
      const double obj = like ? pc_loglike(w_in, d)
                              : __ddiv_rn(d, pc_err(w_in, w_out));
      if (pc_better(obj, bv)) {
        bv = obj;
        bi = s * n_durs + j;
      }
    }
  }
  // lane runs ascend: a later run wins only if strictly better
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double ov = __shfl_down_sync(LK_FULL_MASK, bv, off);
    const int oi = __shfl_down_sync(LK_FULL_MASK, bi, off);
    if ((lane & (2 * off - 1)) == 0 && pc_better(ov, bv)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane != 0) return;
  // the winner's statistics as the plain version takes them at its argmax
  // (index 0 where no window is valid: invalid sums replaced by 1)
  const int s = bi / n_durs, k = __ldg(k_durs + bi % n_durs);
  double w_in, wy_in;
  pc_window(cw, cwy, s, k, nbp, nbins, wr, tw, twy, &w_in, &wy_in);
  const double w_out = __dsub_rn(tw, w_in);
  const double wy_out = __dsub_rn(twy, wy_in);
  const bool ok = w_in > 0.0 && w_out > 0.0 && s < nbp && k <= nbp;
  const double w_in_s = ok ? w_in : 1.0, w_out_s = ok ? w_out : 1.0;
  const double d = pc_depth(w_in_s, wy_in, w_out_s, wy_out);
  const double err = pc_err(w_in_s, w_out_s);
  const double snr = __ddiv_rn(d, err);
  const double ll = pc_loglike(w_in_s, d);
  a.power[o] = ok ? (like ? ll : snr) : -INFINITY;
  a.depth[o] = d;
  a.depth_err[o] = err;
  a.depth_snr[o] = snr;
  a.loglike[o] = ll;
  a.best[o] = bi;
}

// Periods whose columns fit a block's shared memory: a block holds a run
// of consecutive periods of curve blockIdx.y, one a warp.  A period of the
// L2 kernel (0 rows in the plan) leaves its warp idle.
template <typename T>
__global__ void curve_kernel(const PcArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int* groups = a.plan + a.n_durs;
  const int* row_off = groups + a.n_groups + 1;
  const int* rows = row_off + a.P;
  const int p = groups[blockIdx.x] + warp;
  if (p >= groups[blockIdx.x + 1] || rows[p] == 0) return;   // no barrier
  double* cw = reinterpret_cast<double*>(smem_raw) + (size_t)2 * row_off[p];
  pc_search(a, blockIdx.y, p, cw, cw + rows[p], rows[p]);
}

// Periods whose columns do not fit shared memory (a long baseline's
// periods past ~72 d at lightkurve's default bins): each warp owns two
// columns of ``cap`` rows in the global workspace ``ws`` (slot after
// slot), which stay in L2 as far as it holds them, and takes the (curve,
// period) items of the plan's list in turn, ``slots`` apart.
template <typename T>
__global__ void curve_kernel_l2(const PcArgs<T> a, double* ws, int cap,
                                int slots) {
  const int slot = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (slot >= slots) return;
  double* cw = ws + (size_t)2 * cap * slot;
  const int* longs = a.plan + a.n_durs + a.n_groups + 1 + 2 * a.P;
  const long long items = (long long)a.B * a.n_long;
  for (long long it = slot; it < items; it += slots) {
    __syncwarp();   // lane 0's winner read its columns: now free to clear
    pc_search(a, (int)(it / a.n_long), longs[it % a.n_long], cw, cw + cap,
              cap);
  }
}

// At most this many warps (periods) a block: two blocks of 16 fill an SM's
// registers at 64 a thread.
constexpr int kPcMaxWarps = 16;

// The block K-PC launches where its largest period needs ``max_rows`` rows
// (two float64 columns each): ``warps`` periods at most, ``smem`` bytes of
// shared memory for their columns.  Each width up to kPcMaxWarps is given
// the shared memory that lets as many of its blocks share an SM as its
// registers allow (at least the largest period's); the width with the most
// resident warps wins, then the most periods of the largest size resident,
// then the widest.  Sets the kernel's dynamic shared memory limit; an error
// if the largest period does not fit.
template <typename T>
cudaError_t block_of(int max_rows, int* warps_out, int* smem_out,
                     int* blocks_out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int optin = lk_shared_optin(dev);
  int sm_smem = 0, reserved = 0;
  err = cudaDeviceGetAttribute(
      &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(curve_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(curve_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attrs;
  err = cudaFuncGetAttributes(&attrs, curve_kernel<T>);
  if (err != cudaSuccess) return err;
  const size_t need = (size_t)max_rows * 2 * sizeof(double);
  if (max_rows < 1 || need > (size_t)optin) return cudaErrorInvalidValue;
  int best_w = 0, best_smem = 0, best_blocks = 0, best_long = 0;
  for (int w = kPcMaxWarps; w >= 1; w /= 2) {
    if (32 * w > attrs.maxThreadsPerBlock) continue;
    int by_regs = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &by_regs, curve_kernel<T>, 32 * w, 0);
    if (err != cudaSuccess) return err;
    if (by_regs < 1) continue;
    size_t smem = (size_t)(sm_smem / by_regs - reserved) / 16 * 16;
    smem = std::min(std::max(smem, need), (size_t)optin);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, curve_kernel<T>, 32 * w, smem);
    if (err != cudaSuccess) return err;
    const int warps = blocks * w;
    const int longest = blocks * std::min(w, (int)(smem / need));
    if (warps > best_blocks * best_w ||
        (warps == best_blocks * best_w && longest > best_long)) {
      best_w = w;
      best_smem = (int)smem;
      best_blocks = blocks;
      best_long = longest;
    }
  }
  *warps_out = best_w;
  *smem_out = best_smem;
  *blocks_out = best_blocks;
  return best_w > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

// Warps a block of the L2 kernel.
constexpr int kPcL2Warps = 4;

// Both kernels, on one stream: the shared-memory kernel over its n_groups
// blocks, then the L2 kernel over the n_long periods of the plan's list
// with ``slots`` warps, each on 2 * ws_rows float64 of ``ws``.  Either
// part may be empty.
template <typename T>
int launch(const PcArgs<T>& a, int warps, int smem, double* ws, int ws_rows,
           int slots, void* stream) {
  if (a.n_durs < 1 || a.n < 0 || a.B < 1 || a.B > 65535 || a.P < 1 ||
      a.n_groups < 0 || a.n_long < 0 || a.nbins < 1)
    return (int)cudaErrorInvalidValue;
  if (a.n_groups > 0) {
    if (warps < 1 || warps > kPcMaxWarps || smem < 16)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        curve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    curve_kernel<T><<<dim3(a.n_groups, a.B), 32 * warps, smem,
                      (cudaStream_t)stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.n_long > 0) {
    if (ws == nullptr || ws_rows < 1 || slots < 1)
      return (int)cudaErrorInvalidValue;
    const int blocks = (slots + kPcL2Warps - 1) / kPcL2Warps;
    curve_kernel_l2<T><<<blocks, 32 * kPcL2Warps, 0,
                         (cudaStream_t)stream>>>(a, ws, ws_rows, slots);
    return (int)cudaGetLastError();
  }
  return (int)cudaSuccess;
}

template <typename T>
int launch_c(const double* ts, const T* w, const T* wy, const double* pc,
             const int* plan, int n_durs, int n, int B, int P, int n_groups,
             int n_long, int warps, int smem, int nbins, double d_phase,
             double inv_d_phase, int reciprocal, int likelihood, int wrap,
             double* ws, int ws_rows, int slots, double* power, double* depth,
             double* depth_err, double* depth_snr, double* loglike,
             int* best, void* stream) {
  const PcArgs<T> a{ts, w, wy, pc, plan, n_durs, n, B, P, n_groups, n_long,
                    nbins, d_phase, inv_d_phase, reciprocal != 0,
                    likelihood != 0, wrap != 0, power, depth, depth_err,
                    depth_snr, loglike, best};
  return launch(a, warps, smem, ws, ws_rows, slots, stream);
}

}  // namespace

extern "C" {

// The block K-PC's shared-memory kernel launches where its largest period
// needs ``max_rows`` rows (``f64``: float64 data): its width in warps
// (periods), its shared memory in bytes and its resident blocks per SM.
int lk_bls_curve_block(int f64, int max_rows, int* warps, int* smem,
                       int* blocks) {
  return (int)(f64 ? block_of<double>(max_rows, warps, smem, blocks)
                   : block_of<float>(max_rows, warps, smem, blocks));
}

// ``ts`` (B, n) float64 times from each curve's first sample; ``w``, ``wy``
// (B, n) weights and weighted fluxes; ``pc`` (P,) float64 periods;
// ``plan`` int32 as PcArgs describes it (n_groups blocks of ``warps``
// periods at most in ``smem`` bytes; n_long periods on ``slots`` warps'
// columns of ``ws_rows`` rows in ``ws``).  Outputs (B, P).
int lk_bls_curve_fused_f32(const double* ts, const float* w, const float* wy,
                           const double* pc, const int* plan, int n_durs,
                           int n, int B, int P, int n_groups, int n_long,
                           int warps, int smem, int nbins, double d_phase,
                           double inv_d_phase, int reciprocal,
                           int likelihood, int wrap, double* ws, int ws_rows,
                           int slots, double* power, double* depth,
                           double* depth_err, double* depth_snr,
                           double* loglike, int* best, void* stream) {
  return launch_c<float>(ts, w, wy, pc, plan, n_durs, n, B, P, n_groups,
                         n_long, warps, smem, nbins, d_phase, inv_d_phase,
                         reciprocal, likelihood, wrap, ws, ws_rows, slots,
                         power, depth, depth_err, depth_snr, loglike, best,
                         stream);
}

int lk_bls_curve_fused_f64(const double* ts, const double* w,
                           const double* wy, const double* pc,
                           const int* plan, int n_durs, int n, int B, int P,
                           int n_groups, int n_long, int warps, int smem,
                           int nbins, double d_phase, double inv_d_phase,
                           int reciprocal, int likelihood, int wrap,
                           double* ws, int ws_rows, int slots, double* power,
                           double* depth, double* depth_err,
                           double* depth_snr, double* loglike, int* best,
                           void* stream) {
  return launch_c<double>(ts, w, wy, pc, plan, n_durs, n, B, P, n_groups,
                          n_long, warps, smem, nbins, d_phase, inv_d_phase,
                          reciprocal, likelihood, wrap, ws, ws_rows, slots,
                          power, depth, depth_err, depth_snr, loglike, best,
                          stream);
}

}  // extern "C"

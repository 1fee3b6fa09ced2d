// G1: the per-asset ELBO of the tridiagonal GPCV family and its gradient,
// in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this ELBO to XLA, which
// fuses its elementwise work and its `lax.associative_scan`s.  The port's
// plain composition (`models/gpcv.py` `GPCVModel.elbo` with q="tridiag",
// the BM kernel and the closed-form exp term; `ops/bidiag.py`) runs two
// doubling scans of ten rounds each at n = 999, and autograd's reverse of
// them: about 740 kernel launches a step, whose host work set the GPCV
// stage's time.  Here one block per asset computes, with
// d = exp(q_log_d), r_j = e_j / d_j, dx_j = max(x_j - x_{j-1}, 1e-6 / vol)
// (x_{-1} = 0), inv_j = 1 / dx_j (inv_n = 0), c the prior mean:
//
//   var_j  = 1 / d_j^2 + r_j^2 var_{j+1}  (var_n = 0),  cov_j = -r_j var_{j+1}
//   ELL_j  = -y_j^2 / 2 exp(min(2 var_j - 2 m_j, 80)) - m_j - log(2 pi) / 2
//   T_j    = (inv_j + inv_{j+1}) var_j - 2 inv_{j+1} cov_j
//   Q_j    = diff_j^2 inv_j,  diff_0 = c - m_0,  diff_j = m_{j-1} - m_j
//   G      = sum_j (ELL_j - (T_j + Q_j) / (2 vol) - log(dx_j) / 2 - log d_j)
//            + n / 2 - n log(vol) / 2
//
// and returns G / n, the ELBO that `GPCVModel.elbo` returns (the mean of
// ELL less the closed-form KL over n).  Its gradient, when asked for:
//
//   gv_j   = -y_j^2 w_j k_j - (inv_j + inv_{j+1}) / (2 vol)      (d/d var_j)
//            w_j = exp(min(u_j, 80)), k_j = [u_j <= 80], u_j = 2 var_j - 2 m_j
//   lam_j  = r_{j-1}^2 lam_{j-1} + gv_j - r_{j-1} inv_j / vol   (lam_{-1} = 0)
//            the adjoint of the reverse var recurrence, a forward one
//   gr_j   = var_{j+1} (2 r_j lam_j - inv_{j+1} / vol)          (d/d r_j)
//   dG/dq_log_d_j = -2 lam_j / d_j^2 - r_j gr_j - 1
//   dG/de_j       = gr_j / d_j
//   dG/dm_j       = y_j^2 w_j k_j - 1 + h_j - h_{j+1},  h_j = diff_j inv_j / vol
//   dG/dc         = -h_0
//   dG/dvol       = (sum_j (T_j + Q_j) / vol - n) / (2 vol)
//                   + jit / vol sum_j s_j dKL/ddx_j
//            dKL/ddx_j = (inv_j - inv_j^2 (var_j + var_{j-1} + 2 r_{j-1} var_j
//                         + diff_j^2) / vol) / 2, the j-1 terms from j >= 1,
//            s_j = 1 where the floor jit = 1e-6 / vol is taken, 1/2 on a tie
//            (torch.maximum's rule) and 0 elsewhere,
//
// each over n.  k_j is torch.clamp's gradient rule at the cap (it passes
// at u = 80 and not above).
//
// Design: one block of THREADS threads per asset, each thread a contiguous
// chunk of ceil(n / THREADS) steps, so any n >= 1 works.  (1) Each thread
// composes the affine maps var_{j+1} -> var_j of its chunk; a block
// exclusive scan from the last thread (warp shuffles, then one shared-
// memory step across the warps) gives each chunk the var entering it from
// the right.  (2) Each thread runs var over its chunk, from its end, adds
// the terms of G, stores var in a float64 workspace and composes the affine
// maps lam_{j-1} -> lam_j of its chunk; (3) a forward scan of those gives
// each chunk its entering lam; (4) each thread runs lam over its chunk,
// writing the gradients.  Block sums give G and the vol terms.  Without a
// gradient, steps (3) and (4) and the workspace are skipped.
//
// Precision: float32 in and out, float64 inside (as S1): the plain float32
// composition loses digits in the trace term at a grid starting at 0,
// whose first increment is floored at 1e-6 / vol (inv_0 near 5e6 against
// var_0), and the scans sum in another order than the plain doubling scan.
//
// What bounds it on the card: the bytes are x (shared or per row), y, m,
// q_log_d and q_e read once and the ELBO and three gradient rows written
// once, 28 bytes a step (about 14 MB at (505, 999): 4.2 us at 3.35 TB/s).
// What sets its time is latency: each thread's chain of float64
// exponentials, logarithms and divisions over its chunk (8 steps at
// n = 999), three passes of it, two scans of 7 levels and the block
// sums.  Measured on an NVIDIA H100 80GB HBM3 (700 W limit), on the device
// alone (chip_smoke.py): with the gradient 0.031 ms at (64, 999) and
// 0.045 ms at (505, 999) against the bytes' 0.0005 and 0.0042 ms, without
// it 0.0135 and 0.0195 ms; the plain composition's forward and backward
// took 13.8-14.0 ms a call there, nearly all of it the host's launches.

#include <cuda_runtime.h>

#include "affine_scan.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr double HALF_LOG_2PI = 0.91893853320467274;
constexpr double CAP = 80.0;
constexpr double KL_JITTER = 1e-6;

using volt::Affine;

// The block's sums of three values, in every thread.
__device__ void block_sum3(double v[3], double* partial) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(FULL, v[k], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) partial[3 * (threadIdx.x >> 5) + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = 0.0;
    for (int w = 0; w < WARPS; ++w) v[k] += partial[3 * w + k];
  }
}

// One asset's inputs and the quantities of a step that depend on no scan.
struct Row {
  const float* __restrict__ x;
  const float* __restrict__ y;
  const float* __restrict__ m;
  const float* __restrict__ ld;
  const float* __restrict__ e;
  int n;
  double c, vol, jit;

  __device__ double raw_dx(int j) const {
    return static_cast<double>(__ldg(x + j)) - (j > 0 ? __ldg(x + j - 1) : 0.0f);
  }
  // the increment with the floor; NaN passes as torch.maximum's does
  __device__ double dx(int j) const {
    const double r = raw_dx(j);
    return r < jit ? jit : r;
  }
  // d dx_j / d jit: torch.maximum's gradient to its second argument
  __device__ double floor_share(int j) const {
    const double r = raw_dx(j);
    return jit > r ? 1.0 : (jit == r ? 0.5 : 0.0);
  }
  __device__ double inv(int j) const { return j < n ? 1.0 / dx(j) : 0.0; }
  __device__ double inv_d(int j) const { return exp(-static_cast<double>(__ldg(ld + j))); }
  // e_j / d_j; 0 past the last subdiagonal entry
  __device__ double r(int j) const {
    return (j >= 0 && j < n - 1) ? __ldg(e + j) * inv_d(j) : 0.0;
  }
  __device__ double diff(int j) const {
    if (j >= n) return 0.0;
    return (j > 0 ? static_cast<double>(__ldg(m + j - 1)) : c) - __ldg(m + j);
  }
};

// y^2 w k and w of step j's expected log-likelihood at var_j
struct Ell {
  double yw, w, m, y;
  __device__ Ell(const Row& row, int j, double var) {
    m = __ldg(row.m + j);
    y = __ldg(row.y + j);
    const double u = 2.0 * var - 2.0 * m;
    w = exp(u > CAP ? CAP : u);  // NaN passes
    yw = u <= CAP ? y * y * w : 0.0;
  }
  __device__ double value() const { return -0.5 * y * y * w - m - HALF_LOG_2PI; }
};

__global__ void __launch_bounds__(THREADS)
gpcv_elbo_kernel(const float* __restrict__ x, int x_per_row, const float* __restrict__ y,
                 const float* __restrict__ m, const float* __restrict__ q_log_d,
                 const float* __restrict__ q_e, const float* __restrict__ c,
                 const float* __restrict__ vol, float* __restrict__ elbo,
                 float* __restrict__ g_m, float* __restrict__ g_ld, float* __restrict__ g_e,
                 float* __restrict__ g_c, float* __restrict__ g_vol,
                 double* __restrict__ var_ws, int n) {
  __shared__ Affine totals[WARPS];
  __shared__ double partial[3 * WARPS];
  const int b = blockIdx.x;
  const long long off = static_cast<long long>(b) * n;
  const long long off_e = static_cast<long long>(b) * (n - 1);
  const double v = vol[b];
  const Row row{x + (x_per_row ? off : 0), y + off, m + off, q_log_d + off, q_e + off_e,
                n, static_cast<double>(c[b]), v, KL_JITTER / v};
  const bool grad = g_m != nullptr;
  double* ws = grad ? var_ws + off : nullptr;
  const int chunk = (n + THREADS - 1) / THREADS;
  const int lo = min(n, static_cast<int>(threadIdx.x) * chunk);
  const int hi = min(n, lo + chunk);

  // (1) var_{hi} -> var_{lo} over the chunk, scanned from the end: the var
  // entering the chunk from the right
  Affine vm = Affine::identity();
  for (int j = lo; j < hi; ++j) {
    const double rj = row.r(j);
    const double id = row.inv_d(j);
    vm = vm.after(Affine{rj * rj, id * id});
  }
  double var_next = volt::exclusive_scan<WARPS>(vm, true, totals).b;

  // (2) var over the chunk from its end: the terms of G, the stored var,
  // and the map lam_{lo-1} -> lam_{hi-1}
  double sums[3] = {0.0, 0.0, 0.0};  // G's terms, T + Q, the floor's terms
  Affine lm = Affine::identity();
  for (int j = hi - 1; j >= lo; --j) {
    const double rj = row.r(j);
    const double id = row.inv_d(j);
    const double var = id * id + rj * rj * var_next;
    const double cov = -rj * var_next;
    const double inv = row.inv(j), inv_next = row.inv(j + 1);
    const Ell ell(row, j, var);
    const double dj = row.diff(j);
    const double tq = (inv + inv_next) * var - 2.0 * inv_next * cov + dj * dj * inv;
    sums[0] += ell.value() - 0.5 * tq / v - 0.5 * log(row.dx(j)) - __ldg(row.ld + j);
    sums[1] += tq;
    if (grad) {
      ws[j] = var;
      const double gv = -ell.yw - 0.5 * (inv + inv_next) / v;
      const double rp = row.r(j - 1);
      lm = lm.after(Affine{rp * rp, gv - rp * inv / v});
    }
    var_next = var;
  }

  if (grad) {
    // (3) the lam entering each chunk from the left (the scan's barriers
    // also make every thread's stored var visible to the block)
    double lam = volt::exclusive_scan<WARPS>(lm, false, totals).b;

    // (4) lam over the chunk: the gradients
    const double inv_n = 1.0 / n;
    for (int j = lo; j < hi; ++j) {
      const double var = ws[j];
      const double var_after = j + 1 < n ? ws[j + 1] : 0.0;
      const double rj = row.r(j), rp = row.r(j - 1);
      const double id = row.inv_d(j);
      const double inv = row.inv(j), inv_next = row.inv(j + 1);
      const Ell ell(row, j, var);
      lam = rp * rp * lam - ell.yw - 0.5 * (inv + inv_next) / v - rp * inv / v;
      const double gr = var_after * (2.0 * rj * lam - inv_next / v);
      g_ld[off + j] = static_cast<float>((-2.0 * id * id * lam - rj * gr - 1.0) * inv_n);
      if (j < n - 1) g_e[off_e + j] = static_cast<float>(gr * id * inv_n);
      const double dj = row.diff(j);
      const double h = dj * inv / v;
      const double h_next = row.diff(j + 1) * inv_next / v;
      g_m[off + j] = static_cast<float>((ell.yw - 1.0 + h - h_next) * inv_n);
      if (j == 0) g_c[b] = static_cast<float>(-h * inv_n);
      const double s = row.floor_share(j);
      if (s != 0.0) {
        const double before = j > 0 ? ws[j - 1] + 2.0 * rp * var : 0.0;
        sums[2] += s * 0.5 * (inv - inv * inv * (var + before + dj * dj) / v);
      }
    }
  }

  block_sum3(sums, partial);
  if (threadIdx.x == 0) {
    elbo[b] = static_cast<float>((sums[0] + 0.5 * n - 0.5 * n * log(v)) / n);
    if (grad) {
      g_vol[b] = static_cast<float>(
          ((sums[1] / v - n) / (2.0 * v) + row.jit / v * sums[2]) / n);
    }
  }
}

}  // namespace

// Per asset b < batch: x (n,) shared (x_per_row 0) or (batch, n); y, m,
// q_log_d (batch, n); q_e (batch, n - 1); c, vol (batch,).  Writes the
// ELBO (batch,) and, when g_m is not null, its gradients g_m, g_ld
// (batch, n), g_e (batch, n - 1), g_c, g_vol (batch,), through the
// float64 workspace var_ws (batch, n).
extern "C" int volt_gpcv_tridiag_elbo(const float* x, int x_per_row, const float* y,
                                      const float* m, const float* q_log_d,
                                      const float* q_e, const float* c, const float* vol,
                                      float* elbo, float* g_m, float* g_ld, float* g_e,
                                      float* g_c, float* g_vol, double* var_ws, int batch,
                                      int n, cudaStream_t stream) {
  gpcv_elbo_kernel<<<batch, THREADS, 0, stream>>>(x, x_per_row, y, m, q_log_d, q_e, c, vol,
                                                  elbo, g_m, g_ld, g_e, g_c, g_vol, var_ws,
                                                  n);
  return static_cast<int>(cudaGetLastError());
}

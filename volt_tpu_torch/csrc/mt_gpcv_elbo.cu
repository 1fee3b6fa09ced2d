// G3: the joint (Kronecker) tridiagonal GPCV ELBO of the multitask model
// and its gradient, in one C call a step: three launches, no library call
// and no wait for the host.
//
// Replaces no TPU kernel: the JAX package leaves this ELBO to XLA.  The
// port's plain composition (`models/multitask.py`
// `MultitaskVariationalGP.elbo` with q="tridiag", the BM kernel and the
// closed-form exp term; `ops/bidiag.py`, `gp/kronecker.py`) runs two
// doubling scans of ten rounds at n = 999, a Cholesky of the T x T task
// covariance whose jitter ladder waits for the card, two triangular solves
// and autograd's reverse of all of it: about 1000 kernel launches a step,
// whose host work set the stage's time.
//
// The model: returns y (n, T), variational mean M (n, T), the data factor
// of q by its bidiagonal precision root (d = exp(q_log_d), e), the task
// factor by its root R (T, T) (lower triangle), the prior mean c (T,), the
// prior vol * min(x) (x) K_t with K_t = F F^T + diag(v), F (T, r).  With
// dx_j = max(x_j - x_{j-1}, 1e-6 / vol) (x_{-1} = 0), inv_j = 1 / dx_j
// (inv_n = 0), r_j = e_j / d_j:
//
//   sx_j  = 1 / d_j^2 + r_j^2 sx_{j+1} (sx_n = 0), cv_j = -r_j sx_{j+1}
//           the Takahashi band of q's data factor, one scan for all tasks
//   dt_a  = sum_b R_ab^2, the task factor's marginal variances
//   ELL   = sum_ia -y_ia^2 / 2 exp(min(2 sx_i dt_a - 2 M_ia, 80)) - M_ia
//           - log(2 pi) / 2
//   trx   = sum_j ((inv_j + inv_{j+1}) sx_j - 2 inv_{j+1} cv_j) / vol
//   A     = K_t^{-1} = V^{-1} - G C^{-1} G^T, G = V^{-1} F,
//           C = I + F^T V^{-1} F (r x r): Woodbury
//   tau   = tr(A R R^T) = sum_a dt_a / v_a - sum_b P_b^T C^{-1} P_b,
//           P_b = sum_{a >= b} R_ab G_a
//   D_i   = c - M_0 (i = 0), M_{i-1} - M_i: the mean gap's difference
//   Q     = sum_i inv_i D_i^T A D_i
//         = sum_i inv_i (sum_a D_ia^2 / v_a - DG_i^T C^{-1} DG_i),
//           DG_i = sum_a D_ia G_a
//   KL    = (tau trx + Q / vol - n T + T (n log vol + sum_j log dx_j)
//            + n (sum_a log v_a + log|C|) + 2 T sum_j q_log_d_j
//            - 2 n sum_a log|R_aa|) / 2
//
// and returns (ELL - KL) / (n T), the ELBO that `elbo` returns (the mean
// ELL less KL / (n T)).  Its gradient, each term over n T:
//
//   gell_ia = -y^2 w k, w = exp(min(u, 80)), k = [u <= 80] (torch.clamp's
//             rule), u = 2 sx_i dt_a - 2 M_ia
//   eta_i   = inv_i A D_i / vol (eta_n = 0)
//   d/dM_ia = -gell_ia - 1 + eta_ia - eta_{i+1,a},  d/dc = -eta_0
//   lam_j   = r_{j-1}^2 lam_{j-1} + sum_a gell_ja dt_a
//             - tau ((inv_j + inv_{j+1}) / 2 + r_{j-1} inv_j) / vol
//             (lam_{-1} = 0): the adjoint of the sx recurrence, forward
//   gr_j    = sx_{j+1} (2 r_j lam_j - tau inv_{j+1} / vol)
//   d/dq_log_d_j = -2 lam_j / d_j^2 - r_j gr_j - T,  d/de_j = gr_j / d_j
//   d/dR_ab = 2 R_ab sum_i gell_ia sx_i - trx (A R)_ab + [a = b] n / R_aa
//             (a >= b; 0 above the diagonal)
//   with E  = trx R R^T + sum_i inv_i D_i D_i^T / vol and dKL/dK_t =
//   (n A - A E A) / 2, through EG = E G and GEG = G^T E G (r x r):
//   d/dF_a  = -n C^{-1} G_a + C^{-1} EG_a / v_a - C^{-1} GEG C^{-1} G_a
//   d/dv_a  = -(n (1 / v_a - G_a^T C^{-1} G_a) - (A E A)_aa) / 2,
//             (A E A)_aa = E_aa / v_a^2 - 2 G_a^T C^{-1} EG_a / v_a
//                          + G_a^T C^{-1} GEG C^{-1} G_a
//   d/dvol  = ((tau trx vol + Q) / vol - n T) / (2 vol)
//             + jit / vol sum_j s_j dKL/ddx_j,
//             dKL/ddx_j = (T inv_j - inv_j^2 (tau (sx_j + sx_{j-1}
//                          + 2 r_{j-1} sx_j) + D_j^T A D_j) / vol) / 2,
//             s_j the share of the floor jit = 1e-6 / vol in dx_j (1 where
//             taken, 1/2 on a tie: torch.maximum's rule, 0 elsewhere).
//
// The same result as the plain path: with v = softplus(raw_var) > 0, K_t
// is positive definite, and its float64 Woodbury here needs no jitter.
// The plain path's float32 Cholesky adds jitter only when the bare float32
// factor of K_t fails (`ops/chol.py`'s ladder); its float64 run, which the
// benchmark's reference is, does not.  Where the float32 ladder engages,
// this kernel agrees with the float64 plain path, not the float32 one.
//
// Design: three launches, each a grid of blocks of THREADS threads, each
// block one role.  Reductions along a row of (n, T) or (T, T) take a warp
// a row; reductions along columns take a tile of 32 columns, a warp a row
// at a time; the data scans take one block, each thread a chunk of the
// grid, as G1 (`gpcv_elbo.cu`).  Everything passes through a float64
// workspace:
//   (1) the forward Takahashi scan (sx, sum of the trace terms), C and its
//       inverse, dt and log|R_aa| by rows of R, P by columns of R, DG and
//       sum_a D_ia^2 / v_a by rows of (n, T);
//   (2) tau, trx, Q and GEG; the ELL by rows of (n, T) with d/dM, d/dc and
//       sum_a gell dt_a; by columns of (n, T) sum_i gell sx_i, E's
//       diagonal and the data part of EG; by rows of R, R P;
//   (3) the adjoint scan (d/dq_log_d, d/de, the floor's vol terms) and the
//       ELBO and d/dvol; d/dR by rows of R; d/dF and d/dv by tasks.
// Without a gradient, (2) runs its first two roles and (3) its first.
//
// Precision: float32 in and out, float64 inside (as G1 and S1).
//
// What bounds it on the card: every input read once and every output
// written once is 8.1 MB at (n, T, r) = (999, 505, 1), 2.4 us at 3.35 TB/s
// (it reads y and M three times, R twice).  What sets its time is latency:
// three launches, two single-block scans over the grid, float64
// exponentials over (n, T) twice.  Measured on an NVIDIA H100 80GB HBM3
// (700 W limit), on the device alone (chip_smoke.py): 0.150 ms with the
// gradient, 0.044 ms without; the plain composition's forward and backward
// took 15.3 ms a call there, nearly all of it the host's launches.

#include <cuda_runtime.h>

#include "affine_scan.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RMAX = 4;  // the largest rank of F taken
constexpr unsigned FULL = 0xffffffffu;
constexpr double HALF_LOG_2PI = 0.91893853320467274;
constexpr double CAP = 80.0;
constexpr double KL_JITTER = 1e-6;

// The scalars of the workspace, after its arrays: S_COUNT of the
// WS_SCALARS doubles that the wrapper sets aside.
constexpr int WS_SCALARS = 64;
enum Scalar {
  S_SUM_T,    // sum_j of the trace terms, vol * trx
  S_LOG_DX,   // sum_j log dx_j
  S_LD,       // sum_j q_log_d_j
  S_LOG_V,    // sum_a log v_a
  S_LOG_C,    // log|C|
  S_TAU,
  S_TRX,
  S_Q,
  S_LOG_R,    // sum_a log|R_aa|
  S_CINV,     // C^{-1}, RMAX x RMAX
  S_GEG = S_CINV + RMAX * RMAX,
  S_COUNT = S_GEG + RMAX * RMAX,
};
static_assert(S_COUNT <= WS_SCALARS, "the workspace's scalars");

using volt::Affine;

__device__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The block's sums of the K values `v`, in thread 0.
template <int K>
__device__ void block_sum(double v[K]) {
  __shared__ double partial[WARPS][K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) partial[threadIdx.x >> 5][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = 0.0;
      for (int w = 0; w < WARPS; ++w) v[k] += partial[w][k];
    }
  }
}

// A tile of 32 columns' sums of K values a lane over the block's warps,
// in warp 0.
template <int K>
__device__ void column_sum(double v[K]) {
  __shared__ double partial[WARPS][K][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) partial[warp][k][lane] = v[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = 0.0;
      for (int w = 0; w < WARPS; ++w) v[k] += partial[w][k][lane];
    }
  }
}

struct Args {
  const float *x, *y, *m, *ld, *e, *root, *c, *f, *v, *vol;
  float *elbo, *g_m, *g_ld, *g_e, *g_root, *g_c, *g_f, *g_v, *g_vol;
  // the float64 workspace: sx, gsx, ell, rowq (n); dg (n r); dt, logr,
  // gdt, sd2 (T); p, rp, ddg (T r); then the S_COUNT scalars
  double *sx, *gsx, *ell, *rowq, *dg, *dt, *logr, *gdt, *sd2, *p, *rp, *ddg, *s;
  int n, t, r;
  // blocks of the roles by rows (a warp a row) and by column tiles
  int rows_n, rows_t, cols_t;

  __device__ bool grad() const { return g_m != nullptr; }
  __device__ double vol0() const { return vol[0]; }
  __device__ double jit() const { return KL_JITTER / vol0(); }
  __device__ double raw_dx(int j) const {
    return static_cast<double>(__ldg(x + j)) - (j > 0 ? __ldg(x + j - 1) : 0.0f);
  }
  // the increment with the floor; NaN passes as torch.maximum's does
  __device__ double dx(int j) const {
    const double r0 = raw_dx(j), fl = jit();
    return r0 < fl ? fl : r0;
  }
  // d dx_j / d jit: torch.maximum's gradient to its second argument
  __device__ double floor_share(int j) const {
    const double r0 = raw_dx(j), fl = jit();
    return fl > r0 ? 1.0 : (fl == r0 ? 0.5 : 0.0);
  }
  __device__ double inv(int j) const { return j < n ? 1.0 / dx(j) : 0.0; }
  __device__ double inv_d(int j) const { return exp(-static_cast<double>(__ldg(ld + j))); }
  // e_j / d_j; 0 outside the subdiagonal
  __device__ double rr(int j) const {
    return (j >= 0 && j < n - 1) ? __ldg(e + j) * inv_d(j) : 0.0;
  }
  // D_ia
  __device__ double gap(int i, int a) const {
    const long long at = static_cast<long long>(i) * t + a;
    return (i > 0 ? static_cast<double>(__ldg(m + at - t)) : __ldg(c + a)) - __ldg(m + at);
  }
  // the r-vector at row `i` of an (., r) array, 0 past r
  __device__ void load(const double* arr, int i, double out[RMAX]) const {
#pragma unroll
    for (int k = 0; k < RMAX; ++k) out[k] = k < r ? arr[static_cast<long long>(i) * r + k] : 0.0;
  }
  __device__ void store(double* arr, int i, const double z[RMAX]) const {
#pragma unroll
    for (int k = 0; k < RMAX; ++k)
      if (k < r) arr[static_cast<long long>(i) * r + k] = z[k];
  }
  // G_a = F_a / v_a, 0 past r
  __device__ void g_of(int a, double g[RMAX]) const {
    const double va = __ldg(v + a);
#pragma unroll
    for (int k = 0; k < RMAX; ++k) g[k] = k < r ? __ldg(f + a * r + k) / va : 0.0;
  }
  // C^{-1} z (C is the identity past r)
  __device__ void cinv(const double z[RMAX], double out[RMAX]) const {
#pragma unroll
    for (int k = 0; k < RMAX; ++k) {
      out[k] = 0.0;
#pragma unroll
      for (int l = 0; l < RMAX; ++l) out[k] += s[S_CINV + k * RMAX + l] * z[l];
    }
  }
};

__device__ double dot(const double a[RMAX], const double b[RMAX]) {
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < RMAX; ++k) acc += a[k] * b[k];
  return acc;
}

// the chunk [lo, hi) of the grid of this block's thread
__device__ void chunk(int n, int& lo, int& hi) {
  const int size = (n + THREADS - 1) / THREADS;
  lo = min(n, static_cast<int>(threadIdx.x) * size);
  hi = min(n, lo + size);
}

// (1a) The Takahashi band from the end: sx, and the sums of the trace
// terms, log dx and q_log_d.
__device__ void forward_scan(const Args& a) {
  __shared__ Affine totals[WARPS];
  int lo, hi;
  chunk(a.n, lo, hi);
  Affine vm = Affine::identity();
  for (int j = lo; j < hi; ++j) {
    const double rj = a.rr(j), id = a.inv_d(j);
    vm = vm.after(Affine{rj * rj, id * id});
  }
  double next = volt::exclusive_scan<WARPS>(vm, true, totals).b;
  double sums[3] = {0.0, 0.0, 0.0};
  for (int j = hi - 1; j >= lo; --j) {
    const double rj = a.rr(j), id = a.inv_d(j);
    const double sx = id * id + rj * rj * next;
    const double inv = a.inv(j), inv_next = a.inv(j + 1);
    sums[0] += (inv + inv_next) * sx + 2.0 * inv_next * rj * next;
    sums[1] += log(a.dx(j));
    sums[2] += __ldg(a.ld + j);
    a.sx[j] = sx;
    next = sx;
  }
  block_sum<3>(sums);
  if (threadIdx.x == 0) {
    a.s[S_SUM_T] = sums[0];
    a.s[S_LOG_DX] = sums[1];
    a.s[S_LD] = sums[2];
  }
}

// (1b) C = I + F^T V^{-1} F, its inverse and log-determinant by its
// Cholesky factor, and sum_a log v_a.
__device__ void capacitance(const Args& a) {
  constexpr int K = 1 + RMAX * RMAX;
  double acc[K] = {};
  for (int i = threadIdx.x; i < a.t; i += THREADS) {
    double g[RMAX];
    a.g_of(i, g);
    const double va = __ldg(a.v + i);
    acc[0] += log(va);
#pragma unroll
    for (int k = 0; k < RMAX; ++k)
#pragma unroll
      for (int l = 0; l < RMAX; ++l) acc[1 + k * RMAX + l] += g[k] * va * g[l];
  }
  block_sum<K>(acc);
  if (threadIdx.x != 0) return;
  // past r, C is the identity: so is C^{-1}, and log|C| takes nothing
  constexpr int r = RMAX;
  double l[RMAX][RMAX] = {}, logdet = 0.0;
  for (int k = 0; k < r; ++k) {
    for (int j = 0; j <= k; ++j) {
      double sum = acc[1 + k * RMAX + j] + (j == k ? 1.0 : 0.0);
      for (int q = 0; q < j; ++q) sum -= l[k][q] * l[j][q];
      l[k][j] = j == k ? sqrt(sum) : sum / l[j][j];
    }
    logdet += 2.0 * log(l[k][k]);
  }
  // C^{-1} column by column: L L^T z = e_col
  for (int col = 0; col < r; ++col) {
    double z[RMAX];
    for (int k = 0; k < r; ++k) {
      double sum = k == col ? 1.0 : 0.0;
      for (int q = 0; q < k; ++q) sum -= l[k][q] * z[q];
      z[k] = sum / l[k][k];
    }
    for (int k = r - 1; k >= 0; --k) {
      double sum = z[k];
      for (int q = k + 1; q < r; ++q) sum -= l[q][k] * z[q];
      z[k] = sum / l[k][k];
    }
    for (int k = 0; k < r; ++k) a.s[S_CINV + k * RMAX + col] = z[k];
  }
  a.s[S_LOG_C] = logdet;
  a.s[S_LOG_V] = acc[0];
}

// (1c) A warp a row of R: dt_a and log|R_aa|.
__device__ void root_rows(const Args& a, int row) {
  const int lane = threadIdx.x & 31;
  double acc = 0.0;
  for (int b = lane; b <= row; b += 32) {
    const double x = __ldg(a.root + static_cast<long long>(row) * a.t + b);
    acc += x * x;
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    a.dt[row] = acc;
    a.logr[row] = log(fabs(static_cast<double>(__ldg(a.root + static_cast<long long>(row) * a.t + row))));
  }
}

// (1d) A tile of 32 columns b of R: P_b = sum_{a >= b} R_ab G_a.
__device__ void root_columns(const Args& a, int tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = tile * 32 + lane;
  double acc[RMAX] = {};
  for (int row = tile * 32 + warp; row < a.t; row += WARPS) {
    double g[RMAX];
    a.g_of(row, g);
    const double x = b <= row ? __ldg(a.root + static_cast<long long>(row) * a.t + b) : 0.0;
#pragma unroll
    for (int k = 0; k < RMAX; ++k) acc[k] += x * g[k];
  }
  column_sum<RMAX>(acc);
  if (warp == 0 && b < a.t) a.store(a.p, b, acc);
}

// (1e) A warp a row i of (n, T): DG_i and sum_a D_ia^2 / v_a.
__device__ void gap_rows(const Args& a, int i) {
  const int lane = threadIdx.x & 31;
  double acc[RMAX] = {}, q = 0.0;
  for (int col = lane; col < a.t; col += 32) {
    double g[RMAX];
    a.g_of(col, g);
    const double dd = a.gap(i, col);
    q += dd * dd / __ldg(a.v + col);
#pragma unroll
    for (int k = 0; k < RMAX; ++k) acc[k] += dd * g[k];
  }
  q = warp_sum(q);
#pragma unroll
  for (int k = 0; k < RMAX; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
    a.rowq[i] = q;
    a.store(a.dg, i, acc);
  }
}

__global__ void __launch_bounds__(THREADS) phase1(Args a) {
  int b = blockIdx.x;
  if (b == 0) return forward_scan(a);
  if (b == 1) return capacitance(a);
  b -= 2;
  if (b < a.rows_t) {
    const int row = b * WARPS + (threadIdx.x >> 5);
    if (row < a.t) root_rows(a, row);
    return;
  }
  b -= a.rows_t;
  if (b < a.cols_t) return root_columns(a, b);
  b -= a.cols_t;
  const int i = b * WARPS + (threadIdx.x >> 5);
  if (i < a.n) gap_rows(a, i);
}

// (2a) tau, trx, Q, sum_a log|R_aa| and GEG.
__device__ void task_scalars(const Args& a) {
  constexpr int K = 3 + 2 * RMAX * RMAX;
  double acc[K] = {};  // tau, Q, log R, sum_b P P^T, sum_i inv DG DG^T
  for (int b = threadIdx.x; b < a.t; b += THREADS) {
    double pb[RMAX], cp[RMAX];
    a.load(a.p, b, pb);
    a.cinv(pb, cp);
    acc[0] += a.dt[b] / __ldg(a.v + b) - dot(pb, cp);
    acc[2] += a.logr[b];
#pragma unroll
    for (int k = 0; k < RMAX; ++k)
#pragma unroll
      for (int l = 0; l < RMAX; ++l) acc[3 + k * RMAX + l] += pb[k] * pb[l];
  }
  for (int i = threadIdx.x; i < a.n; i += THREADS) {
    double di[RMAX], cd[RMAX];
    a.load(a.dg, i, di);
    a.cinv(di, cd);
    const double inv = a.inv(i);
    acc[1] += inv * (a.rowq[i] - dot(di, cd));
#pragma unroll
    for (int k = 0; k < RMAX; ++k)
#pragma unroll
      for (int l = 0; l < RMAX; ++l) acc[3 + RMAX * RMAX + k * RMAX + l] += inv * di[k] * di[l];
  }
  block_sum<K>(acc);
  if (threadIdx.x != 0) return;
  const double vol = a.vol0(), trx = a.s[S_SUM_T] / vol;
  a.s[S_TAU] = acc[0];
  a.s[S_Q] = acc[1];
  a.s[S_LOG_R] = acc[2];
  a.s[S_TRX] = trx;
  for (int k = 0; k < RMAX * RMAX; ++k)
    a.s[S_GEG + k] = trx * acc[3 + k] + acc[3 + RMAX * RMAX + k] / vol;
}

// C^{-1} DG_i, and inv_i / vol (0 past the last row)
__device__ double eta_of(const Args& a, int i, double cd[RMAX]) {
  if (i >= a.n) return 0.0;
  double di[RMAX];
  a.load(a.dg, i, di);
  a.cinv(di, cd);
  return a.inv(i) / a.vol0();
}

// (2b) A warp a row i of (n, T): the ELL's terms, sum_a gell_ia dt_a and,
// with the gradient, d/dM (and d/dc from row 0).
__device__ void ell_rows(const Args& a, int i, double scale) {
  const int lane = threadIdx.x & 31;
  const double sx = a.sx[i];
  const bool grad = a.grad();
  double cd[RMAX] = {}, cd_next[RMAX] = {}, w_i = 0.0, w_next = 0.0;
  if (grad) {
    w_i = eta_of(a, i, cd);
    w_next = eta_of(a, i + 1, cd_next);
  }
  double ell = 0.0, gs = 0.0;
  for (int col = lane; col < a.t; col += 32) {
    const long long at = static_cast<long long>(i) * a.t + col;
    const double dta = a.dt[col];
    const double mv = __ldg(a.m + at), yv = __ldg(a.y + at);
    const double u = 2.0 * sx * dta - 2.0 * mv;
    const double w = exp(u > CAP ? CAP : u);  // NaN passes
    const double yw = u <= CAP ? yv * yv * w : 0.0;
    ell += -0.5 * yv * yv * w - mv - HALF_LOG_2PI;
    gs -= yw * dta;
    if (grad) {
      double g[RMAX];
      a.g_of(col, g);
      const double va = __ldg(a.v + col);
      const double eta = w_i * (a.gap(i, col) / va - dot(g, cd));
      const double eta_next =
          i + 1 < a.n ? w_next * (a.gap(i + 1, col) / va - dot(g, cd_next)) : 0.0;
      a.g_m[at] = static_cast<float>((yw - 1.0 + eta - eta_next) * scale);
      if (i == 0) a.g_c[col] = static_cast<float>(-eta * scale);
    }
  }
  ell = warp_sum(ell);
  gs = warp_sum(gs);
  if (lane == 0) {
    a.ell[i] = ell;
    a.gsx[i] = gs;
  }
}

// (2c) A tile of 32 columns a of (n, T): sum_i gell_ia sx_i, sum_i inv_i
// D_ia^2 and sum_i inv_i D_ia DG_i.
__device__ void ell_columns(const Args& a, int tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = tile * 32 + lane;
  constexpr int K = 2 + RMAX;
  double acc[K] = {};
  if (col < a.t) {
    const double dta = a.dt[col];
    for (int i = warp; i < a.n; i += WARPS) {
      const long long at = static_cast<long long>(i) * a.t + col;
      const double sx = a.sx[i], inv = a.inv(i);
      const double mv = __ldg(a.m + at), yv = __ldg(a.y + at);
      const double u = 2.0 * sx * dta - 2.0 * mv;
      const double yw = u <= CAP ? yv * yv * exp(u) : 0.0;
      const double dd = a.gap(i, col);
      acc[0] -= yw * sx;
      acc[1] += inv * dd * dd;
      double di[RMAX];
      a.load(a.dg, i, di);
#pragma unroll
      for (int k = 0; k < RMAX; ++k) acc[2 + k] += inv * dd * di[k];
    }
  }
  column_sum<K>(acc);
  if (warp == 0 && col < a.t) {
    a.gdt[col] = acc[0];
    a.sd2[col] = acc[1];
    a.store(a.ddg, col, acc + 2);
  }
}

// (2d) A warp a row of R: R P.
__device__ void root_rows_p(const Args& a, int row) {
  const int lane = threadIdx.x & 31;
  double acc[RMAX] = {};
  for (int b = lane; b <= row; b += 32) {
    const double x = __ldg(a.root + static_cast<long long>(row) * a.t + b);
    double pb[RMAX];
    a.load(a.p, b, pb);
#pragma unroll
    for (int k = 0; k < RMAX; ++k) acc[k] += x * pb[k];
  }
#pragma unroll
  for (int k = 0; k < RMAX; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) a.store(a.rp, row, acc);
}

__global__ void __launch_bounds__(THREADS) phase2(Args a) {
  const double scale = 1.0 / (static_cast<double>(a.n) * a.t);
  int b = blockIdx.x;
  if (b == 0) return task_scalars(a);
  b -= 1;
  if (b < a.rows_n) {
    const int i = b * WARPS + (threadIdx.x >> 5);
    if (i < a.n) ell_rows(a, i, scale);
    return;
  }
  b -= a.rows_n;
  if (b < a.cols_t) return ell_columns(a, b);
  b -= a.cols_t;
  const int row = b * WARPS + (threadIdx.x >> 5);
  if (row < a.t) root_rows_p(a, row);
}

// (3a) The adjoint scan from the start: d/dq_log_d, d/de and the floor's
// vol terms; then the ELBO and d/dvol.
__device__ void adjoint_scan(const Args& a, double scale) {
  __shared__ Affine totals[WARPS];
  const double vol = a.vol0(), tau = a.s[S_TAU];
  const int n = a.n, t = a.t;
  int lo, hi;
  chunk(n, lo, hi);
  // the direct d/dsx_j, and the map lam_{j-1} -> lam_j
  auto step = [&](int j) {
    const double rp = a.rr(j - 1), inv = a.inv(j);
    return Affine{rp * rp, a.gsx[j] - tau * (0.5 * (inv + a.inv(j + 1)) + rp * inv) / vol};
  };
  double sums[2] = {0.0, 0.0};  // the ELL, the floor's terms
  for (int j = lo; j < hi; ++j) sums[0] += a.ell[j];
  if (a.grad()) {
    Affine lm = Affine::identity();
    for (int j = lo; j < hi; ++j) lm = step(j).after(lm);
    double lam = volt::exclusive_scan<WARPS>(lm, false, totals).b;
    for (int j = lo; j < hi; ++j) {
      const Affine st = step(j);
      lam = st.a * lam + st.b;
      const double rj = a.rr(j), rp = a.rr(j - 1), id = a.inv_d(j);
      const double inv = a.inv(j), inv_next = a.inv(j + 1);
      const double sx = a.sx[j], sx_after = j + 1 < n ? a.sx[j + 1] : 0.0;
      const double gr = sx_after * (2.0 * rj * lam - tau * inv_next / vol);
      a.g_ld[j] = static_cast<float>((-2.0 * id * id * lam - rj * gr - t) * scale);
      if (j < n - 1) a.g_e[j] = static_cast<float>(gr * id * scale);
      const double share = a.floor_share(j);
      if (share != 0.0) {
        double di[RMAX], cd[RMAX];
        a.load(a.dg, j, di);
        a.cinv(di, cd);
        const double qq = a.rowq[j] - dot(di, cd);
        const double before = j > 0 ? a.sx[j - 1] + 2.0 * rp * sx : 0.0;
        sums[1] += share * 0.5 * (t * inv - inv * inv * (tau * (sx + before) + qq) / vol);
      }
    }
  }
  block_sum<2>(sums);
  if (threadIdx.x != 0) return;
  const double *s = a.s, nt = static_cast<double>(n) * t;
  const double kl = 0.5 * (tau * s[S_TRX] + s[S_Q] / vol - nt
                           + t * (n * log(vol) + s[S_LOG_DX]) + n * (s[S_LOG_V] + s[S_LOG_C])
                           + 2.0 * t * s[S_LD] - 2.0 * n * s[S_LOG_R]);
  a.elbo[0] = static_cast<float>((sums[0] - kl) * scale);
  if (a.grad()) {
    const double g = ((tau * s[S_SUM_T] + s[S_Q]) / vol - nt) / (2.0 * vol)
                     + a.jit() / vol * sums[1];
    a.g_vol[0] = static_cast<float>(g * scale);
  }
}

// (3b) A warp a row of R: d/dR.
__device__ void root_grad_rows(const Args& a, int row, double scale) {
  const int lane = threadIdx.x & 31;
  double g[RMAX], cg[RMAX];
  a.g_of(row, g);
  a.cinv(g, cg);
  const double trx = a.s[S_TRX], gdt = a.gdt[row], va = __ldg(a.v + row);
  const long long base = static_cast<long long>(row) * a.t;
  for (int b = lane; b < a.t; b += 32) {
    double out = 0.0;
    if (b <= row) {
      const double x = __ldg(a.root + base + b);
      double pb[RMAX];
      a.load(a.p, b, pb);
      out = 2.0 * x * gdt - trx * (x / va - dot(cg, pb));
      if (b == row) out += a.n / x;
    }
    a.g_root[base + b] = static_cast<float>(out * scale);
  }
}

// (3c) A thread a task: d/dF_a and d/dv_a.
__device__ void task_grad(const Args& a, int col, double scale) {
  const double vol = a.vol0(), trx = a.s[S_TRX], va = __ldg(a.v + col);
  double g[RMAX], cg[RMAX], rp[RMAX], ddg[RMAX], eg[RMAX], ceg[RMAX], gcg[RMAX], cgcg[RMAX];
  a.g_of(col, g);
  a.cinv(g, cg);
  a.load(a.rp, col, rp);
  a.load(a.ddg, col, ddg);
#pragma unroll
  for (int k = 0; k < RMAX; ++k) eg[k] = trx * rp[k] + ddg[k] / vol;
  a.cinv(eg, ceg);
#pragma unroll
  for (int k = 0; k < RMAX; ++k) {
    gcg[k] = 0.0;
#pragma unroll
    for (int l = 0; l < RMAX; ++l) gcg[k] += a.s[S_GEG + k * RMAX + l] * cg[l];
  }
  a.cinv(gcg, cgcg);
#pragma unroll
  for (int k = 0; k < RMAX; ++k)
    if (k < a.r)
      a.g_f[col * a.r + k] = static_cast<float>((-a.n * cg[k] + ceg[k] / va - cgcg[k]) * scale);
  const double eaa = trx * a.dt[col] + a.sd2[col] / vol;
  const double aea = eaa / (va * va) - 2.0 * dot(cg, eg) / va + dot(cg, gcg);
  a.g_v[col] = static_cast<float>(-0.5 * (a.n * (1.0 / va - dot(g, cg)) - aea) * scale);
}

__global__ void __launch_bounds__(THREADS) phase3(Args a) {
  const double scale = 1.0 / (static_cast<double>(a.n) * a.t);
  int b = blockIdx.x;
  if (b == 0) return adjoint_scan(a, scale);
  b -= 1;
  if (b < a.rows_t) {
    const int row = b * WARPS + (threadIdx.x >> 5);
    if (row < a.t) root_grad_rows(a, row, scale);
    return;
  }
  b -= a.rows_t;
  const int col = b * THREADS + threadIdx.x;
  if (col < a.t) task_grad(a, col, scale);
}

int blocks(int count, int per) { return (count + per - 1) / per; }

// The float64 workspace's length, in doubles.
long long workspace_len(int n, int t, int r) {
  return static_cast<long long>(n) * (4 + r) + static_cast<long long>(t) * (4 + 3 * r) + WS_SCALARS;
}

}  // namespace

// The float64 workspace's length in doubles: the wrapper allocates it, and
// only this file knows its layout.
extern "C" long long volt_mt_gpcv_workspace_len(int n, int t, int r) {
  return workspace_len(n, t, r);
}

// x (n,); y, m (n, t); q_log_d (n,); q_e (n - 1,); root (t, t); c, v (t,);
// f (t, r), 1 <= r <= 4; vol (1,).  Writes the ELBO (a scalar) and, when
// g_m is not null, its gradients g_m (n, t), g_ld (n,), g_e (n - 1,),
// g_root (t, t) (0 above the diagonal), g_c, g_v (t,), g_f (t, r), g_vol
// (1,), through the float64 workspace ws of ws_len doubles, at least
// volt_mt_gpcv_workspace_len(n, t, r).
extern "C" int volt_mt_gpcv_tridiag_elbo(
    const float* x, const float* y, const float* m, const float* q_log_d, const float* q_e,
    const float* root, const float* c, const float* f, const float* v, const float* vol,
    float* elbo, float* g_m, float* g_ld, float* g_e, float* g_root, float* g_c, float* g_f,
    float* g_v, float* g_vol, double* ws, long long ws_len, int n, int t, int r,
    cudaStream_t stream) {
  if (n < 1 || t < 1 || r < 1 || r > RMAX || ws_len < workspace_len(n, t, r))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, y, m, q_log_d, q_e, root, c, f, v, vol, elbo, g_m, g_ld, g_e, g_root, g_c, g_f,
         g_v, g_vol};
  double* w = ws;
  auto take = [&](long long len) {
    double* out = w;
    w += len;
    return out;
  };
  a.sx = take(n);
  a.gsx = take(n);
  a.ell = take(n);
  a.rowq = take(n);
  a.dg = take(static_cast<long long>(n) * r);
  a.dt = take(t);
  a.logr = take(t);
  a.gdt = take(t);
  a.sd2 = take(t);
  a.p = take(static_cast<long long>(t) * r);
  a.rp = take(static_cast<long long>(t) * r);
  a.ddg = take(static_cast<long long>(t) * r);
  a.s = take(S_COUNT);
  a.n = n;
  a.t = t;
  a.r = r;
  a.rows_n = blocks(n, WARPS);
  a.rows_t = blocks(t, WARPS);
  a.cols_t = blocks(t, 32);
  const bool grad = g_m != nullptr;
  phase1<<<2 + a.rows_t + a.cols_t + a.rows_n, THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  phase2<<<1 + a.rows_n + (grad ? a.cols_t + a.rows_t : 0), THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  phase3<<<1 + (grad ? a.rows_t + blocks(t, THREADS) : 0), THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

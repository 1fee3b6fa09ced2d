// G4: the multitask vol GP's spectral Woodbury MLL and its gradient, in two
// C calls a step around one LU of the T x T coupling: eight launches of its
// own, no library call inside and no wait for the host.
//
// Replaces no TPU kernel: the JAX package leaves this MLL to XLA
// (`volt_tpu/gp/kronecker.py`, kron_mvn_log_prob_blockdiag_lowrank).  The
// port's plain composition (`models/multitask.py` MultitaskBMGP.mll_spectral,
// `gp/kronecker.py`) runs a batched r x r Cholesky whose jitter ladder waits
// for the card, eight batched triangular solves of 1 x 1 matrices, two LUs of
// the same T x T matrix (a solve whose error check waits, and a slogdet) and
// autograd's reverse of all of it: about 300 kernel launches a step, whose
// host work and two waits set the stage's time.
//
// The model, as `ops/mt_vol_mll.py` states it (its mt_vol_mll_reference is
// this file's computation in plain PyTorch, phase by phase): the spectral
// cache p_y (N, T), p_x, mu, w (N,), dx, x0; the parameters vol, the task
// factor F (T, r), its diagonal v (T,) and the noise s.  With
// ld_i = vol dx mu_i, c = vol (x0 - dx), K = F F^T + diag(v),
// diag_b = diag(K), r_i = p_y_i + vol^2 p_x_i diag_b / 2,
// d_it = ld_i v_t + s, G_i = D_i^{-1} F (T x r), M_i = I + ld_i F^T G_i:
//
//   B_i^{-1} = D_i^{-1} - ld_i G_i M_i^{-1} G_i^T          (Woodbury)
//   z_i      = B_i^{-1} r_i,  v = sum_i w_i z_i,  S = sum_i w_i^2 B_i^{-1}
//   m        = I + S c K,  W = m^{-1} c K,  g = W v,  a = v - S g
//   Phi      = sum_i (r_i^T z_i + log|B_i|) + log|m| - v^T g + N T log(2 pi)
//
// and the MLL is -Phi / (2 N T).  Phi's gradient, by d/dSigma = Sigma^{-1} -
// alpha alpha^T for Sigma = blockdiag(B_i) + c (w w^T) (x) K:
//
//   alpha_i  = z_i - w_i B_i^{-1} g
//   d/dB_i   = B_i^{-1} - alpha_i alpha_i^T - w_i^2 B_i^{-1} W B_i^{-1}
//   d/d(cK)  = m^{-1} S - a a^T
//   d/dld_i  = tr(d/dB_i K),  d/ds = sum_i tr(d/dB_i),  d/dc = tr(d/d(cK) K)
//   d/dK     = sum_i ld_i d/dB_i + c d/d(cK) + diag(vol^2 sum_i alpha_i p_x_i)
//   d/dF     = 2 d/dK F,  d/dv = diag(d/dK)
//   d/dvol   = sum_i dx mu_i d/dld_i + (x0 - dx) d/dc
//              + 2 vol sum_i p_x_i alpha_i^T diag_b
//
// Each block's d/dB_i enters only through its diagonal and its product with
// F, which take B_i^{-1} F = G_i M_i^{-1} and, with Y_i = W G_i (one product
// for all blocks) and Phi_i = G_i^T Y_i, B_i^{-1} W B_i^{-1} F = (D_i^{-1}
// Y_i - ld_i G_i M_i^{-1} Phi_i) M_i^{-1}.  M_i >= I, so its Cholesky needs no
// jitter.
//
// Design.  The first C call (volt_mt_vol_woodbury_blocks), three launches:
//   (A1) a warp a row i: M_i, its Cholesky, M_i^{-1}, log|M_i|, M_i^{-1}
//        F^T D_i^{-1} r_i, r_i^T z_i and log|B_i|; it writes G_i^T and
//        w_i^2 ld_i (G_i M_i^{-1})^T (N, r, T) for the product that forms S;
//        more blocks write [c K | 0] and m = I;
//   (A2) tiles of 32 columns by chunks of rows: partial sums of v and of
//        S's diagonal;
//   (A3) a thread a column: the chunks' sums, S's diagonal into its place.
// Between the calls, plain PyTorch on the card (`ops/mt_vol_mll._coupling`):
// S -= sum_i w_i^2 ld_i G_i M_i^{-1} G_i^T and m += S (c K), two products;
// one LU of m (cuSOLVER's getrf); [W | m^{-1} S] by one solve on it; Y by one
// product.  The second C call (volt_mt_vol_woodbury_mll), five launches:
//   (B1) a warp a row of W: g;
//   (B2) a warp a row: a, (m^{-1} S)'s diagonal, its symmetric part times F,
//        tr(K m^{-1} S)'s row, log|m|'s term from the LU's diagonal;
//   (B3) a warp a row i: G_i^T g and Phi_i, then d/dB_i's trace, tr(d/dB_i
//        K) and alpha_i^T diag_b; one more block sums over the tasks;
//   (B4) tiles of 32 columns by chunks of rows: partial sums over i of
//        ld_i d/dB_i's diagonal and its product with F, and alpha_i p_x_i;
//   (B5) a thread a task: d/dF and d/dv; one more block: the MLL, d/dvol and
//        d/ds.
// B3 and B4 compute each (i, t) cell alike (`cell`); nothing is atomic, so
// a result is the same from run to run.
//
// Precision: float32 in and out, float64 inside; the coupling's products,
// LU and solve are float32, as the plain path's.
//
// What bounds it on the card: reading p_y and writing G^T, w^2 ld G M^{-1}
// and the outputs is 6.1 MB at (N, T, r) = (999, 505, 1), 1.8 us at 3.35
// TB/s; the coupling's three products and its solve of 2T columns are 4 N r
// T^2 + 6 T^3 operations, 1.79 GFLOP of float32 (27 us at 67 TFLOP/s), and
// the LU 2 T^3 / 3, 0.09 GFLOP, whose time on this card is latency: its
// panels run one after another.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RMAX = 4;     // the largest rank of F taken
constexpr int CHUNKS = 16;  // row chunks of the column passes
constexpr unsigned FULL = 0xffffffffu;
constexpr double LOG_2PI = 1.8378770664093453;

// The scalars of the workspace, after its arrays.
constexpr int WS_SCALARS = 32;
enum Scalar {
  S_AF,  // F^T a, RMAX
  S_AKA = S_AF + RMAX,
  S_TRK,  // tr(K m^{-1} S)
  S_VG,   // v^T g
  S_LUM,  // log|m|
  S_COUNT,
};
static_assert(S_COUNT <= WS_SCALARS, "the workspace's scalars");

template <int K>
__device__ void warp_sum(double v[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(FULL, v[k], off);
}

// The block's sums of the K values `v`, in thread 0.
template <int K>
__device__ void block_sum(double v[K]) {
  __shared__ double partial[WARPS][K];
  warp_sum<K>(v);
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

// A tile of 32 columns' sums of K values a lane over the block's warps, in
// warp 0.
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

__device__ double dot(const double a[RMAX], const double b[RMAX]) {
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < RMAX; ++k) acc += a[k] * b[k];
  return acc;
}

// out_k = sum_l x_l mat[l][k]
__device__ void vec_mat(const double x[RMAX], const double mat[RMAX][RMAX], double out[RMAX]) {
#pragma unroll
  for (int k = 0; k < RMAX; ++k) {
    out[k] = 0.0;
#pragma unroll
    for (int l = 0; l < RMAX; ++l) out[k] += x[l] * mat[l][k];
  }
}

// The row `i`'s per-row values, padded past r: M_i^{-1} and M_i^{-1} Phi_i
// M_i^{-1} with the identity and zeros, the vectors with zeros.
struct Row {
  double ld, w, px, minv[RMAX][RMAX], sol[RMAX], mg[RMAX], mpm[RMAX][RMAX];
};

struct Args {
  // inputs
  const float *p_y, *p_x, *mu, *w, *dx, *x0, *vol, *f, *v, *s;
  // the first call's outputs: G^T, w^2 ld (G M^{-1})^T (n, r, t); [c K | S]
  // (t, 2t); m (t, t)
  float *gm, *jm, *bmat, *m;
  // the second call's: the LU (its diagonal's stride), [W | m^{-1} S] (by
  // strides), Y (n r, t)
  const float* lu;
  int lu_diag;
  const float* sol;
  int s0, s1;
  const float* y0;
  float *out, *g_vol, *g_f, *g_v, *g_s;
  // the float64 workspace: per row minv, mpm (n r^2), rsol, mg (n r), rowa
  // (n 2), rowb (n 3); per task vv, g, a, msd, trk, vg, lum (t), msf (t r);
  // the chunks' partial sums cola (CHUNKS t 2), colb (CHUNKS t (2 + r));
  // then the S_COUNT scalars
  double *minv, *mpm, *rsol, *mg, *rowa, *rowb, *vv, *g, *a, *msd, *trk, *vg, *lum, *msf,
      *cola, *colb, *sc;
  int n, t, r;
  int rows_n, rows_t, cols_t;

  __device__ double vol0() const { return __ldg(vol); }
  __device__ double noise() const { return __ldg(s); }
  __device__ double c() const {
    return vol0() * (static_cast<double>(__ldg(x0)) - static_cast<double>(__ldg(dx)));
  }
  __device__ double ld(int i) const {
    return vol0() * static_cast<double>(__ldg(dx)) * static_cast<double>(__ldg(mu + i));
  }
  // F's row `tt`, 0 past r
  __device__ void f_row(int tt, double out[RMAX]) const {
#pragma unroll
    for (int k = 0; k < RMAX; ++k) out[k] = k < r ? __ldg(f + tt * r + k) : 0.0;
  }
  __device__ float w_at(int row, int col) const {  // W = m^{-1} c K
    return sol[static_cast<long long>(row) * s0 + static_cast<long long>(col) * s1];
  }
  __device__ float ms_at(int row, int col) const {  // m^{-1} S
    return sol[static_cast<long long>(row) * s0 + static_cast<long long>(t + col) * s1];
  }
  __device__ double k_at(int row, int col) const {
    double fr[RMAX], fc[RMAX];
    f_row(row, fr);
    f_row(col, fc);
    return dot(fr, fc) + (row == col ? static_cast<double>(__ldg(v + row)) : 0.0);
  }
  // an r x r array of row `i` (padded with `pad` on the diagonal)
  __device__ void load_mat(const double* arr, int i, double out[RMAX][RMAX], double pad) const {
#pragma unroll
    for (int k = 0; k < RMAX; ++k)
#pragma unroll
      for (int l = 0; l < RMAX; ++l)
        out[k][l] = (k < r && l < r) ? arr[(static_cast<long long>(i) * r + k) * r + l]
                                     : (k == l ? pad : 0.0);
  }
  __device__ void store_mat(double* arr, int i, const double in[RMAX][RMAX]) const {
#pragma unroll
    for (int k = 0; k < RMAX; ++k)
#pragma unroll
      for (int l = 0; l < RMAX; ++l)
        if (k < r && l < r) arr[(static_cast<long long>(i) * r + k) * r + l] = in[k][l];
  }
  __device__ void load_vec(const double* arr, int i, double out[RMAX]) const {
#pragma unroll
    for (int k = 0; k < RMAX; ++k) out[k] = k < r ? arr[static_cast<long long>(i) * r + k] : 0.0;
  }
  __device__ void store_vec(double* arr, int i, const double in[RMAX]) const {
#pragma unroll
    for (int k = 0; k < RMAX; ++k)
      if (k < r) arr[static_cast<long long>(i) * r + k] = in[k];
  }
  __device__ void load_row(int i, Row& q) const {
    q.ld = ld(i);
    q.w = __ldg(w + i);
    q.px = __ldg(p_x + i);
    load_mat(minv, i, q.minv, 1.0);
    load_mat(mpm, i, q.mpm, 0.0);
    load_vec(rsol, i, q.sol);
    load_vec(mg, i, q.mg);
  }
  // diag_b_tt and r_i at tt
  __device__ double r_at(const Row& q, int i, int tt, const double fr[RMAX], double& db) const {
    const double vol = vol0();
    db = dot(fr, fr) + static_cast<double>(__ldg(v + tt));
    return static_cast<double>(__ldg(p_y + static_cast<long long>(i) * t + tt))
           + 0.5 * vol * vol * q.px * db;
  }
};

// The capacitance M = I + ld fdf (fdf's lower triangle; the identity past
// r): its inverse and log|M| by its Cholesky factor.
__device__ void cap_inverse(const double fdf[RMAX][RMAX], double ld, int r,
                            double minv[RMAX][RMAX], double& logdet) {
  double l[RMAX][RMAX] = {};
  logdet = 0.0;
#pragma unroll
  for (int k = 0; k < RMAX; ++k) {
#pragma unroll
    for (int j = 0; j <= k; ++j) {
      double sum = (k < r && j < r ? ld * fdf[k][j] : 0.0) + (j == k ? 1.0 : 0.0);
#pragma unroll
      for (int q = 0; q < j; ++q) sum -= l[k][q] * l[j][q];
      l[k][j] = j == k ? sqrt(sum) : sum / l[j][j];
    }
    logdet += 2.0 * log(l[k][k]);
  }
  // M^{-1} column by column: L L^T z = e_col
#pragma unroll
  for (int col = 0; col < RMAX; ++col) {
    double z[RMAX];
#pragma unroll
    for (int k = 0; k < RMAX; ++k) {
      double sum = k == col ? 1.0 : 0.0;
#pragma unroll
      for (int q = 0; q < k; ++q) sum -= l[k][q] * z[q];
      z[k] = sum / l[k][k];
    }
#pragma unroll
    for (int k = RMAX - 1; k >= 0; --k) {
      double sum = z[k];
#pragma unroll
      for (int q = k + 1; q < RMAX; ++q) sum -= l[q][k] * z[q];
      z[k] = sum / l[k][k];
    }
#pragma unroll
    for (int k = 0; k < RMAX; ++k) minv[k][col] = z[k];
  }
}

// (A1) A warp a row: the capacitance and the row's terms; G^T and w^2 ld (G
// M^{-1})^T.
__device__ void block_row(const Args& a, int i) {
  const int lane = threadIdx.x & 31;
  const double ld = a.ld(i), s = a.noise(), w = __ldg(a.w + i);
  const double half_v2px = 0.5 * a.vol0() * a.vol0() * __ldg(a.p_x + i);
  // fdf's lower triangle, F^T D^{-1} r, sum log d, sum r^2 / d
  constexpr int K = RMAX * RMAX + RMAX + 2;
  double acc[K] = {};
  for (int tt = lane; tt < a.t; tt += 32) {
    double fr[RMAX];
    a.f_row(tt, fr);
    const double vt = __ldg(a.v + tt);
    const double rt = __ldg(a.p_y + static_cast<long long>(i) * a.t + tt)
                      + half_v2px * (dot(fr, fr) + vt);
    const double d = ld * vt + s, di = 1.0 / d;
#pragma unroll
    for (int k = 0; k < RMAX; ++k) {
#pragma unroll
      for (int l = 0; l <= k; ++l) acc[k * RMAX + l] += di * fr[k] * fr[l];
      acc[RMAX * RMAX + k] += fr[k] * di * rt;
    }
    acc[K - 2] += log(d);
    acc[K - 1] += di * rt * rt;
  }
  warp_sum<K>(acc);
  double fdf[RMAX][RMAX], minv[RMAX][RMAX], logm, sol[RMAX];
#pragma unroll
  for (int k = 0; k < RMAX; ++k)
#pragma unroll
    for (int l = 0; l < RMAX; ++l) fdf[k][l] = acc[k * RMAX + l];
  cap_inverse(fdf, ld, a.r, minv, logm);
  const double* fu = acc + RMAX * RMAX;
#pragma unroll
  for (int k = 0; k < RMAX; ++k) {
    sol[k] = 0.0;
#pragma unroll
    for (int l = 0; l < RMAX; ++l) sol[k] += minv[k][l] * fu[l];
  }
  if (lane == 0) {
    a.store_mat(a.minv, i, minv);
    a.store_vec(a.rsol, i, sol);
    a.rowa[2 * i] = acc[K - 1] - ld * dot(fu, sol);
    a.rowa[2 * i + 1] = acc[K - 2] + logm;
  }
  const double w2ld = w * w * ld;
  for (int tt = lane; tt < a.t; tt += 32) {
    double fr[RMAX], gk[RMAX], gmk[RMAX];
    a.f_row(tt, fr);
    const double di = 1.0 / (ld * __ldg(a.v + tt) + s);
#pragma unroll
    for (int k = 0; k < RMAX; ++k) gk[k] = di * fr[k];
    vec_mat(gk, minv, gmk);
#pragma unroll
    for (int k = 0; k < RMAX; ++k) {
      if (k < a.r) {
        const long long at = (static_cast<long long>(i) * a.r + k) * a.t + tt;
        a.gm[at] = static_cast<float>(gk[k]);
        a.jm[at] = static_cast<float>(w2ld * gmk[k]);
      }
    }
  }
}

// (A1) more blocks: [c K | 0] and m = I, a thread an entry.
__device__ void fill(const Args& a, int block, int blocks) {
  const double c = a.c();
  const long long tt2 = static_cast<long long>(a.t) * a.t;
  for (long long at = static_cast<long long>(block) * THREADS + threadIdx.x; at < tt2;
       at += static_cast<long long>(blocks) * THREADS) {
    const int row = static_cast<int>(at / a.t), col = static_cast<int>(at % a.t);
    const long long b = static_cast<long long>(row) * 2 * a.t + col;
    a.bmat[b] = static_cast<float>(c * a.k_at(row, col));
    a.bmat[b + a.t] = 0.0f;
    a.m[at] = row == col ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS) pass_a1(Args a, int fill_blocks) {
  const int b = blockIdx.x;
  if (b >= a.rows_n) return fill(a, b - a.rows_n, fill_blocks);
  const int row = b * WARPS + (threadIdx.x >> 5);
  if (row < a.n) block_row(a, row);
}

// the rows [lo, hi) of chunk `ch`
__device__ void chunk_rows(int n, int ch, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(n) * ch / CHUNKS);
  hi = static_cast<int>(static_cast<long long>(n) * (ch + 1) / CHUNKS);
}

// (A2) A tile of 32 columns over a chunk of rows: partial v and S's
// diagonal.
__global__ void __launch_bounds__(THREADS) pass_a2(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tt = blockIdx.x * 32 + lane, ch = blockIdx.y;
  int lo, hi;
  chunk_rows(a.n, ch, lo, hi);
  double acc[2] = {0.0, 0.0};
  if (tt < a.t) {
    double fr[RMAX];
    a.f_row(tt, fr);
    const double vt = __ldg(a.v + tt), s = a.noise();
    for (int i = lo + warp; i < hi; i += WARPS) {
      Row q;
      q.ld = a.ld(i);
      q.w = __ldg(a.w + i);
      q.px = __ldg(a.p_x + i);
      a.load_vec(a.rsol, i, q.sol);
      double db;
      const double rt = a.r_at(q, i, tt, fr, db);
      const double di = 1.0 / (q.ld * vt + s);
      const double z = di * rt - q.ld * di * dot(fr, q.sol);
      acc[0] += q.w * z;
      acc[1] += q.w * q.w * di;
    }
  }
  column_sum<2>(acc);
  if (warp == 0 && tt < a.t) {
    double* out = a.cola + (static_cast<long long>(ch) * a.t + tt) * 2;
    out[0] = acc[0];
    out[1] = acc[1];
  }
}

// (A3) A thread a column: v and S's diagonal from the chunks.
__global__ void __launch_bounds__(THREADS) pass_a3(Args a) {
  const int tt = blockIdx.x * THREADS + threadIdx.x;
  if (tt >= a.t) return;
  double vv = 0.0, sd = 0.0;
  for (int ch = 0; ch < CHUNKS; ++ch) {
    const double* in = a.cola + (static_cast<long long>(ch) * a.t + tt) * 2;
    vv += in[0];
    sd += in[1];
  }
  a.vv[tt] = vv;
  a.bmat[static_cast<long long>(tt) * 2 * a.t + a.t + tt] = static_cast<float>(sd);
}

// (B1) A warp a row of W: g = W v.
__global__ void __launch_bounds__(THREADS) pass_b1(Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.t) return;
  double acc[1] = {0.0};
  for (int u = lane; u < a.t; u += 32) acc[0] += static_cast<double>(a.w_at(row, u)) * a.vv[u];
  warp_sum<1>(acc);
  if (lane == 0) a.g[row] = acc[0];
}

// (B2) A warp a row: a = v - S g, the symmetric part of m^{-1} S times F,
// its diagonal, tr(K m^{-1} S)'s row, v g and log|LU's diagonal|.
__global__ void __launch_bounds__(THREADS) pass_b2(Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.t) return;
  constexpr int K = RMAX + 2;
  double acc[K] = {};
  const float* s_row = a.bmat + static_cast<long long>(row) * 2 * a.t + a.t;
  for (int u = lane; u < a.t; u += 32) {
    double fu[RMAX];
    a.f_row(u, fu);
    const double up = a.ms_at(row, u), down = a.ms_at(u, row);
    acc[0] += static_cast<double>(s_row[u]) * a.g[u];
#pragma unroll
    for (int k = 0; k < RMAX; ++k) acc[1 + k] += 0.5 * (up + down) * fu[k];
    acc[K - 1] += a.k_at(row, u) * down;
  }
  warp_sum<K>(acc);
  if (lane == 0) {
    const double vv = a.vv[row];
    a.a[row] = vv - acc[0];
    a.store_vec(a.msf, row, acc + 1);
    a.msd[row] = a.ms_at(row, row);
    a.trk[row] = acc[K - 1];
    a.vg[row] = vv * a.g[row];
    a.lum[row] = log(fabs(static_cast<double>(a.lu[static_cast<long long>(row) * a.lu_diag])));
  }
}

// One (i, tt) cell of d/dB_i: alpha_it, d/dB_i's diagonal `dbd` and its
// product with F `dbf` at tt; `y` is Y_i's row tt.
__device__ void cell(const Args& a, const Row& q, int i, int tt, const double fr[RMAX],
                     const double y[RMAX], double& alpha, double& dbd, double dbf[RMAX],
                     double& db) {
  const double vt = __ldg(a.v + tt), s = a.noise();
  const double rt = a.r_at(q, i, tt, fr, db);
  const double di = 1.0 / (q.ld * vt + s);
  const double z = di * rt - q.ld * di * dot(fr, q.sol);
  const double binv_g = di * a.g[tt] - q.ld * di * dot(fr, q.mg);
  alpha = z - q.w * binv_g;
  double gk[RMAX], gmk[RMAX], ymk[RMAX], gpk[RMAX];
#pragma unroll
  for (int k = 0; k < RMAX; ++k) gk[k] = di * fr[k];
  vec_mat(gk, q.minv, gmk);
  vec_mat(y, q.minv, ymk);
  vec_mat(gk, q.mpm, gpk);
  const double wtt = a.w_at(tt, tt);
  const double diag_binv = di - q.ld * dot(gk, gmk);
  const double diag_bwb = di * di * wtt - 2.0 * q.ld * di * dot(ymk, gk)
                          + q.ld * q.ld * dot(gpk, gk);
  const double w2 = q.w * q.w;
  dbd = diag_binv - alpha * alpha - w2 * diag_bwb;
#pragma unroll
  for (int k = 0; k < RMAX; ++k) {
    const double af = q.sol[k] - q.w * q.mg[k];
    dbf[k] = gmk[k] - alpha * af - w2 * (di * ymk[k] - q.ld * gpk[k]);
  }
}

// Y_i's row tt (0 past r)
__device__ void y_row(const Args& a, int i, int tt, double y[RMAX]) {
#pragma unroll
  for (int k = 0; k < RMAX; ++k)
    y[k] = k < a.r ? a.y0[(static_cast<long long>(i) * a.r + k) * a.t + tt] : 0.0;
}

// (B3) A warp a row: M^{-1} G^T g and M^{-1} Phi M^{-1}, then the row's sums
// of d/dB_i: its trace, tr(d/dB_i K) and alpha^T diag_b.
__device__ void grad_row(const Args& a, int i) {
  const int lane = threadIdx.x & 31;
  Row q;
  q.ld = a.ld(i);
  q.w = __ldg(a.w + i);
  q.px = __ldg(a.p_x + i);
  a.load_mat(a.minv, i, q.minv, 1.0);
  a.load_vec(a.rsol, i, q.sol);
  const double s = a.noise();
  constexpr int K = RMAX + RMAX * RMAX;
  double acc[K] = {};
  for (int tt = lane; tt < a.t; tt += 32) {
    double fr[RMAX], y[RMAX];
    a.f_row(tt, fr);
    y_row(a, i, tt, y);
    const double di = 1.0 / (q.ld * __ldg(a.v + tt) + s), gt = a.g[tt];
#pragma unroll
    for (int k = 0; k < RMAX; ++k) {
      acc[k] += di * fr[k] * gt;
#pragma unroll
      for (int l = 0; l < RMAX; ++l) acc[RMAX + k * RMAX + l] += di * fr[k] * y[l];
    }
  }
  warp_sum<K>(acc);
  double pm[RMAX][RMAX];
#pragma unroll
  for (int k = 0; k < RMAX; ++k) {
    q.mg[k] = 0.0;
#pragma unroll
    for (int l = 0; l < RMAX; ++l) {
      q.mg[k] += q.minv[k][l] * acc[l];
      pm[k][l] = 0.0;
#pragma unroll
      for (int j = 0; j < RMAX; ++j) pm[k][l] += acc[RMAX + k * RMAX + j] * q.minv[j][l];
    }
  }
#pragma unroll
  for (int k = 0; k < RMAX; ++k)
#pragma unroll
    for (int l = 0; l < RMAX; ++l) {
      q.mpm[k][l] = 0.0;
#pragma unroll
      for (int j = 0; j < RMAX; ++j) q.mpm[k][l] += q.minv[k][j] * pm[j][l];
    }
  if (lane == 0) {
    a.store_vec(a.mg, i, q.mg);
    a.store_mat(a.mpm, i, q.mpm);
  }
  double sums[3] = {0.0, 0.0, 0.0};
  for (int tt = lane; tt < a.t; tt += 32) {
    double fr[RMAX], y[RMAX], dbf[RMAX], alpha, dbd, db;
    a.f_row(tt, fr);
    y_row(a, i, tt, y);
    cell(a, q, i, tt, fr, y, alpha, dbd, dbf, db);
    sums[0] += dbd;
    sums[1] += dot(fr, dbf) + static_cast<double>(__ldg(a.v + tt)) * dbd;
    sums[2] += alpha * db;
  }
  warp_sum<3>(sums);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.rowb[3 * i + k] = sums[k];
  }
}

// (B3) one more block: F^T a, a^T K a and the sums over the tasks.
__device__ void task_sums(const Args& a) {
  constexpr int K = RMAX + 4;
  double acc[K] = {};
  for (int tt = threadIdx.x; tt < a.t; tt += THREADS) {
    double fr[RMAX];
    a.f_row(tt, fr);
    const double at = a.a[tt];
#pragma unroll
    for (int k = 0; k < RMAX; ++k) acc[k] += at * fr[k];
    acc[RMAX] += static_cast<double>(__ldg(a.v + tt)) * at * at;
    acc[RMAX + 1] += a.trk[tt];
    acc[RMAX + 2] += a.vg[tt];
    acc[RMAX + 3] += a.lum[tt];
  }
  block_sum<K>(acc);
  if (threadIdx.x == 0) {
    double aka = acc[RMAX];
#pragma unroll
    for (int k = 0; k < RMAX; ++k) {
      a.sc[S_AF + k] = acc[k];
      aka += acc[k] * acc[k];
    }
    a.sc[S_AKA] = aka;
    a.sc[S_TRK] = acc[RMAX + 1];
    a.sc[S_VG] = acc[RMAX + 2];
    a.sc[S_LUM] = acc[RMAX + 3];
  }
}

__global__ void __launch_bounds__(THREADS) pass_b3(Args a) {
  const int b = blockIdx.x;
  if (b == a.rows_n) return task_sums(a);
  const int row = b * WARPS + (threadIdx.x >> 5);
  if (row < a.n) grad_row(a, row);
}

// (B4) A tile of 32 columns over a chunk of rows: partial sums of ld_i
// d/dB_i's diagonal and its product with F, and of alpha_i p_x_i.
__global__ void __launch_bounds__(THREADS) pass_b4(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tt = blockIdx.x * 32 + lane, ch = blockIdx.y;
  int lo, hi;
  chunk_rows(a.n, ch, lo, hi);
  constexpr int K = RMAX + 2;
  double acc[K] = {};
  if (tt < a.t) {
    double fr[RMAX];
    a.f_row(tt, fr);
    for (int i = lo + warp; i < hi; i += WARPS) {
      Row q;
      a.load_row(i, q);
      double y[RMAX], dbf[RMAX], alpha, dbd, db;
      y_row(a, i, tt, y);
      cell(a, q, i, tt, fr, y, alpha, dbd, dbf, db);
      acc[0] += q.ld * dbd;
      acc[1] += alpha * q.px;
#pragma unroll
      for (int k = 0; k < RMAX; ++k) acc[2 + k] += q.ld * dbf[k];
    }
  }
  column_sum<K>(acc);
  if (warp == 0 && tt < a.t) {
    double* out = a.colb + (static_cast<long long>(ch) * a.t + tt) * (2 + a.r);
    out[0] = acc[0];
    out[1] = acc[1];
    for (int k = 0; k < a.r; ++k) out[2 + k] = acc[2 + k];
  }
}

// (B5) the last block: the MLL, d/dvol and d/ds.
__device__ void finish(const Args& a, double scale) {
  constexpr int K = 5;
  double acc[K] = {};
  const double dx = __ldg(a.dx);
  for (int i = threadIdx.x; i < a.n; i += THREADS) {
    acc[0] += a.rowa[2 * i];
    acc[1] += a.rowa[2 * i + 1];
    acc[2] += a.rowb[3 * i];
    acc[3] += a.rowb[3 * i + 1] * (dx * static_cast<double>(__ldg(a.mu + i)));
    acc[4] += a.rowb[3 * i + 2] * static_cast<double>(__ldg(a.p_x + i));
  }
  block_sum<K>(acc);
  if (threadIdx.x != 0) return;
  const double nt = static_cast<double>(a.n) * a.t, vol = a.vol0();
  const double phi = acc[0] + acc[1] + a.sc[S_LUM] - a.sc[S_VG] + nt * LOG_2PI;
  const double d_c = a.sc[S_TRK] - a.sc[S_AKA];
  const double d_vol = acc[3] + d_c * (static_cast<double>(__ldg(a.x0)) - dx) + 2.0 * vol * acc[4];
  a.out[0] = static_cast<float>(scale * phi);
  a.g_vol[0] = static_cast<float>(scale * d_vol);
  a.g_s[0] = static_cast<float>(scale * acc[2]);
}

// (B5) A thread a task: d/dF and d/dv from the chunks and the coupling.
__global__ void __launch_bounds__(THREADS) pass_b5(Args a) {
  const double scale = -0.5 / (static_cast<double>(a.n) * a.t);
  const int last = (a.t + THREADS - 1) / THREADS;
  if (static_cast<int>(blockIdx.x) == last) return finish(a, scale);
  const int tt = blockIdx.x * THREADS + threadIdx.x;
  if (tt >= a.t) return;
  double sums[2 + RMAX] = {};
  for (int ch = 0; ch < CHUNKS; ++ch) {
    const double* in = a.colb + (static_cast<long long>(ch) * a.t + tt) * (2 + a.r);
    sums[0] += in[0];
    sums[1] += in[1];
    for (int k = 0; k < a.r; ++k) sums[2 + k] += in[2 + k];
  }
  double fr[RMAX], msf[RMAX];
  a.f_row(tt, fr);
  a.load_vec(a.msf, tt, msf);
  const double c = a.c(), at = a.a[tt], vol = a.vol0();
  const double d_diag_b = vol * vol * sums[1];
  for (int k = 0; k < a.r; ++k) {
    const double kbf = sums[2 + k] + c * (msf[k] - at * a.sc[S_AF + k]) + d_diag_b * fr[k];
    a.g_f[tt * a.r + k] = static_cast<float>(scale * 2.0 * kbf);
  }
  const double kbd = sums[0] + c * (a.msd[tt] - at * at) + d_diag_b;
  a.g_v[tt] = static_cast<float>(scale * kbd);
}

int blocks(int count, int per) { return (count + per - 1) / per; }

// The float64 workspace's length, in doubles.
long long workspace_len(int n, int t, int r) {
  return static_cast<long long>(n) * (2 * r * r + 2 * r + 5) + static_cast<long long>(t) * (7 + r)
         + static_cast<long long>(CHUNKS) * t * (4 + r) + WS_SCALARS;
}

// Args with the workspace laid out; false if it is too short or a size is
// out of range.
bool layout(Args& a, double* ws, long long ws_len, int n, int t, int r) {
  if (n < 1 || t < 1 || r < 1 || r > RMAX || ws_len < workspace_len(n, t, r)) return false;
  double* p = ws;
  auto take = [&](long long len) {
    double* out = p;
    p += len;
    return out;
  };
  const long long nr = static_cast<long long>(n) * r;
  a.minv = take(nr * r);
  a.mpm = take(nr * r);
  a.rsol = take(nr);
  a.mg = take(nr);
  a.rowa = take(2LL * n);
  a.rowb = take(3LL * n);
  a.vv = take(t);
  a.g = take(t);
  a.a = take(t);
  a.msd = take(t);
  a.trk = take(t);
  a.vg = take(t);
  a.lum = take(t);
  a.msf = take(static_cast<long long>(t) * r);
  a.cola = take(static_cast<long long>(CHUNKS) * t * 2);
  a.colb = take(static_cast<long long>(CHUNKS) * t * (2 + r));
  a.sc = take(WS_SCALARS);
  a.n = n;
  a.t = t;
  a.r = r;
  a.rows_n = blocks(n, WARPS);
  a.rows_t = blocks(t, WARPS);
  a.cols_t = blocks(t, 32);
  return true;
}

}  // namespace

// The float64 workspace's length in doubles that both calls take: the
// wrapper allocates it, and only this file knows its layout.
extern "C" long long volt_mt_vol_woodbury_workspace_len(int n, int t, int r) {
  return workspace_len(n, t, r);
}

// The first call: p_y (n, t); p_x, mu, w (n,); dx, x0, vol, s one value;
// f (t, r), 1 <= r <= 4; v (t,).  Writes gm, jm (n, r, t), bmat (t, 2t) =
// [c K | diag(S)] and m (t, t) = I, and the rows' values into the float64
// workspace ws of ws_len doubles, at least
// volt_mt_vol_woodbury_workspace_len(n, t, r).
extern "C" int volt_mt_vol_woodbury_blocks(
    const float* p_y, const float* p_x, const float* mu, const float* w, const float* dx,
    const float* x0, const float* vol, const float* f, const float* v, const float* s,
    float* gm, float* jm, float* bmat, float* m, double* ws, long long ws_len, int n, int t,
    int r, cudaStream_t stream) {
  Args a{p_y, p_x, mu, w, dx, x0, vol, f, v, s, gm, jm, bmat, m};
  if (!layout(a, ws, ws_len, n, t, r)) return static_cast<int>(cudaErrorInvalidValue);
  int fill_blocks = blocks(t * t, THREADS);
  if (fill_blocks > 256) fill_blocks = 256;
  pass_a1<<<a.rows_n + fill_blocks, THREADS, 0, stream>>>(a, fill_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pass_a2<<<dim3(a.cols_t, CHUNKS), THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pass_a3<<<blocks(t, THREADS), THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The second call, after the coupling: the inputs as above, bmat = [c K |
// S], the LU of m = I + S c K (lu_diag the stride of its diagonal), sol =
// [W | m^{-1} S] (t, 2t) by its strides s0, s1, y0 = (W G_i)^T (n r, t), and
// the workspace as the first call left it.  Writes the MLL / (n t) into out
// (one value) and its gradients g_vol, g_s (one value), g_f (t, r), g_v (t,).
extern "C" int volt_mt_vol_woodbury_mll(
    const float* p_y, const float* p_x, const float* mu, const float* w, const float* dx,
    const float* x0, const float* vol, const float* f, const float* v, const float* s,
    const float* bmat, const float* lu, int lu_diag, const float* sol, int s0, int s1,
    const float* y0, float* out, float* g_vol, float* g_f, float* g_v, float* g_s, double* ws,
    long long ws_len, int n, int t, int r, cudaStream_t stream) {
  Args a{p_y, p_x, mu, w, dx, x0, vol, f, v, s, nullptr, nullptr, const_cast<float*>(bmat),
         nullptr, lu, lu_diag, sol, s0, s1, y0, out, g_vol, g_f, g_v, g_s};
  if (!layout(a, ws, ws_len, n, t, r)) return static_cast<int>(cudaErrorInvalidValue);
  pass_b1<<<a.rows_t, THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pass_b2<<<a.rows_t, THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pass_b3<<<a.rows_n + 1, THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pass_b4<<<dim3(a.cols_t, CHUNKS), THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pass_b5<<<blocks(t, THREADS) + 1, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

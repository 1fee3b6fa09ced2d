// G2: the per-asset spectral MLL of the BM vol GP and its gradient with
// respect to vol and the noise, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves `BMGP.mll_spectral` to
// XLA, which fuses its elementwise work and its row sums.  The port's plain
// composition (`models/bmgp.py` `BMGP.mll_spectral`) is about twenty
// elementwise operations and four row sums over (assets, n), and autograd's
// reverse of them: some 90 kernel launches a vol Adam step for two scalars
// an asset, whose host work set the vol stage's time.  In the eigenbasis of
// the min-matrix, K + s I = diag(d) + a w w^T with
//
//   d_k = vol dx mu_k + s,  a = vol (x0 - dx),  r_k = p_y,k + vol^2 p_t,k / 2
//   A = sum_k w_k^2 / d_k,  B = sum_k w_k r_k / d_k,  C = sum_k r_k^2 / d_k
//   S = 1 + a A,  q = C - a B^2 / S                  (Sherman-Morrison)
//   mll = -(q + sum_k log d_k + log S + n log(2 pi)) / (2 n)
//
// (the determinant lemma for the log-determinant).  A variable with
// derivatives d'_k, a', r'_k moves them by
//
//   A' = -sum w^2 d' / d^2,  B' = sum w r' / d - sum w r d' / d^2,
//   C' = 2 sum r r' / d - sum r^2 d' / d^2,  S' = a' A + a A'
//   q' = C' - a' B^2 / S - 2 a B B' / S + a B^2 S' / S^2
//   (log det)' = sum d' / d + S' / S
//
// and the noise has d' = 1, a' = 0, r' = 0; vol has d' = dx mu, a' = x0 - dx,
// r' = vol p_t.  So both gradients need only the row sums
//
//   sum w^2/d^2, w r/d^2, r^2/d^2, 1/d, w^2 mu/d^2, w r mu/d^2, r^2 mu/d^2,
//   mu/d, w p_t/d, r p_t/d
//
// beside A, B, C and sum log d: fourteen sums of one pass over the row.
//
// Design: one block of THREADS threads per asset; thread t takes k = t,
// t + THREADS, ... (neighbouring threads on neighbouring addresses), so any
// n >= 1 works, and keeps its partial sums in registers.  A block sum
// (warp shuffles, then one shared-memory step across the warps) follows,
// and thread 0 finishes the scalars and writes the MLL and, when asked,
// the two gradients.  No second pass, no atomics, no workspace.
//
// Precision: float32 in and out, float64 inside (as G1 and G4).  On a grid
// from 0, a = -vol dx and sum w^2 / (vol dx mu) = 1 (M^{-1} 1 = e_1 for the
// integer min-matrix M), so S = 1 + a A is 1 less a sum near 1 when the
// noise is small against vol dx: the plain float32 composition loses those
// digits.
//
// What bounds it on the card: the bytes are p_y (and p_t on a grid per
// asset) read once, mu, w and the shared grid once for every asset from
// L2, and three floats an asset written: at (505, 999) about 2 MB, 0.6 us
// at 3.35 TB/s.  What sets its time is latency: each thread's chain of
// float64 divisions and logarithms over its ceil(n / THREADS) steps, then
// the block sums.  Measured on an NVIDIA H100 80GB HBM3 (700 W limit), on
// the device alone (chip_smoke.py): with the gradient 0.0118 ms at
// (505, 999) and 0.0107 ms at (64, 999), without it 0.0098 ms at both,
// against the bytes' 0.0006 and 0.0001 ms; the plain composition's forward
// and backward took 1.82-1.86 ms a call there, nearly all of it the host's
// launches.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr double LOG_2PI = 1.8378770664093453;

// The sums, by their index: the value's four, then the gradient's ten.
enum Sum {
  A,      // w^2 / d
  B,      // w r / d
  C,      // r^2 / d
  LOG_D,  // log d
  A2,     // w^2 / d^2
  B2,     // w r / d^2
  C2,     // r^2 / d^2
  D1,     // 1 / d
  A2M,    // w^2 mu / d^2
  B2M,    // w r mu / d^2
  C2M,    // r^2 mu / d^2
  D1M,    // mu / d
  BP,     // w p_t / d
  CP,     // r p_t / d
  SUMS
};

// The block's sums of the first N values, in thread 0.
template <int N>
__device__ void block_sum(double v[SUMS], double* partial) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(FULL, v[k], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) partial[N * (threadIdx.x >> 5) + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[k] = 0.0;
      for (int w = 0; w < WARPS; ++w) v[k] += partial[N * w + k];
    }
  }
}

template <bool GRAD>
__global__ void __launch_bounds__(THREADS)
bm_vol_mll_kernel(const float* __restrict__ p_y, const float* __restrict__ p_t,
                  const float* __restrict__ mu, const float* __restrict__ w,
                  const float* __restrict__ dx, const float* __restrict__ x0,
                  int grid_per_row, const float* __restrict__ vol,
                  const float* __restrict__ noise, float* __restrict__ mll,
                  float* __restrict__ g_vol, float* __restrict__ g_noise, int n) {
  __shared__ double partial[SUMS * WARPS];
  const int b = blockIdx.x;
  const long long off = static_cast<long long>(b) * n;
  const float* __restrict__ py = p_y + off;
  const float* __restrict__ pt = p_t + (grid_per_row ? off : 0);
  const int g = grid_per_row ? b : 0;
  const double v = vol[b], s = noise[b], h = dx[g];
  const double vh = v * h, half_v2 = 0.5 * v * v;

  double sums[SUMS];
#pragma unroll
  for (int k = 0; k < SUMS; ++k) sums[k] = 0.0;
  for (int k = threadIdx.x; k < n; k += THREADS) {
    const double m = __ldg(mu + k), wk = __ldg(w + k), t = __ldg(pt + k);
    const double d = vh * m + s;
    const double id = 1.0 / d;
    const double r = __ldg(py + k) + half_v2 * t;
    const double wd = wk * id, rd = r * id;
    sums[A] += wk * wd;
    sums[B] += wk * rd;
    sums[C] += r * rd;
    sums[LOG_D] += log(d);
    if (GRAD) {
      const double wd2 = wd * wd, wrd2 = wd * rd, rd2 = rd * rd;
      sums[A2] += wd2;
      sums[B2] += wrd2;
      sums[C2] += rd2;
      sums[D1] += id;
      sums[A2M] += wd2 * m;
      sums[B2M] += wrd2 * m;
      sums[C2M] += rd2 * m;
      sums[D1M] += id * m;
      sums[BP] += wd * t;
      sums[CP] += rd * t;
    }
  }
  block_sum<GRAD ? SUMS : LOG_D + 1>(sums, partial);
  if (threadIdx.x != 0) return;

  const double gap = static_cast<double>(x0[g]) - h;  // d a / d vol
  const double a = v * gap;
  const double big_s = 1.0 + a * sums[A];
  const double bb = sums[B] * sums[B];
  const double q = sums[C] - a * bb / big_s;
  mll[b] = static_cast<float>(
      -0.5 * (q + sums[LOG_D] + log(big_s) + n * LOG_2PI) / n);
  if (!GRAD) return;

  // the derivative of q + log det from (a', B', C', S', sum d' / d)
  const auto phi = [&](double da, double db, double dc, double ds, double dd) {
    return dc - da * bb / big_s - 2.0 * a * sums[B] * db / big_s
           + a * bb * ds / (big_s * big_s) + dd + ds / big_s;
  };
  const double scale = -0.5 / n;
  // the noise: d' = 1, so A' = -sum w^2 / d^2
  g_noise[b] = static_cast<float>(
      scale * phi(0.0, -sums[B2], -sums[C2], -a * sums[A2], sums[D1]));
  // vol: d' = dx mu, a' = x0 - dx, r' = vol p_t, so A' = -dx sum w^2 mu / d^2
  g_vol[b] = static_cast<float>(scale * phi(
      gap, v * sums[BP] - h * sums[B2M], 2.0 * v * sums[CP] - h * sums[C2M],
      gap * sums[A] - a * h * sums[A2M], h * sums[D1M]));
}

}  // namespace

// Per asset b < rows: p_y (rows, n); mu, w (n,); the grid's projection p_t
// and its step dx and start x0 shared ((n,), (1,), (1,); grid_per_row 0) or
// per asset ((rows, n), (rows,), (rows,)); vol, noise (rows,).  Writes the
// MLL (rows,) and, when g_vol is not null, its gradients g_vol and g_noise
// (rows,).
extern "C" int volt_bm_vol_spectral_mll(const float* p_y, const float* p_t, const float* mu,
                                        const float* w, const float* dx, const float* x0,
                                        int grid_per_row, const float* vol,
                                        const float* noise, float* mll, float* g_vol,
                                        float* g_noise, int rows, int n,
                                        cudaStream_t stream) {
  if (g_vol != nullptr) {
    bm_vol_mll_kernel<true><<<rows, THREADS, 0, stream>>>(
        p_y, p_t, mu, w, dx, x0, grid_per_row, vol, noise, mll, g_vol, g_noise, n);
  } else {
    bm_vol_mll_kernel<false><<<rows, THREADS, 0, stream>>>(
        p_y, p_t, mu, w, dx, x0, grid_per_row, vol, noise, mll, g_vol, g_noise, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kalman-filter marginal likelihood of a random walk observed in noise,
// and its reverse-time adjoint.
//
// Replaces the `lax.scan` of volt_tpu/ops/tridiag.py
// `brownian_noise_mll_kalman` (and `brownian_noise_filter`, whose final
// state this forward also returns).  It is not a Pallas kernel, but it is
// the main path's sequential hot spot: the Volt data fit runs the n-step
// scan forward and backward inside every one of its Adam steps.  Written
// as PyTorch ops, each time step costs about 40 launches (forward plus
// autograd backward), about 40k per Adam step at n = 999.
//
// Per lane b, with increments d_t, noise s and residuals y_t:
//   vp = P + d_t;  S = vp + s;  e = y_t - m
//   ll -= (log S + e^2 / S + log 2 pi) / 2
//   g = vp / S;  m += g e;  P = vp (1 - g)
// The forward returns ll / n and the final (m, P); with non-null
// m_prev/p_prev it also stores the state entering each step, which is all
// the backward needs to rebuild every intermediate.
//
// What bounds it on the card: the recursion is sequential in t, so the
// time is n times the latency of one step's dependent chain (a log and
// two IEEE divisions), not bandwidth or FLOPs; lanes are independent and
// at B = 64 the card is nearly empty.  Measured on an H100 SXM (700 W
// limit) at n = 999: one lane takes 0.13 ms (about 250 cycles a step);
// 64 to 1024 lanes take 0.25 ms, because the 32 lanes of a warp read 32
// different rows, so each load is 32 L1 transactions.  Staging
// (32 lanes x 32 steps) tiles through shared memory so the loads
// coalesce is the next step for speed.
//
// Design: one thread per lane runs the scalar recursion over all n steps
// in registers, so one launch replaces n steps of PyTorch ops (the plain
// loop takes about 110 ms forward and 290 ms backward at (64, 999) on the
// same card).  The loads do not depend on the carry, so unrolling lets
// them issue ahead of the chain.  The backward is a second kernel that
// runs the exact adjoint of the same recursion from t = n - 1 down to 0,
// giving d/d delta, d/d s and d/d y.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 64;
constexpr float LOG_2PI = 1.8378770664093453f;

__global__ void __launch_bounds__(BLOCK)
kalman_forward_kernel(const float* __restrict__ delta, const float* __restrict__ s2,
                      const float* __restrict__ resid, float* __restrict__ ll_out,
                      float* __restrict__ mean_out, float* __restrict__ var_out,
                      float* __restrict__ m_prev, float* __restrict__ p_prev,
                      int b, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;
  const long long row = static_cast<long long>(lane) * n;
  const float* d = delta + row;
  const float* y = resid + row;
  const float s = s2[lane];
  const bool save = m_prev != nullptr;
  float mean = 0.f, var = 0.f, ll = 0.f;
#pragma unroll 8
  for (int t = 0; t < n; ++t) {
    if (save) {
      m_prev[row + t] = mean;
      p_prev[row + t] = var;
    }
    const float var_pred = var + d[t];
    const float innov = var_pred + s;
    const float e = y[t] - mean;
    ll = ll - 0.5f * (logf(innov) + e * e / innov + LOG_2PI);
    const float gain = var_pred / innov;
    mean = mean + gain * e;
    var = var_pred * (1.f - gain);
  }
  ll_out[lane] = ll / static_cast<float>(n);
  mean_out[lane] = mean;
  var_out[lane] = var;
}

__global__ void __launch_bounds__(BLOCK)
kalman_backward_kernel(const float* __restrict__ delta, const float* __restrict__ s2,
                       const float* __restrict__ resid, const float* __restrict__ m_prev,
                       const float* __restrict__ p_prev, const float* __restrict__ g_ll,
                       const float* __restrict__ g_mean, const float* __restrict__ g_var,
                       float* __restrict__ g_delta, float* __restrict__ g_s2,
                       float* __restrict__ g_resid, int b, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;
  const long long row = static_cast<long long>(lane) * n;
  const float s = s2[lane];
  const float a_ll = g_ll[lane] / static_cast<float>(n);  // output is ll / n
  float a_m = g_mean[lane];  // adjoints of the carry leaving step t
  float a_p = g_var[lane];
  float a_s = 0.f;
#pragma unroll 8
  for (int t = n - 1; t >= 0; --t) {
    const float m = m_prev[row + t];
    const float vp = p_prev[row + t] + delta[row + t];
    const float innov = vp + s;
    const float inv = 1.f / innov;
    const float e = resid[row + t] - m;
    const float gain = vp * inv;
    // mean' = m + gain e;  var' = vp (1 - gain);  ll' = ll - (...)/2
    const float a_gain = a_m * e - a_p * vp;
    const float a_e = a_m * gain - a_ll * e * inv;
    const float a_innov = -0.5f * a_ll * (inv - e * e * inv * inv)
                          - a_gain * vp * inv * inv;
    const float a_vp = a_p * (1.f - gain) + a_gain * inv + a_innov;
    g_resid[row + t] = a_e;
    g_delta[row + t] = a_vp;
    a_s += a_innov;
    a_m = a_m - a_e;
    a_p = a_vp;
  }
  g_s2[lane] = a_s;
}

}  // namespace

// delta, resid: (b, n); s2: (b,).  Outputs ll / n, final mean and var: (b,).
// m_prev/p_prev: (b, n) or null (no state saved for a backward).
extern "C" int volt_kalman_forward(const float* delta, const float* s2, const float* resid,
                                   float* ll, float* mean, float* var, float* m_prev,
                                   float* p_prev, int b, int n, cudaStream_t stream) {
  kalman_forward_kernel<<<(b + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      delta, s2, resid, ll, mean, var, m_prev, p_prev, b, n);
  return static_cast<int>(cudaGetLastError());
}

// Adjoint of volt_kalman_forward given output cotangents g_ll, g_mean,
// g_var (b,); writes g_delta, g_resid (b, n) and g_s2 (b,).
extern "C" int volt_kalman_backward(const float* delta, const float* s2, const float* resid,
                                    const float* m_prev, const float* p_prev,
                                    const float* g_ll, const float* g_mean,
                                    const float* g_var, float* g_delta, float* g_s2,
                                    float* g_resid, int b, int n, cudaStream_t stream) {
  kalman_backward_kernel<<<(b + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      delta, s2, resid, m_prev, p_prev, g_ll, g_mean, g_var, g_delta, g_s2, g_resid, b, n);
  return static_cast<int>(cudaGetLastError());
}

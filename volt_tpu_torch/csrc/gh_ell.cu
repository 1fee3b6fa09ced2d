// Gauss-Hermite expected log-likelihood of the exp volatility model, and
// its analytic gradient.
//
// Replaces the TPU kernels volt_tpu/ops/pallas/gh_ell.py
// `_gh_ell_fwd_padded` (body `_make_kernel`) and `_gh_ell_bwd_padded`
// (body `_make_bwd_kernel`).  Per datum, with L nodes x_k and normalised
// weights w_k, f_k = sd x_k + mu, sd = sqrt(2 s2), fc = min(f, 80),
// s = max(exp(fc), 1e-3):
//
//   E      = sum_k w_k (-(y / s)^2 / 2 - log s - log(2 pi) / 2)
//   dE/dy  = sum_k w_k (-y / s^2)
//   dE/dmu = sum_k w_k (y^2 / s^2 - 1) [exp(fc) > 1e-3] [f < 80]
//   dE/ds2 = sum_k w_k x_k (...same...) / max(sd, 1e-20)
//
// each times the cotangent g in the backward.
//
// One fused node pass.  The forward computes E and, when a gradient is
// wanted (`saved` not null), the three node sums of the backward in the
// same loop, and stores them (3 floats a datum); the backward kernel is
// then elementwise: g times the sums, and / max(sd, 1e-20) for ds2.  So
// an Adam step runs the node loop once, not twice.
//
// Node arithmetic: one IEEE expf per node and no log: log s is fc where
// the scale is live and the constant log(1e-3f) where it is clamped (the
// difference from logf(expf(fc)) is one rounding of s, about 6e-8).  One
// correctly rounded reciprocal of s per node gives y / s and y / s^2 by
// products, in place of three IEEE divisions.  f = sd x + m is rounded
// twice, never contracted to an FMA, and the clamps compare as the plain
// version's do (NaN included), so the clamp and `live` decisions switch at
// exactly its nodes.
//
// What bounds it on the card: the special-function unit.  Every node needs
// an exponential (a MUFU.EX2) and here a reciprocal (MUFU.RCP) against
// 12 bytes read and 4 (16 with the saved sums) written per datum; 75
// nodes at 16 results per clock per SM is about 1.2 us at (64, 999) for
// the exponentials alone.  At 64k data one thread per datum gives only
// about 15 warps per SM, too few to hide the latency of those units, so
// 2^split_log2 neighbouring lanes share a datum, each taking every
// 2^split_log2-th node, and their sums are combined by __shfl_xor_sync
// (the summation order differs from the plain version's; the tests'
// tolerances hold in any order).  The wrapper picks the split from the
// number of data.  The nodes, weights and their products (3 L floats, from
// the host in float64, cast once) are staged in shared memory by each
// block, so every node read is a broadcast.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr float F_CAP = 80.0f;
constexpr float SCALE_MIN = 1e-3f;
constexpr float LOG_SCALE_MIN = -6.90775537f;  // logf(1e-3f)
constexpr float HALF_LOG_2PI = 0.91893853320467274f;
constexpr unsigned FULL = 0xffffffffu;

// f = sd x + m rounded twice, never contracted to an FMA: the clamps at
// f = 80 and exp(f) = 1e-3 then switch at exactly the nodes where the plain
// version's (separately rounded) product and sum switch them.
__device__ inline float node(float sd, float x, float m) {
  return __fadd_rn(__fmul_rn(sd, x), m);
}

__device__ inline float group_sum(float v, int split) {
  for (int off = split >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <bool SAVE>
__global__ void __launch_bounds__(BLOCK)
gh_ell_forward_kernel(const float* __restrict__ y, const float* __restrict__ mu,
                      const float* __restrict__ s2, const float* __restrict__ nodes,
                      float* __restrict__ out, float* __restrict__ saved, long long count,
                      int num_locs, int split_log2) {
  extern __shared__ float node_s[];  // x, w, w x
  for (int k = threadIdx.x; k < num_locs; k += BLOCK) {
    const float x = nodes[k];
    const float w = nodes[num_locs + k];
    node_s[k] = x;
    node_s[num_locs + k] = w;
    node_s[2 * num_locs + k] = __fmul_rn(w, x);
  }
  __syncthreads();
  const float* loc = node_s;
  const float* wt = node_s + num_locs;
  const float* wx = node_s + 2 * num_locs;
  const int split = 1 << split_log2;
  const long long i = (static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x) >> split_log2;
  const int sub = threadIdx.x & (split - 1);
  const bool live_datum = i < count;
  // past the end, a harmless datum: every lane of a group takes part in
  // the shuffles
  const float yi = live_datum ? y[i] : 0.0f;
  const float m = live_datum ? mu[i] : 0.0f;
  const float sd = sqrtf(2.0f * (live_datum ? s2[i] : 1.0f));
  float e = 0.0f, ay = 0.0f, amu = 0.0f, as2 = 0.0f;
  for (int k = sub; k < num_locs; k += split) {
    const float f = node(sd, loc[k], m);
    const float fc = f >= F_CAP ? F_CAP : f;
    const float ef = expf(fc);
    const bool clamped = ef <= SCALE_MIN;
    const float inv = __frcp_rn(clamped ? SCALE_MIN : ef);
    const float r = yi * inv;
    const float lp = -0.5f * r * r - (clamped ? LOG_SCALE_MIN : fc) - HALF_LOG_2PI;
    e += wt[k] * lp;
    if (SAVE) {
      const float live = (ef > SCALE_MIN && f < F_CAP) ? 1.0f : 0.0f;
      const float dlp = (r * r - 1.0f) * live;
      ay += wt[k] * (-r * inv);
      amu += wt[k] * dlp;
      as2 += wx[k] * dlp;
    }
  }
  e = group_sum(e, split);
  if (SAVE) {
    ay = group_sum(ay, split);
    amu = group_sum(amu, split);
    as2 = group_sum(as2, split);
  }
  if (live_datum && sub == 0) {
    out[i] = e;
    if (SAVE) {
      saved[i] = ay;
      saved[count + i] = amu;
      saved[2 * count + i] = as2;
    }
  }
}

__global__ void __launch_bounds__(BLOCK)
gh_ell_backward_kernel(const float* __restrict__ s2, const float* __restrict__ g,
                       const float* __restrict__ saved, float* __restrict__ dy,
                       float* __restrict__ dmu, float* __restrict__ ds2, long long count) {
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= count) return;
  const float inv_sd = 1.0f / fmaxf(sqrtf(2.0f * s2[i]), 1e-20f);
  const float gi = g[i];
  dy[i] = gi * saved[i];
  dmu[i] = gi * saved[count + i];
  ds2[i] = gi * saved[2 * count + i] * inv_sd;
}

int blocks_for(long long threads) {
  return static_cast<int>((threads + BLOCK - 1) / BLOCK);
}

}  // namespace

// y, mu, s2, out: `count` float32 each; nodes: [x_0..x_{L-1}, w_0..w_{L-1}];
// saved: null (E alone) or 3 count floats, the node sums of dE/dy, dE/dmu
// and sd dE/ds2 for volt_gh_ell_backward; 2^split_log2 lanes per datum
// (split_log2 in 0..5).
extern "C" int volt_gh_ell_forward(const float* y, const float* mu, const float* s2,
                                   const float* nodes, float* out, float* saved, int count,
                                   int num_locs, int split_log2, cudaStream_t stream) {
  const size_t smem = 3 * static_cast<size_t>(num_locs) * sizeof(float);
  const int blocks = blocks_for(static_cast<long long>(count) << split_log2);
  if (saved != nullptr) {
    gh_ell_forward_kernel<true><<<blocks, BLOCK, smem, stream>>>(
        y, mu, s2, nodes, out, saved, count, num_locs, split_log2);
  } else {
    gh_ell_forward_kernel<false><<<blocks, BLOCK, smem, stream>>>(
        y, mu, s2, nodes, out, saved, count, num_locs, split_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: the cotangent of the forward's output; saved: the forward's node sums;
// dy, dmu, ds2: `count` each.
extern "C" int volt_gh_ell_backward(const float* s2, const float* g, const float* saved,
                                    float* dy, float* dmu, float* ds2, int count,
                                    cudaStream_t stream) {
  gh_ell_backward_kernel<<<blocks_for(count), BLOCK, 0, stream>>>(s2, g, saved, dy, dmu,
                                                                  ds2, count);
  return static_cast<int>(cudaGetLastError());
}

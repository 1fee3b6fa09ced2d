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
// What bounds it on the card: every node costs an exp, a log and a
// division per datum (75 nodes: 225 special-function operations), against
// 16 bytes read and 4 written, so at large R N the special-function units
// bound it; at the GPCV shape (64, 999), 64k data, the card is far from
// full and the call is launch latency.
//
// Design: one thread per datum, the node loop in registers, nothing of
// the (nodes, N) intermediate ever in memory, as on the TPU.  The nodes and
// weights (2 L floats, from the host in float64, cast once) are staged in
// shared memory by each block, so every node read is a broadcast.  IEEE
// expf, logf and division throughout: the fast intrinsics move the sum
// past a 1e-5 relative tolerance.  Inputs are flattened by the wrapper, so
// the kernel sees one contiguous run of `count` data.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_GRID = 65535;
constexpr float F_CAP = 80.0f;
constexpr float SCALE_MIN = 1e-3f;
constexpr float HALF_LOG_2PI = 0.91893853320467274f;

// f = sd x + m rounded twice, never contracted to an FMA: the clamps at
// f = 80 and exp(f) = 1e-3 then switch at exactly the nodes where the plain
// version's (separately rounded) product and sum switch them.
__device__ inline float node(float sd, float x, float m) {
  return __fadd_rn(__fmul_rn(sd, x), m);
}

__device__ inline void stage_nodes(const float* __restrict__ nodes,
                                   float* node_s, int num_locs) {
  for (int k = threadIdx.x; k < 2 * num_locs; k += BLOCK) node_s[k] = nodes[k];
  __syncthreads();
}

__global__ void __launch_bounds__(BLOCK)
gh_ell_forward_kernel(const float* __restrict__ y, const float* __restrict__ mu,
                      const float* __restrict__ s2, const float* __restrict__ nodes,
                      float* __restrict__ out, int count, int num_locs) {
  extern __shared__ float node_s[];
  stage_nodes(nodes, node_s, num_locs);
  const float* loc = node_s;
  const float* wt = node_s + num_locs;
  for (int i = blockIdx.x * BLOCK + threadIdx.x; i < count; i += gridDim.x * BLOCK) {
    const float yi = y[i];
    const float m = mu[i];
    const float sd = sqrtf(2.0f * s2[i]);
    float acc = 0.0f;
    for (int k = 0; k < num_locs; ++k) {
      const float f = fminf(node(sd, loc[k], m), F_CAP);
      const float scale = fmaxf(expf(f), SCALE_MIN);
      const float r = yi / scale;
      const float lp = -0.5f * r * r - logf(scale) - HALF_LOG_2PI;
      acc += wt[k] * lp;
    }
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(BLOCK)
gh_ell_backward_kernel(const float* __restrict__ y, const float* __restrict__ mu,
                       const float* __restrict__ s2, const float* __restrict__ g,
                       const float* __restrict__ nodes, float* __restrict__ dy,
                       float* __restrict__ dmu, float* __restrict__ ds2, int count,
                       int num_locs) {
  extern __shared__ float node_s[];
  stage_nodes(nodes, node_s, num_locs);
  const float* loc = node_s;
  const float* wt = node_s + num_locs;
  for (int i = blockIdx.x * BLOCK + threadIdx.x; i < count; i += gridDim.x * BLOCK) {
    const float yi = y[i];
    const float m = mu[i];
    const float sd = sqrtf(2.0f * s2[i]);
    const float inv_sd = 1.0f / fmaxf(sd, 1e-20f);
    float ay = 0.0f, amu = 0.0f, as2 = 0.0f;
    for (int k = 0; k < num_locs; ++k) {
      const float x = loc[k];
      const float w = wt[k];
      const float f = node(sd, x, m);
      const float ef = expf(fminf(f, F_CAP));
      const float scale = fmaxf(ef, SCALE_MIN);
      const float live = (ef > SCALE_MIN && f < F_CAP) ? 1.0f : 0.0f;
      const float r = yi / scale;
      const float dlp = (r * r - 1.0f) * live;
      ay += w * (-yi / (scale * scale));
      amu += w * dlp;
      as2 += (w * x) * dlp;
    }
    const float gi = g[i];
    dy[i] = gi * ay;
    dmu[i] = gi * amu;
    ds2[i] = gi * as2 * inv_sd;
  }
}

int grid_for(int count) {
  const int blocks = (count + BLOCK - 1) / BLOCK;
  return blocks < MAX_GRID ? blocks : MAX_GRID;
}

}  // namespace

// y, mu, s2, out: `count` float32 each; nodes: [x_0..x_{L-1}, w_0..w_{L-1}].
extern "C" int volt_gh_ell_forward(const float* y, const float* mu, const float* s2,
                                   const float* nodes, float* out, int count,
                                   int num_locs, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(num_locs) * sizeof(float);
  gh_ell_forward_kernel<<<grid_for(count), BLOCK, smem, stream>>>(
      y, mu, s2, nodes, out, count, num_locs);
  return static_cast<int>(cudaGetLastError());
}

// g: the cotangent of the forward's output; dy, dmu, ds2: `count` each.
extern "C" int volt_gh_ell_backward(const float* y, const float* mu, const float* s2,
                                    const float* g, const float* nodes, float* dy,
                                    float* dmu, float* ds2, int count, int num_locs,
                                    cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(num_locs) * sizeof(float);
  gh_ell_backward_kernel<<<grid_for(count), BLOCK, smem, stream>>>(
      y, mu, s2, g, nodes, dy, dmu, ds2, count, num_locs);
  return static_cast<int>(cudaGetLastError());
}

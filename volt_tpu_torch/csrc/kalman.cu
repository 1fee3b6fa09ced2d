// Kalman-filter marginal likelihood of a random walk observed in noise,
// and its reverse-time adjoint, as chunked parallel-in-time scans.
//
// Replaces the `lax.scan` of volt_tpu/ops/tridiag.py
// `brownian_noise_mll_kalman` (and `brownian_noise_filter`, whose final
// state this forward also returns).  It is not a Pallas kernel, but it is
// the main path's sequential hot spot: the Volt data fit runs the n-step
// scan forward and backward inside every one of its Adam steps.
//
// Per lane, with increments d_t, noise s and residuals y_t:
//   vp = P + d_t;  S = vp + s;  e = y_t - m
//   ll -= (log S + e^2 / S + log 2 pi) / 2
//   g = vp / S;  m += g e;  P = vp (1 - g)
// The forward returns ll / n and the final (m, P); with non-null
// m_prev/p_prev it also stores the state entering each step, which is all
// the backward needs to rebuild every intermediate.
//
// Why it scans: run step by step, the time is n times one step's
// dependent chain (a log and two IEEE divisions, about 250 cycles), 0.13
// to 0.26 ms at n = 999, while the bytes take 0.3 us.  Each recursion is
// associative once written as a map of the carry:
//   P  -> (s P + s d) / (P + d + s), a Moebius map: the 2x2 matrix
//         [[s, s d], [1, d + s]], all entries non-negative;
//   m  -> (1 - g) m + g y, affine once the gains are known;
//   the adjoint (a_m, a_p) -> ([q, 0], [s e / S^2, q^2]) (a_m, a_p)
//         + (a_ll e / S, -a_ll (1 / S - e^2 / S^2) / 2), q = s / S,
//         affine with a lower-triangular matrix (from the serial lines
//         below, with a_ll the cotangent of ll).
//
// Design: one block of THREADS threads per lane walks the row in tiles of
// TILE = THREADS * CHUNK steps, carrying the state (the adjoint, walking
// back) from tile to tile, so any n >= 1 works.  A tile is loaded into
// shared memory by coalesced scalar loads (a warp reads 128 contiguous
// bytes, whatever the row's alignment) and each thread takes one chunk of
// CHUNK steps, read at a padded stride so the warp hits 32 banks.
// Forward: (1) each thread composes its chunk's Moebius matrices, each
// product scaled by a power of two (exact) to keep it in range; a block
// exclusive scan (warp shuffles, then one shared-memory step across the
// warps) gives every chunk its entering P.  (2) Each thread runs P over
// its chunk, keeping P and the gains, and composes the chunk's affine
// mean map; a second scan gives the entering m.  (3) Each thread runs m
// over its chunk, adds its ll terms and writes the saved state through
// shared memory (coalesced stores); a block sum gives ll.  Backward: the
// same over the tiles from the last, the adjoint maps scanned from the
// end; each thread then steps the adjoint over its chunk, writing d/d
// delta and d/d y, and a block sum gives d/d s.
//
// Precision: float32 in and out, float64 inside.  A scan sums in another
// order than the serial loop, and its entering state for a chunk is not
// the state the previous chunk's own run ends with: in float32 the two
// differ by the error accumulated over the whole row, which shows as a
// jump at every chunk boundary (in d/dv, a difference of neighbouring
// d/d delta, it used 1.25 of the tolerance against the float32 plain loop
// at (500, 999), in an emulation of this kernel, tests/test_torch_kalman.py).
// In float64 the jumps are 1e-16 and the kernel is closer to a float64
// loop than the float32 plain loop is.  Only the log is taken in float32
// (logf of the rounded S), which moves ll by about 1e-7.
//
// What bounds it on the card: a thread's chain is three passes over 8
// steps plus two 7-level scans; the bytes (each input read once, each
// output written once) take 0.31 us forward and 0.46 us backward at
// (64, 999) at 3.35 TB/s, so launch and memory latency, not bandwidth or
// FLOPs, set the time.  Measured on an NVIDIA H100 80GB HBM3 (700 W
// limit), on the device alone (chip_smoke.py, and its --ab mode against
// the serial kernel): forward with the saved state 0.0076-0.0078 ms and
// backward 0.0055-0.0056 ms at (64, 999) and at (1, 999), 0.016 and
// 0.012 ms at (500, 999), 0.088 and 0.055 ms at (16, 16000); the serial
// kernel it replaces took 0.25 and 0.27 ms at (64, 999).  A call through
// the wrapper takes 0.03 to 0.07 ms, most of it host work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8;
constexpr int TILE = THREADS * CHUNK;
constexpr int SMEM = TILE + TILE / CHUNK;  // one pad word after each chunk
constexpr unsigned FULL = 0xffffffffu;
constexpr double LOG_2PI = 1.8378770664093453;

// Shared-memory slot of tile step t: chunk j's steps sit at j (CHUNK + 1) + k.
__device__ __forceinline__ int slot(int t) { return t + t / CHUNK; }

// P -> (a P + b) / (c P + d).  Maps compose as matrix products; a product
// is scaled by the power of two that brings its largest entry into [1, 2),
// which changes no map and rounds nothing.
struct Moebius {
  double a, b, c, d;
  __device__ static Moebius identity() { return {1.0, 0.0, 0.0, 1.0}; }
  __device__ Moebius scaled() const {
    const long long e =
        __double_as_longlong(fmax(fmax(a, b), fmax(c, d))) & 0x7ff0000000000000LL;
    const double k = __longlong_as_double(0x7fe0000000000000LL - e);
    return {a * k, b * k, c * k, d * k};
  }
  // this map applied after `x`
  __device__ Moebius after(const Moebius& x) const {
    return Moebius{a * x.a + b * x.c, a * x.b + b * x.d,
                   c * x.a + d * x.c, c * x.b + d * x.d}.scaled();
  }
  __device__ Moebius shfl(int src) const {
    return {__shfl_sync(FULL, a, src), __shfl_sync(FULL, b, src),
            __shfl_sync(FULL, c, src), __shfl_sync(FULL, d, src)};
  }
  __device__ double operator()(double p) const { return (a * p + b) / (c * p + d); }
};

// m -> a m + b
struct Affine {
  double a, b;
  __device__ static Affine identity() { return {1.0, 0.0}; }
  __device__ Affine after(const Affine& x) const { return {a * x.a, a * x.b + b}; }
  __device__ Affine shfl(int src) const {
    return {__shfl_sync(FULL, a, src), __shfl_sync(FULL, b, src)};
  }
};

// (a_m, a_p) -> (q a_m + c0, l a_m + r a_p + c1)
struct Adjoint {
  double q, l, r, c0, c1;
  __device__ static Adjoint identity() { return {1.0, 0.0, 1.0, 0.0, 0.0}; }
  // the adjoint of one step, the carry leaving it to the carry entering it
  __device__ static Adjoint step(double s, double vp, double inv, double e,
                                 double a_ll) {
    const double q = 1.0 - vp * inv;
    const double ei = e * inv;
    return {q, s * ei * inv, q * q, a_ll * ei, -0.5 * a_ll * (inv - ei * ei)};
  }
  __device__ Adjoint after(const Adjoint& x) const {
    return {q * x.q, l * x.q + r * x.l, r * x.r, q * x.c0 + c0,
            l * x.c0 + r * x.c1 + c1};
  }
  __device__ Adjoint shfl(int src) const {
    return {__shfl_sync(FULL, q, src), __shfl_sync(FULL, l, src),
            __shfl_sync(FULL, r, src), __shfl_sync(FULL, c0, src),
            __shfl_sync(FULL, c1, src)};
  }
};

// Exclusive scan of the threads' maps in thread order (from the last
// thread when `reverse`): returns the composition of the maps of all
// threads before this one, the latest applied last.  `totals` holds
// WARPS maps of shared memory.
template <class Map>
__device__ Map exclusive_scan(Map x, bool reverse, Map* totals) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pos = reverse ? 31 - lane : lane;  // place in scan order
  const int wpos = reverse ? WARPS - 1 - warp : warp;
  const int back = reverse ? 1 : -1;           // lane step to earlier maps
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Map y = x.shfl(lane + back * off);
    if (pos >= off) x = x.after(y);
  }
  if (pos == 31) totals[wpos] = x;
  Map ex = x.shfl(lane + back);
  if (pos == 0) ex = Map::identity();
  __syncthreads();
  Map before = Map::identity();
  for (int w = 0; w < wpos; ++w) before = totals[w].after(before);
  __syncthreads();  // totals is reused by the next scan
  return ex.after(before);
}

__device__ double block_sum(double v, double* partial) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += partial[w];
  return total;
}

// Steps [0, len) of a tile starting at global offset `off`: coalesced
// loads into shared memory at the padded slots.
__device__ __forceinline__ void stage(const float* __restrict__ src, float* dst,
                                      long long off, int len) {
#pragma unroll
  for (int r = 0; r < CHUNK; ++r) {
    const int t = threadIdx.x + r * THREADS;
    if (t < len) dst[slot(t)] = src[off + t];
  }
}

__device__ __forceinline__ void unstage(const float* src, float* __restrict__ dst,
                                        long long off, int len) {
#pragma unroll
  for (int r = 0; r < CHUNK; ++r) {
    const int t = threadIdx.x + r * THREADS;
    if (t < len) dst[off + t] = src[slot(t)];
  }
}

__global__ void __launch_bounds__(THREADS)
kalman_forward_kernel(const float* __restrict__ delta, const float* __restrict__ s2,
                      const float* __restrict__ resid, float* __restrict__ ll_out,
                      float* __restrict__ mean_out, float* __restrict__ var_out,
                      float* __restrict__ m_prev, float* __restrict__ p_prev, int n) {
  __shared__ float d_s[SMEM];  // delta, then the saved m of the tile
  __shared__ float y_s[SMEM];  // resid, then the saved P
  __shared__ Moebius p_tot[WARPS];
  __shared__ Affine m_tot[WARPS];
  __shared__ double carry_s[2];
  __shared__ double sum_s[WARPS];
  const long long row = static_cast<long long>(blockIdx.x) * n;
  const double s = s2[blockIdx.x];
  const bool save = m_prev != nullptr;
  const int first = threadIdx.x * CHUNK;  // this thread's chunk in the tile
  double mean = 0.0, var = 0.0;           // the state entering the tile
  double ll = 0.0;                        // this thread's terms
  for (int base = 0; base < n; base += TILE) {
    const int len = min(TILE, n - base);
    stage(delta, d_s, row + base, len);
    stage(resid, y_s, row + base, len);
    __syncthreads();
    const int steps = max(0, min(CHUNK, len - first));
    double d[CHUNK], y[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (k < steps) {
        d[k] = d_s[slot(first + k)];
        y[k] = y_s[slot(first + k)];
      }
    }

    // (1) the variance map of the chunk, scanned: the entering P
    Moebius pm = Moebius::identity();
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (k < steps) pm = Moebius{s, s * d[k], 1.0, d[k] + s}.after(pm);
    }
    double p = exclusive_scan(pm, false, p_tot)(var);

    // (2) P over the chunk, keeping P and the gains, and the mean map:
    // the entering m
    double p_in[CHUNK], gain[CHUNK];
    Affine mm = Affine::identity();
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (k < steps) {
        p_in[k] = p;
        const double var_pred = p + d[k];
        const double g = var_pred / (var_pred + s);
        gain[k] = g;
        mm = {mm.a * (1.0 - g), mm.b + g * (y[k] - mm.b)};
        p = var_pred * (1.0 - g);
      }
    }
    const Affine m_in = exclusive_scan(mm, false, m_tot);
    double m = m_in.a * mean + m_in.b;

    // (3) m over the chunk: the ll terms and the saved state
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (k < steps) {
        const double innov = p_in[k] + d[k] + s;
        const double e = y[k] - m;
        const double log_innov = logf(__double2float_rn(innov));
        ll -= 0.5 * (log_innov + e * e / innov + LOG_2PI);
        if (save) {
          d_s[slot(first + k)] = __double2float_rn(m);
          y_s[slot(first + k)] = __double2float_rn(p_in[k]);
        }
        m += gain[k] * e;
      }
    }
    if (steps > 0 && first + steps == len) {
      carry_s[0] = m;
      carry_s[1] = p;
    }
    __syncthreads();
    if (save) {
      unstage(d_s, m_prev, row + base, len);
      unstage(y_s, p_prev, row + base, len);
    }
    mean = carry_s[0];
    var = carry_s[1];
    __syncthreads();  // the next tile overwrites d_s, y_s and carry_s
  }
  ll = block_sum(ll, sum_s);
  if (threadIdx.x == 0) {
    ll_out[blockIdx.x] = __double2float_rn(ll / n);
    mean_out[blockIdx.x] = __double2float_rn(mean);
    var_out[blockIdx.x] = __double2float_rn(var);
  }
}

__global__ void __launch_bounds__(THREADS)
kalman_backward_kernel(const float* __restrict__ delta, const float* __restrict__ s2,
                       const float* __restrict__ resid, const float* __restrict__ m_prev,
                       const float* __restrict__ p_prev, const float* __restrict__ g_ll,
                       const float* __restrict__ g_mean, const float* __restrict__ g_var,
                       float* __restrict__ g_delta, float* __restrict__ g_s2,
                       float* __restrict__ g_resid, int n) {
  __shared__ float d_s[SMEM];  // delta, then d/d delta
  __shared__ float y_s[SMEM];  // resid, then d/d resid
  __shared__ float m_s[SMEM];
  __shared__ float p_s[SMEM];
  __shared__ Adjoint a_tot[WARPS];
  __shared__ double carry_s[2];
  __shared__ double sum_s[WARPS];
  const long long row = static_cast<long long>(blockIdx.x) * n;
  const double s = s2[blockIdx.x];
  const double a_ll = static_cast<double>(g_ll[blockIdx.x]) / n;  // output is ll / n
  const int first = threadIdx.x * CHUNK;
  double a_m = g_mean[blockIdx.x];  // adjoints of the state leaving the tile
  double a_p = g_var[blockIdx.x];
  double a_s = 0.0;                 // this thread's terms of d/d s
  for (int base = (n - 1) / TILE * TILE; base >= 0; base -= TILE) {
    const int len = min(TILE, n - base);
    stage(delta, d_s, row + base, len);
    stage(resid, y_s, row + base, len);
    stage(m_prev, m_s, row + base, len);
    stage(p_prev, p_s, row + base, len);
    __syncthreads();
    const int steps = max(0, min(CHUNK, len - first));
    double vp[CHUNK], inv[CHUNK], e[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (k < steps) {
        const int i = slot(first + k);
        vp[k] = static_cast<double>(p_s[i]) + d_s[i];
        inv[k] = 1.0 / (vp[k] + s);
        e[k] = static_cast<double>(y_s[i]) - m_s[i];
      }
    }

    // the chunk's adjoint map, last step applied first, scanned from the
    // end: the adjoint leaving the chunk
    Adjoint am = Adjoint::identity();
#pragma unroll
    for (int k = CHUNK - 1; k >= 0; --k) {
      if (k < steps) am = Adjoint::step(s, vp[k], inv[k], e[k], a_ll).after(am);
    }
    const Adjoint out = exclusive_scan(am, true, a_tot);
    double am_k = out.q * a_m + out.c0;
    double ap_k = out.l * a_m + out.r * a_p + out.c1;

    // the steps of the chunk, last first, with their gradients
#pragma unroll
    for (int k = CHUNK - 1; k >= 0; --k) {
      if (k < steps) {
        const Adjoint st = Adjoint::step(s, vp[k], inv[k], e[k], a_ll);
        // mean' = m + gain e;  var' = vp (1 - gain);  ll' = ll - (...)/2
        const double a_gain = am_k * e[k] - ap_k * vp[k];
        a_s += -0.5 * a_ll * (inv[k] - e[k] * e[k] * inv[k] * inv[k])
               - a_gain * vp[k] * inv[k] * inv[k];
        y_s[slot(first + k)] = __double2float_rn(am_k * vp[k] * inv[k] - st.c0);
        const double am_next = st.q * am_k + st.c0;
        ap_k = st.l * am_k + st.r * ap_k + st.c1;
        am_k = am_next;
        d_s[slot(first + k)] = __double2float_rn(ap_k);
      }
    }
    if (threadIdx.x == 0) {
      carry_s[0] = am_k;
      carry_s[1] = ap_k;
    }
    __syncthreads();
    unstage(y_s, g_resid, row + base, len);
    unstage(d_s, g_delta, row + base, len);
    a_m = carry_s[0];
    a_p = carry_s[1];
    __syncthreads();  // the next tile overwrites the staged arrays and carry_s
  }
  a_s = block_sum(a_s, sum_s);
  if (threadIdx.x == 0) g_s2[blockIdx.x] = __double2float_rn(a_s);
}

}  // namespace

// delta, resid: (b, n); s2: (b,).  Outputs ll / n, final mean and var: (b,).
// m_prev/p_prev: (b, n) or null (no state saved for a backward).
extern "C" int volt_kalman_forward(const float* delta, const float* s2, const float* resid,
                                   float* ll, float* mean, float* var, float* m_prev,
                                   float* p_prev, int b, int n, cudaStream_t stream) {
  kalman_forward_kernel<<<b, THREADS, 0, stream>>>(delta, s2, resid, ll, mean, var,
                                                   m_prev, p_prev, n);
  return static_cast<int>(cudaGetLastError());
}

// Adjoint of volt_kalman_forward given output cotangents g_ll, g_mean,
// g_var (b,); writes g_delta, g_resid (b, n) and g_s2 (b,).
extern "C" int volt_kalman_backward(const float* delta, const float* s2, const float* resid,
                                    const float* m_prev, const float* p_prev,
                                    const float* g_ll, const float* g_mean,
                                    const float* g_var, float* g_delta, float* g_s2,
                                    float* g_resid, int b, int n, cudaStream_t stream) {
  kalman_backward_kernel<<<b, THREADS, 0, stream>>>(delta, s2, resid, m_prev, p_prev,
                                                    g_ll, g_mean, g_var, g_delta, g_s2,
                                                    g_resid, n);
  return static_cast<int>(cudaGetLastError());
}

// Truncated, renormalised k-tap EWMA filter (the Volt "Magpie" mean).
//
// Replaces the TPU kernel volt_tpu/ops/pallas/ewma_filter.py
// `_ewma_padded` (body `_kernel`), which ran the filter as a banded matmul
// on the MXU: 512-wide output tiles times a (512 + k_pad, 512) band matrix
// that is almost all zeros, because Mosaic only loads lane-aligned slices.
//
//   out[r, j] = sum_{i<k} w[i] * padded[r, j + i],   j = 0..T
//   padded[r, p] = y[r, 0] for p < k, else y[r, p - k]
//
// The taps are geometric, w[i] = c beta^(k-1-i) with beta = 1 - 2/(k+1)
// and c = (1 - beta) / (1 - beta^k), so the filter is exactly a first-order
// recurrence on its output (every tap of out[0] sees the pad value y[0],
// and the taps sum to one):
//
//   out[0]   = y[0]
//   out[i+1] = beta out[i] + c (y[i] - beta^k y[max(i - k, 0)]),  i = 0..T-1
//
// O(1) work per output for any k (k = 1: beta = 0; k > T: every lagged read
// is y[0]).  The host computes beta, c and beta^k in float64.
//
// Precision: float32 in and out, float64 inside.  The recurrence contracts
// (beta < 1), and 1 / (1 - beta^k) is at most about 1.16, so the bracket
// cancels little: the result lies within a rounding of the exact filter,
// closer than a float32 k-term FIR.
//
// Non-finite inputs: the recurrence carries a NaN (or the NaN that an
// infinity makes in the bracket) from its step to the end of its row; the
// FIR confined it to the k outputs whose window holds it, and the TPU
// kernel spread it over its 512-output tile (NaN * 0 in the band matrix).
// Other rows are never touched.
//
// Design: a chunked parallel-in-time scan, as S1's (csrc/kalman.cu).  A
// row gets a segment of L threads of a block of 128 (L a power of two, the
// least with L * CHUNK >= T, at most 128), so a block serves 128 / L short
// rows at once and a (70000, 3) input fills the grid.  Each thread takes
// CHUNK = 8 steps: (1) it composes its chunk's map out -> beta^steps out + b,
// (2) a Hillis-Steele scan of the maps across the segment (shuffles within
// a warp, then the totals of the segment's earlier warps through shared
// memory) gives every chunk its entering value, (3) the thread reruns its
// chunk from it.  What costs is the number of steps a thread walks: on an
// NVIDIA H100 80GB HBM3 (700 W limit), on the device alone at (64, 999),
// a row over one warp of 32-step chunks took 0.0086 ms and over four warps
// of 8-step chunks 0.0036 ms (chip_smoke.py; PERF.md).  A block stages
// its rows' steps in shared memory with coalesced loads, all issued before
// the first store, a chunk per 9 words (the pad word keeps the threads on
// distinct banks), and writes the outputs back the same way.  Rows longer
// than 128 * CHUNK steps walk in tiles with the carry; there the lagged
// read y[i - k] falls before the staged tile when k is large, and is read
// through L1 / L2.
//
// What bounds it on the card: the bytes, rows (2T + 1) 4 (0.15 us at
// (64, 999), 1.2 us at (500, 999) at 3.35 TB/s); the arithmetic is three
// float64 operations per output.  At the main path's shapes the launch and
// the memory latency set the time.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / WARP;
constexpr int CHUNK_LOG2 = 3;
constexpr int CHUNK = 1 << CHUNK_LOG2;   // steps per thread
constexpr int TILE = THREADS * CHUNK;    // steps staged per block
constexpr int SLOTS = TILE + TILE / CHUNK;
constexpr int MAX_LANES_LOG2 = 7;        // a segment of all 128 threads
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory slot of staged step f: chunk j's steps sit at j (CHUNK + 1) + k.
__device__ __forceinline__ int slot(int f) { return f + f / CHUNK; }

__global__ void __launch_bounds__(THREADS)
ewma_filter_kernel(const float* __restrict__ y, float* __restrict__ out, int rows,
                   int t, int k, int lanes_log2, double beta, double c,
                   double beta_k) {
  __shared__ float buf[SLOTS];
  __shared__ double tot_a[WARPS], tot_b[WARPS];  // warp totals of the maps
  __shared__ double carry_s[THREADS];            // per segment
  const int lanes = 1 << lanes_log2;             // L: threads per row
  const int width = min(lanes, WARP);            // a segment's part of a warp
  const int seg_log2 = lanes_log2 + CHUNK_LOG2;
  const int seg_tile = 1 << seg_log2;            // steps of a row per tile
  const long long row0 = static_cast<long long>(blockIdx.x) << (MAX_LANES_LOG2 - lanes_log2);
  const int g = threadIdx.x >> lanes_log2;       // this thread's row in the block
  const int s = threadIdx.x & (lanes - 1);       // its place in the row's segment
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const long long row = row0 + g;
  const bool live = row < rows;
  const float* yr = y + row * t;
  const int first = s * CHUNK;                   // its chunk in the tile
  const int seg = g << seg_log2;                 // the row's first staged step
  double carry = 0.0;                            // out[base], entering the tile
  for (int base = 0; base < t; base += seg_tile) {
    const int len = min(seg_tile, t - base);
    // stage steps [base, base + len) of each row of the block: every load
    // issued before the first store, so the block waits on memory once
    float staged[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int f = threadIdx.x + j * THREADS;
      const int tt = f & (seg_tile - 1);
      const long long r = row0 + (f >> seg_log2);
      staged[j] = tt < len && r < rows ? y[r * t + base + tt] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) buf[slot(threadIdx.x + j * THREADS)] = staged[j];
    __syncthreads();
    if (base == 0) {
      carry = buf[slot(seg)];
      if (live && s == 0) out[row * (t + 1)] = buf[slot(seg)];
    }

    // (1) the inputs' terms, then the chunk's map out -> a out + b
    const int steps = live ? max(0, min(CHUNK, len - first)) : 0;
    double v[CHUNK];
#pragma unroll
    for (int kk = 0; kk < CHUNK; ++kk) {
      if (kk < steps) {
        const int q = max(base + first + kk - k, 0);
        const float lag = q >= base ? buf[slot(seg + q - base)] : __ldg(yr + q);
        v[kk] = c * (static_cast<double>(buf[slot(seg + first + kk)]) -
                     beta_k * static_cast<double>(lag));
      }
    }
    double a = 1.0, b = 0.0;
#pragma unroll
    for (int kk = 0; kk < CHUNK; ++kk) {
      if (kk < steps) {
        b = beta * b + v[kk];
        a *= beta;
      }
    }

    // (2) inclusive scan of the maps within the warp's part of the segment,
    // shifted by one lane, then after the totals of the segment's earlier
    // warps: the map of all chunks before this one
    const int pos = lane & (width - 1);
    for (int off = 1; off < width; off <<= 1) {
      const double a_up = __shfl_up_sync(FULL, a, off, width);
      const double b_up = __shfl_up_sync(FULL, b, off, width);
      if (pos >= off) {
        b = a * b_up + b;
        a *= a_up;
      }
    }
    double a_in = __shfl_up_sync(FULL, a, 1, width);
    double b_in = __shfl_up_sync(FULL, b, 1, width);
    if (pos == 0) {
      a_in = 1.0;
      b_in = 0.0;
    }
    if (lane == WARP - 1) {
      tot_a[warp] = a;
      tot_b[warp] = b;
    }
    __syncthreads();  // the totals written, the staged steps all read
    double pa = 1.0, pb = 0.0;
    for (int w = warp & ~((lanes >> 5) - 1); lanes > WARP && w < warp; ++w) {
      pb = tot_a[w] * pb + tot_b[w];
      pa *= tot_a[w];
    }

    // (3) the chunk rerun from its entering value, into the staged slots
    double o = a_in * (pa * carry + pb) + b_in;
#pragma unroll
    for (int kk = 0; kk < CHUNK; ++kk) {
      if (kk < steps) {
        o = beta * o + v[kk];
        buf[slot(seg + first + kk)] = __double2float_rn(o);
      }
    }
    // the carry: the value after the row's last step, from the thread that
    // took it (only a row of one segment per block has another tile)
    if (s == (len - 1) / CHUNK) carry_s[g] = o;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int f = threadIdx.x + j * THREADS;
      const int tt = f & (seg_tile - 1);
      const long long r = row0 + (f >> seg_log2);
      if (tt < len && r < rows) out[r * (t + 1) + 1 + base + tt] = buf[slot(f)];
    }
    carry = carry_s[g];
    __syncthreads();  // the next tile overwrites the staged slots and totals
  }
}

}  // namespace

// y: (rows, t) float32, out: (rows, t + 1); beta, c, beta_k: the
// recurrence's coefficients for k taps.
extern "C" int volt_ewma_filter(const float* y, float* out, int rows, int t, int k,
                                double beta, double c, double beta_k,
                                cudaStream_t stream) {
  int lanes_log2 = 0;  // the least L = 2^lanes_log2 with L * CHUNK >= t
  while (lanes_log2 < MAX_LANES_LOG2 && (CHUNK << lanes_log2) < t) ++lanes_log2;
  const int per_block_log2 = MAX_LANES_LOG2 - lanes_log2;  // rows per block
  const int blocks = static_cast<int>(
      (static_cast<long long>(rows) + (1 << per_block_log2) - 1) >> per_block_log2);
  ewma_filter_kernel<<<blocks, THREADS, 0, stream>>>(y, out, rows, t, k, lanes_log2, beta,
                                                     c, beta_k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* volt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

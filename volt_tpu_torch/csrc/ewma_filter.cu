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
// What bounds it on the card: each output is k FMAs over k taps and k
// inputs, so the work is k * rows * (T + 1) FMAs over only rows * (2T + 1)
// floats of device memory.  At the main path's shape (64 rows, T = 999,
// k = 300) that is 19 MFLOP and 0.5 MB, far below what fills an H100: the
// call is launch latency (0.02 ms on an H100 SXM, 700 W limit; the plain
// cuDNN conv1d 0.06 ms).  At 4096 rows it runs at about 10 TFLOP/s
// (0.24 ms), the rate of two shared-memory loads per FMA, one of them a
// broadcast; keeping taps and inputs in registers across several outputs
// per thread is the next step for speed.
//
// Design: the FIR directly, no band matrix.  One block covers one row and
// a tile of TILE outputs, one output per thread.  The taps and the row
// segment [tile_start + c0, tile_start + c0 + TILE + kc - 1) are staged in
// shared memory in chunks of KCHUNK taps, so any k >= 1 works (k > T too)
// within a fixed 9 KB of static shared memory.  The k copies of y[0] in
// the left pad are produced by index, never materialised.  Neighbouring
// threads read neighbouring shared words (no bank conflicts) and the tap
// is a broadcast.  Accumulation is float32, oldest tap first.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;
constexpr int KCHUNK = 1024;
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(TILE)
ewma_filter_kernel(const float* __restrict__ y, const float* __restrict__ w,
                   float* __restrict__ out, int rows, int t, int k) {
  __shared__ float w_s[KCHUNK];
  __shared__ float seg_s[TILE + KCHUNK - 1];
  const int out_len = t + 1;
  const int j0 = blockIdx.x * TILE;
  const int j = j0 + threadIdx.x;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* yr = y + static_cast<long long>(r) * t;
    const float y0 = yr[0];
    float acc = 0.f;
    for (int c0 = 0; c0 < k; c0 += KCHUNK) {
      const int kc = min(KCHUNK, k - c0);
      for (int i = threadIdx.x; i < kc; i += TILE) w_s[i] = w[c0 + i];
      const int seg_len = TILE + kc - 1;
      for (int i = threadIdx.x; i < seg_len; i += TILE) {
        const long long p = static_cast<long long>(j0) + c0 + i;
        float v = 0.f;  // past the series: only read for masked outputs
        if (p < k) {
          v = y0;
        } else if (p - k < t) {
          v = yr[p - k];
        }
        seg_s[i] = v;
      }
      __syncthreads();
      if (j < out_len) {
        for (int i = 0; i < kc; ++i) acc = fmaf(w_s[i], seg_s[threadIdx.x + i], acc);
      }
      __syncthreads();
    }
    if (j < out_len) out[static_cast<long long>(r) * out_len + j] = acc;
  }
}

}  // namespace

// y: (rows, t) float32, w: (k,) float32 taps oldest first, out: (rows, t + 1).
extern "C" int volt_ewma_filter(const float* y, const float* w, float* out,
                                int rows, int t, int k, cudaStream_t stream) {
  const dim3 grid((t + 1 + TILE - 1) / TILE, rows < MAX_GRID_Y ? rows : MAX_GRID_Y);
  ewma_filter_kernel<<<grid, TILE, 0, stream>>>(y, w, out, rows, t, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* volt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The dense Volt covariance K[b, i, j] = I[b, min(i, j)].
//
// Replaces the TPU kernel volt_tpu/ops/pallas/volt_cov.py
// `_volt_covariance_padded` (body `_kernel`), which wrote 256 x 256 tiles
// by a broadcast-compare-select on the VPU after padding N to a multiple
// of 256.  As there, the O(N) running integral I = cumsum(w vol^2) is
// computed outside (by the wrapper, in torch) and the kernel owns the
// O(N^2) expansion.
//
// What bounds it on the card: the output is pure stores, B N^2 floats,
// against B N floats read.  At the main shape (64, 999) that is 255 MB,
// about 76 us at the H100's 3.35 TB/s, so the kernel is bound by store
// bandwidth, and the design's job is to keep every store full width.
//
// Design: one block writes a TILE_R x TILE_C tile of one matrix.  The
// tile's TILE_R row entries and TILE_C column entries of I are staged in
// shared memory; a warp writes one row of the tile at a time, neighbouring
// lanes on neighbouring columns.  A row starts at element (b N + i) N + c0,
// which is 16-byte aligned only when that index is a multiple of 4, so
// each row is written as a scalar head up to the next aligned element, a
// body of float4 stores, and a scalar tail.  The ragged edges (N not a
// multiple of the tile) are masked by index: there is no padding.  Offsets
// are 64-bit, so B N^2 may pass 2^31.  Values are copies of I, so the
// result equals the plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_R = 32;
constexpr int TILE_C = 512;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GRID_Z = 65535;

__global__ void __launch_bounds__(THREADS)
volt_cov_kernel(const float* __restrict__ integral, float* __restrict__ out,
                int rows, int n) {
  __shared__ float row_s[TILE_R];
  __shared__ float col_s[TILE_C];
  const int c0 = blockIdx.x * TILE_C;
  const int r0 = blockIdx.y * TILE_R;
  const int c_end = min(c0 + TILE_C, n);
  const int r_end = min(r0 + TILE_R, n);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int b = blockIdx.z; b < rows; b += gridDim.z) {
    const float* ib = integral + static_cast<long long>(b) * n;
    for (int c = threadIdx.x; c < c_end - c0; c += THREADS) col_s[c] = ib[c0 + c];
    if (threadIdx.x < r_end - r0) row_s[threadIdx.x] = ib[r0 + threadIdx.x];
    __syncthreads();
    for (int i = r0 + warp; i < r_end; i += WARPS) {
      const float ri = row_s[i - r0];
      const long long row = (static_cast<long long>(b) * n + i) * n;
      float* orow = out + row;
      // element j of this row: I[i] where i <= j, else I[j]
      const int head = min(static_cast<int>((4 - ((row + c0) & 3)) & 3), c_end - c0);
      if (lane < head) {
        const int j = c0 + lane;
        orow[j] = i <= j ? ri : col_s[j - c0];
      }
      const int jb = c0 + head;
      const int body = (c_end - jb) >> 2;
      float4* ov = reinterpret_cast<float4*>(orow + jb);
      for (int q = lane; q < body; q += 32) {
        const int j = jb + 4 * q;
        const float* cs = col_s + (j - c0);
        float4 v;
        v.x = i <= j ? ri : cs[0];
        v.y = i <= j + 1 ? ri : cs[1];
        v.z = i <= j + 2 ? ri : cs[2];
        v.w = i <= j + 3 ? ri : cs[3];
        ov[q] = v;
      }
      const int j = jb + 4 * body + lane;
      if (j < c_end) orow[j] = i <= j ? ri : col_s[j - c0];
    }
    __syncthreads();
  }
}

}  // namespace

// integral: (rows, n) float32; out: (rows, n, n) float32, 16-byte aligned.
extern "C" int volt_covariance(const float* integral, float* out, int rows,
                               int n, cudaStream_t stream) {
  const dim3 grid((n + TILE_C - 1) / TILE_C, (n + TILE_R - 1) / TILE_R,
                  rows < MAX_GRID_Z ? rows : MAX_GRID_Z);
  volt_cov_kernel<<<grid, THREADS, 0, stream>>>(integral, out, rows, n);
  return static_cast<int>(cudaGetLastError());
}

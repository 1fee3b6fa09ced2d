// The affine maps z -> a z + b of a first-order linear recurrence, and a
// block's exclusive scan of them in thread order: the chunked scans of G1
// (gpcv_elbo.cu) and G3 (mt_gpcv_elbo.cu).
#pragma once

namespace volt {

// z -> a z + b
struct Affine {
  double a, b;
  __device__ static Affine identity() { return {1.0, 0.0}; }
  // this map applied after `x`
  __device__ Affine after(const Affine& x) const { return {a * x.a, a * x.b + b}; }
  __device__ Affine shfl(int src) const {
    return {__shfl_sync(0xffffffffu, a, src), __shfl_sync(0xffffffffu, b, src)};
  }
};

// Exclusive scan of the threads' maps in thread order (from the last
// thread when `reverse`) over a block of WARPS warps: the composition of
// the maps of all threads before this one, the latest applied last.
// `totals` holds WARPS maps of shared memory.
template <int WARPS>
__device__ Affine exclusive_scan(Affine x, bool reverse, Affine* totals) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pos = reverse ? 31 - lane : lane;  // place in scan order
  const int wpos = reverse ? WARPS - 1 - warp : warp;
  const int back = reverse ? 1 : -1;           // lane step to earlier maps
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Affine y = x.shfl(lane + back * off);
    if (pos >= off) x = x.after(y);
  }
  if (pos == 31) totals[wpos] = x;
  Affine ex = x.shfl(lane + back);
  if (pos == 0) ex = Affine::identity();
  __syncthreads();
  Affine before = Affine::identity();
  for (int w = 0; w < wpos; ++w) before = totals[w].after(before);
  __syncthreads();  // totals is reused by the next scan
  return ex.after(before);
}

}  // namespace volt

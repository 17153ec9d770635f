// K8: any-hit occlusion over a two-level BVH (instanced scenes), for one
// wave of world-space shadow rays.
//
// Replaces sfvp_tpu/kernels/bvh_tlas.py, make_two_level_occlusion (kernel
// body from :477, pallas_call at :666): the wavefront loop's shadow-ray
// test of instanced scenes under next-event estimation. One thread owns one
// ray of the (N,) wave, reads its 7 planes (an inactive ray has t_max =
// -inf) and writes one byte, whether a triangle of any instance lies in
// (t_min, t_max) along it (two_level.cuh two_level_any_hit).
//
// What bounds it on an H100: as for K4 (bvh_occlusion.cu), dependent loads
// from the L2-resident tables and divergence; its own traffic is 29 bytes
// a ray. What the simple design does about it: a ray stops at its first
// hit, carries no payload and re-derives its object-space ray only when
// the popped context changes. Left for later work: K3's list.
#include "two_level.cuh"

namespace sfvp {

__global__ void __launch_bounds__(kBlock)
tlas_occlusion_kernel(const TwoLevel g, const float* __restrict__ rays,
                      int n, uint8_t* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t m = n;
  if (i >= m) return;
  out[i] = two_level_any_hit(g, rays[i], rays[m + i], rays[2 * m + i],
                             rays[3 * m + i], rays[4 * m + i],
                             rays[5 * m + i], rays[6 * m + i]);
}

}  // namespace sfvp

// rays: (7, n) world-space planes ox oy oz dx dy dz tmax; out: n bytes, 0
// or 1 (a torch.bool tensor); n is below 2**31. Returns cudaGetLastError()
// of the launch on ``stream``.
extern "C" int sfvp_tlas_occlusion(const sfvp::TwoLevel* g,
                                   const float* rays, int n, uint8_t* out,
                                   void* stream) {
  const unsigned blocks =
      (unsigned)(((size_t)n + sfvp::kBlock - 1) / sfvp::kBlock);
  sfvp::tlas_occlusion_kernel<<<blocks, sfvp::kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      *g, rays, n, out);
  return static_cast<int>(cudaGetLastError());
}

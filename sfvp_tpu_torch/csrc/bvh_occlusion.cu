// K4: any-hit occlusion over the 8-wide BVH, for one wave of shadow rays.
//
// Replaces sfvp_tpu/kernels/bvh_packet.py, make_packet_occlusion (kernel
// body from :469, pallas_call at :635): the wavefront loop's shadow-ray
// test under next-event estimation. One thread owns one ray of the (N,)
// wave, reads its 7 planes (o, d, t_max; an inactive ray has t_max = -inf)
// and writes one byte, whether a triangle lies in (t_min, t_max) along it
// (wide_bvh.cuh wide_any_hit).
//
// What bounds it on an H100: as for K3 (bvh_trace.cu), dependent node and
// leaf loads from the L2-resident tree and divergence; its own traffic is
// 29 bytes a ray. What the design does about it: a ray stops at its
// first hit and carries no payload, and the TPU kernel's packet (every ray
// of a 1024-ray packet walks any subtree one of them enters) becomes one
// walk per ray, which reads half a node row and a leaf slot at a time by
// 16-byte loads (wide_bvh.cuh; about a third off the city's shadow wave,
// PERF.md). Left for later work: the ray reordering and persistent
// threads of K3's list.
#include "wide_bvh.cuh"

namespace sfvp {

__global__ void __launch_bounds__(kBlock)
bvh_occlusion_kernel(const Wide w, const float* __restrict__ rays, int n,
                     uint8_t* __restrict__ out) {
  // plane offsets in size_t, as K3's
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t m = n;
  if (i >= m) return;
  out[i] = wide_any_hit(w, rays[i], rays[m + i], rays[2 * m + i],
                        rays[3 * m + i], rays[4 * m + i], rays[5 * m + i],
                        rays[6 * m + i]);
}

}  // namespace sfvp

// rays: (7, n) planes ox oy oz dx dy dz tmax; out: n bytes, 0 or 1 (a
// torch.bool tensor); n is below 2**31 (kernels/build.py
// launch_bvh_occlusion checks). Returns cudaGetLastError() of the launch
// on ``stream``.
extern "C" int sfvp_bvh_occlusion(const sfvp::Wide* w, const float* rays,
                                  int n, uint8_t* out, void* stream) {
  const unsigned blocks =
      (unsigned)(((size_t)n + sfvp::kBlock - 1) / sfvp::kBlock);
  sfvp::bvh_occlusion_kernel<<<blocks, sfvp::kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      *w, rays, n, out);
  return static_cast<int>(cudaGetLastError());
}

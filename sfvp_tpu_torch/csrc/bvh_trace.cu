// K3: closest hit plus shading payload over the 8-wide BVH, for one wave of
// rays.
//
// Replaces sfvp_tpu/kernels/bvh_packet.py, make_packet_trace (kernel body
// from :118, pallas_call at :394): the wavefront loop's per-bounce trace
// of large scenes. One thread owns one ray of the (N,) wave, walks the tree
// with its own stack (wide_bvh.cuh) and writes the 19 planes of the
// Payload: t, u, v, the hit triangle's three vertices, albedo, emission
// and packed material type (zeros and t = +inf on a miss), and on a
// textured tree the hit's interpolated vt and texid+1 (22 planes, from the
// aux rows, sfvp_tpu bvh_packet.py:95-97, :278-334).
//
// What bounds it on an H100: dependent loads and divergence, not bytes.
// Each pop reads one 256-byte node prefix or one 512-byte leaf row at an
// address that depends on the previous pop, and the 32 rays of a warp walk
// different paths. The tree (node and leaf rows, accel/wide.py: 10.4 MB for
// the 100k sphere, 57.8 MB for the 500k one): the 100k tree fits the 50 MB
// L2, so after the first touches most loads hit in L2 or L1; the 500k tree
// does not, and part of its rows come from HBM.
// What the design does about it: the walk reads a node row by 16 and a
// leaf slot by 3 16-byte loads (wide_bvh.cuh), not lane by lane, which
// took ~18% off a first-bounce launch (PERF.md); the per-ray stack lives
// in local memory (L1-cached). Left for later work: ray reordering for
// coherent warps, a compact node format, persistent threads that fetch
// new rays.
#include "wide_bvh.cuh"

namespace sfvp {

__global__ void __launch_bounds__(kBlock)
bvh_trace_kernel(const Wide w, const float* __restrict__ rays, int n,
                 float* __restrict__ out) {
  // plane offsets in size_t: 19 planes of a wave past 113M rays pass 2**31
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t m = n;
  if (i >= m) return;
  const WideHit h = wide_closest_hit(
      w, rays[i], rays[m + i], rays[2 * m + i], rays[3 * m + i],
      rays[4 * m + i], rays[5 * m + i], rays[6 * m + i]);
  write_payload(w, out, m, i, h.t, h.u, h.v, h.row, h.slot);
}

}  // namespace sfvp

// rays: (7, n) planes ox oy oz dx dy dz tmax; out: (19, n) planes, (22, n)
// with w->aux; n is
// below 2**31 (kernels/build.py launch_bvh_trace checks). Returns
// cudaGetLastError() of the launch on ``stream``.
extern "C" int sfvp_bvh_trace(const sfvp::Wide* w, const float* rays, int n,
                              float* out, void* stream) {
  const unsigned blocks =
      (unsigned)(((size_t)n + sfvp::kBlock - 1) / sfvp::kBlock);
  sfvp::bvh_trace_kernel<<<blocks, sfvp::kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(*w, rays, n,
                                                                out);
  return static_cast<int>(cudaGetLastError());
}

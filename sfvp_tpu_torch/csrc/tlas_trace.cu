// K7: closest hit plus shading payload over a two-level BVH (instanced
// scenes), for one wave of world-space rays.
//
// Replaces sfvp_tpu/kernels/bvh_tlas.py, make_two_level_trace (kernel body
// from :107, pallas_call at :403): the wavefront loop's per-bounce trace
// of instanced scenes. One thread owns one ray of the (N,) wave, walks the
// TLAS and the instanced BLASes on its own stack of codes, each entry's
// instance context derived from its stack index (two_level.cuh), and
// writes K3's 19 payload planes: t, u, v, the hit triangle's three
// vertices in WORLD space, albedo, emission and packed material type
// (zeros and t = +inf on a miss).
//
// What bounds it on an H100, as measured (NVIDIA H100 80GB HBM3, 700 W;
// five variants of the walk timed against each other by chip_ab.py,
// PERF.md): the row loads. A node pop read its row's 64 used lanes and a
// leaf pop its 8 slots' 72 vertex lanes by scalar loads, and on a warp
// whose lanes pop different rows each load splits into up to 32
// requests. The two local-memory stacks, the instance pops' extra loop
// trips and the re-derived ray cost a few percent; divergence between
// node and leaf pops did not pay to separate. What the design does about
// it: 16-byte loads (16 a node row, 3 a leaf slot), one stack, and the
// BLAS root expanded in its instance pop's trip: 0.83 -> 0.60 ms a launch
// on the 220k field's 1M-ray first bounce, 1.03 -> 0.73 on its third
// (29% off; the walk, and so the payload, bit for bit the same). Left
// for later work: the tests' own arithmetic and divergence, and K3's list
// (ray reordering, a compact node format, persistent threads).
#include "two_level.cuh"

namespace sfvp {

__global__ void __launch_bounds__(kBlock)
tlas_trace_kernel(const TwoLevel g, const float* __restrict__ rays, int n,
                  float* __restrict__ out) {
  // plane offsets in size_t, as K3's
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t m = n;
  if (i >= m) return;
  const TwoLevelHit h = two_level_closest_hit(
      g, rays[i], rays[m + i], rays[2 * m + i], rays[3 * m + i],
      rays[4 * m + i], rays[5 * m + i], rays[6 * m + i]);
  out[i] = h.t;
  out[m + i] = h.u;
  out[2 * m + i] = h.v;
  if (h.row >= 0) {
    const float* s = g.tris + (size_t)h.row * kRowLanes + 16 * h.slot;
    float p[9];
    tl_vertices(g, h, s, p);
    for (int j = 0; j < 9; ++j) out[(3 + j) * m + i] = p[j];
    for (int j = 9; j < 16; ++j) out[(3 + j) * m + i] = __ldg(s + j);
  } else {
    for (int j = 0; j < 16; ++j) out[(3 + j) * m + i] = 0.0f;
  }
}

}  // namespace sfvp

// rays: (7, n) world-space planes ox oy oz dx dy dz tmax; out: (19, n)
// planes; n is below 2**31 (kernels/build.py _launch_wave checks). Returns
// cudaGetLastError() of the launch on ``stream``.
extern "C" int sfvp_tlas_trace(const sfvp::TwoLevel* g, const float* rays,
                               int n, float* out, void* stream) {
  const unsigned blocks =
      (unsigned)(((size_t)n + sfvp::kBlock - 1) / sfvp::kBlock);
  sfvp::tlas_trace_kernel<<<blocks, sfvp::kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(*g, rays, n,
                                                                 out);
  return static_cast<int>(cudaGetLastError());
}

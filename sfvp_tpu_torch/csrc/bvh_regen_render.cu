// K5: path tracer with in-thread sample regeneration over the 8-wide BVH.
//
// Replaces sfvp_tpu/kernels/megakernel_bvh.py, make_bvh_regen_render_step
// (single-level kernel built in build_kernel, pallas_call at :2326), for
// the slice the port runs: diffuse and mirror materials, uniform or cosine
// sampling, Russian roulette with a roulette number drawn at every bounce
// (megakernel_bvh.py:2173-2182), next-event estimation toward the area
// lights with balance-heuristic MIS, whose shadow rays take the any-hit
// walk of wide_bvh.cuh (the TPU kernel's second packet traversal per
// bounce, shadow_occluded, megakernel_bvh.py:1447-1710). One thread owns
// one pixel and runs its spp
// samples back to back, K1's loop (regen_render.cu) with the brute-force
// triangle loop replaced by the wide-BVH walk of wide_bvh.cuh; each
// segment's radiance is added straight into the pixel total. The pixel of
// a thread is its row-major index: each pixel's random streams come from
// its global coordinates, so the TPU kernel's tile swizzle changes nothing
// here.
//
// What bounds it on an H100: the traversal, as for K3 (dependent node and
// leaf loads from an L2-resident tree, warp divergence), plus the
// shading arithmetic per segment. Device-memory traffic of its own is 16
// bytes per pixel. What the simple design does about it: a thread that
// ends a path starts the next sample at once, so no lane waits for a
// wave's longest path; there is no per-bounce relaunch, sort or payload
// round trip through device memory, which the wavefront route (K3) pays.
#include "wide_bvh.cuh"

namespace sfvp {

template <bool HAS_MIRRORS, bool NEE>
__global__ void __launch_bounds__(kBlock)
bvh_regen_kernel(const Wide w, const float* __restrict__ lights,
                 const Params p, float* __restrict__ colr,
                 float* __restrict__ colg, float* __restrict__ colb,
                 int* __restrict__ segs_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.npix) return;
  const int px = i % p.gw;
  const int py = i / p.gw + p.row0;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int segs = 0;
  for (int s = 0; s < p.spp; ++s) {
    Path q = camera_path(px, py, s, p);
    for (int depth = 0; depth < p.max_depth; ++depth) {
      ++segs;
      const WideHit h =
          wide_closest_hit(w, q.ox, q.oy, q.oz, q.dx, q.dy, q.dz, p.t_max);
      if (h.row < 0) {
        add_sky(p, q, cr, cg, cb);
        break;
      }
      const Surface f = wide_surface(w, h);
      if (!shade_hit<HAS_MIRRORS, NEE, true>(
              p, lights, depth, h.t, f, q, cr, cg, cb,
              [&](float ox, float oy, float oz, float dx, float dy, float dz,
                  float smax) {
                return wide_any_hit(w, ox, oy, oz, dx, dy, dz, smax);
              }))
        break;
    }
  }
  colr[i] = cr;
  colg[i] = cg;
  colb[i] = cb;
  segs_out[i] = segs;
}

}  // namespace sfvp

namespace {

template <bool HAS_MIRRORS, bool NEE>
int launch(const sfvp::Wide* w, const float* lights, const sfvp::Params* p,
           float* colr, float* colg, float* colb, int* segs,
           cudaStream_t st) {
  const int blocks = (p->npix + sfvp::kBlock - 1) / sfvp::kBlock;
  sfvp::bvh_regen_kernel<HAS_MIRRORS, NEE><<<blocks, sfvp::kBlock, 0, st>>>(
      *w, lights, *p, colr, colg, colb, segs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lights: the (16, p->num_lights) light table when p->use_nee, else
// unused. Outputs are per pixel (p->npix each); returns cudaGetLastError()
// of the launch on ``stream``.
extern "C" int sfvp_bvh_regen_render(const sfvp::Wide* w, const float* lights,
                                     const sfvp::Params* p, int has_mirrors,
                                     float* colr, float* colg, float* colb,
                                     int* segs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->use_nee)
    return has_mirrors
               ? launch<true, true>(w, lights, p, colr, colg, colb, segs, st)
               : launch<false, true>(w, lights, p, colr, colg, colb, segs, st);
  return has_mirrors
             ? launch<true, false>(w, lights, p, colr, colg, colb, segs, st)
             : launch<false, false>(w, lights, p, colr, colg, colb, segs, st);
}

// K5 and K9: path tracer with in-thread sample regeneration over the 8-wide
// BVH (K5) or over the two-level BVH of an instanced scene (K9).
//
// K5 replaces sfvp_tpu/kernels/megakernel_bvh.py, make_bvh_regen_render_step
// (single-level kernel built in build_kernel, pallas_call at :2326):
// diffuse, mirror, GGX glossy and smooth dielectric materials decoded from
// the leaf's packed material lane (megakernel_bvh.py:1388-1445,
// :1895-2017, :2107-2170; wide_bvh.cuh slot_surface, common.cuh ggx_*,
// dielectric_dir), the thin-lens camera (:411-420, :683-700), uniform or
// cosine sampling, Russian roulette with a roulette number drawn at every
// bounce
// (megakernel_bvh.py:2173-2182), next-event estimation toward the area
// lights with balance-heuristic MIS, whose shadow rays take the any-hit
// walk of wide_bvh.cuh (the TPU kernel's second packet traversal per
// bounce, shadow_occluded, megakernel_bvh.py:1447-1710), an equirect
// environment sky with its importance-sampled NEE and map_Kd textures
// from a textured tree's aux rows (megakernel_bvh.py:303-400; K1's
// fetches, common.cuh, at any map size: the TPU kernel's deferred env
// records and pooled-proposal routing have no counterpart). One thread owns
// one pixel and runs its spp
// samples back to back, K1's loop (regen_render.cu) with the brute-force
// triangle loop replaced by the wide-BVH walk of wide_bvh.cuh; each
// segment's radiance is added straight into the pixel total. The pixel of
// a thread is its row-major index: each pixel's random streams come from
// its global coordinates, so the TPU kernel's tile swizzle changes nothing
// here.
//
// K9 replaces the same function with ``tl=`` (megakernel_bvh.py:52,
// pallas_call at :2326; two-level code at :111-183, :742-1267, the shadow
// walk at :1447-1707, the deferred world transform at :1327-1350): the same
// kernel over the two-level walks of two_level.cuh, the closest hit shaded
// from its world-space vertices (tl_surface) and the shadow rays through
// the two-level any-hit walk. Lights and materials for NEE come from the
// flattened scene's light table, as the TPU kernel's do; materials, the
// thin lens and their shading are K5's. The TPU kernel's appended
// identity instance row (megakernel_bvh.py:136-146) only spares
// its vector selects; here a world-space entry takes the ray as it is.
//
// What bounds it on an H100: the traversal, as for K3 (dependent node and
// leaf loads from an L2-resident tree, warp divergence), plus the
// shading arithmetic per segment; K9 adds the instance pops and the
// object-space rays. Device-memory traffic of its own is 16 bytes per
// pixel. What the design does about it: there is no per-bounce relaunch,
// sort or payload round trip through device memory, which the wavefront
// route (K3, K7) pays; a lane whose path ends waits for its warp's lanes
// to leave the loop over depths, then starts its next sample (K1's one
// trip a segment, tried here, gained on the sphere and lost on the
// city). As measured (NVIDIA H100 80GB HBM3, 700 W; variants of the
// walks timed against each other by chip_ab.py, PERF.md), the walks'
// row loads bound both kernels, and then their registers: the walks read
// their rows by 16-byte loads (wide_bvh.cuh, two_level.cuh), which raised
// the NEE and material kernels to 94-128 registers, 4-5 blocks an SM. So
// each walk's kernel carries a launch bound (Walk::kMinBlocks): K9's 7
// blocks an SM (72 registers, up to ~350 bytes of spills, which cost
// less than the lost warps; the field's step 45.8 -> 35.0 ms, the lit
// field's 51.3 -> 42.8, the glossy lit field's 84.9 -> 73.3) and K5's 6
// (80 registers; 5 blocks gained less), bit for bit the same images.
// K9's shadow walks were ~39% of the lit step and ~21% of the glossy one
// (run twice a shadow ray, they added that much to each); the
// any-hit walk with the closest hit's 16-byte loads, one stack and
// folded instance pops took them 43.1 -> 39.1 and 73.9 -> 68.4 ms, and
// 7 blocks an SM still beat 6 and 8.
#include "two_level.cuh"

namespace sfvp {

// The walks of the single-level tree (K5). kMinBlocks: the blocks of
// kBlock threads an SM must hold, K5's launch bound (regen_walk_kernel).
struct WideWalk {
  static constexpr int kMinBlocks = 6;
  Wide w;
  template <bool IMG>
  __device__ __forceinline__ bool closest(const Path& q, const Params& p,
                                          float& t, Surface& f) const {
    const WideHit h =
        wide_closest_hit(w, q.ox, q.oy, q.oz, q.dx, q.dy, q.dz, p.t_max);
    if (h.row < 0) return false;
    t = h.t;
    f = wide_surface<IMG>(w, h, p);
    return true;
  }
  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float smax) const {
    return wide_any_hit(w, ox, oy, oz, dx, dy, dz, smax);
  }
};

// The walks of the two-level tree (K9), which has neither textures nor an
// environment map (the wrapper refuses them, ROADMAP.md A.13b): the
// closest hit and, for the shadow rays, the any-hit walk of K8's threads
// (two_level.cuh), one ray a call. kMinBlocks: K9's launch bound.
struct TwoLevelWalk {
  static constexpr int kMinBlocks = 7;
  TwoLevel g;
  template <bool IMG>
  __device__ __forceinline__ bool closest(const Path& q, const Params& p,
                                          float& t, Surface& f) const {
    const TwoLevelHit h = two_level_closest_hit(g, q.ox, q.oy, q.oz, q.dx,
                                                q.dy, q.dz, p.t_max);
    if (h.row < 0) return false;
    t = h.t;
    f = tl_surface(g, h);
    return true;
  }
  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float smax) const {
    return two_level_any_hit(g, ox, oy, oz, dx, dy, dz, smax);
  }
};

// One pixel a thread, its samples back to back: K5 over a WideWalk, K9
// over a TwoLevelWalk, at least Walk::kMinBlocks blocks an SM. MAT (GGX
// or dielectric faces) and DOF (the thin lens) are compiled only into the
// kernels of scenes and cameras that have them, as IMG is.
template <class Walk, bool HAS_MIRRORS, bool NEE, bool IMG, bool MAT,
          bool DOF>
__global__ void __launch_bounds__(kBlock, Walk::kMinBlocks)
regen_walk_kernel(const Walk walk, const float* __restrict__ lights,
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
    Path q = camera_path<DOF>(px, py, s, p);
    for (int depth = 0; depth < p.max_depth; ++depth) {
      ++segs;
      float t;
      Surface f;
      if (!walk.template closest<IMG>(q, p, t, f)) {
        add_miss<NEE, IMG>(p, q, cr, cg, cb);
        break;
      }
      if (!shade_hit<HAS_MIRRORS, NEE, true, IMG, MAT>(
              p, lights, depth, t, f, q, cr, cg, cb,
              [&](float ox, float oy, float oz, float dx, float dy, float dz,
                  float smax) {
                return walk.occluded(ox, oy, oz, dx, dy, dz, smax);
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

template <class Walk, bool HAS_MIRRORS, bool NEE, bool IMG, bool MAT,
          bool DOF>
int launch(const Walk& walk, const float* lights, const sfvp::Params* p,
           float* colr, float* colg, float* colb, int* segs,
           cudaStream_t st) {
  const int blocks = (p->npix + sfvp::kBlock - 1) / sfvp::kBlock;
  sfvp::regen_walk_kernel<Walk, HAS_MIRRORS, NEE, IMG, MAT, DOF>
      <<<blocks, sfvp::kBlock, 0, st>>>(walk, lights, *p, colr, colg, colb,
                                         segs);
  return static_cast<int>(cudaGetLastError());
}

// IMG: an environment map or textures, which only the single-level walk
// takes (K9 refuses them until ROADMAP.md A.13b). Scenes with GGX or
// dielectric faces or an open lens take kernels with that code (MAT, DOF),
// which check for mirrors at run time.
template <class Walk, bool NEE, bool IMG>
int launch_mirrors(const Walk& walk, const float* lights,
                   const sfvp::Params* p, int has_mirrors, float* colr,
                   float* colg, float* colb, int* segs, cudaStream_t st) {
  if (p->use_mat && p->use_dof)
    return launch<Walk, true, NEE, IMG, true, true>(walk, lights, p, colr,
                                                    colg, colb, segs, st);
  if (p->use_mat)
    return launch<Walk, true, NEE, IMG, true, false>(walk, lights, p, colr,
                                                     colg, colb, segs, st);
  if (p->use_dof)
    return launch<Walk, true, NEE, IMG, false, true>(walk, lights, p, colr,
                                                     colg, colb, segs, st);
  return has_mirrors
             ? launch<Walk, true, NEE, IMG, false, false>(walk, lights, p,
                                                          colr, colg, colb,
                                                          segs, st)
             : launch<Walk, false, NEE, IMG, false, false>(walk, lights, p,
                                                           colr, colg, colb,
                                                           segs, st);
}

template <class Walk, bool CAN_IMG>
int launch_any(const Walk& walk, const float* lights, const sfvp::Params* p,
               int has_mirrors, float* colr, float* colg, float* colb,
               int* segs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool nee = p->use_nee || p->use_env_nee;
  if constexpr (CAN_IMG) {
    if (p->use_env || p->use_tex)
      return nee ? launch_mirrors<Walk, true, true>(walk, lights, p,
                                                    has_mirrors, colr, colg,
                                                    colb, segs, st)
                 : launch_mirrors<Walk, false, true>(walk, lights, p,
                                                     has_mirrors, colr, colg,
                                                     colb, segs, st);
  } else {
    if (p->use_env || p->use_tex)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return nee ? launch_mirrors<Walk, true, false>(walk, lights, p, has_mirrors,
                                                 colr, colg, colb, segs, st)
             : launch_mirrors<Walk, false, false>(walk, lights, p,
                                                  has_mirrors, colr, colg,
                                                  colb, segs, st);
}

}  // namespace

// lights: the (16, p->num_lights) light table when p->use_nee, else
// unused. Outputs are per pixel (p->npix each); each returns
// cudaGetLastError() of the launch on ``stream``.
extern "C" int sfvp_bvh_regen_render(const sfvp::Wide* w, const float* lights,
                                     const sfvp::Params* p, int has_mirrors,
                                     float* colr, float* colg, float* colb,
                                     int* segs, void* stream) {
  return launch_any<sfvp::WideWalk, true>(sfvp::WideWalk{*w}, lights, p,
                                          has_mirrors, colr, colg, colb, segs,
                                          stream);
}

extern "C" int sfvp_tlas_regen_render(const sfvp::TwoLevel* g,
                                      const float* lights,
                                      const sfvp::Params* p, int has_mirrors,
                                      float* colr, float* colg, float* colb,
                                      int* segs, void* stream) {
  return launch_any<sfvp::TwoLevelWalk, false>(sfvp::TwoLevelWalk{*g},
                                               lights, p, has_mirrors, colr,
                                               colg, colb, segs, stream);
}

// K1: brute-force path tracer with in-thread sample regeneration.
//
// Replaces sfvp_tpu/kernels/megakernel_regen.py, make_regen_render_step
// (kernel body in build_kernel, pallas_call at :1137), for the slice the
// port runs: diffuse and mirror materials, uniform or cosine sampling,
// Russian roulette, next-event estimation toward the area lights with
// balance-heuristic MIS, an equirect environment sky with its own
// importance-sampled NEE (alone or beside the area lights), and map_Kd
// textures (env/tex at megakernel_regen.py:144-218; the TPU's one-hot MXU
// fetch, atlas gate and deferred env records have no counterpart: the
// texel pool and the environment's CDF are read from device memory
// through L1, common.cuh env_lookup, texel_bilinear, env_sample). One
// thread owns one pixel and runs its spp
// samples back to back, the shape of the reference's raygen shader
// (raygen.rgen:41-91): seed -> camera ray -> up to max_depth segments of
// closest hit against every triangle -> shade -> next direction -> RR.
// Each segment's radiance is added straight into the pixel's running total,
// in the order of megakernel_regen.py:629-631.
//
// What bounds it on an H100: arithmetic in the triangle loop. The Cornell
// Box has 36 triangles and a segment tests all of them at ~30 flops plus
// one division each; the only device-memory traffic is the scene table
// (read once per block) and four output words per pixel.
// What the simple design does about it: the table (26 rows of float32 per
// triangle, 33 textured) sits in shared memory with its edges precomputed,
// as dynamic shared memory up to the 227 KB a block may opt in to (2,235
// triangles, 1,760 textured), so the loop reads broadcast shared words and
// does no global loads; a thread that finishes a sample starts the next at
// once, so no lane waits for the longest path of a wave. A larger table
// goes through shared memory in tiles of p.tile triangles (v0 and the two
// edges, 9 rows): the block then runs in lockstep, one closest-hit pass
// and one shadow pass a segment, each over every tile in ascending order
// (common.cuh tiled_closest, tiled_any_hit), a thread whose sample ends
// starting its next at once. Not done yet: BVH culling, wgmma or TMA
// (there is no matrix work), persistent blocks.
//
// Next-event estimation (common.cuh nee_direct) adds per hit a binary
// search of the light CDF and the sampled light's 15 fields, read from
// global memory through L1 (the TPU kernel holds the table in VMEM and,
// past a few dozen lights, selects by a one-hot matmul; a search takes any
// number of lights), and one shadow ray against the shared-memory table
// that stops at its first hit: up to twice the triangle tests a segment.
#include "common.cuh"

namespace sfvp {

template <bool HAS_MIRRORS, bool NEE, bool IMG>
__global__ void __launch_bounds__(kBlock)
regen_kernel(const float* __restrict__ table,
             const float* __restrict__ lights, const Params p,
             float* __restrict__ colr, float* __restrict__ colg,
             float* __restrict__ colb, int* __restrict__ segs_out) {
  extern __shared__ float tab[];
  load_table(tab, table, p);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.npix) return;  // padded threads trace nothing and count nothing
  const int px = i % p.gw;
  const int py = i / p.gw + p.row0;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int segs = 0;
  for (int s = 0; s < p.spp; ++s) {
    Path q = camera_path(px, py, s, p);
    for (int depth = 0; depth < p.max_depth; ++depth) {
      ++segs;
      if (!path_segment<HAS_MIRRORS, true, NEE, IMG>(tab, p, depth, q, cr, cg,
                                                     cb, lights))
        break;
    }
  }
  colr[i] = cr;
  colg[i] = cg;
  colb[i] = cb;
  segs_out[i] = segs;
}

// The same paths over a table staged through shared memory in tiles: the
// block advances one segment of every thread's current sample per round,
// a thread whose sample ends taking its next, until no thread has one.
template <bool HAS_MIRRORS, bool NEE, bool IMG>
__global__ void __launch_bounds__(kBlock)
regen_tiled_kernel(const float* __restrict__ table,
                   const float* __restrict__ lights, const Params p,
                   float* __restrict__ colr, float* __restrict__ colg,
                   float* __restrict__ colb, int* __restrict__ segs_out) {
  extern __shared__ float tile[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < p.npix;
  const int px = real ? i % p.gw : 0;
  const int py = real ? i / p.gw + p.row0 : 0;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int segs = 0, s = 0, depth = 0;
  bool live = real && p.spp > 0 && p.max_depth > 0;
  Path q;
  if (live) q = camera_path(px, py, 0, p);
  while (__syncthreads_or(live)) {
    float t, u, v;
    const int k = tiled_closest(tile, table, p, live, q, t, u, v);
    ShadowRay sh[2];
    sh[0].on = sh[1].on = false;
    Surface f;
    bool cont = false;
    if (live) {
      ++segs;
      if (k < 0) {
        add_miss<NEE, IMG>(p, q, cr, cg, cb);
      } else {
        f = table_surface<IMG>(table, p.tp, k, u, v, p);
        shade_begin<NEE, IMG>(p, lights, t, f,
                              HAS_MIRRORS && is_mirror(f.mtype), q, cr, cg,
                              cb, sh);
      }
    }
    bool blocked[2];
    if (NEE) tiled_any_hit(tile, table, p, sh, blocked);
    if (live && k >= 0) {
      if (NEE) {
        add_light<IMG>(p, sh[0], blocked[0], f, q, cr, cg, cb);
        add_light<IMG>(p, sh[1], blocked[1], f, q, cr, cg, cb);
      }
      cont = scatter<HAS_MIRRORS, true, NEE>(p, depth, f, q);
    }
    if (live) {
      if (cont && ++depth < p.max_depth) continue;
      depth = 0;
      if (++s < p.spp)
        q = camera_path(px, py, s, p);
      else
        live = false;
    }
  }
  if (real) {
    colr[i] = cr;
    colg[i] = cg;
    colb[i] = cb;
    segs_out[i] = segs;
  }
}

}  // namespace sfvp

namespace {

template <bool HAS_MIRRORS, bool NEE, bool IMG>
int launch(const float* table, const float* lights, const sfvp::Params* p,
           size_t smem, float* colr, float* colg, float* colb, int* segs,
           cudaStream_t st) {
  const int blocks = (p->npix + sfvp::kBlock - 1) / sfvp::kBlock;
  auto kernel = p->tile ? sfvp::regen_tiled_kernel<HAS_MIRRORS, NEE, IMG>
                        : sfvp::regen_kernel<HAS_MIRRORS, NEE, IMG>;
  // past the default 48 KB of shared memory a block opts in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, sfvp::kBlock, smem, st>>>(table, lights, *p, colr, colg,
                                             colb, segs);
  return static_cast<int>(cudaGetLastError());
}

template <bool HAS_MIRRORS, bool NEE>
int launch_images(const float* table, const float* lights,
                  const sfvp::Params* p, size_t smem, float* colr,
                  float* colg, float* colb, int* segs, cudaStream_t st) {
  return p->use_env || p->use_tex
             ? launch<HAS_MIRRORS, NEE, true>(table, lights, p, smem, colr,
                                              colg, colb, segs, st)
             : launch<HAS_MIRRORS, NEE, false>(table, lights, p, smem, colr,
                                               colg, colb, segs, st);
}

}  // namespace

// lights: the (16, p->num_lights) light table when p->use_nee, else
// unused; smem: the dynamic shared memory of the table or its tile
// (kernels/build.py table_plan). Outputs are per pixel (p->npix each);
// returns the error of the attribute call or cudaGetLastError() of the
// launch on ``stream``.
extern "C" int sfvp_regen_render(const float* table, const float* lights,
                                 const sfvp::Params* p, int has_mirrors,
                                 int smem, float* colr, float* colg,
                                 float* colb, int* segs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (p->use_nee || p->use_env_nee)
    return has_mirrors ? launch_images<true, true>(table, lights, p, sm, colr,
                                                   colg, colb, segs, st)
                       : launch_images<false, true>(table, lights, p, sm, colr,
                                                    colg, colb, segs, st);
  return has_mirrors ? launch_images<true, false>(table, lights, p, sm, colr,
                                                  colg, colb, segs, st)
                     : launch_images<false, false>(table, lights, p, sm, colr,
                                                   colg, colb, segs, st);
}

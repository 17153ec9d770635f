// K1: brute-force path tracer with in-thread sample regeneration.
//
// Replaces sfvp_tpu/kernels/megakernel_regen.py, make_regen_render_step
// (kernel body in build_kernel, pallas_call at :1137): diffuse, mirror,
// GGX glossy and smooth dielectric materials (megakernel_regen.py:497-540,
// :723-781, :839-889, :976-1044; common.cuh ggx_*, dielectric_dir), the
// thin-lens camera (:232-246, :368; camera_path<DOF>), uniform or cosine
// sampling, Russian roulette, next-event estimation toward the area
// lights with balance-heuristic MIS (a GGX face evaluating its brdf and
// pdf toward the light), an equirect environment sky with its own
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
// What bounds it on an H100, as measured (NVIDIA H100 80GB HBM3, 700 W;
// variants timed against each other by chip_ab.py, PERF.md): the triangle
// tests. Running the closest-hit loop twice a segment made the parity
// step 1.88x as long, the shadow scan twice the sky + NEE step 1.52x. Two
// things held the loop back: a lane whose sample ended waited at the
// exit of the inner loop over depths for its warp's longest path, and a
// test read its triangle by nine scalar shared-memory loads from rows
// [row][T]. What the design does about it: one loop trip a segment, the
// next sample started in the same trip (regen_kernel), and the table in
// shared memory as one 12-float record a triangle (v0, e1, e2, three
// zeros; common.cuh load_table), read by three 16-byte loads, which left
// the registers as they were (four triangles a 16-byte load, lanes of rows
// padded to 4, raised them to 90-120 and lost on the shadow scan). The
// shading reads the hit's row of the host table from device memory
// through L1, as the tiled kernel does, so 227 KB of shared memory hold
// 4,842 triangles, textured or not. A warp vote that skips a triangle no
// lane can hit, unrolling the loop over scalar loads and a 12-block bound
// were slower. Built with -fmad=false for bitwise parity, every float
// operation is an instruction of its own: no kernel that keeps the
// twins' bits can beat twice the bound, which counts a fused multiply-add
// as two operations. A larger table goes through shared memory in tiles
// of p.tile triangles (v0 and the two edges, 9 rows): the block then runs
// in lockstep, one closest-hit pass and one shadow pass a segment, each
// over every tile in ascending order (common.cuh tiled_closest,
// tiled_any_hit), a thread whose sample ends starting its next at once.
// Not done yet: BVH culling, persistent blocks.
//
// Next-event estimation (common.cuh nee_direct) adds per hit a binary
// search of the light CDF and the sampled light's 15 fields, read from
// global memory through L1 (the TPU kernel holds the table in VMEM and,
// past a few dozen lights, selects by a one-hot matmul; a search takes any
// number of lights), and one shadow ray against the shared-memory table
// that stops at its first hit: up to twice the triangle tests a segment.
#include "common.cuh"

namespace sfvp {

// MAT: GGX or dielectric faces, DOF: the thin lens; each compiled only into
// the kernels of scenes and cameras that have them (their code costs the
// others registers and time, as the environment's did: PERF.md §6).
template <bool HAS_MIRRORS, bool NEE, bool IMG, bool MAT, bool DOF>
__global__ void __launch_bounds__(kBlock)
regen_kernel(const float* __restrict__ table,
             const float* __restrict__ lights, const Params p,
             float* __restrict__ colr, float* __restrict__ colg,
             float* __restrict__ colb, int* __restrict__ segs_out) {
  extern __shared__ __align__(16) float tab[];
  load_table(tab, table, p);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.npix) return;  // padded threads trace nothing and count nothing
  const int px = i % p.gw;
  const int py = i / p.gw + p.row0;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  // one trip a segment: a sample that ends starts the next in the same
  // trip, so a warp's lanes trace together instead of waiting at a loop's
  // exit for the warp's longest path
  int segs = 0, s = 0, depth = 0;
  bool live = p.spp > 0 && p.max_depth > 0;
  Path q;
  if (live) q = camera_path<DOF>(px, py, 0, p);
  while (live) {
    ++segs;
    if (path_segment<HAS_MIRRORS, true, NEE, IMG, MAT>(tab, table, p, depth,
                                                       q, cr, cg, cb,
                                                       lights) &&
        ++depth < p.max_depth)
      continue;
    depth = 0;
    if (++s < p.spp)
      q = camera_path<DOF>(px, py, s, p);
    else
      live = false;
  }
  colr[i] = cr;
  colg[i] = cg;
  colb[i] = cb;
  segs_out[i] = segs;
}

// The same paths over a table staged through shared memory in tiles: the
// block advances one segment of every thread's current sample per round,
// a thread whose sample ends taking its next, until no thread has one.
template <bool HAS_MIRRORS, bool NEE, bool IMG, bool MAT, bool DOF>
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
  if (live) q = camera_path<DOF>(px, py, 0, p);
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
        shade_begin<NEE, IMG, MAT>(p, lights, t, f,
                                   is_specular<HAS_MIRRORS, MAT>(f), q, cr,
                                   cg, cb, sh);
      }
    }
    bool blocked[2];
    if (NEE) tiled_any_hit(tile, table, p, sh, blocked);
    if (live && k >= 0) {
      if (NEE) {
        add_light<IMG, MAT>(p, sh[0], blocked[0], f, q, cr, cg, cb);
        add_light<IMG, MAT>(p, sh[1], blocked[1], f, q, cr, cg, cb);
      }
      cont = scatter<HAS_MIRRORS, true, NEE, MAT>(p, depth, f, q);
    }
    if (live) {
      if (cont && ++depth < p.max_depth) continue;
      depth = 0;
      if (++s < p.spp)
        q = camera_path<DOF>(px, py, s, p);
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

template <bool HAS_MIRRORS, bool NEE, bool IMG, bool MAT, bool DOF>
int launch(const float* table, const float* lights, const sfvp::Params* p,
           size_t smem, float* colr, float* colg, float* colb, int* segs,
           cudaStream_t st) {
  const int blocks = (p->npix + sfvp::kBlock - 1) / sfvp::kBlock;
  auto kernel =
      p->tile ? sfvp::regen_tiled_kernel<HAS_MIRRORS, NEE, IMG, MAT, DOF>
              : sfvp::regen_kernel<HAS_MIRRORS, NEE, IMG, MAT, DOF>;
  // past the default 48 KB of shared memory a block opts in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, sfvp::kBlock, smem, st>>>(table, lights, *p, colr, colg,
                                             colb, segs);
  return static_cast<int>(cudaGetLastError());
}

// The scenes with GGX or dielectric faces or an open lens take kernels
// with their code (MAT, DOF), which check for mirrors at run time; the
// others, the kernels without it.
template <bool HAS_MIRRORS, bool NEE, bool IMG>
int launch_ext(const float* table, const float* lights,
               const sfvp::Params* p, size_t smem, float* colr, float* colg,
               float* colb, int* segs, cudaStream_t st) {
  if (p->use_mat && p->use_dof)
    return launch<true, NEE, IMG, true, true>(table, lights, p, smem, colr,
                                              colg, colb, segs, st);
  if (p->use_mat)
    return launch<true, NEE, IMG, true, false>(table, lights, p, smem, colr,
                                               colg, colb, segs, st);
  if (p->use_dof)
    return launch<true, NEE, IMG, false, true>(table, lights, p, smem, colr,
                                               colg, colb, segs, st);
  return launch<HAS_MIRRORS, NEE, IMG, false, false>(table, lights, p, smem,
                                                     colr, colg, colb, segs,
                                                     st);
}

template <bool HAS_MIRRORS, bool NEE>
int launch_images(const float* table, const float* lights,
                  const sfvp::Params* p, size_t smem, float* colr,
                  float* colg, float* colb, int* segs, cudaStream_t st) {
  return p->use_env || p->use_tex
             ? launch_ext<HAS_MIRRORS, NEE, true>(table, lights, p, smem,
                                                  colr, colg, colb, segs, st)
             : launch_ext<HAS_MIRRORS, NEE, false>(table, lights, p, smem,
                                                   colr, colg, colb, segs, st);
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

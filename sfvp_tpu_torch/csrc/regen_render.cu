// K1: brute-force path tracer with in-thread sample regeneration.
//
// Replaces sfvp_tpu/kernels/megakernel_regen.py, make_regen_render_step
// (kernel body in build_kernel, pallas_call at :1137), for the slice the
// port runs: diffuse and mirror materials, uniform or cosine sampling,
// Russian roulette, next-event estimation toward the area lights with
// balance-heuristic MIS. One thread owns one pixel and runs its spp
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
// What the simple design does about it: the table (<= 480 triangles,
// 25 rows, <= 48 KB) sits in shared memory with its edges precomputed, so
// the loop reads broadcast shared words and does no global loads; a thread
// that finishes a sample starts the next at once, so no lane waits for the
// longest path of a wave. Not done yet: BVH culling, wgmma or TMA (there is
// no matrix work), persistent blocks.
//
// Next-event estimation (common.cuh nee_direct) adds per hit a binary
// search of the light CDF and the sampled light's 15 fields, read from
// global memory through L1 (the TPU kernel holds the table in VMEM and,
// past a few dozen lights, selects by a one-hot matmul; a search takes any
// number of lights), and one shadow ray against the shared-memory table
// that stops at its first hit: up to twice the triangle tests a segment.
#include "common.cuh"

namespace sfvp {

template <bool HAS_MIRRORS, bool NEE>
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
      if (!path_segment<HAS_MIRRORS, true, NEE>(tab, p, depth, q, cr, cg, cb,
                                                lights))
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
int launch(const float* table, const float* lights, const sfvp::Params* p,
           float* colr, float* colg, float* colb, int* segs,
           cudaStream_t st) {
  const int blocks = (p->npix + sfvp::kBlock - 1) / sfvp::kBlock;
  const size_t smem = sizeof(float) * sfvp::kSmemRows * p->num_tris;
  sfvp::regen_kernel<HAS_MIRRORS, NEE><<<blocks, sfvp::kBlock, smem, st>>>(
      table, lights, *p, colr, colg, colb, segs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lights: the (16, p->num_lights) light table when p->use_nee, else
// unused. Outputs are per pixel (p->npix each); returns cudaGetLastError()
// of the launch on ``stream``.
extern "C" int sfvp_regen_render(const float* table, const float* lights,
                                 const sfvp::Params* p, int has_mirrors,
                                 float* colr, float* colg, float* colb,
                                 int* segs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->use_nee)
    return has_mirrors
               ? launch<true, true>(table, lights, p, colr, colg, colb, segs, st)
               : launch<false, true>(table, lights, p, colr, colg, colb, segs, st);
  return has_mirrors
             ? launch<true, false>(table, lights, p, colr, colg, colb, segs, st)
             : launch<false, false>(table, lights, p, colr, colg, colb, segs, st);
}

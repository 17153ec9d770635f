// K1: brute-force path tracer with in-thread sample regeneration.
//
// Replaces sfvp_tpu/kernels/megakernel_regen.py, make_regen_render_step
// (kernel body in build_kernel, pallas_call at :1137), for the slice the
// port runs: diffuse and mirror materials, uniform or cosine sampling,
// Russian roulette. One thread owns one pixel and runs its spp samples back
// to back, the shape of the reference's raygen shader
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
#include "common.cuh"

namespace sfvp {

template <bool HAS_MIRRORS>
__global__ void __launch_bounds__(kBlock)
regen_kernel(const float* __restrict__ table, const Params p,
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
      if (!path_segment<HAS_MIRRORS, true>(tab, p, depth, q, cr, cg, cb)) break;
    }
  }
  colr[i] = cr;
  colg[i] = cg;
  colb[i] = cb;
  segs_out[i] = segs;
}

}  // namespace sfvp

// Outputs are per pixel (p->npix each); returns cudaGetLastError() of the
// launch on ``stream``.
extern "C" int sfvp_regen_render(const float* table, const sfvp::Params* p,
                                 int has_mirrors, float* colr, float* colg,
                                 float* colb, int* segs, void* stream) {
  const int blocks = (p->npix + sfvp::kBlock - 1) / sfvp::kBlock;
  const size_t smem = sizeof(float) * sfvp::kSmemRows * p->num_tris;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (has_mirrors)
    sfvp::regen_kernel<true><<<blocks, sfvp::kBlock, smem, st>>>(
        table, *p, colr, colg, colb, segs);
  else
    sfvp::regen_kernel<false><<<blocks, sfvp::kBlock, smem, st>>>(
        table, *p, colr, colg, colb, segs);
  return static_cast<int>(cudaGetLastError());
}

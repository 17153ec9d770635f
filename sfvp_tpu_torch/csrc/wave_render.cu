// K2: chunked brute-force path tracer, one thread per ray of a wave.
//
// Replaces sfvp_tpu/kernels/megakernel.py, make_wave_kernel (pallas_call at
// :366), driven by make_render_step_pallas: one launch traces a wave of
// spp_chunk samples x npix pixels, each ray running up to max_depth
// segments (megakernel.py:219-349). Diffuse and mirror materials, uniform
// or cosine sampling, Russian roulette drawn only from rr_start_depth on
// (megakernel.py:336). Each ray writes its own colour, so the wrapper can
// sum a pixel's samples in the order the wavefront integrator does and the
// result matches it sample for sample.
//
// What bounds it on an H100: arithmetic in the triangle loop, as in K1
// (regen_render.cu); memory traffic is four output words per ray. Threads
// whose path ends early idle until their warp's longest path ends, which is
// what K1's in-thread regeneration removes.
// What the simple design does about it: the scene table and its edges sit
// in shared memory, loaded once per block; nothing else is read.
#include "common.cuh"

namespace sfvp {

template <bool HAS_MIRRORS>
__global__ void __launch_bounds__(kBlock)
wave_kernel(const float* __restrict__ table, const Params p,
            float* __restrict__ colr, float* __restrict__ colg,
            float* __restrict__ colb, int* __restrict__ segs_out) {
  extern __shared__ float tab[];
  load_table(tab, table, p);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.chunk * p.npix) return;  // padded threads count nothing
  const int pix = i % p.npix;          // local pixel
  const int s = i / p.npix;            // sample within the wave
  const int px = pix % p.gw;
  const int py = pix / p.gw + p.row0;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int segs = 0;
  Path q = camera_path(px, py, p.chunk_idx * p.chunk + s, p);
  for (int depth = 0; depth < p.max_depth; ++depth) {
    ++segs;
    if (!path_segment<HAS_MIRRORS, false>(tab, p, depth, q, cr, cg, cb)) break;
  }
  colr[i] = cr;
  colg[i] = cg;
  colb[i] = cb;
  segs_out[i] = segs;
}

}  // namespace sfvp

// Outputs are per ray (p->chunk * p->npix each); returns
// cudaGetLastError() of the launch on ``stream``.
extern "C" int sfvp_wave_render(const float* table, const sfvp::Params* p,
                                int has_mirrors, float* colr, float* colg,
                                float* colb, int* segs, void* stream) {
  const int n_rays = p->chunk * p->npix;
  const int blocks = (n_rays + sfvp::kBlock - 1) / sfvp::kBlock;
  const size_t smem = sizeof(float) * sfvp::kSmemRows * p->num_tris;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (has_mirrors)
    sfvp::wave_kernel<true><<<blocks, sfvp::kBlock, smem, st>>>(
        table, *p, colr, colg, colb, segs);
  else
    sfvp::wave_kernel<false><<<blocks, sfvp::kBlock, smem, st>>>(
        table, *p, colr, colg, colb, segs);
  return static_cast<int>(cudaGetLastError());
}

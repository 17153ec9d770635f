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
// in shared memory, loaded once per block, up to the 227 KB a block may opt
// in to (2,235 triangles); nothing else is read. A larger table goes
// through shared memory in tiles (common.cuh tiled_closest), the block in
// lockstep one segment a round. K2 has neither environment maps nor
// textures, as sfvp_tpu's chunked kernel (its dispatch routes them to the
// wavefront loop, dispatch.py:245-256).
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

// The same rays over a table staged through shared memory in tiles, every
// thread of the block taking part in each tile load.
template <bool HAS_MIRRORS>
__global__ void __launch_bounds__(kBlock)
wave_tiled_kernel(const float* __restrict__ table, const Params p,
                  float* __restrict__ colr, float* __restrict__ colg,
                  float* __restrict__ colb, int* __restrict__ segs_out) {
  extern __shared__ float tile[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < p.chunk * p.npix;
  const int pix = i % p.npix;
  const int px = pix % p.gw;
  const int py = pix / p.gw + p.row0;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int segs = 0;
  Path q;
  if (real) q = camera_path(px, py, p.chunk_idx * p.chunk + i / p.npix, p);
  bool live = real;
  for (int depth = 0; depth < p.max_depth && __syncthreads_or(live);
       ++depth) {
    float t, u, v;
    const int k = tiled_closest(tile, table, p, live, q, t, u, v);
    if (live) {
      ++segs;
      if (k < 0) {
        add_miss<false, false>(p, q, cr, cg, cb);
        live = false;
      } else {
        const Surface f = table_surface<false>(table, p.tp, k, u, v, p);
        cr = cr + q.wr * f.er;
        cg = cg + q.wg * f.eg;
        cb = cb + q.wb * f.eb;
        live = scatter<HAS_MIRRORS, false>(p, depth, f, q);
      }
    }
  }
  if (real) {
    colr[i] = cr;
    colg[i] = cg;
    colb[i] = cb;
    segs_out[i] = segs;
  }
}

template <bool HAS_MIRRORS>
int launch(const float* table, const Params* p, size_t smem, float* colr,
           float* colg, float* colb, int* segs, cudaStream_t st) {
  const int n_rays = p->chunk * p->npix;
  const int blocks = (n_rays + kBlock - 1) / kBlock;
  auto kernel = p->tile ? wave_tiled_kernel<HAS_MIRRORS>
                        : wave_kernel<HAS_MIRRORS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kBlock, smem, st>>>(table, *p, colr, colg, colb, segs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sfvp

// smem: the dynamic shared memory of the table or its tile (kernels/
// build.py table_plan). Outputs are per ray (p->chunk * p->npix each);
// returns the error of the attribute call or cudaGetLastError() of the
// launch on ``stream``.
extern "C" int sfvp_wave_render(const float* table, const sfvp::Params* p,
                                int has_mirrors, int smem, float* colr,
                                float* colg, float* colb, int* segs,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return has_mirrors
             ? sfvp::launch<true>(table, p, (size_t)smem, colr, colg, colb, segs, st)
             : sfvp::launch<false>(table, p, (size_t)smem, colr, colg, colb, segs, st);
}

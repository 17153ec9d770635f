// P3 and P4: the equirect environment fetch over a wave of directions.
//
// P3 replaces benchmarks/probe_envfetch.py, run (pallas_call at :66): the
// TPU kernel's in-kernel fetch of the environment map (kernels/imgfetch.py
// env_fetch_rows: atan2 and arccos polynomials, a one-hot MXU contraction
// per block row) held against sample_environment. Here one thread owns one
// direction of the (n,) wave and calls env_lookup (common.cuh), the very
// device function K1 and K5 call on a miss and for the radiance of an env
// NEE sample: atan2f and acosf of the CUDA math library, v clamped to the
// band of texel centres, the four texels of the SoA pool read from device
// memory and blended with sample_bilinear's weights and repeat wrap. So P3
// is the card's unit check of that fetch, against its twin
// scene/textures.py sample_environment.
//
// P4 replaces benchmarks/probe_envfetch_ablate.py, main (pallas_call at
// :111), which takes the TPU fetch apart to find its cost. The GPU meaning
// of its ladder, a template parameter here (kernels/envfetch.py ABLATIONS):
//   trig    the direction's (u, v) alone: writes u, v, u + v;
//   noread  the index and weight math with the four texel reads replaced
//           by 1.0: writes the weights' sum to each plane;
//   half    the texels read from a float16 copy of the map (the TPU's bf16
//           operand): within float16 rounding of full;
//   full    P3 itself.
// The TPU ladder's `high` (the MXU's precision) and `noconc` (a concat)
// have no meaning without the MXU.
//
// What bounds it on an H100: the texel reads. Per direction 12 bytes in,
// 12 out and four scattered 4-byte reads per channel that L2 or L1 serve
// once the map is cached (a 2048 x 1024 map is 24 MB, under the 50 MB L2);
// ~60 float operations besides atan2f and acosf. What the simple design
// does about it: coalesced direction and output planes, texels through the
// read-only path (__ldg). Not done: a texture object with hardware
// filtering, which rounds its weights to 8 bits and so is not the
// sample_bilinear of the twins.
#include <cuda_fp16.h>

#include "common.cuh"

namespace sfvp {

enum EnvFetchMode { kFull = 0, kTrig = 1, kNoRead = 2, kHalf = 3 };

template <int MODE>
__global__ void __launch_bounds__(kBlock)
env_fetch_kernel(const Params p, const float* __restrict__ dirs, int n,
                 const __half* __restrict__ half_map,
                 float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t m = n;
  if (i >= m) return;
  const float dx = dirs[i], dy = dirs[m + i], dz = dirs[2 * m + i];
  float cr, cg, cb;
  if (MODE == kFull) {
    env_lookup(p, dx, dy, dz, cr, cg, cb);
  } else {
    float u, v;
    equirect_uv(p, dx, dy, dz, u, v);
    if (MODE == kTrig) {
      cr = u;
      cg = v;
      cb = u + v;
    } else {
      int idx[4];
      float wt[4];
      bilinear_taps(0, p.env_w, p.env_h, u, v, idx, wt);
      if (MODE == kNoRead) {
        cr = cg = cb = 1.0f * wt[0] + 1.0f * wt[1] + 1.0f * wt[2] +
                       1.0f * wt[3];
      } else {
        const size_t hw = (size_t)p.env_w * p.env_h;
        float c[3];
        for (int ch = 0; ch < 3; ++ch) {
          const __half* h = half_map + ch * hw;
          c[ch] = __half2float(h[idx[0]]) * wt[0] +
                  __half2float(h[idx[1]]) * wt[1] +
                  __half2float(h[idx[2]]) * wt[2] +
                  __half2float(h[idx[3]]) * wt[3];
        }
        cr = c[0];
        cg = c[1];
        cb = c[2];
      }
    }
  }
  out[i] = cr;
  out[m + i] = cg;
  out[2 * m + i] = cb;
}

}  // namespace sfvp

// dirs: (3, n) direction planes; out: (3, n) planes; p: the environment's
// fields of Params (env_* and the constants); half_map: the (3, H*W)
// float16 map for mode 3 (half), else unused; n is below 2**31. Returns
// cudaGetLastError() of the launch on ``stream``.
extern "C" int sfvp_env_fetch(const sfvp::Params* p, const float* dirs,
                              int n, int mode, const void* half_map,
                              float* out, void* stream) {
  const unsigned blocks =
      (unsigned)(((size_t)n + sfvp::kBlock - 1) / sfvp::kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __half* hm = static_cast<const __half*>(half_map);
  switch (mode) {
    case sfvp::kFull:
      sfvp::env_fetch_kernel<sfvp::kFull><<<blocks, sfvp::kBlock, 0, st>>>(
          *p, dirs, n, hm, out);
      break;
    case sfvp::kTrig:
      sfvp::env_fetch_kernel<sfvp::kTrig><<<blocks, sfvp::kBlock, 0, st>>>(
          *p, dirs, n, hm, out);
      break;
    case sfvp::kNoRead:
      sfvp::env_fetch_kernel<sfvp::kNoRead><<<blocks, sfvp::kBlock, 0, st>>>(
          *p, dirs, n, hm, out);
      break;
    case sfvp::kHalf:
      sfvp::env_fetch_kernel<sfvp::kHalf><<<blocks, sfvp::kBlock, 0, st>>>(
          *p, dirs, n, hm, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

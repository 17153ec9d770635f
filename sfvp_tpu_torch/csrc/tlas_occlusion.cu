// K8: any-hit occlusion over a two-level BVH (instanced scenes), for one
// wave of world-space shadow rays.
//
// Replaces sfvp_tpu/kernels/bvh_tlas.py, make_two_level_occlusion (kernel
// body from :477, pallas_call at :666): the wavefront loop's shadow-ray
// test of instanced scenes under next-event estimation. Each ray of the
// (N,) wave (7 planes; an inactive ray has t_max = -inf) gets one byte,
// whether a triangle of any instance lies in (t_min, t_max) along it
// (two_level.cuh any_hit_pop, the walk K9's shadow rays take).
//
// Persistent threads: the grid is the blocks the card holds at once, and
// each thread walks one ray after another, a pop a trip of its loop. The
// lanes of a warp that have no ray take the next ones from a counter of
// the wave's rays (one atomicAdd a warp, once at least kRefill lanes are
// idle or all are), and rays with no window are answered at the fetch.
// A ray stops at its first hit, so walk lengths vary widely within a
// warp; with one ray a thread, a warp ran as long as its longest walk.
// As measured (NVIDIA H100 80GB HBM3, 700 W; variants timed against each
// other by chip_ab.py, PERF.md), on the lit field's 1M-ray first-bounce
// shadow wave (601,339 rays with a window): the walk's 16-byte row loads,
// one stack and folded instance pops took the kernel from 0.678 to 0.476
// ms, these persistent threads to 0.427. A bound of 12 blocks an SM (40
// registers) cost 15%, nearest-first pushes up to 4%, and fetching at 1,
// 4 or 16 idle lanes in place of 8 2-13%.
//
// The answer of an any-hit walk does not depend on which thread walks a
// ray or in which order, so every ray's byte is the twin's. Each thread's
// loop has one exit (a flag and a break), as every walk's.
#include "two_level.cuh"

namespace sfvp {

// Idle lanes of a warp at which it fetches new rays (or all 32).
constexpr int kRefill = 8;

__global__ void __launch_bounds__(kBlock)
tlas_occlusion_kernel(const TwoLevel g, const float* __restrict__ rays,
                      int n, unsigned* __restrict__ next,
                      uint8_t* __restrict__ out) {
  const size_t m = n;
  const unsigned full = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  // the walk of the thread's ray (two_level_any_hit's state)
  int stack[kMaxStack];
  int sp = 0, base = kMaxStack, id = -1, cur = -1;
  Ray r;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float smax = 0.0f;
  bool hit = false;
  size_t i = 0;        // the thread's ray
  bool live = false;   // whether it is walking one
  bool drained = false;  // whether the counter has passed the wave's end
  for (;;) {
    unsigned idle = __ballot_sync(full, !live);
    while (!drained && (__popc(idle) >= kRefill || idle == full)) {
      const int leader = __ffs(idle) - 1;
      unsigned first = 0;
      if ((int)lane == leader) first = atomicAdd(next, (unsigned)__popc(idle));
      first = __shfl_sync(full, first, leader);
      if (!live) {
        const unsigned j = first + __popc(idle & below);
        if (j < (unsigned)n) {
          const float w = rays[6 * m + j];
          if (w > g.t_min) {
            i = j;
            ox = rays[i];
            oy = rays[m + i];
            oz = rays[2 * m + i];
            dx = rays[3 * m + i];
            dy = rays[4 * m + i];
            dz = rays[5 * m + i];
            smax = w;
            stack[0] = 1;  // the TLAS root, internal node 0, in world space
            sp = 1;
            base = kMaxStack;
            id = -1;
            cur = -1;
            r = local_ray(g, -1, ox, oy, oz, dx, dy, dz);
            hit = false;
            live = true;
          } else {
            out[j] = 0;
          }
        }
      }
      drained = first + __popc(idle) >= (unsigned)n;
      idle = __ballot_sync(full, !live);
    }
    if (idle == full) break;  // every lane idle and the wave drained
    if (live) {
      any_hit_pop(g, stack, sp, base, id, cur, r, ox, oy, oz, dx, dy, dz,
                  smax, hit);
      if (!(sp > 0 && !hit)) {
        out[i] = hit;
        live = false;
      }
    }
  }
}

}  // namespace sfvp

// rays: (7, n) world-space planes ox oy oz dx dy dz tmax; next: one
// unsigned int, zero at the launch (the wave's ray counter); out: n bytes,
// 0 or 1 (a torch.bool tensor); n is below 2**31. Returns the first CUDA
// error of the launch on ``stream``.
extern "C" int sfvp_tlas_occlusion(const sfvp::TwoLevel* g,
                                   const float* rays, int n, unsigned* next,
                                   uint8_t* out, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sfvp::tlas_occlusion_kernel, sfvp::kBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)(sms * (per_sm > 0 ? per_sm : 1));
  sfvp::tlas_occlusion_kernel<<<blocks, sfvp::kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      *g, rays, n, next, out);
  return static_cast<int>(cudaGetLastError());
}

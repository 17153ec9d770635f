// Closest-hit and any-hit traversal of a two-level BVH (accel/tlas.py: a
// TLAS over instance boxes above the BLASes of the shared meshes), one ray
// per thread: the closest hit shared by K7 (tlas_trace.cu) and K9
// (bvh_regen_render.cu over a TwoLevel tree), the any hit by K8
// (tlas_occlusion.cu) and K9's shadow rays. The walks of wide_bvh.cuh with
// the two-level additions of sfvp_tpu/kernels/bvh_tlas.py:
//
//   - every stack entry lives in an instance context, the instance whose
//     object space it is in (-1 = the TLAS, world space); the start state
//     is the TLAS root in world space. The any-hit walk keeps a stack of
//     contexts beside its stack of codes, as the twins do; the closest-hit
//     walk derives an entry's context from its stack index (see there);
//   - at each pop the ray in the popped entry's space, from the instance
//     row's inverse transform (lanes 0-11), o' = iR o + it and d' = iR d,
//     left to right; the direction is NOT renormalised, so t stays in
//     world measure and the best t prunes across instances. Consecutive
//     pops mostly share their context, so the ray is re-derived only when
//     the context changes (the same floats either way);
//   - an instance code stands for the instance's BLAS root (lane 24) under
//     the instance's context, with no box test: the any-hit walk pushes
//     the root, the closest-hit walk expands it at once;
//   - the winning triangle's object-space vertices go to world space once,
//     after the walk, with the instance's forward transform (lanes 12-23),
//     x' = R0 x + R1 y + R2 z + t0: the order of both TPU forms
//     (bvh_tlas.py:317-323 and K9's deferred transform,
//     megakernel_bvh.py:1337-1346), so one function serves K7's payload
//     and K9's shading.
//
// Every expression keeps the operation order of the plain twins
// (kernels/bvh_tlas.py), built with -fmad=false, and each walk pops the
// twins' entries in their order, so kernels and twins agree bit for bit.
// Each walk has one exit (a flag and a break), as wide_any_hit must.
#pragma once

#include "wide_bvh.cuh"

namespace sfvp {

// Launch parameters of the tree; mirrored by kernels/build.py
// TwoLevelParams.
struct TwoLevel {
  const float* nodes;  // (n_nodes, 128): TLAS rows, then every BLAS's
  const float* tris;   // (n_leaf_rows, 128)
  const float* inst;   // (n_inst, 128) instance rows
  int n_nodes, n_leaf_rows, n_inst, max_stack;
  float t_min, det_eps;
};

struct TwoLevelHit {
  float t, u, v;        // t = +inf on a miss
  int row, slot, inst;  // leaf row, slot and instance of the hit; row -1 on
                        // a miss, inst -1 for a leaf in world space
};

// The world ray (o, d) in the object space of instance ctx (ctx < 0: world
// space, the ray as it is).
__device__ __forceinline__ Ray local_ray(const TwoLevel& g, int ctx,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz) {
  if (ctx < 0) return make_ray(ox, oy, oz, dx, dy, dz);
  const float* tf = g.inst + (size_t)ctx * kRowLanes;
  return make_ray(
      __ldg(tf + 0) * ox + __ldg(tf + 1) * oy + __ldg(tf + 2) * oz + __ldg(tf + 9),
      __ldg(tf + 3) * ox + __ldg(tf + 4) * oy + __ldg(tf + 5) * oz + __ldg(tf + 10),
      __ldg(tf + 6) * ox + __ldg(tf + 7) * oy + __ldg(tf + 8) * oz + __ldg(tf + 11),
      __ldg(tf + 0) * dx + __ldg(tf + 1) * dy + __ldg(tf + 2) * dz,
      __ldg(tf + 3) * dx + __ldg(tf + 4) * dy + __ldg(tf + 5) * dz,
      __ldg(tf + 6) * dx + __ldg(tf + 7) * dy + __ldg(tf + 8) * dz);
}

// Closest hit in (t_min, tmax) of one world-space ray. A ray with tmax <=
// t_min (an inactive one) misses without walking the tree.
//
// One stack of codes. A TLAS has one level of instances, so the entries
// pushed while the walk is inside instance id all lie at or above the
// index ``base`` where the instance was popped, and every entry below it
// lies in world space: the context of the entry popped at index k is id
// for k >= base, else world space. A pop below base takes base away (no
// entry of the instance is left, and world children pushed later may sit
// at or above the old base). An instance pop expands the instance's BLAS
// root, an internal node and its next pop anyway, in the same trip.
static __device__ __noinline__ TwoLevelHit two_level_closest_hit(
    const TwoLevel& g, float ox, float oy, float oz, float dx, float dy,
    float dz, float tmax) {
  TwoLevelHit h;
  h.t = __int_as_float(0x7f800000);
  h.u = 0.0f;
  h.v = 0.0f;
  h.row = -1;
  h.slot = -1;
  h.inst = -1;
  if (!(tmax > g.t_min)) return h;
  int stack[kMaxStack];
  stack[0] = 1;  // the TLAS root, internal node 0, in world space
  int sp = 1;
  int base = kMaxStack;  // none: every entry in world space
  int id = -1;           // the instance of the entries at or above base
  int cur = -1;          // the context of r
  Ray r = local_ray(g, -1, ox, oy, oz, dx, dy, dz);
  while (sp > 0) {
    --sp;
    int code = stack[sp];
    int ctx = id;
    if (sp < base) {
      ctx = -1;
      base = kMaxStack;
    }
    if (code < 0 && -code - 1 >= kInstBase) {
      // instance: its BLAS root, under its own context
      id = ctx = -code - 1 - kInstBase;
      base = sp;
      code = (int)__ldg(g.inst + (size_t)id * kRowLanes + 24) + 1;
    }
    if (ctx != cur) {
      r = local_ray(g, ctx, ox, oy, oz, dx, dy, dz);
      cur = ctx;
    }
    if (code < 0) {
      // leaf row: Moller-Trumbore in object space, strict t < best, each
      // slot's 9 vertex lanes by three 16-byte loads
      const int row = -code - 1;
      const float* s = g.tris + (size_t)row * kRowLanes;
      for (int k = 0; k < 8; ++k) {
        float vtx[12];
        load_quads(s + 16 * k, vtx, 3);
        float t, u, v;
        if (slot_test<SharedRow>(vtx, r, g.det_eps, t, u, v) &&
            t > g.t_min && t < tmax && t < h.t) {
          h.t = t;
          h.u = u;
          h.v = v;
          h.row = row;
          h.slot = k;
          h.inst = ctx;
        }
      }
    } else {
      int cc[8];
      sorted_children_quads(g.nodes + (size_t)(code - 1) * kRowLanes, r,
                            g.t_min, fminf(h.t, tmax), cc);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (cc[c] != 0) stack[sp++] = cc[c];
      }
    }
  }
  return h;
}

// Whether a triangle lies in (t_min, smax) along a world-space ray: the
// walk of two_level_closest_hit with the window fixed at [t_min, smax],
// every child box the ray enters pushed in slot order (sfvp_tpu's
// make_two_level_occlusion), ending at the first hit, with one exit. A ray
// with smax <= t_min walks nothing. K9 calls it after two_level_closest_hit
// has returned, so the two frames take the same place on the call stack.
static __device__ __noinline__ bool two_level_any_hit(
    const TwoLevel& g, float ox, float oy, float oz, float dx, float dy,
    float dz, float smax) {
  if (!(smax > g.t_min)) return false;
  int stack[kMaxStack], ctxs[kMaxStack];
  stack[0] = 1;
  ctxs[0] = -1;
  int sp = 1;
  int cur = -1;
  Ray r = local_ray(g, -1, ox, oy, oz, dx, dy, dz);
  bool hit = false;
  while (sp > 0 && !hit) {
    --sp;
    const int code = stack[sp], ctx = ctxs[sp];
    const int neg = -code - 1;
    if (code < 0 && neg >= kInstBase) {
      const int id = neg - kInstBase;
      stack[sp] = (int)__ldg(g.inst + (size_t)id * kRowLanes + 24) + 1;
      ctxs[sp] = id;
      ++sp;
    } else {
      if (ctx != cur) {
        r = local_ray(g, ctx, ox, oy, oz, dx, dy, dz);
        cur = ctx;
      }
      if (code < 0) {
        const float* s = g.tris + (size_t)neg * kRowLanes;
        for (int k = 0; k < 8; ++k) {
          float t, u, v;
          if (slot_test(s + 16 * k, r, g.det_eps, t, u, v) && t > g.t_min &&
              t < smax) {
            hit = true;
            break;
          }
        }
      } else {
        const float* row = g.nodes + (size_t)(code - 1) * kRowLanes;
        for (int c = 0; c < 8; ++c) {
          const int code_c = child_code(row, c);
          float tnear;
          if (code_c != 0 && enters(row, c, r, g.t_min, smax, tnear)) {
            stack[sp] = code_c;
            ctxs[sp] = ctx;
            ++sp;
          }
        }
      }
    }
  }
  return hit;
}

// The world-space vertices of a two-level hit's triangle: the slot's
// object-space vertices through the forward transform of the hit's
// instance (unchanged for a leaf in world space).
__device__ __forceinline__ void tl_vertices(const TwoLevel& g,
                                            const TwoLevelHit& h,
                                            const float* s, float p[9]) {
  if (h.inst < 0) {
#pragma unroll
    for (int j = 0; j < 9; ++j) p[j] = __ldg(s + j);
    return;
  }
  const float* fw = g.inst + (size_t)h.inst * kRowLanes + 12;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x = __ldg(s + 3 * k), y = __ldg(s + 3 * k + 1),
                z = __ldg(s + 3 * k + 2);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      p[3 * k + a] = __ldg(fw + 3 * a) * x + __ldg(fw + 3 * a + 1) * y +
                     __ldg(fw + 3 * a + 2) * z + __ldg(fw + 9 + a);
  }
}

// The shading data of a two-level hit: wide_bvh.cuh's slot_surface on the
// world-space vertices.
__device__ __forceinline__ Surface tl_surface(const TwoLevel& g,
                                              const TwoLevelHit& h) {
  const float* s = g.tris + (size_t)h.row * kRowLanes + 16 * h.slot;
  float p[9];
  tl_vertices(g, h, s, p);
  return slot_surface(s, p, h.u, h.v);
}

}  // namespace sfvp

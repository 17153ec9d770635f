// Closest-hit and any-hit traversal of a two-level BVH (accel/tlas.py: a
// TLAS over instance boxes above the BLASes of the shared meshes), one ray
// per thread: the closest hit shared by K7 (tlas_trace.cu) and K9
// (bvh_regen_render.cu over a TwoLevel tree), the any hit by K8
// (tlas_occlusion.cu) and K9's shadow rays. The walks of wide_bvh.cuh with
// the two-level additions of sfvp_tpu/kernels/bvh_tlas.py:
//
//   - every stack entry lives in an instance context, the instance whose
//     object space it is in (-1 = the TLAS, world space); the start state
//     is the TLAS root in world space. The twins keep a stack of contexts
//     beside the stack of codes; both walks here derive an entry's
//     context from its stack index (two_level_closest_hit says how);
//   - at each pop the ray in the popped entry's space, from the instance
//     row's inverse transform (lanes 0-11, three 16-byte loads), o' = iR o
//     + it and d' = iR d, left to right; the direction is NOT
//     renormalised, so t stays in world measure and the best t prunes
//     across instances. Consecutive pops mostly share their context, so
//     the ray is re-derived only when the context changes (the same floats
//     either way);
//   - an instance code stands for the instance's BLAS root (lane 24) under
//     the instance's context, with no box test: the twins push the root,
//     both walks here expand it in the instance pop's trip;
//   - the winning triangle's object-space vertices go to world space once,
//     after the walk, with the instance's forward transform (lanes 12-23),
//     x' = R0 x + R1 y + R2 z + t0: the order of both TPU forms
//     (bvh_tlas.py:317-323 and K9's deferred transform,
//     megakernel_bvh.py:1337-1346), so one function serves K7's payload
//     and K9's shading.
//
// Every expression keeps the operation order of the plain twins
// (kernels/bvh_tlas.py), built with -fmad=false, and each walk pops the
// twins' entries in their order, so kernels and twins agree bit for bit
// (an any-hit walk's answer would not depend on its order; the order
// kept is the twins' all the same). Each walk has one exit (a flag and a
// break), as wide_any_hit must.
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
// space, the ray as it is), the transform's 12 lanes read by three 16-byte
// loads (build.two_level_params checks that the table is aligned).
__device__ __forceinline__ Ray local_ray(const TwoLevel& g, int ctx,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz) {
  if (ctx < 0) return make_ray(ox, oy, oz, dx, dy, dz);
  float m[12];
  load_quads(g.inst + (size_t)ctx * kRowLanes, m, 3);
  return make_ray(m[0] * ox + m[1] * oy + m[2] * oz + m[9],
                  m[3] * ox + m[4] * oy + m[5] * oz + m[10],
                  m[6] * ox + m[7] * oy + m[8] * oz + m[11],
                  m[0] * dx + m[1] * dy + m[2] * dz,
                  m[3] * dx + m[4] * dy + m[5] * dz,
                  m[6] * dx + m[7] * dy + m[8] * dz);
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

// One pop of the any-hit walk of a world-space ray (o, d) in the window
// (t_min, smax): the walk of two_level_closest_hit with the window fixed,
// every child box the ray enters pushed in slot order (sfvp_tpu's
// make_two_level_occlusion), ending at the first hit (``hit``). The
// walk's state is the caller's: its stack, sp, base and id (the context
// rule of two_level_closest_hit), cur and r (the ray in context cur).
// Node rows are read half a row at a time by 8 16-byte loads (a whole row
// in registers raised K5's NEE kernels to 113 registers, wide_bvh.cuh),
// leaf slots by 3. Shared by two_level_any_hit (K9's shadow rays) and
// K8's kernel, whose threads keep the state across rays.
__device__ __forceinline__ void any_hit_pop(const TwoLevel& g, int* stack,
                                            int& sp, int& base, int& id,
                                            int& cur, Ray& r, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float smax,
                                            bool& hit) {
  --sp;
  int code = stack[sp];
  int ctx = id;
  if (sp < base) {
    ctx = -1;
    base = kMaxStack;
  }
  if (code < 0 && -code - 1 >= kInstBase) {
    id = ctx = -code - 1 - kInstBase;
    base = sp;
    code = (int)__ldg(g.inst + (size_t)id * kRowLanes + 24) + 1;
  }
  if (ctx != cur) {
    r = local_ray(g, ctx, ox, oy, oz, dx, dy, dz);
    cur = ctx;
  }
  if (code < 0) {
    const float* s = g.tris + (size_t)(-code - 1) * kRowLanes;
    for (int k = 0; k < 8; ++k) {
      float vtx[12];
      load_quads(s + 16 * k, vtx, 3);
      float t, u, v;
      if (slot_test<SharedRow>(vtx, r, g.det_eps, t, u, v) && t > g.t_min &&
          t < smax) {
        hit = true;
        break;
      }
    }
  } else {
    const float* row = g.nodes + (size_t)(code - 1) * kRowLanes;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float n[64];
      load_node_half(row, half, n);
#pragma unroll
      for (int c = 4 * half; c < 4 * half + 4; ++c) {
        const int code_c = child_code<SharedRow>(n, c);
        float tnear;
        if (code_c != 0 && enters<SharedRow>(n, c, r, g.t_min, smax, tnear))
          stack[sp++] = code_c;
      }
    }
  }
}

// Whether a triangle lies in (t_min, smax) along a world-space ray, by
// any_hit_pop until the stack is empty or a hit is found, with one exit.
// A ray with smax <= t_min walks nothing. K9 calls it after
// two_level_closest_hit has returned, so the two frames take the same
// place on the call stack.
static __device__ __noinline__ bool two_level_any_hit(
    const TwoLevel& g, float ox, float oy, float oz, float dx, float dy,
    float dz, float smax) {
  if (!(smax > g.t_min)) return false;
  int stack[kMaxStack];
  stack[0] = 1;  // the TLAS root, internal node 0, in world space
  int sp = 1;
  int base = kMaxStack;
  int id = -1;
  int cur = -1;
  Ray r = local_ray(g, -1, ox, oy, oz, dx, dy, dz);
  bool hit = false;
  while (sp > 0 && !hit)
    any_hit_pop(g, stack, sp, base, id, cur, r, ox, oy, oz, dx, dy, dz, smax,
                hit);
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

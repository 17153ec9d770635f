// Closest-hit and any-hit traversal of the 8-wide BVH (accel/wide.py), one
// ray per thread: the closest hit shared by K3 (bvh_trace.cu) and K5
// (bvh_regen_render.cu), the any hit by K4 (bvh_occlusion.cu) and K5's
// shadow rays; and the pieces of a walk that the two-level walks of
// two_level.cuh (K7, K8, K9) and the packet walk of K6 (packet_trace2.cu)
// share with them: the triangle-slot test, the slab tests of a node's
// children and the sorting network.
//
// The tree is read from device memory in the JAX package's 128-lane row
// layout: a node row holds its 8 children's boxes (lanes 0-47), refs
// (48-55, float) and tags (56-63); a triangle row holds 8 triangles of 16
// lanes (9 vertex coordinates, albedo, emission, packed material type).
// The ray keeps a private stack of child codes (ref+1 for a node, -(ref+1)
// for a leaf row, the decode of WideBVH.codes) in local memory.
//
// Every expression keeps the operation order of the plain twin
// (kernels/bvh_packet.py packet_trace_plain), built with -fmad=false: the
// slab test and Moller-Trumbore of sfvp_tpu/kernels/bvh_packet.py (kernel
// body), children pushed far to near through its 19-comparator sorting
// network, so kernel and twin visit the same nodes in the same order and
// break exact ties alike.
#pragma once

#include "common.cuh"

namespace sfvp {

// Launch parameters of the tree; mirrored by kernels/build.py WideParams.
struct Wide {
  const float* nodes;  // (n_nodes, 128)
  const float* tris;   // (n_leaf_rows, 128)
  int n_nodes, n_leaf_rows, max_stack;
  float t_min, det_eps;
  // a textured tree's rows beside ``tris``: slot k's lanes 16k..16k+6 hold
  // u0 v0 u1 v1 u2 v2 texid+1 (accel/wide.py uv_array); null otherwise
  const float* aux;
};

// Stack entries a thread can hold; the wrappers refuse a tree whose
// max_stack exceeds it (kernels/build.py MAX_WIDE_STACK).
constexpr int kMaxStack = 256;
constexpr int kRowLanes = 128;
// Stack code of a TLAS leaf: -(kInstBase + instance + 1), below every leaf
// row's -(row + 1) since rows stay under 2**24 (kernels/bvh_packet.py
// INSTANCE_CODE_BASE). Single-level trees have no such child.
constexpr int kInstBase = 1 << 27;

struct WideHit {
  float t, u, v;  // t = +inf on a miss
  int row, slot;  // leaf row and triangle slot of the hit, -1 on a miss
};

// A ray with the safe inverses of its direction, for the slab tests.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz;
};

__device__ __forceinline__ float safe_inv(float c) {
  return fabsf(c) > 1e-30f ? 1.0f / c : (c >= 0.0f ? 1e30f : -1e30f);
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  return Ray{ox, oy, oz, dx, dy, dz, safe_inv(dx), safe_inv(dy), safe_inv(dz)};
}

// Moller-Trumbore of a ray against the triangle of the 16-lane slot s: its
// t, u, v, and whether the ray's line crosses it (det away from zero, the
// barycentrics inside). The caller applies its own t window.
__device__ __forceinline__ bool slot_test(const float* s, const Ray& r,
                                          float det_eps, float& t, float& u,
                                          float& v) {
  const float t0x = __ldg(s + 0), t0y = __ldg(s + 1), t0z = __ldg(s + 2);
  const float e1x = __ldg(s + 3) - t0x, e1y = __ldg(s + 4) - t0y,
              e1z = __ldg(s + 5) - t0z;
  const float e2x = __ldg(s + 6) - t0x, e2y = __ldg(s + 7) - t0y,
              e2z = __ldg(s + 8) - t0z;
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool nonzero = fabsf(det) > det_eps;
  const float inv_det = nonzero ? 1.0f / det : 0.0f;
  const float tvx = r.ox - t0x, tvy = r.oy - t0y, tvz = r.oz - t0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return nonzero && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

// The stack code of child c of a node row: ref+1 (node), -(ref+1) (leaf
// row), -(kInstBase+ref+1) (instance), 0 (empty slot).
__device__ __forceinline__ int child_code(const float* row, int c) {
  const int ref = (int)__ldg(row + 48 + c);
  const float tag = __ldg(row + 56 + c);
  return tag > 2.5f ? -(kInstBase + ref + 1)
                    : (tag > 1.5f ? -(ref + 1) : (tag > 0.5f ? ref + 1 : 0));
}

// The slab test of a node row's child c in [t_min, limit]: whether the ray
// enters its box, and the entry distance.
__device__ __forceinline__ bool enters(const float* row, int c, const Ray& r,
                                       float t_min, float limit,
                                       float& tnear) {
  const float tx0 = (__ldg(row + c) - r.ox) * r.ivx;
  const float tx1 = (__ldg(row + 24 + c) - r.ox) * r.ivx;
  const float ty0 = (__ldg(row + 8 + c) - r.oy) * r.ivy;
  const float ty1 = (__ldg(row + 32 + c) - r.oy) * r.ivy;
  const float tz0 = (__ldg(row + 16 + c) - r.oz) * r.ivz;
  const float tz1 = (__ldg(row + 40 + c) - r.oz) * r.ivz;
  tnear = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                fmaxf(fminf(tz0, tz1), t_min));
  const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fminf(fmaxf(tz0, tz1), limit));
  return tnear <= tfar;
}

// Sort 8 (key, code) pairs by key, descending, in place, through the JAX
// package's 19-comparator network (sfvp_tpu/kernels/bvh_packet.py:247-250).
__device__ __forceinline__ void sort_desc(float key[8], int cc[8]) {
#define SFVP_CMPSWAP(a, b)                                 \
  {                                                        \
    const bool sw = key[a] < key[b];                       \
    const float ka = sw ? key[b] : key[a];                 \
    const float kb = sw ? key[a] : key[b];                 \
    const int ca = sw ? cc[b] : cc[a];                     \
    const int cb = sw ? cc[a] : cc[b];                     \
    key[a] = ka;                                           \
    key[b] = kb;                                           \
    cc[a] = ca;                                            \
    cc[b] = cb;                                            \
  }
  SFVP_CMPSWAP(0, 1) SFVP_CMPSWAP(2, 3) SFVP_CMPSWAP(4, 5)
  SFVP_CMPSWAP(6, 7) SFVP_CMPSWAP(0, 2) SFVP_CMPSWAP(1, 3)
  SFVP_CMPSWAP(4, 6) SFVP_CMPSWAP(5, 7) SFVP_CMPSWAP(1, 2)
  SFVP_CMPSWAP(5, 6) SFVP_CMPSWAP(0, 4) SFVP_CMPSWAP(3, 7)
  SFVP_CMPSWAP(1, 5) SFVP_CMPSWAP(2, 6) SFVP_CMPSWAP(1, 4)
  SFVP_CMPSWAP(3, 6) SFVP_CMPSWAP(2, 4) SFVP_CMPSWAP(3, 5)
  SFVP_CMPSWAP(3, 4)
#undef SFVP_CMPSWAP
}

// The children of a node row that a closest-hit walk pushes, far to near:
// cc[0..7] their codes (0 = none), the nearest last. Each child the ray
// enters in [t_min, limit] gets its entry distance as key (-inf for no
// push), and sort_desc orders the keys descending.
__device__ __forceinline__ void sorted_children(const float* row,
                                                const Ray& r, float t_min,
                                                float limit, int cc[8]) {
  float key[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float tnear;
    const bool hit = enters(row, c, r, t_min, limit, tnear);
    const int code_c = child_code(row, c);
    const bool push = code_c != 0 && hit;
    key[c] = push ? tnear : __int_as_float(0xff800000);  // -inf
    cc[c] = push ? code_c : 0;
  }
  sort_desc(key, cc);
}

// Closest hit in (t_min, tmax) of one ray. A ray with tmax <= t_min (an
// inactive one) misses without walking the tree. Static: each kernel's
// translation unit keeps its own copy.
static __device__ __noinline__ WideHit wide_closest_hit(const Wide& w, float ox,
                                                 float oy, float oz, float dx,
                                                 float dy, float dz,
                                                 float tmax) {
  WideHit h;
  h.t = __int_as_float(0x7f800000);
  h.u = 0.0f;
  h.v = 0.0f;
  h.row = -1;
  h.slot = -1;
  if (!(tmax > w.t_min)) return h;
  const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
  int stack[kMaxStack];
  stack[0] = 1;  // the root, internal node 0
  int sp = 1;
  while (sp > 0) {
    const int code = stack[--sp];
    if (code < 0) {
      // leaf row: Moller-Trumbore on its 8 slots, strict t < best
      const int row = -code - 1;
      const float* s = w.tris + (size_t)row * kRowLanes;
      for (int k = 0; k < 8; ++k) {
        float t, u, v;
        if (slot_test(s + 16 * k, r, w.det_eps, t, u, v) && t > w.t_min &&
            t < tmax && t < h.t) {
          h.t = t;
          h.u = u;
          h.v = v;
          h.row = row;
          h.slot = k;
        }
      }
    } else {
      // internal node: the children entered in [t_min, best], nearest
      // pushed last and popped first
      int cc[8];
      sorted_children(w.nodes + (size_t)(code - 1) * kRowLanes, r, w.t_min,
                      fminf(h.t, tmax), cc);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (cc[c] != 0) stack[sp++] = cc[c];
      }
    }
  }
  return h;
}

// Whether a triangle lies in (t_min, smax) along the ray (kernels/
// bvh_packet.py packet_occlusion_plain; sfvp_tpu's make_packet_occlusion
// kernel body, bvh_packet.py:469-602): the walk of wide_closest_hit with
// the window fixed at [t_min, smax], every child box the ray enters pushed
// in slot order, ending at the first hit. Which nodes are entered does
// not depend on the order, so neither does the answer. A ray with smax <=
// t_min (an inactive one) walks nothing. The stack is this function's
// own: K5 calls it after wide_closest_hit has returned, so the two frames
// take the same place on the thread's call stack.
//
// The walk has one exit. With a `return true` from inside the slot loop,
// K5 built for sm_90a by nvcc 12.8 lost whole samples of some lanes of a
// warp after their shadow walks (the 100k city at 1024x1024, 8 spp, against
// its twin); with a flag and a break it is bitwise.
static __device__ __noinline__ bool wide_any_hit(const Wide& w, float ox,
                                                 float oy, float oz, float dx,
                                                 float dy, float dz,
                                                 float smax) {
  if (!(smax > w.t_min)) return false;
  const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
  int stack[kMaxStack];
  stack[0] = 1;  // the root, internal node 0
  int sp = 1;
  bool hit = false;
  while (sp > 0 && !hit) {
    const int code = stack[--sp];
    if (code < 0) {
      const float* s = w.tris + (size_t)(-code - 1) * kRowLanes;
      for (int k = 0; k < 8; ++k) {
        float t, u, v;
        if (slot_test(s + 16 * k, r, w.det_eps, t, u, v) && t > w.t_min &&
            t < smax) {
          hit = true;
          break;
        }
      }
    } else {
      const float* row = w.nodes + (size_t)(code - 1) * kRowLanes;
      for (int c = 0; c < 8; ++c) {
        const int code_c = child_code(row, c);
        float tnear;
        if (code_c != 0 && enters(row, c, r, w.t_min, smax, tnear))
          stack[sp++] = code_c;
      }
    }
  }
  return hit;
}

// The shading data of a hit on the triangle of slot s whose (world-space)
// vertices are p: position from the barycentrics, normal -cross(e1, e2) /
// |cross| (1/sqrt of the squared length clamped at 1e-30, as sfvp_tpu's
// _shade_from_payload), the albedo lanes as both diffuse albedo and mirror
// tint, the emission, the packed material type.
__device__ __forceinline__ Surface slot_surface(const float* s,
                                                const float p[9], float u,
                                                float v) {
  Surface f;
  const float wb = 1.0f - u - v;
  f.posx = p[0] * wb + p[3] * u + p[6] * v;
  f.posy = p[1] * wb + p[4] * u + p[7] * v;
  f.posz = p[2] * wb + p[5] * u + p[8] * v;
  const float e1x = p[3] - p[0], e1y = p[4] - p[1], e1z = p[5] - p[2];
  const float e2x = p[6] - p[0], e2y = p[7] - p[1], e2z = p[8] - p[2];
  const float cx = e1y * e2z - e1z * e2y;
  const float cy = e1z * e2x - e1x * e2z;
  const float cz = e1x * e2y - e1y * e2x;
  const float inv_len = 1.0f / sqrtf(fmaxf(cx * cx + cy * cy + cz * cz, 1e-30f));
  f.nx = -(cx * inv_len);
  f.ny = -(cy * inv_len);
  f.nz = -(cz * inv_len);
  f.dr = f.sr = __ldg(s + 9);
  f.dg = f.sg = __ldg(s + 10);
  f.db = f.sb = __ldg(s + 11);
  f.er = __ldg(s + 12);
  f.eg = __ldg(s + 13);
  f.eb = __ldg(s + 14);
  f.mtype = __ldg(s + 15);
  return f;
}

// The texture coordinates of a hit (t, u, v) on slot a of a textured
// tree's aux rows: the per-corner vt interpolated with the barycentrics,
// as sfvp_tpu's K3 (bvh_packet.py:326-334), and texid+1.
__device__ __forceinline__ void slot_uv(const float* a, float u, float v,
                                        float& tu, float& tv, float& tid1) {
  const float wb = 1.0f - u - v;
  tu = __ldg(a) * wb + __ldg(a + 2) * u + __ldg(a + 4) * v;
  tv = __ldg(a + 1) * wb + __ldg(a + 3) * u + __ldg(a + 5) * v;
  tid1 = __ldg(a + 6);
}

// The shading data of a hit of the single-level tree (vertices as stored),
// the albedo times the map_Kd texel on a textured tree (IMG: the kernel
// was built for one, common.cuh table_surface).
template <bool IMG>
__device__ __forceinline__ Surface wide_surface(const Wide& w,
                                                const WideHit& h,
                                                const Params& prm) {
  const size_t off = (size_t)h.row * kRowLanes + 16 * h.slot;
  const float* s = w.tris + off;
  float p[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) p[j] = __ldg(s + j);
  Surface f = slot_surface(s, p, h.u, h.v);
  if (IMG && w.aux != nullptr) {
    float tu, tv, tid1, tr, tg, tb;
    slot_uv(w.aux + off, h.u, h.v, tu, tv, tid1);
    texel_bilinear(prm, (int)tid1 - 1, tu, tv, tr, tg, tb);
    f.dr = f.dr * tr;
    f.dg = f.dg * tg;
    f.db = f.db * tb;
  }
  return f;
}

// The payload planes of a hit (or a miss, row -1) of ray i of an (m,) wave:
// t, u, v, then the slot's 16 lanes (zeros on a miss), then on a textured
// tree texu, texv and texid+1 (zeros on a miss), the planes of K3 and K6.
__device__ __forceinline__ void write_payload(const Wide& w, float* out,
                                              size_t m, size_t i, float t,
                                              float u, float v, int row,
                                              int slot) {
  out[i] = t;
  out[m + i] = u;
  out[2 * m + i] = v;
  float tu = 0.0f, tv = 0.0f, tid1 = 0.0f;
  if (row >= 0) {
    const size_t off = (size_t)row * kRowLanes + 16 * slot;
    for (int j = 0; j < 16; ++j) out[(3 + j) * m + i] = __ldg(w.tris + off + j);
    if (w.aux != nullptr) slot_uv(w.aux + off, u, v, tu, tv, tid1);
  } else {
    for (int j = 0; j < 16; ++j) out[(3 + j) * m + i] = 0.0f;
  }
  if (w.aux != nullptr) {
    out[19 * m + i] = tu;
    out[20 * m + i] = tv;
    out[21 * m + i] = tid1;
  }
}

}  // namespace sfvp

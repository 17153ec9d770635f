// Closest-hit and any-hit traversal of the 8-wide BVH (accel/wide.py), one
// ray per thread: the closest hit shared by K3 (bvh_trace.cu) and K5
// (bvh_regen_render.cu), the any hit by K4 (bvh_occlusion.cu) and K5's
// shadow rays.
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
};

// Stack entries a thread can hold; the wrappers refuse a tree whose
// max_stack exceeds it (kernels/build.py MAX_WIDE_STACK).
constexpr int kMaxStack = 256;
constexpr int kRowLanes = 128;

struct WideHit {
  float t, u, v;  // t = +inf on a miss
  int row, slot;  // leaf row and triangle slot of the hit, -1 on a miss
};

__device__ __forceinline__ float safe_inv(float c) {
  return fabsf(c) > 1e-30f ? 1.0f / c : (c >= 0.0f ? 1e30f : -1e30f);
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
  const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
  int stack[kMaxStack];
  stack[0] = 1;  // the root, internal node 0
  int sp = 1;
  while (sp > 0) {
    const int code = stack[--sp];
    if (code < 0) {
      // leaf row: Moller-Trumbore on its 8 slots, strict t < best
      const int r = -code - 1;
      const float* row = w.tris + (size_t)r * kRowLanes;
      for (int k = 0; k < 8; ++k) {
        const float* s = row + 16 * k;
        const float t0x = __ldg(s + 0), t0y = __ldg(s + 1), t0z = __ldg(s + 2);
        const float t1x = __ldg(s + 3), t1y = __ldg(s + 4), t1z = __ldg(s + 5);
        const float t2x = __ldg(s + 6), t2y = __ldg(s + 7), t2z = __ldg(s + 8);
        const float e1x = t1x - t0x, e1y = t1y - t0y, e1z = t1z - t0z;
        const float e2x = t2x - t0x, e2y = t2y - t0y, e2z = t2z - t0z;
        const float pvx = dy * e2z - dz * e2y;
        const float pvy = dz * e2x - dx * e2z;
        const float pvz = dx * e2y - dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const bool nonzero = fabsf(det) > w.det_eps;
        const float inv_det = nonzero ? 1.0f / det : 0.0f;
        const float tvx = ox - t0x, tvy = oy - t0y, tvz = oz - t0z;
        const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
        const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        if (nonzero && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
            t > w.t_min && t < tmax && t < h.t) {
          h.t = t;
          h.u = u;
          h.v = v;
          h.row = r;
          h.slot = k;
        }
      }
    } else {
      // internal node: slab-test the 8 children against [t_min, best]
      const float* row = w.nodes + (size_t)(code - 1) * kRowLanes;
      const float limit = fminf(h.t, tmax);
      float key[8];
      int cc[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float tx0 = (__ldg(row + c) - ox) * ivx;
        const float tx1 = (__ldg(row + 24 + c) - ox) * ivx;
        const float ty0 = (__ldg(row + 8 + c) - oy) * ivy;
        const float ty1 = (__ldg(row + 32 + c) - oy) * ivy;
        const float tz0 = (__ldg(row + 16 + c) - oz) * ivz;
        const float tz1 = (__ldg(row + 40 + c) - oz) * ivz;
        const float tnear = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                  fmaxf(fminf(tz0, tz1), w.t_min));
        const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                 fminf(fmaxf(tz0, tz1), limit));
        const int ref = (int)__ldg(row + 48 + c);
        const float tag = __ldg(row + 56 + c);
        const int code_c = tag > 1.5f ? -(ref + 1) : (tag > 0.5f ? ref + 1 : 0);
        const bool push = code_c != 0 && tnear <= tfar;
        key[c] = push ? tnear : __int_as_float(0xff800000);  // -inf
        cc[c] = push ? code_c : 0;
      }
      // descending sort by key (the JAX package's network): the nearest
      // child is pushed last and popped first
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
// in slot order, returning at the first hit. Which nodes are entered does
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
  const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
  int stack[kMaxStack];
  stack[0] = 1;  // the root, internal node 0
  int sp = 1;
  bool hit = false;
  while (sp > 0 && !hit) {
    const int code = stack[--sp];
    if (code < 0) {
      const float* row = w.tris + (size_t)(-code - 1) * kRowLanes;
      for (int k = 0; k < 8; ++k) {
        const float* s = row + 16 * k;
        const float t0x = __ldg(s + 0), t0y = __ldg(s + 1), t0z = __ldg(s + 2);
        const float e1x = __ldg(s + 3) - t0x, e1y = __ldg(s + 4) - t0y,
                    e1z = __ldg(s + 5) - t0z;
        const float e2x = __ldg(s + 6) - t0x, e2y = __ldg(s + 7) - t0y,
                    e2z = __ldg(s + 8) - t0z;
        const float pvx = dy * e2z - dz * e2y;
        const float pvy = dz * e2x - dx * e2z;
        const float pvz = dx * e2y - dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const bool nonzero = fabsf(det) > w.det_eps;
        const float inv_det = nonzero ? 1.0f / det : 0.0f;
        const float tvx = ox - t0x, tvy = oy - t0y, tvz = oz - t0z;
        const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
        const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        if (nonzero && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
            t > w.t_min && t < smax) {
          hit = true;
          break;
        }
      }
    } else {
      const float* row = w.nodes + (size_t)(code - 1) * kRowLanes;
      for (int c = 0; c < 8; ++c) {
        const float tag = __ldg(row + 56 + c);
        if (!(tag > 0.5f)) continue;
        const float tx0 = (__ldg(row + c) - ox) * ivx;
        const float tx1 = (__ldg(row + 24 + c) - ox) * ivx;
        const float ty0 = (__ldg(row + 8 + c) - oy) * ivy;
        const float ty1 = (__ldg(row + 32 + c) - oy) * ivy;
        const float tz0 = (__ldg(row + 16 + c) - oz) * ivz;
        const float tz1 = (__ldg(row + 40 + c) - oz) * ivz;
        const float tnear = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                  fmaxf(fminf(tz0, tz1), w.t_min));
        const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                 fminf(fmaxf(tz0, tz1), smax));
        if (tnear <= tfar) {
          const int ref = (int)__ldg(row + 48 + c);
          stack[sp++] = tag > 1.5f ? -(ref + 1) : ref + 1;
        }
      }
    }
  }
  return hit;
}

// The shading data of a hit from its triangle slot: position from the
// barycentrics, normal -cross(e1, e2) / |cross| (1/sqrt of the squared
// length clamped at 1e-30, as sfvp_tpu's _shade_from_payload), the albedo
// lanes as both diffuse albedo and mirror tint, the emission, the packed
// material type.
__device__ __forceinline__ Surface wide_surface(const Wide& w,
                                                const WideHit& h) {
  const float* s = w.tris + (size_t)h.row * kRowLanes + 16 * h.slot;
  const float p0x = __ldg(s + 0), p0y = __ldg(s + 1), p0z = __ldg(s + 2);
  const float p1x = __ldg(s + 3), p1y = __ldg(s + 4), p1z = __ldg(s + 5);
  const float p2x = __ldg(s + 6), p2y = __ldg(s + 7), p2z = __ldg(s + 8);
  Surface f;
  const float wb = 1.0f - h.u - h.v;
  f.posx = p0x * wb + p1x * h.u + p2x * h.v;
  f.posy = p0y * wb + p1y * h.u + p2y * h.v;
  f.posz = p0z * wb + p1z * h.u + p2z * h.v;
  const float e1x = p1x - p0x, e1y = p1y - p0y, e1z = p1z - p0z;
  const float e2x = p2x - p0x, e2y = p2y - p0y, e2z = p2z - p0z;
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

}  // namespace sfvp

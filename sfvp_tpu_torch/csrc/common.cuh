// Device functions shared by the path-tracing kernels (regen_render.cu =
// K1, wave_render.cu = K2, bvh_regen_render.cu = K5 and K9) and the
// environment fetch (env_fetch.cu = P3, P4): bit-exact PCG, the camera ray
// (through the thin lens when it is open), Moller-Trumbore closest and any
// hit against a scene table in shared memory, the bilinear fetch of a
// texture or of the equirect environment map, the environment's
// importance sampling, and the shading of a hit (emission, next-event
// estimation toward the area lights and the environment, the next
// direction of a diffuse, mirror, GGX glossy or dielectric face,
// roulette).
//
// 1/sqrt is 1.0f / sqrtf(x), two correctly rounded ops, never the
// approximate rsqrtf (see utils/vec.py inv_sqrt). atan2f, acosf, sinf and
// cosf are the CUDA math library's, which PyTorch's CUDA atan2, acos, sin
// and cos call too (neither builds with fast math).
//
// Every expression keeps the operation order of the plain PyTorch twin
// (sfvp_tpu_torch/integrate/wavefront.py and scene/textures.py, which in
// turn keep that of the JAX package), and the library is built with
// -fmad=false: with no fused multiply-adds each float op rounds as the
// twin's does, so the kernels can agree with the twins bit for bit on the
// card.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sfvp {

// Launch parameters; mirrored field for field by kernels/build.py Params.
struct Params {
  int frame, row0, gw, gh, npix, spp, max_depth, uniform, use_rr, rr_start;
  int chunk, chunk_idx, num_tris, tp;
  float t_min, t_max, inv2w, inv2h, two_pi, uniform_scale, det_eps;
  float cam_c[3], cam_r[3], cam_u[3], cam_o[3], sky[3];
  // next-event estimation (integrate/lights.py): the light count, the
  // float32 total area and the float32 1/total_area the host rounds, 1/pi
  // and the uniform hemisphere pdf 1/(2 pi)
  int use_nee, use_mis, num_lights;
  float total_area, inv_area, inv_pi, uniform_pdf;
  // environment map (scene/textures.py): its size, and under NEE its
  // importance distribution's grid (integrate/lights.py EnvDistribution);
  // map_Kd textures; the brute-force table's rows (20, or 27 with the vt
  // and texid+1 rows) and its tile (0: the whole table in shared memory)
  int use_env, use_env_nee, env_w, env_h, dist_w, dist_h, use_tex, rows,
      tile;
  // float32 constants of the environment: W*H/(2 pi^2), pi/H, 2 pi/W and
  // H/pi of the distribution's grid, 1/(2 pi) and pi
  float env_inv_patch, env_pi_over_h, env_two_pi_over_w, env_h_over_pi,
      inv_two_pi, pi;
  const float *env_r, *env_g, *env_b, *env_cdf, *env_pdf;
  const float *tex_r, *tex_g, *tex_b;
  const int *tex_off, *tex_w, *tex_h;
  // GGX glossy or dielectric faces in the scene (the kernels built with
  // their shading, template flag MAT, take it); the thin lens (template
  // flag DOF): its radius, focal distance and float32 frame (right, up,
  // forward, each normalized; camera.lens_frame)
  int use_mat, use_dof;
  float lens_r, focus_d, lens_rn[3], lens_un[3], lens_fwd[3];
};

// A shadow ray stops float32(1 - 1e-3) of the way to its light sample
// (integrate/wavefront.py SHADOW_SCALE).
constexpr float kShadowScale = 0.999f;
constexpr int kBlock = 128;

// The brute-force scene table in shared memory: one 12-float record a
// triangle, v0 xyz, e1 = v1 - v0 and e2 = v2 - v0 (each computed once per
// block), then three zeros, so that a test reads its triangle by three
// 16-byte loads (closest_hit, brute_any_hit). The shading of a hit reads
// the host table's rows from device memory (table_surface), as the tiled
// kernels do (kernels/build.py table_plan sizes it: 48 bytes a triangle).
constexpr int kRecord = 12;

__device__ __forceinline__ void load_table(float* tab, const float* table,
                                           const Params& p) {
  for (int j = threadIdx.x; j < p.num_tris; j += blockDim.x) {
    const float* c = table + j;
    float* rec = tab + kRecord * j;
    for (int a = 0; a < 3; ++a) {
      const float v0 = c[a * p.tp];
      rec[a] = v0;
      rec[3 + a] = c[(3 + a) * p.tp] - v0;
      rec[6 + a] = c[(6 + a) * p.tp] - v0;
    }
    rec[9] = rec[10] = rec[11] = 0.0f;
  }
}

// A tile of a table too large for shared memory: triangles k0..k0+n-1 of
// the host table as 9 rows of stride p.tile, v0 xyz then e1 and e2 xyz,
// all the intersection tests read. The block loads it together.
__device__ __forceinline__ void load_tile(float* tile, const float* table,
                                          const Params& p, int k0, int n) {
  const int S = p.tile;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float* c = table + k0 + j;
    for (int a = 0; a < 3; ++a) {
      const float v0 = c[a * p.tp];
      tile[a * S + j] = v0;
      tile[(3 + a) * S + j] = c[(3 + a) * p.tp] - v0;
      tile[(6 + a) * S + j] = c[(6 + a) * p.tp] - v0;
    }
  }
}

// ---- PCG, ref shaders/common.glsl:13-37 ----
__device__ __forceinline__ uint32_t pcg(uint32_t& state) {
  const uint32_t prev = state * 747796405u + 2891336453u;
  const uint32_t word = ((prev >> ((prev >> 28u) + 4u)) ^ prev) * 277803737u;
  state = prev;
  return (word >> 22u) ^ word;
}

// float(u) * 2^-32: the reference's rand, including that it can return 1.0
__device__ __forceinline__ float rand01(uint32_t& state) {
  return __uint2float_rn(pcg(state)) * 0x1p-32f;
}

// seed = pcg2d(pixel * (sample + spp*frame + 1)), s.x + s.y
// (ref shaders/raygen.rgen:47-48)
__device__ __forceinline__ uint32_t sample_seed(int px, int py, int sample,
                                                const Params& p) {
  const uint32_t k = 1664525u, c = 1013904223u;
  const uint32_t m = (uint32_t)sample + (uint32_t)p.spp * (uint32_t)p.frame + 1u;
  uint32_t vx = (uint32_t)px * m, vy = (uint32_t)py * m;
  vx = vx * k + c;
  vy = vy * k + c;
  vx = vx + vy * k;
  vy = vy + vx * k;
  vx = vx ^ (vx >> 16u);
  vy = vy ^ (vy >> 16u);
  vx = vx + vy * k;
  vy = vy + vx * k;
  vx = vx ^ (vx >> 16u);
  vy = vy ^ (vy >> 16u);
  return vx + vy;
}

struct Path {
  float ox, oy, oz, dx, dy, dz;  // ray
  float wr, wg, wb;              // throughput
  uint32_t seed;
  float pdf_prev;   // MIS: solid-angle pdf of the direction that led here
  bool count_emit;  // NEE: emission counts in full (camera ray, mirror)
};

// Seed a sample and shoot its camera ray (ref shaders/raygen.rgen:50-57);
// DOF: two more numbers move it through the thin lens
// (camera.apply_thin_lens_soa: a uniform disk sample on the lens, re-aimed
// at the pinhole ray's point on the focal plane; sfvp_tpu
// megakernel_regen.py:232-246, :368).
template <bool DOF = false>
__device__ __forceinline__ Path camera_path(int px, int py, int sample,
                                            const Params& p) {
  Path q;
  q.seed = sample_seed(px, py, sample, p);
  const float r1 = rand01(q.seed);
  const float r2 = rand01(q.seed);
  const float sx = ((float)px + r1) * p.inv2w - 1.0f;
  const float sy = ((float)py + r2) * p.inv2h - 1.0f;
  float dx = p.cam_c[0] + sx * p.cam_r[0] + sy * p.cam_u[0] - p.cam_o[0];
  float dy = p.cam_c[1] + sx * p.cam_r[1] + sy * p.cam_u[1] - p.cam_o[1];
  float dz = p.cam_c[2] + sx * p.cam_r[2] + sy * p.cam_u[2] - p.cam_o[2];
  const float inv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  q.dx = dx * inv;
  q.dy = dy * inv;
  q.dz = dz * inv;
  q.ox = p.cam_o[0];
  q.oy = p.cam_o[1];
  q.oz = p.cam_o[2];
  if (DOF) {
    const float rl1 = rand01(q.seed);
    const float rl2 = rand01(q.seed);
    const float rad = p.lens_r * sqrtf(fmaxf(rl1, 0.0f));
    const float phi = p.two_pi * rl2;
    const float lx = rad * cosf(phi);
    const float ly = rad * sinf(phi);
    // focus_d / cos as torch's scalar / tensor: its reciprocal, then times
    const float t_focal =
        (1.0f / fmaxf(q.dx * p.lens_fwd[0] + q.dy * p.lens_fwd[1] +
                          q.dz * p.lens_fwd[2],
                      1e-4f)) *
        p.focus_d;
    const float fx = q.ox + q.dx * t_focal;
    const float fy = q.oy + q.dy * t_focal;
    const float fz = q.oz + q.dz * t_focal;
    q.ox = q.ox + lx * p.lens_rn[0] + ly * p.lens_un[0];
    q.oy = q.oy + lx * p.lens_rn[1] + ly * p.lens_un[1];
    q.oz = q.oz + lx * p.lens_rn[2] + ly * p.lens_un[2];
    dx = fx - q.ox;
    dy = fy - q.oy;
    dz = fz - q.oz;
    const float il = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
    q.dx = dx * il;
    q.dy = dy * il;
    q.dz = dz * il;
  }
  q.wr = q.wg = q.wb = 1.0f;
  q.pdf_prev = 0.0f;
  q.count_emit = true;
  return q;
}

// Moller-Trumbore of a ray against the triangle (v0, e1, e2): its t, u, v,
// and whether the ray's line crosses it (det away from zero, the
// barycentrics inside). The caller applies its own t window.
__device__ __forceinline__ bool tri_test(float v0x, float v0y, float v0z,
                                         float e1x, float e1y, float e1z,
                                         float e2x, float e2y, float e2z,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float det_eps, float& t, float& u,
                                         float& v) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool nonzero = fabsf(det) > det_eps;
  const float inv_det = nonzero ? 1.0f / det : 0.0f;
  const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return nonzero && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

// tri_test of triangle j of a tile of stride S whose vertex rows start at
// v0 (x, y, z) and edge rows at e (e1 xyz, e2 xyz).
__device__ __forceinline__ bool table_test(const float* v0, const float* e,
                                           int S, int j, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float det_eps, float& t,
                                           float& u, float& v) {
  return tri_test(v0[j], v0[S + j], v0[2 * S + j], e[j], e[S + j],
                  e[2 * S + j], e[3 * S + j], e[4 * S + j], e[5 * S + j], ox,
                  oy, oz, dx, dy, dz, det_eps, t, u, v);
}

// tri_test of record j of the shared-memory table, read by three 16-byte
// loads.
__device__ __forceinline__ bool record_test(const float* tab, int j,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float det_eps, float& t,
                                            float& u, float& v) {
  const float4* r = reinterpret_cast<const float4*>(tab + kRecord * j);
  const float4 a = r[0], b = r[1], c = r[2];
  return tri_test(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox, oy, oz,
                  dx, dy, dz, det_eps, t, u, v);
}

// Closest hit over triangles k0..k0+n-1 (table index j = k - k0), in
// ascending order with a strict t < best: of equal t the lowest id wins.
// Updates the best (prim, t, u, v); prim -1 until a hit.
__device__ __forceinline__ void closest_range(const float* v0, const float* e,
                                              int S, int k0, int n,
                                              const Params& p, const Path& q,
                                              int& prim, float& bt,
                                              float& bu, float& bv) {
  for (int j = 0; j < n; ++j) {
    float t, u, v;
    if (table_test(v0, e, S, j, q.ox, q.oy, q.oz, q.dx, q.dy, q.dz,
                   p.det_eps, t, u, v) &&
        t > p.t_min && t < p.t_max && t < bt) {
      bt = t;
      bu = u;
      bv = v;
      prim = k0 + j;
    }
  }
}

// Closest hit over the whole shared-memory table, in ascending order with
// a strict t < best, as closest_range. Returns the triangle id, or -1 on a
// miss, and its t, u, v.
__device__ __forceinline__ int closest_hit(const float* tab, const Params& p,
                                           const Path& q, float& bt,
                                           float& bu, float& bv) {
  bt = __int_as_float(0x7f800000);  // +inf
  bu = 0.0f;
  bv = 0.0f;
  int prim = -1;
  for (int j = 0; j < p.num_tris; ++j) {
    float t, u, v;
    if (record_test(tab, j, q.ox, q.oy, q.oz, q.dx, q.dy, q.dz, p.det_eps, t,
                    u, v) &&
        t > p.t_min && t < p.t_max && t < bt) {
      bt = t;
      bu = u;
      bv = v;
      prim = j;
    }
  }
  return prim;
}

// Whether any triangle lies in (t_min, smax) along the ray: the same
// Moller-Trumbore as closest_hit, stopping at the first hit. One exit, as
// wide_any_hit (wide_bvh.cuh) needs.
__device__ __forceinline__ bool brute_any_hit(const float* tab,
                                              const Params& p, float ox,
                                              float oy, float oz, float dx,
                                              float dy, float dz,
                                              float smax) {
  bool hit = false;
  for (int k = 0; k < p.num_tris && !hit; ++k) {
    float t, u, v;
    hit = record_test(tab, k, ox, oy, oz, dx, dy, dz, p.det_eps, t, u, v) &&
          t > p.t_min && t < smax;
  }
  return hit;
}

// What the shading after a hit needs of the surface (ref
// closesthit.rchit:43-65): the hit point, the geometric normal
// -normalize(cross(e1, e2)), the albedo that diffuse sampling scales by
// (times the map_Kd texel on a textured face), the emission, the Ks tint
// of a mirror, GGX or dielectric face, the material type (1 mirror, 2 GGX,
// 3 dielectric: an integer from the brute-force table, the packed lane
// mtype + fraction of a wide tree's leaf) and the roughness or encoded IOR
// (Ni - 1) / 4 of GGX and dielectric faces.
struct Surface {
  float posx, posy, posz, nx, ny, nz;
  float dr, dg, db;
  float er, eg, eb;
  float sr, sg, sb;
  float mtype, rough;
};

// The material classes, split as sfvp_tpu's kernels split the packed lane
// (megakernel_bvh.py:1388-1400): a GGX lane holds at most 2.96 (roughness
// clipped to 0.96, accel/wide.py), a dielectric's 3.0 and up, so the cut
// is at 2.98, not 2.5.
__device__ __forceinline__ bool is_mirror(float mtype) {
  return mtype > 0.5f && mtype < 1.5f;
}
__device__ __forceinline__ bool is_glossy(float mtype) {
  return mtype > 1.5f && mtype < 2.98f;
}
__device__ __forceinline__ bool is_dielectric(float mtype) {
  return mtype > 2.98f;
}

// ---- GGX glossy (sampling.py, integrate/wavefront.py ggx_*) ----
//
// Trowbridge-Reitz/GGX reflection with Smith height-correlated shadowing
// and VNDF sampling (Heitz 2018), in the shading frame of the normal
// flipped toward the incoming ray, the Ks tint as Schlick's F0: sfvp_tpu
// wavefront.py:355-403, :566-588, megakernel_bvh.py:1402-1445. Each
// expression keeps the twin's operation order.

__device__ __forceinline__ float ggx_lambda(float cos_t, float alpha) {
  const float c = fmaxf(fabsf(cos_t), 1e-6f);
  const float c2 = c * c;
  const float tan2 = fmaxf(1.0f - c2, 0.0f) / c2;
  return 0.5f * (-1.0f + sqrtf(1.0f + alpha * alpha * tan2));
}

__device__ __forceinline__ float ggx_d(const Params& p, float cos_h,
                                       float alpha) {
  const float a2 = alpha * alpha;
  const float c = fmaxf(cos_h, 0.0f);
  const float denom = c * c * (a2 - 1.0f) + 1.0f;
  return a2 * p.inv_pi / fmaxf(denom * denom, 1e-12f);
}

// G1(wo) D(h) / (4 cos_o): the solid-angle pdf of a VNDF-sampled direction.
__device__ __forceinline__ float ggx_vndf_pdf(const Params& p, float cos_o,
                                              float cos_h, float alpha) {
  const float g1 = 1.0f / (1.0f + ggx_lambda(cos_o, alpha));
  return g1 * ggx_d(p, cos_h, alpha) / fmaxf(4.0f * cos_o, 1e-6f);
}

// The frame of a GGX hit: n_g (the normal toward the incoming ray) with
// its tangent basis (coordinate_system_soa), the view direction in it
// (its z clamped at 1e-6), alpha = max(rough^2, 1e-4) and Lambda(wo).
struct Ggx {
  float tx, ty, tz, bx, by, bz, nx, ny, nz;
  float wox, woy, woz, alpha, lam_o;
};

__device__ __forceinline__ Ggx ggx_frame(const Surface& s, const Path& q) {
  Ggx g;
  const bool flip = q.dx * s.nx + q.dy * s.ny + q.dz * s.nz > 0.0f;
  g.nx = flip ? s.nx * -1.0f : s.nx;
  g.ny = flip ? s.ny * -1.0f : s.ny;
  g.nz = flip ? s.nz * -1.0f : s.nz;
  const bool use_x = fabsf(g.nx) > fabsf(g.ny);
  const float inv_a = 1.0f / sqrtf(g.nx * g.nx + g.nz * g.nz);
  const float inv_b = 1.0f / sqrtf(g.ny * g.ny + g.nz * g.nz);
  g.tx = use_x ? g.nz * inv_a : 0.0f;
  g.ty = use_x ? 0.0f : -g.nz * inv_b;
  g.tz = use_x ? -g.nx * inv_a : g.ny * inv_b;
  g.bx = g.ny * g.tz - g.nz * g.ty;
  g.by = g.nz * g.tx - g.nx * g.tz;
  g.bz = g.nx * g.ty - g.ny * g.tx;
  const float wx = q.dx * -1.0f, wy = q.dy * -1.0f, wz = q.dz * -1.0f;
  g.woz = fmaxf(wx * g.nx + wy * g.ny + wz * g.nz, 1e-6f);
  g.wox = wx * g.tx + wy * g.ty + wz * g.tz;
  g.woy = wx * g.bx + wy * g.by + wz * g.bz;
  g.alpha = fmaxf(s.rough * s.rough, 1e-4f);
  g.lam_o = ggx_lambda(g.woz, g.alpha);
  return g;
}

// Schlick's Fresnel of one channel, F0 the Ks tint.
__device__ __forceinline__ float ggx_fresnel(float f0, float coh) {
  const float m1 = 1.0f - coh;
  float f5 = m1 * m1;
  f5 = f5 * f5 * m1;
  return f0 + (1.0f - f0) * f5;
}

// f_r (fr, fg, fb), the VNDF pdf and the cosine to n_g of the light
// direction (wlx, wly, wlz) (integrate/wavefront.py ggx_eval).
__device__ __forceinline__ void ggx_eval(const Params& p, const Ggx& g,
                                         const Surface& s, float wlx,
                                         float wly, float wlz, float& fr,
                                         float& fg, float& fb, float& pdf,
                                         float& cos_i) {
  const float lx = wlx * g.tx + wly * g.ty + wlz * g.tz;
  const float ly = wlx * g.bx + wly * g.by + wlz * g.bz;
  cos_i = wlx * g.nx + wly * g.ny + wlz * g.nz;
  float hx = g.wox + lx, hy = g.woy + ly, hz = g.woz + cos_i;
  const float inv_h = 1.0f / sqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
  hx = hx * inv_h;
  hy = hy * inv_h;
  hz = hz * inv_h;
  const float dgg = ggx_d(p, hz, g.alpha);
  const float g2 = 1.0f / (1.0f + g.lam_o + ggx_lambda(cos_i, g.alpha));
  const float coh = fmaxf(g.wox * hx + g.woy * hy + g.woz * hz, 1e-6f);
  const float denom = fmaxf(4.0f * g.woz * fmaxf(cos_i, 1e-6f), 1e-6f);
  fr = ggx_fresnel(s.sr, coh) * dgg * g2 / denom;
  fg = ggx_fresnel(s.sg, coh) * dgg * g2 / denom;
  fb = ggx_fresnel(s.sb, coh) * dgg * g2 / denom;
  pdf = ggx_vndf_pdf(p, g.woz, hz, g.alpha);
}

// The GGX bounce from r1, r2 (the hemisphere sample's numbers): a VNDF
// half-vector (sampling.py ggx_sample_vndf_local), the reflected direction
// in world space (nd), its weight F G2 / G1(wo) (f), its pdf; false when
// it lies below the surface, which absorbs the path.
__device__ __forceinline__ bool ggx_bounce(const Params& p, const Ggx& g,
                                           const Surface& s, float r1,
                                           float r2, float& ndx, float& ndy,
                                           float& ndz, float& fr, float& fg,
                                           float& fb, float& pdf) {
  float vx = g.alpha * g.wox, vy = g.alpha * g.woy, vz = g.woz;
  const float inv_len = 1.0f / sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-20f));
  vx = vx * inv_len;
  vy = vy * inv_len;
  vz = vz * inv_len;
  const float lensq = vx * vx + vy * vy;
  const float inv_l = 1.0f / sqrtf(fmaxf(lensq, 1e-20f));
  const bool ok = lensq > 1e-12f;
  const float t1x = ok ? -vy * inv_l : 1.0f;
  const float t1y = ok ? vx * inv_l : 0.0f;
  const float t1z = 0.0f;
  const float t2x = vy * t1z - vz * t1y;
  const float t2y = vz * t1x - vx * t1z;
  const float t2z = vx * t1y - vy * t1x;
  const float rr = sqrtf(fmaxf(r1, 0.0f));
  const float phi = p.two_pi * r2;
  const float p1 = rr * cosf(phi);
  float p2 = rr * sinf(phi);
  const float sw = 0.5f * (1.0f + vz);
  p2 = (1.0f - sw) * sqrtf(fmaxf(1.0f - p1 * p1, 0.0f)) + sw * p2;
  const float p3 = sqrtf(fmaxf(1.0f - p1 * p1 - p2 * p2, 0.0f));
  float hx = g.alpha * (t1x * p1 + t2x * p2 + vx * p3);
  float hy = g.alpha * (t1y * p1 + t2y * p2 + vy * p3);
  float hz = fmaxf(t1z * p1 + t2z * p2 + vz * p3, 1e-6f);
  const float inv_h = 1.0f / sqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
  hx = hx * inv_h;
  hy = hy * inv_h;
  hz = hz * inv_h;
  const float coh = fmaxf(g.wox * hx + g.woy * hy + g.woz * hz, 1e-6f);
  const float k = 2.0f * coh;
  const float wix = hx * k - g.wox, wiy = hy * k - g.woy, wiz = hz * k - g.woz;
  ndx = g.tx * wix + g.bx * wiy + g.nx * wiz;
  ndy = g.ty * wix + g.by * wiy + g.ny * wiz;
  ndz = g.tz * wix + g.bz * wiy + g.nz * wiz;
  const float g2_over_g1 =
      (1.0f + g.lam_o) / (1.0f + g.lam_o + ggx_lambda(wiz, g.alpha));
  fr = ggx_fresnel(s.sr, coh) * g2_over_g1;
  fg = ggx_fresnel(s.sg, coh) * g2_over_g1;
  fb = ggx_fresnel(s.sb, coh) * g2_over_g1;
  pdf = ggx_vndf_pdf(p, g.woz, hz, g.alpha);
  return wiz > 1e-5f;
}

// The smooth dielectric's next direction (sampling.py
// dielectric_reflect_refract_soa; sfvp_tpu wavefront.py:606-625): Snell
// with the exact unpolarized Fresnel split, reflection where it totally
// reflects or r1 < F, the IOR 1 + 4 rough.
__device__ __forceinline__ void dielectric_dir(const Surface& s,
                                               const Path& q, float r1,
                                               float& ndx, float& ndy,
                                               float& ndz) {
  const bool entering = q.dx * s.nx + q.dy * s.ny + q.dz * s.nz < 0.0f;
  const float nx = entering ? s.nx : s.nx * -1.0f;
  const float ny = entering ? s.ny : s.ny * -1.0f;
  const float nz = entering ? s.nz : s.nz * -1.0f;
  const float ior = 1.0f + 4.0f * s.rough;
  const float eta = entering ? 1.0f / ior : ior;
  const float dn = q.dx * nx + q.dy * ny + q.dz * nz;
  const float cos_i = fminf(fmaxf(-dn, 0.0f), 1.0f);
  const float sin2_t = eta * eta * fmaxf(1.0f - cos_i * cos_i, 0.0f);
  const bool tir = sin2_t > 1.0f;
  const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
  const float rs = (eta * cos_i - cos_t) / fmaxf(eta * cos_i + cos_t, 1e-12f);
  const float rp = (eta * cos_t - cos_i) / fmaxf(eta * cos_t + cos_i, 1e-12f);
  const float fres = tir ? 1.0f : 0.5f * (rs * rs + rp * rp);
  if (tir || r1 < fres) {
    const float k = 2.0f * dn;
    ndx = q.dx - nx * k;
    ndy = q.dy - ny * k;
    ndz = q.dz - nz * k;
  } else {
    const float k = eta * cos_i - cos_t;
    ndx = q.dx * eta + nx * k;
    ndy = q.dy * eta + ny * k;
    ndz = q.dz * eta + nz * k;
  }
}

// ---- textures and the environment map (scene/textures.py) ----

// Python's modulo of i by n > 0 (torch.remainder, jnp.mod): the repeat wrap.
__device__ __forceinline__ int wrap_index(int i, int n) {
  return ((i % n) + n) % n;
}

// The four texel indices of a bilinear fetch at (u, v) of the w x h
// texture at texel ``base`` of a pool, and their weights: repeat wrap, v
// from the bottom, in the order of textures.py bilinear_taps.
__device__ __forceinline__ void bilinear_taps(int base, int wi, int hi,
                                              float u, float v, int idx[4],
                                              float wt[4]) {
  const float w = (float)wi, h = (float)hi;
  const float uu = u - floorf(u);
  const float vv = v - floorf(v);
  const float x = uu * w - 0.5f;
  const float y = (1.0f - vv) * h - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int x0i = wrap_index((int)x0, wi), x1i = wrap_index((int)(x0 + 1.0f), wi);
  const int y0i = wrap_index((int)y0, hi), y1i = wrap_index((int)(y0 + 1.0f), hi);
  idx[0] = base + y0i * wi + x0i;
  idx[1] = base + y0i * wi + x1i;
  idx[2] = base + y1i * wi + x0i;
  idx[3] = base + y1i * wi + x1i;
  wt[0] = (1.0f - fx) * (1.0f - fy);
  wt[1] = fx * (1.0f - fy);
  wt[2] = (1.0f - fx) * fy;
  wt[3] = fx * fy;
}

// a*w00 + b*w10 + c*w01 + d*w11 of one channel's texels (textures.py blend).
__device__ __forceinline__ float blend(const float* __restrict__ c,
                                       const int idx[4], const float wt[4]) {
  return __ldg(c + idx[0]) * wt[0] + __ldg(c + idx[1]) * wt[1] +
         __ldg(c + idx[2]) * wt[2] + __ldg(c + idx[3]) * wt[3];
}

// Bilinear fetch at (u, v) of the w x h texture at texel ``base`` of the
// SoA pool (r, g, b): sample_bilinear of one texture.
__device__ __forceinline__ void bilinear(const float* __restrict__ r,
                                         const float* __restrict__ g,
                                         const float* __restrict__ b,
                                         int base, int wi, int hi, float u,
                                         float v, float& cr, float& cg,
                                         float& cb) {
  int idx[4];
  float wt[4];
  bilinear_taps(base, wi, hi, u, v, idx, wt);
  cr = blend(r, idx, wt);
  cg = blend(g, idx, wt);
  cb = blend(b, idx, wt);
}

// The map_Kd texel of texture ``tid`` at (u, v); white for tid < 0
// (sample_bilinear).
__device__ __forceinline__ void texel_bilinear(const Params& p, int tid,
                                               float u, float v, float& cr,
                                               float& cg, float& cb) {
  if (tid < 0) {
    cr = cg = cb = 1.0f;
    return;
  }
  bilinear(p.tex_r, p.tex_g, p.tex_b, __ldg(p.tex_off + tid),
           __ldg(p.tex_w + tid), __ldg(p.tex_h + tid), u, v, cr, cg, cb);
}

// The (u, v) the equirect map is read at in direction d: longitude from
// atan2(z, x), latitude from acos(y), v clamped to the band of texel
// centres (textures.py equirect_uv).
__device__ __forceinline__ void equirect_uv(const Params& p, float dx,
                                            float dy, float dz, float& u,
                                            float& v) {
  u = atan2f(dz, dx) * p.inv_two_pi + 0.5f;
  v = 1.0f - acosf(fminf(fmaxf(dy, -1.0f), 1.0f)) * p.inv_pi;
  const float h = (float)p.env_h;
  v = fminf(fmaxf(v, 0.5f / h), 1.0f - 0.5f / h);
}

// The environment's radiance in direction d (sample_environment): the
// fetch of a miss in K1 and K5, of their env NEE, and P3's whole work.
__device__ __forceinline__ void env_lookup(const Params& p, float dx,
                                           float dy, float dz, float& cr,
                                           float& cg, float& cb) {
  float u, v;
  equirect_uv(p, dx, dy, dz, u, v);
  bilinear(p.env_r, p.env_g, p.env_b, 0, p.env_w, p.env_h, u, v, cr, cg,
           cb);
}

// A direction drawn from the environment's importance distribution
// (lights.sample_env): the cell holding the count of CDF entries <= r_sel
// (a binary search of the non-decreasing CDF in global memory, as
// pick_light), jittered uniformly in (theta, phi); its solid-angle pdf.
__device__ __forceinline__ void env_sample(const Params& p, float r_sel,
                                           float r1, float r2, float& wx,
                                           float& wy, float& wz,
                                           float& pdf) {
  const int n = p.dist_w * p.dist_h;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(p.env_cdf + mid) <= r_sel)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int ti = min(lo, n - 1);
  const int row = ti / p.dist_w, col = ti % p.dist_w;
  const float theta = ((float)row + r1) * p.env_pi_over_h;
  const float phi = ((float)col + r2) * p.env_two_pi_over_w - p.pi;
  const float st = sinf(theta);
  wx = st * cosf(phi);
  wy = cosf(theta);
  wz = st * sinf(phi);
  pdf = __ldg(p.env_pdf + ti) * p.env_inv_patch / fmaxf(st, 1e-6f);
}

// The solid-angle pdf env_sample gives direction d (lights.env_pdf), for
// the MIS weight of a sky the BSDF sample found.
__device__ __forceinline__ float env_pdf_sa(const Params& p, float dx,
                                            float dy, float dz) {
  const float u = atan2f(dz, dx) * p.inv_two_pi + 0.5f;
  const float theta = acosf(fminf(fmaxf(dy, -1.0f), 1.0f));
  const int row = min(max((int)(theta * p.env_h_over_pi), 0), p.dist_h - 1);
  const int col = min(max(wrap_index((int)(u * (float)p.dist_w), p.dist_w), 0),
                      p.dist_w - 1);
  return __ldg(p.env_pdf + row * p.dist_w + col) * p.env_inv_patch /
         fmaxf(sinf(theta), 1e-6f);
}

// The surface of hit (k, u, v) on the host table in device memory (its
// rows of stride S),
// its albedo times the map_Kd texel on a textured scene (rows 20-26:
// per-corner vt interpolated with the barycentrics, texid+1). IMG: the
// kernel was built for a scene with an environment map or textures; the
// others carry none of that code (its registers cost the NEE kernels
// 15-25% of their speed).
template <bool IMG>
__device__ __forceinline__ Surface table_surface(const float* tab, int S,
                                                 int k, float u, float v,
                                                 const Params& p) {
  Surface s;
  const float w = 1.0f - u - v;
  s.posx = tab[k] * w + tab[3 * S + k] * u + tab[6 * S + k] * v;
  s.posy = tab[S + k] * w + tab[4 * S + k] * u + tab[7 * S + k] * v;
  s.posz = tab[2 * S + k] * w + tab[5 * S + k] * u + tab[8 * S + k] * v;
  const float e1x = tab[3 * S + k] - tab[k], e1y = tab[4 * S + k] - tab[S + k],
              e1z = tab[5 * S + k] - tab[2 * S + k];
  const float e2x = tab[6 * S + k] - tab[k], e2y = tab[7 * S + k] - tab[S + k],
              e2z = tab[8 * S + k] - tab[2 * S + k];
  const float cx = e1y * e2z - e1z * e2y;
  const float cy = e1z * e2x - e1x * e2z;
  const float cz = e1x * e2y - e1y * e2x;
  const float inv_len = 1.0f / sqrtf(cx * cx + cy * cy + cz * cz);
  s.nx = -(cx * inv_len);
  s.ny = -(cy * inv_len);
  s.nz = -(cz * inv_len);
  s.dr = tab[9 * S + k];
  s.dg = tab[10 * S + k];
  s.db = tab[11 * S + k];
  s.er = tab[12 * S + k];
  s.eg = tab[13 * S + k];
  s.eb = tab[14 * S + k];
  s.sr = tab[15 * S + k];
  s.sg = tab[16 * S + k];
  s.sb = tab[17 * S + k];
  s.mtype = tab[18 * S + k];
  s.rough = tab[19 * S + k];
  if (IMG && p.use_tex) {
    const float tu = tab[20 * S + k] * w + tab[22 * S + k] * u + tab[24 * S + k] * v;
    const float tv = tab[21 * S + k] * w + tab[23 * S + k] * u + tab[25 * S + k] * v;
    float tr, tg, tb;
    texel_bilinear(p, (int)tab[26 * S + k] - 1, tu, tv, tr, tg, tb);
    s.dr = s.dr * tr;
    s.dg = s.dg * tg;
    s.db = s.db * tb;
  }
  return s;
}

// Shade a hit whose emission is already added: pick the next direction,
// update the throughput, play roulette. Returns whether the path continues.
// RR_EVERY_DEPTH: draw the roulette number at every depth (K1, K5 and the
// wavefront integrator) or only from rr_start on (K2). NEE: record what
// the next hit's emission weight needs, count_emit (after a mirror or a
// dielectric) and the pdf of the sampled direction, taken before the
// mirror override (megakernel_regen.py:993-1008). MAT: the kernel was
// built for a scene with GGX or dielectric faces (template flag; their
// code costs the other kernels registers): a GGX face takes the VNDF
// bounce from the same r1, r2, and absorbs the path when it points below
// the surface; a dielectric reflects or refracts by r1, tinted by Ks.
template <bool HAS_MIRRORS, bool RR_EVERY_DEPTH, bool NEE = false,
          bool MAT = false>
__device__ __forceinline__ bool scatter(const Params& p, int depth,
                                        const Surface& s, Path& q) {
  const float nx = s.nx, ny = s.ny, nz = s.nz;
  // next direction, ref shaders/raygen.rgen:14-39 (+ cosine variant)
  const float r1 = rand01(q.seed);
  const float r2 = rand01(q.seed);
  float ndx, ndy, ndz, fr, fg, fb, new_pdf = 0.0f;
  bool mirror = false, diel = false;
  if (MAT && is_glossy(s.mtype)) {
    if (!ggx_bounce(p, ggx_frame(s, q), s, r1, r2, ndx, ndy, ndz, fr, fg,
                    fb, new_pdf))
      return false;
  } else {
    const bool use_x = fabsf(nx) > fabsf(ny);
    const float inv_a = 1.0f / sqrtf(nx * nx + nz * nz);
    const float inv_b = 1.0f / sqrtf(ny * ny + nz * nz);
    const float tx = use_x ? nz * inv_a : 0.0f;
    const float ty = use_x ? 0.0f : -nz * inv_b;
    const float tz = use_x ? -nx * inv_a : ny * inv_b;
    const float bx = ny * tz - nz * ty;
    const float by = nz * tx - nx * tz;
    const float bz = nx * ty - ny * tx;
    float sq, lz;
    if (p.uniform) {
      sq = sqrtf(fmaxf(1.0f - r1 * r1, 0.0f));
      lz = r1;
    } else {
      sq = sqrtf(fmaxf(r1, 0.0f));
      lz = sqrtf(fmaxf(1.0f - r1, 0.0f));
    }
    const float phi = p.two_pi * r2;
    const float lx = cosf(phi) * sq;
    const float ly = sinf(phi) * sq;
    ndx = tx * lx + bx * ly + nx * lz;
    ndy = ty * lx + by * ly + ny * lz;
    ndz = tz * lx + bz * ly + nz * lz;
    fr = s.dr;
    fg = s.dg;
    fb = s.db;
    if (p.uniform) {
      const float c = p.uniform_scale * (ndx * nx + ndy * ny + ndz * nz);
      fr = fr * c;
      fg = fg * c;
      fb = fb * c;
    }
    if (NEE)
      new_pdf = p.uniform ? p.uniform_pdf
                          : fmaxf(ndx * nx + ndy * ny + ndz * nz, 0.0f) * p.inv_pi;
    mirror = HAS_MIRRORS && is_mirror(s.mtype);
    if (HAS_MIRRORS) {
      if (mirror) {
        // perfect mirror about the normal flipped toward the incoming ray
        const bool flip = q.dx * nx + q.dy * ny + q.dz * nz > 0.0f;
        const float fx = flip ? nx * -1.0f : nx;
        const float fy = flip ? ny * -1.0f : ny;
        const float fz = flip ? nz * -1.0f : nz;
        const float kk = 2.0f * (q.dx * fx + q.dy * fy + q.dz * fz);
        ndx = q.dx - fx * kk;
        ndy = q.dy - fy * kk;
        ndz = q.dz - fz * kk;
        fr = s.sr;
        fg = s.sg;
        fb = s.sb;
      }
    }
    diel = MAT && is_dielectric(s.mtype);
    if (MAT && diel) {
      dielectric_dir(s, q, r1, ndx, ndy, ndz);
      fr = s.sr;
      fg = s.sg;
      fb = s.sb;
    }
  }
  const bool rr_on = depth >= p.rr_start;
  if (p.use_rr && (RR_EVERY_DEPTH || rr_on)) {
    const float m = fmaxf(q.wr * fr, fmaxf(q.wg * fg, q.wb * fb));
    const float pmax = fminf(fmaxf(m, 0.05f), 0.95f);
    const float r_rr = rand01(q.seed);
    if (rr_on) {
      if (!(r_rr < pmax)) return false;
      const float inv_p = 1.0f / pmax;
      fr = fr * inv_p;
      fg = fg * inv_p;
      fb = fb * inv_p;
    }
  }
  q.ox = s.posx;
  q.oy = s.posy;
  q.oz = s.posz;
  q.dx = ndx;
  q.dy = ndy;
  q.dz = ndz;
  q.wr = q.wr * fr;
  q.wg = q.wg * fg;
  q.wb = q.wb * fb;
  if (NEE) {
    q.count_emit = mirror || diel;
    q.pdf_prev = new_pdf;
  }
  return true;
}

// The radiance a miss adds, ending the path (ref miss.rmiss:8-12): the
// constant sky or the environment map in the ray's direction, times its
// weight under env NEE (integrate/wavefront.py emission_weight): 1 after
// a camera ray or a mirror, else 0, or under MIS the balance heuristic
// p_bsdf / (p_bsdf + p_env).
template <bool NEE, bool IMG>
__device__ __forceinline__ void add_miss(const Params& p, const Path& q,
                                         float& cr, float& cg, float& cb) {
  float er = p.sky[0], eg = p.sky[1], eb = p.sky[2];
  if (IMG && p.use_env) env_lookup(p, q.dx, q.dy, q.dz, er, eg, eb);
  float ew = 1.0f;
  if (NEE && IMG && p.use_env_nee && !q.count_emit) {
    ew = 0.0f;
    if (p.use_mis) {
      const float p_env = env_pdf_sa(p, q.dx, q.dy, q.dz);
      ew = q.pdf_prev / fmaxf(q.pdf_prev + p_env, 1e-30f);
    }
  }
  cr = cr + q.wr * er * ew;
  cg = cg + q.wg * eg * ew;
  cb = cb + q.wb * eb * ew;
}

// Weight of a hit's emission under NEE (integrate/wavefront.py
// emission_weight; megakernel_regen.py:545-628): with area lights, 1 on
// camera rays and after mirrors, else 0, or under MIS the balance
// heuristic p_bsdf / (p_bsdf + p_nee) of an emissive hit at distance t;
// with the environment alone, 1.
__device__ __forceinline__ float emission_weight(const Params& p,
                                                 const Path& q, float t,
                                                 const Surface& s) {
  if (!p.use_nee) return 1.0f;
  if (q.count_emit) return 1.0f;
  if (!p.use_mis) return 0.0f;
  const float cos_l_hit = fabsf(q.dx * s.nx + q.dy * s.ny + q.dz * s.nz);
  const float p_nee_hit = t * t * p.inv_area / fmaxf(cos_l_hit, 1e-6f);
  const float w_bsdf = q.pdf_prev / fmaxf(q.pdf_prev + p_nee_hit, 1e-30f);
  return fmaxf(fmaxf(s.er, s.eg), s.eb) > 0.0f ? w_bsdf : 0.0f;
}

// The light a selection number picks: the count of CDF entries below r
// among the first L - 1 (the fused kernels' unrolled chain,
// megakernel_regen.py:676-688), by a binary search over the non-decreasing
// CDF, so any number of lights costs log2(L) loads.
__device__ __forceinline__ int pick_light(const float* __restrict__ lights,
                                          int L, float r) {
  const float* cdf = lights + 15 * L;
  int lo = 0, hi = L - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cdf + mid) < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float bsdf_pdf(const Params& p, float cos_s) {
  return p.uniform ? p.uniform_pdf : fmaxf(cos_s, 0.0f) * p.inv_pi;
}

// A shadow ray of next-event estimation (``on`` false: none), with what
// the light it tests adds when nothing blocks it: the factor g (geometry,
// pdf and MIS weight), for an area light its column of the light table
// (null for the environment sample, whose radiance is fetched in the
// ray's direction), and from a GGX face (``glossy``) its f_r toward the
// light (fr, fg, fb; a diffuse face's Kd / pi is read after the test). The
// radiance is read after the shadow test, so that little is live across
// it.
struct ShadowRay {
  float ox, oy, oz, dx, dy, dz, smax, g;
  const float* lt;
  bool on, glossy;
  float fr, fg, fb;
};

// The brdf, cosine and bsdf pdf of a light direction at a hit: a diffuse
// face's cos_s and sampling pdf, or on a GGX face (MAT) f_r, the cosine
// to n_g and the VNDF pdf (integrate/wavefront.py light_bsdf).
template <bool MAT>
__device__ __forceinline__ float light_cos(const Params& p, const Surface& s,
                                           const Path& q, float wlx,
                                           float wly, float wlz,
                                           ShadowRay& r, float& pdf_b) {
  r.glossy = MAT && is_glossy(s.mtype);
  if (MAT && r.glossy) {
    float cos_i;
    ggx_eval(p, ggx_frame(s, q), s, wlx, wly, wlz, r.fr, r.fg, r.fb, pdf_b,
             cos_i);
    return cos_i;
  }
  const float cos_s = wlx * s.nx + wly * s.ny + wlz * s.nz;
  pdf_b = bsdf_pdf(p, cos_s);
  return cos_s;
}

// The area-light sample at a hit (megakernel_regen.py:651-797,
// megakernel_bvh.py:1824-1946, in their float order; integrate/wavefront.py
// nee_direct with fused=True): draw its three numbers, pick a light of the
// (16, L) table (rows v0 v1 v2 n Le xyz, cdf; read through L1), sample a
// point on it; no ray from a mirror or dielectric (``spec``) or toward a
// light behind the surface. MAT: GGX faces evaluate their brdf and pdf.
template <bool MAT = false>
__device__ __forceinline__ ShadowRay light_sample(
    const Params& p, const float* __restrict__ lights, const Surface& s,
    bool spec, Path& q) {
  ShadowRay r;
  r.on = false;
  const float r_sel = rand01(q.seed);
  const float rl1 = rand01(q.seed);
  const float rl2 = rand01(q.seed);
  if (spec) return r;
  const int L = p.num_lights;
  const float* lt = lights + pick_light(lights, L, r_sel);
  const float su = sqrtf(fmaxf(rl1, 0.0f));
  const float b0 = 1.0f - su;
  const float b1 = su * (1.0f - rl2);
  const float b2 = su * rl2;
  const float tlx = __ldg(lt) * b0 + __ldg(lt + 3 * L) * b1 +
                    __ldg(lt + 6 * L) * b2 - s.posx;
  const float tly = __ldg(lt + L) * b0 + __ldg(lt + 4 * L) * b1 +
                    __ldg(lt + 7 * L) * b2 - s.posy;
  const float tlz = __ldg(lt + 2 * L) * b0 + __ldg(lt + 5 * L) * b1 +
                    __ldg(lt + 8 * L) * b2 - s.posz;
  const float dist2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-12f);
  const float inv_dist = 1.0f / sqrtf(dist2);
  const float wlx = tlx * inv_dist, wly = tly * inv_dist, wlz = tlz * inv_dist;
  float pdf_b;
  const float cos_s = light_cos<MAT>(p, s, q, wlx, wly, wlz, r, pdf_b);
  if (!(cos_s > 0.0f)) return r;
  const float cos_l = fabsf(wlx * __ldg(lt + 9 * L) + wly * __ldg(lt + 10 * L) +
                            wlz * __ldg(lt + 11 * L));
  float g_pdf = cos_s * cos_l / dist2 * p.total_area;
  if (p.use_mis) {
    const float p_nee_sa = dist2 / (p.total_area * fmaxf(cos_l, 1e-6f));
    g_pdf = g_pdf * (p_nee_sa / fmaxf(p_nee_sa + pdf_b, 1e-30f));
  }
  r.ox = s.posx;
  r.oy = s.posy;
  r.oz = s.posz;
  r.dx = wlx;
  r.dy = wly;
  r.dz = wlz;
  r.smax = (1.0f / inv_dist) * kShadowScale;
  r.g = g_pdf;
  r.lt = lt;
  r.on = true;
  return r;
}

// The environment sample at a hit (megakernel_regen.py:799-909;
// integrate/wavefront.py env_nee_direct with fused=True): draw its three
// numbers and a direction from the map's importance distribution
// (env_sample); a shadow ray to t_max (1 - 1e-3), none from a mirror or
// dielectric or below the surface. MAT: as light_sample's.
template <bool MAT = false>
__device__ __forceinline__ ShadowRay env_light_sample(const Params& p,
                                                      const Surface& s,
                                                      bool spec, Path& q) {
  ShadowRay r;
  r.on = false;
  const float r_sel = rand01(q.seed);
  const float rl1 = rand01(q.seed);
  const float rl2 = rand01(q.seed);
  if (spec) return r;
  float wlx, wly, wlz, pdf_sa, pdf_b;
  env_sample(p, r_sel, rl1, rl2, wlx, wly, wlz, pdf_sa);
  const float cos_s = light_cos<MAT>(p, s, q, wlx, wly, wlz, r, pdf_b);
  if (!(cos_s > 0.0f)) return r;
  float g_w = cos_s / fmaxf(pdf_sa, 1e-12f);
  if (p.use_mis) g_w = g_w * (pdf_sa / fmaxf(pdf_sa + pdf_b, 1e-30f));
  r.ox = s.posx;
  r.oy = s.posy;
  r.oz = s.posz;
  r.dx = wlx;
  r.dy = wly;
  r.dz = wlz;
  r.smax = p.t_max * kShadowScale;
  r.g = g_w;
  r.lt = nullptr;
  r.on = true;
  return r;
}

// Add what an unblocked shadow ray's light brings: w * brdf * Le * g, Le
// the area light's emission or (IMG) the map's radiance in the ray's
// direction, brdf Kd / pi or (MAT) a GGX face's f_r.
template <bool IMG, bool MAT = false>
__device__ __forceinline__ void add_light(const Params& p, const ShadowRay& r,
                                          bool blocked, const Surface& s,
                                          const Path& q, float& cr,
                                          float& cg, float& cb) {
  if (!r.on || blocked) return;
  float ler, leg, leb;
  if (!IMG || r.lt != nullptr) {
    const int L = p.num_lights;
    ler = __ldg(r.lt + 12 * L);
    leg = __ldg(r.lt + 13 * L);
    leb = __ldg(r.lt + 14 * L);
  } else {
    env_lookup(p, r.dx, r.dy, r.dz, ler, leg, leb);
  }
  float br, bg, bb;
  if (MAT && r.glossy) {
    br = r.fr;
    bg = r.fg;
    bb = r.fb;
  } else {
    br = s.dr * p.inv_pi;
    bg = s.dg * p.inv_pi;
    bb = s.db * p.inv_pi;
  }
  cr = cr + q.wr * br * ler * r.g;
  cg = cg + q.wg * bg * leg * r.g;
  cb = cb + q.wb * bb * leb * r.g;
}

// A hit's (weighted) emission.
template <bool NEE>
__device__ __forceinline__ void add_emission(const Params& p, const Path& q,
                                             float t, const Surface& s,
                                             float& cr, float& cg,
                                             float& cb) {
  const float ew = NEE ? emission_weight(p, q, t, s) : 1.0f;
  cr = cr + q.wr * s.er * ew;
  cg = cg + q.wg * s.eg * ew;
  cb = cb + q.wb * s.eb * ew;
}

// Whether a hit takes no light sample: a mirror, or (MAT) a dielectric.
template <bool HAS_MIRRORS, bool MAT>
__device__ __forceinline__ bool is_specular(const Surface& s) {
  return (HAS_MIRRORS && is_mirror(s.mtype)) ||
         (MAT && is_dielectric(s.mtype));
}

// The first half of shading a hit at distance t, for a block that tests
// its shadow rays together (K1's tiled kernel): add its (weighted)
// emission, then under NEE draw the area-light sample and the environment
// sample, in that order, as shadow rays sh[0] and sh[1]; none from a
// specular face (``spec``).
template <bool NEE, bool IMG, bool MAT = false>
__device__ __forceinline__ void shade_begin(const Params& p,
                                            const float* __restrict__ lights,
                                            float t, const Surface& s,
                                            bool spec, Path& q, float& cr,
                                            float& cg, float& cb,
                                            ShadowRay sh[2]) {
  add_emission<NEE>(p, q, t, s, cr, cg, cb);
  sh[0].on = sh[1].on = false;
  if (NEE && p.use_nee) sh[0] = light_sample<MAT>(p, lights, s, spec, q);
  if (NEE && IMG && p.use_env_nee)
    sh[1] = env_light_sample<MAT>(p, s, spec, q);
}

// A hit at distance t: add its (weighted) emission, then with NEE each
// light sample in turn, drawn, tested by ``occluded(o, d, smax)`` and
// added, then scatter. The shading K1, K5 and K9 share. Returns whether
// the path continues. MAT: the GGX and dielectric shading (scatter).
template <bool HAS_MIRRORS, bool NEE, bool RR_EVERY_DEPTH, bool IMG,
          bool MAT, class Occluded>
__device__ __forceinline__ bool shade_hit(const Params& p,
                                          const float* __restrict__ lights,
                                          int depth, float t,
                                          const Surface& s, Path& q,
                                          float& cr, float& cg, float& cb,
                                          const Occluded& occluded) {
  add_emission<NEE>(p, q, t, s, cr, cg, cb);
  const bool spec = is_specular<HAS_MIRRORS, MAT>(s);
  if (NEE && p.use_nee) {
    const ShadowRay r = light_sample<MAT>(p, lights, s, spec, q);
    add_light<IMG, MAT>(p, r, r.on && occluded(r.ox, r.oy, r.oz, r.dx, r.dy,
                                               r.dz, r.smax), s, q, cr, cg,
                        cb);
  }
  if (NEE && IMG && p.use_env_nee) {
    const ShadowRay r = env_light_sample<MAT>(p, s, spec, q);
    add_light<IMG, MAT>(p, r, r.on && occluded(r.ox, r.oy, r.oz, r.dx, r.dy,
                                               r.dz, r.smax), s, q, cr, cg,
                        cb);
  }
  return scatter<HAS_MIRRORS, RR_EVERY_DEPTH, NEE, MAT>(p, depth, s, q);
}

// One path segment against the brute-force table in shared memory: trace,
// add its radiance into (cr, cg, cb), then shade from the hit's row of the
// host table in device memory; with NEE its shadow rays test the shared
// table too. Returns whether the path continues.
template <bool HAS_MIRRORS, bool RR_EVERY_DEPTH, bool NEE = false,
          bool IMG = false, bool MAT = false>
__device__ __forceinline__ bool path_segment(const float* tab,
                                             const float* __restrict__ table,
                                             const Params& p, int depth,
                                             Path& q, float& cr, float& cg,
                                             float& cb,
                                             const float* lights = nullptr) {
  float t, u, v;
  const int k = closest_hit(tab, p, q, t, u, v);
  if (k < 0) {
    add_miss<NEE, IMG>(p, q, cr, cg, cb);
    return false;
  }
  // hit shading, ref shaders/closesthit.rchit:43-65
  const Surface s = table_surface<IMG>(table, p.tp, k, u, v, p);
  return shade_hit<HAS_MIRRORS, NEE, RR_EVERY_DEPTH, IMG, MAT>(
      p, lights, depth, t, s, q, cr, cg, cb,
      [&](float ox, float oy, float oz, float dx, float dy, float dz,
          float smax) {
        return brute_any_hit(tab, p, ox, oy, oz, dx, dy, dz, smax);
      });
}

// ---- a table too large for shared memory: the block in lockstep ----
//
// Every thread of the block takes part in every tile load, so the tiled
// walks run between block barriers; a thread with nothing to trace
// (``active`` false) loads and waits. The tiles go in ascending order and
// each keeps the strict t < best test, so the closest hit is the whole
// table's, bit for bit.

// Closest hit of the thread's ray over every tile of the table in device
// memory; -1 and t = +inf for a miss or an inactive thread.
__device__ __forceinline__ int tiled_closest(float* tile, const float* table,
                                             const Params& p, bool active,
                                             const Path& q, float& bt,
                                             float& bu, float& bv) {
  bt = __int_as_float(0x7f800000);
  bu = 0.0f;
  bv = 0.0f;
  int prim = -1;
  const int S = p.tile;
  for (int k0 = 0; k0 < p.num_tris; k0 += S) {
    const int n = min(S, p.num_tris - k0);
    __syncthreads();
    load_tile(tile, table, p, k0, n);
    __syncthreads();
    if (active) closest_range(tile, tile + 3 * S, S, k0, n, p, q, prim, bt, bu, bv);
  }
  return prim;
}

// Whether something blocks each of the thread's shadow rays sh[0], sh[1]
// (an off ray is not traced), over every tile.
__device__ __forceinline__ void tiled_any_hit(float* tile, const float* table,
                                              const Params& p,
                                              const ShadowRay sh[2],
                                              bool blocked[2]) {
  blocked[0] = blocked[1] = false;
  const int S = p.tile;
  for (int k0 = 0; k0 < p.num_tris; k0 += S) {
    const int n = min(S, p.num_tris - k0);
    __syncthreads();
    load_tile(tile, table, p, k0, n);
    __syncthreads();
    for (int r = 0; r < 2; ++r) {
      const ShadowRay& s = sh[r];
      for (int j = 0; j < n && s.on && !blocked[r]; ++j) {
        float t, u, v;
        blocked[r] = table_test(tile, tile + 3 * S, S, j, s.ox, s.oy, s.oz,
                                s.dx, s.dy, s.dz, p.det_eps, t, u, v) &&
                     t > p.t_min && t < s.smax;
      }
    }
  }
}

}  // namespace sfvp

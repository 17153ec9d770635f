// Device functions shared by the path-tracing kernels (regen_render.cu =
// K1, wave_render.cu = K2, bvh_regen_render.cu = K5): bit-exact PCG, the
// camera ray, Moller-Trumbore closest and any hit against a scene table in
// shared memory, and the shading of a hit (emission, next-event estimation
// toward the area lights, the next direction, roulette).
//
// 1/sqrt is 1.0f / sqrtf(x), two correctly rounded ops, never the
// approximate rsqrtf (see utils/vec.py inv_sqrt).
//
// Every expression keeps the operation order of the plain PyTorch twin
// (sfvp_tpu_torch/integrate/wavefront.py, which in turn keeps that of the
// JAX package), and the library is built with -fmad=false: with no fused
// multiply-adds each float op rounds as the twin's does, so the kernels can
// agree with the twins bit for bit on the card.
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
};

// A shadow ray stops float32(1 - 1e-3) of the way to its light sample
// (integrate/wavefront.py SHADOW_SCALE).
constexpr float kShadowScale = 0.999f;

// Shared-memory scene table, row-major [row][num_tris]: rows 0-18 are the
// host table's (v0 v1 v2 xyz, Kd, Ke, Ks, mtype), rows 19-24 the edges
// e1 = v1 - v0 and e2 = v2 - v0, computed once per block.
constexpr int kSmemRows = 25;
constexpr int kBlock = 128;

__device__ __forceinline__ void load_table(float* tab, const float* table,
                                           const Params& p) {
  const int T = p.num_tris;
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    for (int r = 0; r < 19; ++r) tab[r * T + j] = table[r * p.tp + j];
    for (int a = 0; a < 3; ++a) {
      tab[(19 + a) * T + j] = tab[(3 + a) * T + j] - tab[a * T + j];
      tab[(22 + a) * T + j] = tab[(6 + a) * T + j] - tab[a * T + j];
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

// Seed a sample and shoot its camera ray (ref shaders/raygen.rgen:50-57).
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
  q.wr = q.wg = q.wb = 1.0f;
  q.pdf_prev = 0.0f;
  q.count_emit = true;
  return q;
}

// Closest hit over every triangle; of equal t the lowest id wins.
// Returns the triangle id, or -1 on a miss, and its t, u, v.
__device__ __forceinline__ int closest_hit(const float* tab, const Params& p,
                                           const Path& q, float& bt,
                                           float& bu, float& bv) {
  const int T = p.num_tris;
  bt = __int_as_float(0x7f800000);  // +inf
  int prim = -1;
  bu = 0.0f;
  bv = 0.0f;
  for (int k = 0; k < T; ++k) {
    const float e1x = tab[19 * T + k], e1y = tab[20 * T + k], e1z = tab[21 * T + k];
    const float e2x = tab[22 * T + k], e2y = tab[23 * T + k], e2z = tab[24 * T + k];
    const float pvx = q.dy * e2z - q.dz * e2y;
    const float pvy = q.dz * e2x - q.dx * e2z;
    const float pvz = q.dx * e2y - q.dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const bool nonzero = fabsf(det) > p.det_eps;
    const float inv_det = nonzero ? 1.0f / det : 0.0f;
    const float tvx = q.ox - tab[k], tvy = q.oy - tab[T + k], tvz = q.oz - tab[2 * T + k];
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (q.dx * qvx + q.dy * qvy + q.dz * qvz) * inv_det;
    const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    if (nonzero && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > p.t_min &&
        t < p.t_max && t < bt) {
      bt = t;
      bu = u;
      bv = v;
      prim = k;
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
  const int T = p.num_tris;
  bool hit = false;
  for (int k = 0; k < T && !hit; ++k) {
    const float e1x = tab[19 * T + k], e1y = tab[20 * T + k], e1z = tab[21 * T + k];
    const float e2x = tab[22 * T + k], e2y = tab[23 * T + k], e2z = tab[24 * T + k];
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const bool nonzero = fabsf(det) > p.det_eps;
    const float inv_det = nonzero ? 1.0f / det : 0.0f;
    const float tvx = ox - tab[k], tvy = oy - tab[T + k], tvz = oz - tab[2 * T + k];
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
    const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    hit = nonzero && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
          t > p.t_min && t < smax;
  }
  return hit;
}

// What the shading after a hit needs of the surface (ref
// closesthit.rchit:43-65): the hit point, the geometric normal
// -normalize(cross(e1, e2)), the albedo that diffuse sampling scales by,
// the emission, the mirror tint and the material type (1 = mirror).
struct Surface {
  float posx, posy, posz, nx, ny, nz;
  float dr, dg, db;
  float er, eg, eb;
  float sr, sg, sb;
  float mtype;
};

__device__ __forceinline__ bool is_mirror(float mtype) {
  return mtype > 0.5f && mtype < 1.5f;
}

// Shade a hit whose emission is already added: pick the next direction,
// update the throughput, play roulette. Returns whether the path continues.
// RR_EVERY_DEPTH: draw the roulette number at every depth (K1, K5 and the
// wavefront integrator) or only from rr_start on (K2). NEE: record what
// the next hit's emission weight needs, count_emit (after a mirror) and
// the pdf of the sampled direction, taken before the mirror override
// (megakernel_regen.py:993-1008).
template <bool HAS_MIRRORS, bool RR_EVERY_DEPTH, bool NEE = false>
__device__ __forceinline__ bool scatter(const Params& p, int depth,
                                        const Surface& s, Path& q) {
  const float nx = s.nx, ny = s.ny, nz = s.nz;
  // next direction, ref shaders/raygen.rgen:14-39 (+ cosine variant)
  const float r1 = rand01(q.seed);
  const float r2 = rand01(q.seed);
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
  float ndx = tx * lx + bx * ly + nx * lz;
  float ndy = ty * lx + by * ly + ny * lz;
  float ndz = tz * lx + bz * ly + nz * lz;
  float fr = s.dr, fg = s.dg, fb = s.db;
  if (p.uniform) {
    const float c = p.uniform_scale * (ndx * nx + ndy * ny + ndz * nz);
    fr = fr * c;
    fg = fg * c;
    fb = fb * c;
  }
  float new_pdf = 0.0f;
  if (NEE)
    new_pdf = p.uniform ? p.uniform_pdf
                        : fmaxf(ndx * nx + ndy * ny + ndz * nz, 0.0f) * p.inv_pi;
  const bool mirror = HAS_MIRRORS && is_mirror(s.mtype);
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
    q.count_emit = mirror;
    q.pdf_prev = new_pdf;
  }
  return true;
}

// A miss: sky emission ends the path (ref miss.rmiss:8-12).
__device__ __forceinline__ void add_sky(const Params& p, const Path& q,
                                        float& cr, float& cg, float& cb) {
  cr = cr + q.wr * p.sky[0];
  cg = cg + q.wg * p.sky[1];
  cb = cb + q.wb * p.sky[2];
}

// Weight of a hit's emission under NEE (integrate/wavefront.py
// emission_weight; megakernel_regen.py:603-628): 1 on camera rays and after
// mirrors, else 0, or under MIS the balance heuristic p_bsdf / (p_bsdf +
// p_nee) of an emissive hit at distance t.
__device__ __forceinline__ float emission_weight(const Params& p,
                                                 const Path& q, float t,
                                                 const Surface& s) {
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

// Next-event estimation at a hit (megakernel_regen.py:651-797,
// megakernel_bvh.py:1824-1946, in their float order; integrate/wavefront.py
// nee_direct with fused=True): draw the light sample's three numbers, pick
// a light of the (16, L) table (rows v0 v1 v2 n Le xyz, cdf; read through
// L1), sample a point on it, and add its MIS-weighted direct light unless
// the surface is a mirror, the light is behind it or
// ``occluded(o, d, smax)`` finds a triangle on the shadow ray.
template <class Occluded>
__device__ __forceinline__ void nee_direct(const Params& p,
                                           const float* __restrict__ lights,
                                           const Surface& s, bool mirror,
                                           Path& q, float& cr, float& cg,
                                           float& cb,
                                           const Occluded& occluded) {
  const float r_sel = rand01(q.seed);
  const float rl1 = rand01(q.seed);
  const float rl2 = rand01(q.seed);
  if (mirror) return;
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
  const float cos_s = wlx * s.nx + wly * s.ny + wlz * s.nz;
  if (!(cos_s > 0.0f)) return;
  const float cos_l = fabsf(wlx * __ldg(lt + 9 * L) + wly * __ldg(lt + 10 * L) +
                            wlz * __ldg(lt + 11 * L));
  const float smax = (1.0f / inv_dist) * kShadowScale;
  if (occluded(s.posx, s.posy, s.posz, wlx, wly, wlz, smax)) return;
  float g_pdf = cos_s * cos_l / dist2 * p.total_area;
  if (p.use_mis) {
    const float p_nee_sa = dist2 / (p.total_area * fmaxf(cos_l, 1e-6f));
    const float p_bsdf =
        p.uniform ? p.uniform_pdf : fmaxf(cos_s, 0.0f) * p.inv_pi;
    g_pdf = g_pdf * (p_nee_sa / fmaxf(p_nee_sa + p_bsdf, 1e-30f));
  }
  cr = cr + q.wr * (s.dr * p.inv_pi) * __ldg(lt + 12 * L) * g_pdf;
  cg = cg + q.wg * (s.dg * p.inv_pi) * __ldg(lt + 13 * L) * g_pdf;
  cb = cb + q.wb * (s.db * p.inv_pi) * __ldg(lt + 14 * L) * g_pdf;
}

// A hit at distance t: add its (weighted) emission, then with NEE the
// light sample, then scatter. The shading K1 and K5 share; ``occluded``
// is their shadow-ray test. Returns whether the path continues.
template <bool HAS_MIRRORS, bool NEE, bool RR_EVERY_DEPTH, class Occluded>
__device__ __forceinline__ bool shade_hit(const Params& p,
                                          const float* __restrict__ lights,
                                          int depth, float t,
                                          const Surface& s, Path& q,
                                          float& cr, float& cg, float& cb,
                                          const Occluded& occluded) {
  const float ew = NEE ? emission_weight(p, q, t, s) : 1.0f;
  cr = cr + q.wr * s.er * ew;
  cg = cg + q.wg * s.eg * ew;
  cb = cb + q.wb * s.eb * ew;
  if (NEE)
    nee_direct(p, lights, s, HAS_MIRRORS && is_mirror(s.mtype), q, cr, cg,
               cb, occluded);
  return scatter<HAS_MIRRORS, RR_EVERY_DEPTH, NEE>(p, depth, s, q);
}

// One path segment against the brute-force table: trace, add its radiance
// into (cr, cg, cb), then shade; with NEE its shadow rays test the table
// too. Returns whether the path continues.
template <bool HAS_MIRRORS, bool RR_EVERY_DEPTH, bool NEE = false>
__device__ __forceinline__ bool path_segment(const float* tab, const Params& p,
                                             int depth, Path& q, float& cr,
                                             float& cg, float& cb,
                                             const float* lights = nullptr) {
  const int T = p.num_tris;
  float t, u, v;
  const int k = closest_hit(tab, p, q, t, u, v);
  if (k < 0) {
    add_sky(p, q, cr, cg, cb);
    return false;
  }
  // hit shading, ref shaders/closesthit.rchit:43-65
  Surface s;
  const float w = 1.0f - u - v;
  s.posx = tab[k] * w + tab[3 * T + k] * u + tab[6 * T + k] * v;
  s.posy = tab[T + k] * w + tab[4 * T + k] * u + tab[7 * T + k] * v;
  s.posz = tab[2 * T + k] * w + tab[5 * T + k] * u + tab[8 * T + k] * v;
  const float e1x = tab[19 * T + k], e1y = tab[20 * T + k], e1z = tab[21 * T + k];
  const float e2x = tab[22 * T + k], e2y = tab[23 * T + k], e2z = tab[24 * T + k];
  const float cx = e1y * e2z - e1z * e2y;
  const float cy = e1z * e2x - e1x * e2z;
  const float cz = e1x * e2y - e1y * e2x;
  const float inv_len = 1.0f / sqrtf(cx * cx + cy * cy + cz * cz);
  s.nx = -(cx * inv_len);
  s.ny = -(cy * inv_len);
  s.nz = -(cz * inv_len);
  s.dr = tab[9 * T + k];
  s.dg = tab[10 * T + k];
  s.db = tab[11 * T + k];
  s.er = tab[12 * T + k];
  s.eg = tab[13 * T + k];
  s.eb = tab[14 * T + k];
  s.sr = tab[15 * T + k];
  s.sg = tab[16 * T + k];
  s.sb = tab[17 * T + k];
  s.mtype = tab[18 * T + k];
  return shade_hit<HAS_MIRRORS, NEE, RR_EVERY_DEPTH>(
      p, lights, depth, t, s, q, cr, cg, cb,
      [&](float ox, float oy, float oz, float dx, float dy, float dz,
          float smax) {
        return brute_any_hit(tab, p, ox, oy, oz, dx, dy, dz, smax);
      });
}

}  // namespace sfvp

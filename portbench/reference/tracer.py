"""The plain reference path tracer of the benchmark.

It grows from ``tools/oracle_ref.py`` (an independent float32
transcription of the Vulkan reference's shaders: PCG, camera, uniform
hemisphere sampling, the closest hit by Moller-Trumbore over every
triangle, the progressive mean) and adds what the benchmark's cells
switch on, after the program's documented semantics (the JAX package's
integrator, which the port follows): cosine sampling, Russian roulette,
next-event estimation toward area lights and toward an equirect
environment map, with balance-heuristic MIS.

It is plain PyTorch on any device (the card, so that it costs seconds a
run; the CPU in the tests), vectorised over (pixel, frame) slots, one
sample index at a time, each slot's colour summed in the order a fused
kernel sums it: sample after sample, segment after segment. It imports
nothing of the program, and the program hands it nothing: the benchmark
gives both sides the same triangles, materials and environment image.

The closest hit is brute force over every triangle. On a large mesh the
triangles are cut into clusters of consecutive triangles along a Morton
order, and a ray is tested against the triangles of every cluster whose
padded box it enters: the same answer as testing all of them, since a hit
lies inside its triangle's box. Ties in t go to the lowest triangle id.

``dtype`` sets the precision of every float the tracer computes (the
boxes of the clusters stay float32: they choose work, not answers);
``torch.bfloat16`` gives the benchmark's control.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

M32 = 0xFFFFFFFF
F32 = np.float32


def f32(x) -> float:
    return float(np.float32(x))


TWO_PI = f32(2.0 * np.pi)
INV_PI = f32(1.0 / np.pi)
UNIFORM_SCALE = float(np.float32(INV_PI) * np.float32(TWO_PI))
UNIFORM_PDF = f32(1.0 / TWO_PI)
SHADOW_SCALE = f32(1.0 - 1e-3)
DET_EPS = f32(1e-12)
RR_START = 3
CLUSTER = 64
DENSE_MAX_TRIS = 256


# ------------------------------------------------------------------ PCG
# common.glsl:13-37; uint32 words held in int64 and masked


def pcg(state):
    prev = (state * 747796405 + 2891336453) & M32
    word = (((prev >> ((prev >> 28) + 4)) ^ prev) * 277803737) & M32
    return (word >> 22) ^ word, prev


def pcg2d(vx, vy):
    k, c = 1664525, 1013904223
    vx = (vx * k + c) & M32
    vy = (vy * k + c) & M32
    vx = (vx + vy * k) & M32
    vy = (vy + vx * k) & M32
    vx = vx ^ (vx >> 16)
    vy = vy ^ (vy >> 16)
    vx = (vx + vy * k) & M32
    vy = (vy + vx * k) & M32
    vx = vx ^ (vx >> 16)
    vy = vy ^ (vy >> 16)
    return vx, vy


def sample_seed(px, py, s: int, frame, spp: int):
    """raygen.rgen:47-48: s = pcg2d(pixel * (sample + spp*frame + 1)),
    seed = s.x + s.y. ``frame``: an int64 tensor (one frame a slot)."""
    m = (frame * spp + (s + 1)) & M32
    sx, sy = pcg2d((px * m) & M32, (py * m) & M32)
    return (sx + sy) & M32


class Rng:
    """The per-ray PCG stream: ``next()`` is GLSL's rand, float(pcg) *
    2^-32 (float(0xffffffffu) rounds to 2^32)."""

    def __init__(self, seed, dtype):
        self.seed, self.dtype = seed, dtype

    def next(self):
        val, self.seed = pcg(self.seed)
        return val.to(self.dtype) * (2.0 ** -32)

    def keep(self, idx):
        self.seed = self.seed[idx]


# --------------------------------------------------------------- vectors


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def normalize(a):
    return scale(a, 1.0 / torch.sqrt(dot(a, a)))


def where(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def take(a, idx):
    return tuple(x[idx] for x in a)


def maxc(a):
    return torch.maximum(a[0], torch.maximum(a[1], a[2]))


# ---------------------------------------------------------------- camera


class Camera(NamedTuple):
    """target = center + d.x*right + d.y*up, d in NDC (raygen.rgen:50-57,
    generalised)."""

    origin: tuple
    center: tuple
    right: tuple
    up: tuple

    @staticmethod
    def reference():
        """The Vulkan reference's frustum: origin (0,-1,5), target (d.x,
        d.y - 1, 2)."""
        return Camera((0.0, -1.0, 5.0), (0.0, -1.0, 2.0), (1.0, 0.0, 0.0),
                      (0.0, 1.0, 0.0))

    @staticmethod
    def look_at(origin, target, up=(0.0, 1.0, 0.0), fov_y_deg=60.0,
                aspect=1.0):
        """A look-at frame with a vertical field of view; image rows grow
        downward, so world up maps to negative d.y."""
        o = np.asarray(origin, np.float64)
        fwd = np.asarray(target, np.float64) - o
        fwd = fwd / np.linalg.norm(fwd)
        r = np.cross(fwd, np.asarray(up, np.float64))
        r = r / np.linalg.norm(r)
        u = np.cross(r, fwd)
        half_h = math.tan(math.radians(fov_y_deg) / 2.0)
        return Camera(tuple(map(float, o)), tuple(map(float, o + fwd)),
                      tuple(map(float, r * (half_h * aspect))),
                      tuple(map(float, -u * half_h)))


def camera_rays(cam: Camera, px, py, r1, r2, width, height):
    dx = (px.to(r1.dtype) + r1) * f32(2.0 / width) - 1.0
    dy = (py.to(r1.dtype) + r2) * f32(2.0 / height) - 1.0
    c, r, u, o = ([f32(x) for x in v] for v in (cam.center, cam.right,
                                                cam.up, cam.origin))
    d = tuple(c[i] + dx * r[i] + dy * u[i] - o[i] for i in range(3))
    d = normalize(d)
    return tuple(torch.full_like(dx, oi) for oi in o), d


# -------------------------------------------------------------- sampling


def frame_of(n):
    """createCoordinateSystem (raygen.rgen:14-21): tangent, bitangent."""
    nx, ny, nz = n
    use_x = torch.abs(nx) > torch.abs(ny)
    inv_a = 1.0 / torch.sqrt(nx * nx + nz * nz)
    inv_b = 1.0 / torch.sqrt(ny * ny + nz * nz)
    zero = torch.zeros_like(nx)
    t = (torch.where(use_x, nz * inv_a, zero),
         torch.where(use_x, zero, -nz * inv_b),
         torch.where(use_x, -nx * inv_a, ny * inv_b))
    return t, cross(n, t)


def to_world(local, n):
    t, b = frame_of(n)
    return add(add(scale(t, local[0]), scale(b, local[1])),
               scale(n, local[2]))


def hemisphere(r1, r2, uniform: bool):
    """Uniform (z = r1, pdf 1/2pi; raygen.rgen:23-30) or cosine-weighted
    (z = sqrt(1 - r1), pdf cos/pi) local direction."""
    if uniform:
        s = torch.sqrt(torch.clamp_min(1.0 - r1 * r1, 0.0))
        z = r1
    else:
        z = torch.sqrt(torch.clamp_min(1.0 - r1, 0.0))
        s = torch.sqrt(torch.clamp_min(r1, 0.0))
    phi = TWO_PI * r2
    return (torch.cos(phi) * s, torch.sin(phi) * s, z)


# ----------------------------------------------------------- environment


def srgb_to_linear(u8: np.ndarray) -> np.ndarray:
    """The sRGB EOTF on 8-bit data, float32."""
    x = u8.astype(np.float32) / 255.0
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


class Environment:
    """An equirect sky (longitude atan2(z, x), row 0 at +y), read by a
    bilinear fetch with repeat addressing, and its NEE distribution:
    luminance, 3x3 max-dilated, times each texel's solid angle, sampled
    by texel and jittered uniformly in (theta, phi) inside it."""

    def __init__(self, rgb: np.ndarray, device, dtype):
        h, w = rgb.shape[:2]
        self.h, self.w = h, w
        flat = rgb.reshape(-1, 3)
        self.tex = tuple(torch.tensor(flat[:, c], device=device, dtype=dtype)
                         for c in range(3))
        r, g, b = (rgb[..., c] for c in range(3))
        lum = 0.2126 * r + 0.7152 * g + 0.0722 * b
        lum = np.max([np.roll(lum, s, axis=1) for s in (-1, 0, 1)], axis=0)
        pad = np.pad(lum, ((1, 1), (0, 0)), mode="edge")
        lum = np.max([pad[:-2], pad[1:-1], pad[2:]], axis=0)
        theta = (np.arange(h) + 0.5) * (np.pi / h)
        d_omega = (2 * np.pi / w) * (np.pi / h) * np.sin(theta)[:, None]
        weight = np.maximum(lum, 1e-8) * d_omega
        p = (weight / float(weight.sum())).reshape(-1)
        self.cdf = torch.tensor(np.cumsum(p).astype(np.float32),
                                device=device, dtype=dtype)
        self.pdf = torch.tensor(p.astype(np.float32), device=device,
                                dtype=dtype)
        self.inv_patch = f32(w * h / (2.0 * math.pi * math.pi))

    def lookup(self, d):
        dx, dy, dz = d
        u = torch.atan2(dz, dx) * f32(0.5 / math.pi) + 0.5
        v = 1.0 - torch.acos(torch.clamp(dy, -1.0, 1.0)) * f32(1.0 / math.pi)
        hf = torch.tensor(float(self.h), dtype=dx.dtype, device=dx.device)
        v = torch.clamp(v, 0.5 / hf, 1.0 - 0.5 / hf)
        x = (u - torch.floor(u)) * float(self.w) - 0.5
        y = (1.0 - (v - torch.floor(v))) * float(self.h) - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0i = torch.remainder(x0.to(torch.int32), self.w)
        x1i = torch.remainder((x0 + 1).to(torch.int32), self.w)
        y0i = torch.remainder(y0.to(torch.int32), self.h)
        y1i = torch.remainder((y0 + 1).to(torch.int32), self.h)
        taps = [(yi * self.w + xi).long() for yi, xi in
                ((y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i))]
        wts = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
        return tuple(ch[taps[0]] * wts[0] + ch[taps[1]] * wts[1]
                     + ch[taps[2]] * wts[2] + ch[taps[3]] * wts[3]
                     for ch in self.tex)

    def pdf_at(self, ti, sin_theta):
        return self.pdf[ti] * self.inv_patch / torch.clamp_min(sin_theta,
                                                               1e-6)

    def sample(self, r_sel, r1, r2):
        ti = torch.clamp_max(torch.searchsorted(self.cdf, r_sel, right=True),
                             self.h * self.w - 1)
        row, col = ti // self.w, ti % self.w
        theta = (row.to(r1.dtype) + r1) * f32(math.pi / self.h)
        phi = (col.to(r1.dtype) + r2) * f32(2 * math.pi / self.w) - f32(
            math.pi)
        st = torch.sin(theta)
        return ((st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi)),
                self.pdf_at(ti, st))

    def pdf_of(self, d):
        dx, dy, dz = d
        u = torch.atan2(dz, dx) * f32(0.5 / math.pi) + 0.5
        theta = torch.acos(torch.clamp(dy, -1.0, 1.0))
        row = torch.clamp((theta * f32(self.h / math.pi)).to(torch.int32), 0,
                          self.h - 1)
        col = torch.clamp(torch.remainder((u * self.w).to(torch.int32),
                                          self.w), 0, self.w - 1)
        return self.pdf_at((row * self.w + col).long(), torch.sin(theta))


# ----------------------------------------------------------------- scene


class Lights:
    """The emissive triangles, picked in proportion to their area (the
    count of CDF entries below the number among the first L - 1), a point
    uniform in the triangle by the square-root warp; double sided."""

    def __init__(self, tris, ke, device, dtype):
        lit = np.any(ke > 0, axis=1)
        t = tris[lit]
        cr = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        norm = np.linalg.norm(cr, axis=1)
        area = 0.5 * norm
        self.total_area = float(area.sum())
        n = cr / np.maximum(norm, 1e-30)[:, None]
        cdf = (np.cumsum(area) / max(self.total_area, 1e-30)).astype(F32)
        self.num = int(lit.sum())

        def col(a):
            return torch.tensor(np.asarray(a, F32), device=device,
                                dtype=dtype)

        self.v = [tuple(col(t[:, k, a]) for a in range(3)) for k in range(3)]
        self.n = tuple(col(n[:, a]) for a in range(3))
        self.le = tuple(col(ke[lit][:, a]) for a in range(3))
        self.cdf_head = col(cdf[: self.num - 1])
        self.inv_area = f32(1.0 / max(self.total_area, 1e-30))

    def sample(self, r_sel, r1, r2):
        li = torch.searchsorted(self.cdf_head, r_sel.contiguous())
        v0, v1, v2 = (take(v, li) for v in self.v)
        su = torch.sqrt(torch.clamp_min(r1, 0.0))
        b0, b1, b2 = 1.0 - su, su * (1.0 - r2), su * r2
        q = tuple(a * b0 + b * b1 + c * b2 for a, b, c in zip(v0, v1, v2))
        return q, take(self.n, li), take(self.le, li)


def morton_order(centroids: np.ndarray) -> np.ndarray:
    """Triangle ids in the order of their centroids' 30-bit Morton codes."""
    lo, hi = centroids.min(0), centroids.max(0)
    q = ((centroids - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(
        np.int64)
    code = np.zeros(len(q), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return np.argsort(code, kind="stable")


class RefScene:
    """Triangles, materials and lights on ``device``, in ``dtype``."""

    def __init__(self, tris, kd, ke, device, dtype=torch.float32,
                 env_rgb: Optional[np.ndarray] = None):
        tris = np.asarray(tris, F32)
        self.num_tris = len(tris)
        self.dtype, self.device = dtype, torch.device(device)

        def col(a):
            return torch.tensor(np.asarray(a, F32), device=device,
                                dtype=dtype)

        self.p = [tuple(col(tris[:, k, a]) for a in range(3))
                  for k in range(3)]
        e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
        self.e1 = tuple(col(e1[:, a]) for a in range(3))
        self.e2 = tuple(col(e2[:, a]) for a in range(3))
        self.kd = tuple(col(kd[:, a]) for a in range(3))
        self.ke = tuple(col(ke[:, a]) for a in range(3))
        self.lights = (Lights(tris, ke, device, dtype)
                       if np.any(ke > 0) else None)
        self.env = (Environment(env_rgb, device, dtype)
                    if env_rgb is not None else None)
        self.members = None
        if self.num_tris > DENSE_MAX_TRIS:
            order = morton_order(tris.mean(1))
            nc = -(-self.num_tris // CLUSTER)
            members = np.full(nc * CLUSTER, -1, np.int64)
            members[: self.num_tris] = order
            members = members.reshape(nc, CLUSTER)
            pts = tris[np.maximum(members, 0)].reshape(nc, -1, 3)
            ext = float((tris.max((0, 1)) - tris.min((0, 1))).max())
            pad = 1e-4 * ext + 1e-6
            self.bmin = torch.tensor(pts.min(1) - pad, device=device)
            self.bmax = torch.tensor(pts.max(1) + pad, device=device)
            self.members = torch.tensor(members, device=device)

    # -------------------------------------------------------- intersection

    def _test(self, o, d, tri, t_min, t_max):
        """Moller-Trumbore, no culling, of rays (o, d) against triangles
        ``tri`` (broadcast); (valid, t, u, v)."""
        p0, e1, e2 = take(self.p[0], tri), take(self.e1, tri), take(self.e2,
                                                                   tri)
        pv = cross(d, e2)
        det = dot(e1, pv)
        nonzero = torch.abs(det) > DET_EPS
        inv_det = torch.where(nonzero, 1.0 / det, torch.zeros_like(det))
        tv = sub(o, p0)
        u = dot(tv, pv) * inv_det
        qv = cross(tv, e1)
        v = dot(d, qv) * inv_det
        t = dot(e2, qv) * inv_det
        valid = (nonzero & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                 & (t > t_min) & (t < t_max))
        return valid, t, u, v

    def _candidates(self, o, d, t_max):
        """(ray, triangle) pairs whose cluster box the ray enters, for a
        chunk of rays; every pair on a small scene."""
        n = o[0].shape[0]
        if self.members is None:
            ri = torch.arange(n, device=self.device).repeat_interleave(
                self.num_tris)
            return ri, torch.arange(self.num_tris,
                                    device=self.device).repeat(n)
        tnear = tfar = None
        for a in range(3):
            oa, da = o[a].float(), d[a].float()
            da = torch.where(torch.abs(da) < 1e-30, torch.full_like(da,
                                                                   1e-30), da)
            inv = (1.0 / da)[:, None]
            t0 = (self.bmin[None, :, a] - oa[:, None]) * inv
            t1 = (self.bmax[None, :, a] - oa[:, None]) * inv
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tnear = lo if tnear is None else torch.maximum(tnear, lo)
            tfar = hi if tfar is None else torch.minimum(tfar, hi)
        tm = t_max.float()[:, None] if torch.is_tensor(t_max) else t_max
        ri, ci = torch.nonzero((tnear <= tfar) & (tfar >= 0.0)
                               & (tnear <= tm), as_tuple=True)
        tri = self.members[ci].reshape(-1)
        ri = ri.repeat_interleave(CLUSTER)
        keep = tri >= 0
        return ri[keep], tri[keep]

    def _chunks(self, n):
        """Ray ranges of about 2^21 (ray, triangle) pairs on a small scene,
        2^24 (ray, cluster) boxes on a large one."""
        step = max(1, (1 << 21) // self.num_tris if self.members is None
                   else (1 << 24) // self.members.shape[0])
        for a in range(0, n, step):
            yield a, min(n, a + step)

    def closest_hit(self, o, d, t_min, t_max):
        """(prim (-1 on a miss), t, u, v) of each ray's closest hit in
        (t_min, t_max); of equal t the lowest triangle id."""
        n = o[0].shape[0]
        prim = torch.full((n,), -1, dtype=torch.long, device=self.device)
        t_out = torch.full((n,), float("inf"), dtype=self.dtype,
                           device=self.device)
        u_out = torch.zeros((n,), dtype=self.dtype, device=self.device)
        v_out = torch.zeros_like(u_out)
        big = self.num_tris + 1
        for a, b in self._chunks(n):
            oc, dc = tuple(x[a:b] for x in o), tuple(x[a:b] for x in d)
            ri, tri = self._candidates(oc, dc, t_max)
            valid, t, u, v = self._test(take(oc, ri), take(dc, ri), tri,
                                        t_min, t_max)
            t = torch.where(valid, t, torch.full_like(t, float("inf")))
            best = torch.full((b - a,), float("inf"), dtype=self.dtype,
                              device=self.device)
            best = best.scatter_reduce(0, ri, t, "amin")
            win = valid & (t == best[ri])
            first = torch.full((b - a,), big, dtype=torch.long,
                               device=self.device)
            first = first.scatter_reduce(0, ri[win], tri[win], "amin")
            sel = win & (tri == first[ri])
            rows = ri[sel] + a
            prim[rows] = tri[sel]
            t_out[rows] = t[sel]
            u_out[rows] = u[sel]
            v_out[rows] = v[sel]
        return prim, t_out, u_out, v_out

    def occluded(self, o, d, t_min, t_max):
        """Whether any triangle lies in (t_min, t_max) along each ray;
        ``t_max`` a tensor, one a ray."""
        n = o[0].shape[0]
        out = torch.zeros((n,), dtype=torch.bool, device=self.device)
        for a, b in self._chunks(n):
            oc, dc = tuple(x[a:b] for x in o), tuple(x[a:b] for x in d)
            tm = t_max[a:b]
            ri, tri = self._candidates(oc, dc, tm)
            valid = self._test(take(oc, ri), take(dc, ri), tri, t_min,
                               tm[ri])[0]
            hits = torch.zeros((b - a,), dtype=torch.long, device=self.device)
            hits.index_add_(0, ri, valid.long())
            out[a:b] = hits > 0
        return out


# ------------------------------------------------------------ integrator


class Estimator(NamedTuple):
    """What a cell's traffic switches on."""

    uniform: bool
    use_rr: bool
    use_nee: bool
    use_mis: bool


class Render(NamedTuple):
    width: int
    height: int
    spp: int
    max_depth: int
    t_min: float
    t_max: float
    sky: tuple
    camera: Camera


def render_slots(scene: RefScene, rd: Render, est: Estimator, px, py,
                 frames, stats: Optional[dict] = None):
    """The colour totals a fused kernel returns for pixels (px, py) at
    ``frames``: an (S, 3) tensor for S = len(px) slots, slot i pixel
    (px[i], py[i]) of frame frames[i], summed over the step's samples.
    ``stats`` gathers "segments" and "shadow_rays"."""
    dev, dt = scene.device, scene.dtype
    px, py, frames = (torch.as_tensor(x, dtype=torch.long, device=dev)
                      for x in (px, py, frames))
    n = px.shape[0]
    color = [torch.zeros((n,), dtype=dt, device=dev) for _ in range(3)]
    lights = scene.lights if est.use_nee else None
    env_nee = est.use_nee and scene.env is not None
    mis = est.use_mis and (lights is not None or env_nee)
    sky_c = tuple(f32(s) for s in rd.sky)
    segments = shadow_rays = 0
    for s in range(rd.spp):
        rng = Rng(sample_seed(px, py, s, frames, rd.spp), dt)
        r1, r2 = rng.next(), rng.next()
        o, d = camera_rays(rd.camera, px, py, r1, r2, rd.width, rd.height)
        ids = torch.arange(n, device=dev)
        weight = tuple(torch.ones((n,), dtype=dt, device=dev)
                       for _ in range(3))
        count_emit = torch.ones((n,), dtype=torch.bool, device=dev)
        pdf_prev = torch.zeros((n,), dtype=dt, device=dev)
        for depth in range(rd.max_depth):
            if ids.numel() == 0:
                break
            segments += ids.numel()
            prim, t_hit, u, v = scene.closest_hit(o, d, rd.t_min, rd.t_max)
            miss = prim < 0
            hit = torch.logical_not(miss)
            pi = torch.clamp_min(prim, 0)
            p0, p1, p2 = (take(p, pi) for p in scene.p)
            w = 1.0 - u - v
            position = add(add(scale(p0, w), scale(p1, u)), scale(p2, v))
            normal = scale(normalize(cross(sub(p1, p0), sub(p2, p0))), -1.0)
            kd, ke = take(scene.kd, pi), take(scene.ke, pi)
            if scene.env is not None:
                sky = scene.env.lookup(d)
            else:
                sky = tuple(torch.full_like(u, c) for c in sky_c)
            emission = where(miss, sky, ke)
            emit_w = torch.ones_like(u)
            if lights is not None or env_nee:
                emit_w = emission_weight(mis, count_emit, pdf_prev, miss, d,
                                         normal, t_hit, emission, lights,
                                         scene.env if env_nee else None)
            contrib = scale(mul(weight, emission), emit_w)
            for c in range(3):
                color[c][ids] = color[c][ids] + contrib[c]
            shadow_q = hit
            if lights is not None:
                r_sel, rl1, rl2 = rng.next(), rng.next(), rng.next()
                q, nl, le = lights.sample(r_sel, rl1, rl2)
                to_l = sub(q, position)
                dist2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
                inv_dist = 1.0 / torch.sqrt(dist2)
                wl = scale(to_l, inv_dist)
                cos_s = dot(wl, normal)
                cos_l = torch.abs(dot(wl, nl))
                sq = shadow_q & (cos_s > 0)
                shadow_rays += int(sq.sum())
                vis = sq.clone()
                if sq.any():
                    k = sq.nonzero(as_tuple=True)[0]
                    vis[k] = torch.logical_not(scene.occluded(
                        take(position, k), take(wl, k), rd.t_min,
                        ((1.0 / inv_dist) * SHADOW_SCALE)[k]))
                area = f32(lights.total_area)
                g = cos_s * cos_l / dist2 * area
                if mis:
                    p_nee = dist2 / (area * torch.clamp_min(cos_l, 1e-6))
                    g = g * (p_nee / torch.clamp_min(
                        p_nee + bsdf_pdf(est.uniform, cos_s), 1e-30))
                direct = scale(mul(mul(weight, scale(kd, INV_PI)), le), g)
                for c in range(3):
                    color[c][ids] = color[c][ids] + torch.where(
                        vis, direct[c], torch.zeros_like(g))
            if env_nee:
                r_sel, rl1, rl2 = rng.next(), rng.next(), rng.next()
                wl, pdf_sa = scene.env.sample(r_sel, rl1, rl2)
                cos_s = dot(wl, normal)
                sq = shadow_q & (cos_s > 0)
                shadow_rays += int(sq.sum())
                vis = sq.clone()
                if sq.any():
                    k = sq.nonzero(as_tuple=True)[0]
                    smax = torch.full((k.numel(),), f32(
                        F32(rd.t_max) * F32(SHADOW_SCALE)), dtype=dt,
                        device=dev)
                    vis[k] = torch.logical_not(scene.occluded(
                        take(position, k), take(wl, k), rd.t_min, smax))
                le = scene.env.lookup(wl)
                g = cos_s / torch.clamp_min(pdf_sa, 1e-12)
                if mis:
                    g = g * (pdf_sa / torch.clamp_min(
                        pdf_sa + bsdf_pdf(est.uniform, cos_s), 1e-30))
                direct = scale(mul(mul(weight, scale(kd, INV_PI)), le), g)
                for c in range(3):
                    color[c][ids] = color[c][ids] + torch.where(
                        vis, direct[c], torch.zeros_like(g))
            b1, b2 = rng.next(), rng.next()
            new_dir = to_world(hemisphere(b1, b2, est.uniform), normal)
            if est.uniform:
                bounce = scale(kd, UNIFORM_SCALE * dot(new_dir, normal))
                new_pdf = torch.full_like(pdf_prev, UNIFORM_PDF)
            else:
                bounce = kd
                new_pdf = torch.clamp_min(dot(new_dir, normal), 0.0) * INV_PI
            cont = hit
            if est.use_rr:
                p = torch.clamp(maxc(mul(weight, bounce)), 0.05, 0.95)
                r_rr = rng.next()
                if depth >= RR_START:
                    cont = cont & (r_rr < p)
                    bounce = scale(bounce, 1.0 / p)
            keep = cont.nonzero(as_tuple=True)[0]
            ids = ids[keep]
            rng.keep(keep)
            o = take(position, keep)
            d = take(new_dir, keep)
            weight = take(mul(weight, bounce), keep)
            count_emit = torch.zeros((keep.numel(),), dtype=torch.bool,
                                     device=dev)
            pdf_prev = new_pdf[keep]
    if stats is not None:
        stats["segments"] = stats.get("segments", 0) + segments
        stats["shadow_rays"] = stats.get("shadow_rays", 0) + shadow_rays
        stats["samples"] = stats.get("samples", 0) + n * rd.spp
    return torch.stack(color, dim=1)


def bsdf_pdf(uniform: bool, cos_s):
    if uniform:
        return torch.full_like(cos_s, UNIFORM_PDF)
    return torch.clamp_min(cos_s, 0.0) * INV_PI


def emission_weight(mis, count_emit, pdf_prev, miss, d, normal, t_hit,
                    emission, lights: Optional[Lights],
                    env: Optional[Environment]):
    """The weight of the emission a segment adds under NEE: in full on
    camera rays; a miss in full when only area lights are sampled; a hit
    in full when only the environment is; otherwise nothing, or under MIS
    the balance weight of the BSDF sample against the light sample's pdf
    in solid angle."""
    hit = torch.logical_not(miss)
    if not mis:
        if lights is not None and env is not None:
            full = count_emit
        elif env is not None:
            full = count_emit | hit
        else:
            full = count_emit | miss
        return full.to(pdf_prev.dtype)
    one = torch.ones_like(pdf_prev)
    if env is not None:
        w_env = pdf_prev / torch.clamp_min(pdf_prev + env.pdf_of(d), 1e-30)
        if lights is None:
            return torch.where(count_emit | hit, one, w_env)
    cos_l = torch.abs(dot(d, normal))
    t_safe = torch.where(miss, torch.zeros_like(t_hit), t_hit)
    p_nee = (t_safe * t_safe) * lights.inv_area / torch.clamp_min(cos_l,
                                                                  1e-6)
    w_bsdf = pdf_prev / torch.clamp_min(pdf_prev + p_nee, 1e-30)
    emissive = (maxc(emission) > 0) & hit
    surf = torch.where(emissive, w_bsdf, torch.zeros_like(w_bsdf))
    if env is not None:
        return torch.where(count_emit, one, torch.where(miss, w_env, surf))
    return torch.where(count_emit | miss, one, surf)


def accumulate(colors, frame0: int, spp: int):
    """The progressive mean after frames frame0, frame0 + 1, ... from an
    empty accumulator: colors (P, n, 3) step totals, in order; returns
    (P, 3), new = (old * f + total / spp) / (f + 1)."""
    dt, dev = colors.dtype, colors.device
    mean = colors / torch.tensor(float(spp), dtype=dt, device=dev)
    acc = torch.zeros((colors.shape[0], 3), dtype=dt, device=dev)
    for k in range(colors.shape[1]):
        f = float(frame0 + k)
        acc = (acc * f + mean[:, k]) / torch.tensor(f + 1.0, dtype=dt,
                                                    device=dev)
    return acc

"""K7, the closest-hit payload trace of a two-level BVH (a TLAS over
instanced BLASes, accel/tlas.py): the wavefront loop's per-bounce trace of
instanced scenes; and K8, its any-hit trace of the shadow rays under
next-event estimation.

``two_level_trace`` traces one (N,) wave: on a CUDA tensor through the
hand-written kernel csrc/tlas_trace.cu, on a CPU tensor through its plain
PyTorch twin ``two_level_trace_plain``. ``two_level_occlusion`` answers,
for one (N,) wave of shadow rays, whether any triangle lies in (t_min,
t_max) along each: csrc/tlas_occlusion.cu, or ``two_level_occlusion_plain``.

Counterpart of sfvp_tpu/kernels/bvh_tlas.py (``make_two_level_trace``,
``make_two_level_occlusion``). The walk is K3's and K4's
(kernels/bvh_packet.py) with:
  - a second stack of instance contexts beside the stack of child codes:
    every pushed entry records the instance whose object space it lives
    in (-1 = the TLAS, world space);
  - the ray re-derived at each pop in the popped entry's space from the
    instance row's inverse transform, its direction NOT renormalised, so
    t stays in world measure and the best t prunes across instances;
  - TLAS leaves (instance codes): popping one pushes the instance's BLAS
    root under its context, with no box test;
  - the winning triangle's object-space vertices transformed once, after
    the walk, with the instance's forward transform, so the payload is in
    world space and shading downstream is space-agnostic.

Here each ray walks alone, where the TPU kernel walks a 1024-ray packet on
a shared stack: closest hits are the same up to exact ties in t, and the
any-hit answer is the same on every ray.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.vec import f32
from . import build
from .bvh_packet import (
    INSTANCE_CODE_BASE,
    N_PAYLOAD,
    Payload,
    _check_rays,
    _count,
    _leaf_tests,
    _node_children,
    _push,
    _Rays,
    payload_from_planes,
    ray_planes,
)
from .bvh_traverse import safe_inv


class DeviceTwoLevel(NamedTuple):
    """A two-level BVH's tables on one device (accel/tlas.py layout)."""

    nodes: torch.Tensor  # (M, 128) f32: TLAS rows, then every BLAS's
    tris: torch.Tensor   # (L, 128) f32 leaf-triangle rows of every BLAS
    inst: torch.Tensor   # (I, 128) f32 instance rows
    max_stack: int
    num_instances: int

    @property
    def device(self) -> torch.device:
        return self.nodes.device


def device_two_level(tl, device) -> DeviceTwoLevel:
    """Copy a TwoLevelBVH's tables (from this package's builder or
    sfvp_tpu's: the same arrays) to ``device``. Child refs are float32 in
    the rows, so each table must have fewer than 2**24 rows, which also
    keeps every leaf-row code above the instance codes. Textured BLASes
    (``tris_aux``) come with ROADMAP.md A.13."""
    if tl.tris_aux is not None:
        raise NotImplementedError(
            "textured instances (the two-level tris_aux planes) are not "
            "ported to sfvp_tpu_torch yet (ROADMAP.md A.13)")

    def table(name):
        a = getattr(tl, name)
        if a.shape[0] >= build.MAX_WIDE_ROWS:
            raise ValueError(f"two-level BVH {name} has {a.shape[0]} rows; "
                             f"refs are float32, exact below "
                             f"{build.MAX_WIDE_ROWS}")
        return torch.as_tensor(a, dtype=torch.float32,
                               device=device).contiguous()

    return DeviceTwoLevel(nodes=table("nodes"), tris=table("tris"),
                          inst=table("inst"), max_stack=int(tl.max_stack),
                          num_instances=int(tl.num_instances))


def _local_rays(dt: DeviceTwoLevel, rays, idx, ctx, t_min) -> _Rays:
    """The rays ``idx`` of the (7, N) planes in the object space of their
    instance contexts ``ctx`` (world space where ctx < 0): o' = iR o + it,
    d' = iR d in sfvp_tpu's operation order, with their safe inverse
    directions."""
    wox, woy, woz, wdx, wdy, wdz, tmax = rays[:, idx]
    tf = dt.inst[torch.clamp_min(ctx, 0), :12]
    in_inst = ctx >= 0

    def row(a, x, y, z, shift=None):
        out = tf[:, a] * x + tf[:, a + 1] * y + tf[:, a + 2] * z
        return out if shift is None else out + tf[:, shift]

    ray = _Rays((
        torch.where(in_inst, row(0, wox, woy, woz, 9), wox),
        torch.where(in_inst, row(3, wox, woy, woz, 10), woy),
        torch.where(in_inst, row(6, wox, woy, woz, 11), woz),
        torch.where(in_inst, row(0, wdx, wdy, wdz), wdx),
        torch.where(in_inst, row(3, wdx, wdy, wdz), wdy),
        torch.where(in_inst, row(6, wdx, wdy, wdz), wdz),
        tmax))
    ray.inv = tuple(safe_inv(c) for c in ray[3:6])
    ray.t_min = t_min
    return ray


def _walk(dt: DeviceTwoLevel, t_min, rays, counts, leaf, node):
    """The two-level walk of every ray of the (7, N) planes: each pass pops
    one (code, context) entry of every ray that has one left. An instance
    pop pushes the instance's BLAS root under its context; a leaf pop calls
    ``leaf(li, lrow, ray, ctx)``, which may return rays to retire (an
    any-hit walk's), and a node pop ``node(ni, node_row, ray) -> (M, 8)
    child codes``, each with the rays in their contexts' space. A ray with
    tmax <= t_min walks nothing."""
    n = rays.shape[1]
    dev = rays.device
    stack = torch.zeros((n, dt.max_stack), dtype=torch.int64, device=dev)
    ctx_stack = torch.full_like(stack, -1)
    stack[:, 0] = 1  # the TLAS root, internal node 0, in world space
    sp = (rays[6] > t_min).to(torch.int64)
    while True:
        idx = torch.nonzero(sp > 0).squeeze(1)
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        code = stack[idx, sp[idx]]
        ctx = ctx_stack[idx, sp[idx]]
        neg = -code - 1
        is_inst = (code < 0) & (neg >= INSTANCE_CODE_BASE)
        is_leaf = (code < 0) & ~is_inst
        ii = idx[is_inst]
        if ii.numel():
            iid = neg[is_inst] - INSTANCE_CODE_BASE
            stack[ii, sp[ii]] = dt.inst[iid, 24].to(torch.int64) + 1
            ctx_stack[ii, sp[ii]] = iid
            sp[ii] += 1
        li = idx[is_leaf]
        if li.numel():
            lctx = ctx[is_leaf]
            retire = leaf(li, neg[is_leaf],
                          _local_rays(dt, rays, li, lctx, t_min), lctx)
            if retire is not None:
                sp[retire] = 0
        is_node = code > 0
        ni = idx[is_node]
        if ni.numel():
            nctx = ctx[is_node]
            child = node(ni, code[is_node] - 1,
                         _local_rays(dt, rays, ni, nctx, t_min))
            _push(stack, sp, ni, child, ctx_stack, nctx)
        _count(counts, ni, li, ii)


def world_vertices(dt: DeviceTwoLevel, verts, ctx):
    """(M, 9) object-space vertices of triangles of instances ``ctx`` in
    world space: the forward transform (instance lanes 12-23), x' = R0 x +
    R1 y + R2 z + t0 in sfvp_tpu's operation order (bvh_tlas.py:317-323,
    megakernel_bvh.py:1337-1346); unchanged where ctx < 0."""
    fw = dt.inst[torch.clamp_min(ctx, 0), 12:24]
    out = []
    for k in range(3):
        x, y, z = verts[:, 3 * k], verts[:, 3 * k + 1], verts[:, 3 * k + 2]
        for a in range(3):
            out.append(fw[:, 3 * a] * x + fw[:, 3 * a + 1] * y
                       + fw[:, 3 * a + 2] * z + fw[:, 9 + a])
    return torch.where((ctx >= 0)[:, None], torch.stack(out, 1), verts)


def two_level_trace_plain(dt: DeviceTwoLevel, t_min: float,
                          rays: torch.Tensor,
                          counts: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch twin of the K7 kernel: same arguments, same results.

    rays: (7, N) float32 world-space planes ox oy oz dx dy dz tmax (tmax =
    -inf for an inactive ray). Returns the (19, N) payload planes of
    kernels/bvh_packet.py (t, u, v, world-space p0, p1, p2, albedo,
    emission, mtype). ``counts``, when given, gains the node, leaf and
    instance pops ("node_pops", "leaf_pops", "inst_pops")."""
    t_min = f32(t_min)
    dev = rays.device
    n = rays.shape[1]
    bt = torch.full((n,), float("inf"), device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    brow = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bslot = torch.zeros(n, dtype=torch.int64, device=dev)
    bctx = torch.full((n,), -1, dtype=torch.int64, device=dev)

    def leaf(li, lrow, ray, ctx):
        slot, t, u, v = _leaf_tests(dt.tris, lrow, ray, bt[li])
        better = t < bt[li]
        bt[li] = torch.where(better, t, bt[li])
        bu[li] = torch.where(better, u, bu[li])
        bv[li] = torch.where(better, v, bv[li])
        brow[li] = torch.where(better, lrow, brow[li])
        bslot[li] = torch.where(better, slot, bslot[li])
        bctx[li] = torch.where(better, ctx, bctx[li])

    def node(ni, node_row, ray):
        return _node_children(dt.nodes, node_row, ray, bt[ni], t_min)

    _walk(dt, t_min, rays, counts, leaf, node)
    out = torch.zeros((N_PAYLOAD, n), dtype=torch.float32, device=dev)
    out[0], out[1], out[2] = bt, bu, bv
    hit = torch.nonzero(brow >= 0).squeeze(1)
    lanes = 16 * bslot[hit][:, None] + torch.arange(16, device=dev)
    slots = torch.gather(dt.tris[brow[hit]], 1, lanes)
    out[3:12, hit] = world_vertices(dt, slots[:, :9], bctx[hit]).T
    out[12:, hit] = slots[:, 9:].T
    return out


def two_level_occlusion_plain(dt: DeviceTwoLevel, t_min: float,
                              rays: torch.Tensor,
                              counts: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch twin of the K8 kernel: same arguments, same results.

    rays: (7, N) float32 world-space planes (tmax = -inf for an inactive
    ray). Returns (N,) bool: a triangle lies in (t_min, tmax). The walk of
    ``two_level_trace_plain`` with a fixed window [t_min, tmax]: every
    child box the ray enters is pushed in slot order, and a ray retires on
    its first leaf with a hit. ``counts`` gains the pops."""
    t_min = f32(t_min)
    n = rays.shape[1]
    inf = torch.full((n,), float("inf"), device=rays.device)
    occ = torch.zeros(n, dtype=torch.bool, device=rays.device)

    def leaf(li, lrow, ray, ctx):
        t = _leaf_tests(dt.tris, lrow, ray, inf[li])[1]
        hit = li[torch.isfinite(t)]
        occ[hit] = True
        return hit

    def node(ni, node_row, ray):
        return _node_children(dt.nodes, node_row, ray, inf[ni], t_min,
                              ordered=False)

    _walk(dt, t_min, rays, counts, leaf, node)
    return occ


def two_level_trace(dt: DeviceTwoLevel, t_min: float, rays: torch.Tensor):
    """K7 on the rays' device: the CUDA kernel for a CUDA tensor (or an
    error), the plain twin for a CPU tensor. ``two_level_trace.launches``
    counts kernel launches."""
    if rays.device.type == "cpu":
        return two_level_trace_plain(dt, t_min, rays)
    _check_rays(rays)
    tp = build.two_level_params(dt, t_min)
    if rays.device != tp.device:
        raise ValueError(f"rays on {rays.device}, BVH on {tp.device}")
    out = build.launch_tlas_trace(tp, rays)
    two_level_trace.launches += 1
    return out


two_level_trace.launches = 0


def two_level_occlusion(dt: DeviceTwoLevel, t_min: float, rays: torch.Tensor):
    """K8 on the rays' device: the CUDA kernel for a CUDA tensor (or an
    error), the plain twin for a CPU tensor.
    ``two_level_occlusion.launches`` counts kernel launches."""
    if rays.device.type == "cpu":
        return two_level_occlusion_plain(dt, t_min, rays)
    _check_rays(rays)
    tp = build.two_level_params(dt, t_min)
    if rays.device != tp.device:
        raise ValueError(f"rays on {rays.device}, BVH on {tp.device}")
    out = build.launch_tlas_occlusion(tp, rays)
    two_level_occlusion.launches += 1
    return out


two_level_occlusion.launches = 0


def make_two_level_trace(dt: DeviceTwoLevel, t_min: float):
    """Build ``trace(o, d, t_max, active=None) -> Payload`` over (N,) SoA
    world-space rays on the device of ``dt``, as sfvp_tpu's
    make_two_level_trace. Inactive rays report a miss."""

    def trace(o, d, t_max, active=None) -> Payload:
        rays = ray_planes(o, d, t_max, active)
        return payload_from_planes(two_level_trace(dt, t_min, rays))

    return trace


def make_two_level_occlusion(dt: DeviceTwoLevel, t_min: float):
    """Build ``occluded(o, d, t_max, active=None) -> (N,) bool`` over (N,)
    SoA shadow rays on the device of ``dt``, as sfvp_tpu's
    make_two_level_occlusion: whether a triangle lies in (t_min, t_max)
    along each ray, and False for inactive rays."""

    def occluded(o, d, t_max, active=None):
        occ = two_level_occlusion(dt, t_min, ray_planes(o, d, t_max, active))
        return occ if active is None else occ & active

    return occluded

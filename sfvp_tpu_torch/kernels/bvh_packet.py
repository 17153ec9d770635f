"""K3, the closest-hit trace of the 8-wide BVH with its shading payload:
the wavefront loop's per-bounce trace of large scenes; and K4, the any-hit
trace of its shadow rays under next-event estimation.

``packet_trace`` traces one (N,) wave: on a CUDA tensor through the
hand-written kernel csrc/bvh_trace.cu, on a CPU tensor through its plain
PyTorch twin ``packet_trace_plain``. Both walk the same 128-lane rows of
accel/wide.py one ray at a time, with a stack of child codes per ray,
children pushed far to near through the JAX package's sorting network,
so they visit the same nodes in the same order and break exact ties
alike.

Counterpart of sfvp_tpu/kernels/bvh_packet.py (``Payload``,
``make_packet_trace``). There a 1024-ray packet walks the tree on one
shared stack and enters a subtree when any of its rays hits the box; here
each ray walks alone. The closest hit is the same up to exact ties in t.

``packet_occlusion`` answers, for one (N,) wave of shadow rays, whether
any triangle lies in (t_min, t_max) along each: on a CUDA tensor through
csrc/bvh_occlusion.cu, on a CPU tensor through ``packet_occlusion_plain``.
Both push every child box the ray enters and stop at the first hit; the
answer does not depend on the order, so kernel and twin agree on every
ray. Counterpart of sfvp_tpu's make_packet_occlusion (bvh_packet.py:433).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..accel.wide import WideBVH
from ..utils.vec import f32
from . import build
from .bvh_traverse import safe_inv
from .intersect import _DET_EPS

# the descending sorting network of sfvp_tpu/kernels/bvh_packet.py:247-250
# as its 7 layers of disjoint comparators (applied in this order, they are
# its 19 comparators in its order)
NET_LAYERS = (
    ((0, 1), (2, 3), (4, 5), (6, 7)),
    ((0, 2), (1, 3), (4, 6), (5, 7)),
    ((1, 2), (5, 6), (0, 4), (3, 7)),
    ((1, 5), (2, 6)),
    ((1, 4), (3, 6)),
    ((2, 4), (3, 5)),
    ((3, 4),),
)
N_PAYLOAD = 19
# stack code of a TLAS leaf, -(INSTANCE_CODE_BASE + instance id + 1)
# (sfvp_tpu/kernels/bvh_tlas.py _IB): below every leaf-row code, since
# rows stay under build.MAX_WIDE_ROWS = 2**24
INSTANCE_CODE_BASE = 1 << 27


class Payload(NamedTuple):
    """Closest-hit record + shade data, SoA over rays (miss: t == +inf,
    every other field 0)."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    p0: tuple
    p1: tuple
    p2: tuple
    albedo: tuple    # Kd for diffuse, Ks for mirrors (see accel/wide.py)
    emission: tuple
    mtype: torch.Tensor  # f32: material type + roughness (accel/wide.py)


def payload_from_planes(out: torch.Tensor) -> Payload:
    """The Payload view of the (19, N) planes the trace writes."""
    p = tuple(out)
    return Payload(t=p[0], u=p[1], v=p[2], p0=p[3:6], p1=p[6:9],
                   p2=p[9:12], albedo=p[12:15], emission=p[15:18],
                   mtype=p[18])


class DeviceWide(NamedTuple):
    """The wide BVH's row tables on one device."""

    nodes: torch.Tensor  # (Mi, 128) f32
    tris: torch.Tensor   # (Ml, 128) f32
    max_stack: int

    @property
    def device(self) -> torch.device:
        return self.nodes.device


def device_wide(wide: WideBVH, device) -> DeviceWide:
    """Copy a host WideBVH's tables to ``device``. Child refs are float32
    in the rows, so each table must have fewer than 2**24 rows. A textured
    tree (``tris_aux``, the payload's texture planes) raises until
    ROADMAP.md A.13."""
    if wide.tris_aux is not None:
        raise NotImplementedError(
            "textured wide BVHs (the tris_aux planes) are not ported to "
            "sfvp_tpu_torch yet (ROADMAP.md A.13)")
    for name, a in (("nodes", wide.nodes), ("tris", wide.tris)):
        if a.shape[0] >= build.MAX_WIDE_ROWS:
            raise ValueError(f"wide BVH {name} has {a.shape[0]} rows; refs "
                             f"are float32, exact below "
                             f"{build.MAX_WIDE_ROWS}")
    return DeviceWide(
        nodes=torch.as_tensor(wide.nodes, dtype=torch.float32,
                              device=device).contiguous(),
        tris=torch.as_tensor(wide.tris, dtype=torch.float32,
                             device=device).contiguous(),
        max_stack=int(wide.max_stack))


def _slot_tests(s, ray, t_min, bt):
    """Moller-Trumbore of rays against the 8 triangle slots ``s`` (..., 8,
    16) of their leaf rows; ``ray`` the 7 planes ox oy oz dx dy dz tmax
    and ``bt`` each ray's best t, all broadcastable against (..., 8).
    Returns the first slot of least valid t and that t, u, v over the last
    dimension (t = +inf where no slot is valid). Of equal t the lowest slot
    wins, as the kernels' strict ``t < best`` scan over the slots."""
    ox, oy, oz, dx, dy, dz, tmax = ray
    t0x, t0y, t0z = s[..., 0], s[..., 1], s[..., 2]
    e1x, e1y, e1z = s[..., 3] - t0x, s[..., 4] - t0y, s[..., 5] - t0z
    e2x, e2y, e2z = s[..., 6] - t0x, s[..., 7] - t0y, s[..., 8] - t0z
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    nonzero = torch.abs(det) > _DET_EPS
    inv_det = torch.where(nonzero, 1.0 / det, 0.0)
    tvx, tvy, tvz = ox - t0x, oy - t0y, oz - t0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = (nonzero & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < tmax) & (t < bt))
    t = torch.where(ok, t, float("inf"))
    slot = torch.argmin(t, dim=-1, keepdim=True)
    return (slot.squeeze(-1), torch.gather(t, -1, slot).squeeze(-1),
            torch.gather(u, -1, slot).squeeze(-1),
            torch.gather(v, -1, slot).squeeze(-1))


def _leaf_tests(tris, rows, ray, bt):
    """``_slot_tests`` of rays (a _Rays of (L,) planes) against the 8
    slots of their leaf rows ``rows`` (L,)."""
    return _slot_tests(tris[rows].view(-1, 8, 16),
                       tuple(c[:, None] for c in ray), ray.t_min,
                       bt[:, None])


def _child_codes(f):
    """The stack codes of the children of node rows, from their (..., 8
    field, 8 child) prefix: ref+1 (node), -(ref+1) (leaf row), the
    instance code of a child tagged as an instance (accel/tlas.py
    TAG_INSTANCE, only in a two-level TLAS), 0 (empty slot)."""
    ref = f[..., 6, :].to(torch.int64)
    tag = f[..., 7, :]
    return torch.where(
        tag > 2.5, -(INSTANCE_CODE_BASE + ref + 1),
        torch.where(tag > 1.5, -(ref + 1), torch.where(tag > 0.5, ref + 1, 0)))


@functools.lru_cache(maxsize=None)
def _net_index(device: torch.device):
    """NET_LAYERS as (a, b) index tensors on ``device``."""
    return [tuple(torch.tensor(side, device=device) for side in zip(*layer))
            for layer in NET_LAYERS]


def _sort_desc(key, code):
    """Sort each row's 8 (key, code) pairs by key, descending, in place,
    through the JAX package's 19-comparator network."""
    for a, b in _net_index(key.device):
        ka, kb, ca, cb = key[:, a], key[:, b], code[:, a], code[:, b]
        swap = ka < kb
        key[:, a] = torch.where(swap, kb, ka)
        key[:, b] = torch.where(swap, ka, kb)
        code[:, a] = torch.where(swap, cb, ca)
        code[:, b] = torch.where(swap, ca, cb)


def _node_children(nodes, node_idx, ray, bt, t_min, ordered=True):
    """Slab tests of rays against the 8 children of their nodes; returns
    the (M, 8) child codes to push, far to near (0 = no push); in slot
    order when not ``ordered`` (an any-hit walk). A child tagged as an
    instance (accel/tlas.py TAG_INSTANCE, only in a two-level TLAS) gets
    its instance code."""
    ox, oy, oz = (c[:, None] for c in ray[:3])
    ivx, ivy, ivz = (c[:, None] for c in ray.inv)
    f = nodes[node_idx, :64].view(-1, 8, 8)  # (M, field, child)
    limit = torch.minimum(bt, ray[6])[:, None]
    tx0 = (f[:, 0] - ox) * ivx
    tx1 = (f[:, 3] - ox) * ivx
    ty0 = (f[:, 1] - oy) * ivy
    ty1 = (f[:, 4] - oy) * ivy
    tz0 = (f[:, 2] - oz) * ivz
    tz1 = (f[:, 5] - oz) * ivz
    tnear = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.clamp_min(torch.minimum(tz0, tz1), t_min))
    tfar = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.minimum(torch.maximum(tz0, tz1), limit))
    code = _child_codes(f)
    push = (code != 0) & (tnear <= tfar)
    key = torch.where(push, tnear, float("-inf"))
    code = torch.where(push, code, 0)
    if ordered:
        _sort_desc(key, code)
    return code


class _Rays(tuple):
    """(ox, oy, oz, dx, dy, dz, tmax) planes of a subset of rays, with
    their safe inverse directions and the trace's t_min."""

    def take(self, idx):
        r = _Rays(c[idx] for c in self)
        r.inv = tuple(c[idx] for c in self.inv)
        r.t_min = self.t_min
        return r


def _push(stack, sp, ni, child, ctx_stack=None, ctx=None):
    """Push each ray's (8,) child codes (0 = none) in slot order; with
    ``ctx_stack``, each beside its ray's (M,) instance context ``ctx``."""
    pushed = child != 0
    pos = sp[ni][:, None] + torch.cumsum(pushed, dim=1) - 1
    rows = ni[:, None].expand(-1, 8)
    stack[rows[pushed], pos[pushed]] = child[pushed]
    if ctx_stack is not None:
        ctx_stack[rows[pushed], pos[pushed]] = ctx[:, None].expand(
            -1, 8)[pushed]
    sp[ni] += pushed.sum(dim=1)


def _count(counts, ni, li, ii=None):
    if counts is not None:
        counts["node_pops"] = counts.get("node_pops", 0) + ni.numel()
        counts["leaf_pops"] = counts.get("leaf_pops", 0) + li.numel()
        if ii is not None:
            counts["inst_pops"] = counts.get("inst_pops", 0) + ii.numel()


def _walk_setup(dw: DeviceWide, t_min: float, rays: torch.Tensor):
    """The ray view, an (N, max_stack) stack holding the root and each
    ray's stack pointer (0 for tmax <= t_min: no walk)."""
    n = rays.shape[1]
    ray = _Rays(rays)
    ray.inv = tuple(safe_inv(c) for c in rays[3:6])
    ray.t_min = t_min
    stack = torch.zeros((n, dw.max_stack), dtype=torch.int64,
                        device=rays.device)
    stack[:, 0] = 1  # the root, internal node 0
    sp = (rays[6] > t_min).to(torch.int64)
    return ray, stack, sp


def packet_trace_plain(dw: DeviceWide, t_min: float, rays: torch.Tensor,
                       counts: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch twin of the K3 kernel: same arguments, same results.

    rays: (7, N) float32 planes ox oy oz dx dy dz tmax (tmax = -inf for an
    inactive ray). Returns the (19, N) payload planes (t, u, v, p0, p1,
    p2, albedo, emission, mtype).

    Every ray holds a row of an (N, max_stack) stack of child codes; each
    pass pops one code of every ray that has one left. ``counts``, when
    given, gains the pass's node and leaf pops ("node_pops",
    "leaf_pops"): 8 box or 8 triangle tests each.
    """
    t_min = f32(t_min)
    dev = rays.device
    n = rays.shape[1]
    ray, stack, sp = _walk_setup(dw, t_min, rays)
    bt = torch.full((n,), float("inf"), device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    brow = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bslot = torch.zeros(n, dtype=torch.int64, device=dev)
    while True:
        idx = torch.nonzero(sp > 0).squeeze(1)
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        code = stack[idx, sp[idx]]
        leaf = code < 0
        li, lrow = idx[leaf], -code[leaf] - 1
        if li.numel():
            slot, t, u, v = _leaf_tests(dw.tris, lrow, ray.take(li), bt[li])
            better = t < bt[li]
            bt[li] = torch.where(better, t, bt[li])
            bu[li] = torch.where(better, u, bu[li])
            bv[li] = torch.where(better, v, bv[li])
            brow[li] = torch.where(better, lrow, brow[li])
            bslot[li] = torch.where(better, slot, bslot[li])
        ni = idx[~leaf]
        if ni.numel():
            _push(stack, sp, ni, _node_children(
                dw.nodes, code[~leaf] - 1, ray.take(ni), bt[ni], t_min))
        _count(counts, ni, li)
    return payload_planes(dw.tris, bt, bu, bv, brow, bslot)


def payload_planes(tris, bt, bu, bv, brow, bslot) -> torch.Tensor:
    """The (19, N) payload planes of rays whose best hit is (t, u, v) on
    slot ``bslot`` of leaf row ``brow`` (-1: a miss, every plane but t
    zero)."""
    out = torch.zeros((N_PAYLOAD, bt.shape[0]), dtype=torch.float32,
                      device=bt.device)
    out[0], out[1], out[2] = bt, bu, bv
    hit = torch.nonzero(brow >= 0).squeeze(1)
    lanes = 16 * bslot[hit][:, None] + torch.arange(16, device=bt.device)
    out[3:, hit] = torch.gather(tris[brow[hit]], 1, lanes).T
    return out


def _check_rays(rays: torch.Tensor) -> None:
    if (rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7
            or not rays.is_contiguous()):
        raise ValueError(f"rays must be contiguous float32 (7, N) planes, "
                         f"got {rays.dtype} {tuple(rays.shape)}")


def packet_trace(dw: DeviceWide, t_min: float, rays: torch.Tensor):
    """K3 on the rays' device: the CUDA kernel for a CUDA tensor (or an
    error), the plain twin for a CPU tensor. ``packet_trace.launches``
    counts kernel launches."""
    if rays.device.type == "cpu":
        return packet_trace_plain(dw, t_min, rays)
    _check_rays(rays)
    wp = build.wide_params(dw, t_min)
    if rays.device != wp.device:
        raise ValueError(f"rays on {rays.device}, BVH on {wp.device}")
    out = build.launch_bvh_trace(wp, rays)
    packet_trace.launches += 1
    return out


packet_trace.launches = 0


def ray_planes(o, d, t_max, active=None) -> torch.Tensor:
    """(7, N) planes of rays o, d (component tuples of (N,) tensors) with
    their t_max (a scalar or (N,) tensor); -inf for inactive rays."""
    n = o[0].shape[0]
    tmax = torch.as_tensor(t_max, dtype=torch.float32, device=o[0].device)
    tmax = tmax.expand(n)
    if active is not None:
        tmax = torch.where(active, tmax, float("-inf"))
    return torch.stack([*o, *d, tmax]).contiguous()


def make_packet_trace(dw: DeviceWide, t_min: float):
    """Build ``trace(o, d, t_max, active=None) -> Payload`` over (N,) SoA
    rays on the device of ``dw``, as sfvp_tpu's make_packet_trace.
    Inactive rays report a miss."""

    def trace(o, d, t_max, active=None) -> Payload:
        rays = ray_planes(o, d, t_max, active)
        return payload_from_planes(packet_trace(dw, t_min, rays))

    return trace


def packet_occlusion_plain(dw: DeviceWide, t_min: float, rays: torch.Tensor,
                           counts: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch twin of the K4 kernel: same arguments, same results.

    rays: (7, N) float32 planes ox oy oz dx dy dz tmax (tmax = -inf for an
    inactive ray). Returns (N,) bool: a triangle lies in (t_min, tmax).

    The walk of ``packet_trace_plain`` with a fixed window [t_min, tmax]:
    every child box the ray enters is pushed in slot order, and a ray
    retires on its first leaf with a hit. ``counts`` gains the pops."""
    t_min = f32(t_min)
    n = rays.shape[1]
    ray, stack, sp = _walk_setup(dw, t_min, rays)
    inf = torch.full((n,), float("inf"), device=rays.device)
    occ = torch.zeros(n, dtype=torch.bool, device=rays.device)
    while True:
        idx = torch.nonzero(sp > 0).squeeze(1)
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        code = stack[idx, sp[idx]]
        leaf = code < 0
        li, lrow = idx[leaf], -code[leaf] - 1
        if li.numel():
            t = _leaf_tests(dw.tris, lrow, ray.take(li), inf[li])[1]
            hit = li[torch.isfinite(t)]
            occ[hit] = True
            sp[hit] = 0
        ni = idx[~leaf]
        if ni.numel():
            _push(stack, sp, ni, _node_children(
                dw.nodes, code[~leaf] - 1, ray.take(ni), inf[ni], t_min,
                ordered=False))
        _count(counts, ni, li)
    return occ


def packet_occlusion(dw: DeviceWide, t_min: float, rays: torch.Tensor):
    """K4 on the rays' device: the CUDA kernel for a CUDA tensor (or an
    error), the plain twin for a CPU tensor. ``packet_occlusion.launches``
    counts kernel launches."""
    if rays.device.type == "cpu":
        return packet_occlusion_plain(dw, t_min, rays)
    _check_rays(rays)
    wp = build.wide_params(dw, t_min)
    if rays.device != wp.device:
        raise ValueError(f"rays on {rays.device}, BVH on {wp.device}")
    out = build.launch_bvh_occlusion(wp, rays)
    packet_occlusion.launches += 1
    return out


packet_occlusion.launches = 0


def make_packet_occlusion(dw: DeviceWide, t_min: float):
    """Build ``occluded(o, d, t_max, active=None) -> (N,) bool`` over (N,)
    SoA shadow rays on the device of ``dw``, as sfvp_tpu's
    make_packet_occlusion: whether a triangle lies in (t_min, t_max) along
    each ray, and False for inactive rays."""

    def occluded(o, d, t_max, active=None):
        occ = packet_occlusion(dw, t_min, ray_planes(o, d, t_max, active))
        return occ if active is None else occ & active

    return occluded

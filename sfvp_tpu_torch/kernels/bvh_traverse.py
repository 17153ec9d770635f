"""Threaded-BVH closest-hit traversal in eager PyTorch, the counterpart of
sfvp_tpu.kernels.bvh_traverse (make_trace_bvh_jnp): the independent oracle
that the wide-BVH traces (K3's twin, kernels/bvh_packet.py) are held
against, as the JAX package's own tests do.

Stackless: each ray carries one node pointer through the DFS-ordered node
array (see accel/lbvh.py for the skip-link layout); the loop runs while
any ray has a node left, each pass over the rays still walking. Box tests
prune against the ray's current best t, so the closest hit equals brute
force (of equal t, the first triangle in the walk's order).
"""

from __future__ import annotations

import torch

from ..accel.lbvh import BVH
from .intersect import Hit, moller_trumbore_soa

_BIG = 1e30


def safe_inv(c: torch.Tensor) -> torch.Tensor:
    """1/c for slab tests, +-1e30 where |c| <= 1e-30 (the JAX package's
    safe inverse direction)."""
    return torch.where(torch.abs(c) > 1e-30, 1.0 / c,
                       torch.where(c >= 0, _BIG, -_BIG))


def slab(bmin, bmax, o, inv, t_min, limit):
    """(tnear, tfar) of rays against boxes, in the JAX package's operation
    order: the window is [t_min, limit]."""
    tx0 = (bmin[0] - o[0]) * inv[0]
    tx1 = (bmax[0] - o[0]) * inv[0]
    ty0 = (bmin[1] - o[1]) * inv[1]
    ty1 = (bmax[1] - o[1]) * inv[1]
    tz0 = (bmin[2] - o[2]) * inv[2]
    tz1 = (bmax[2] - o[2]) * inv[2]
    tnear = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.clamp_min(torch.minimum(tz0, tz1), t_min))
    tfar = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.minimum(torch.maximum(tz0, tz1), limit))
    return tnear, tfar


def make_trace_bvh(bvh: BVH, device):
    """Returns ``trace(o, d, scene, t_min, t_max, active=None) -> Hit`` on
    ``device``, with the interface of kernels.intersect.trace_brute.
    ``scene`` is accepted for interface parity; geometry comes from the
    (sorted) BVH arrays and hits report ORIGINAL primitive ids."""

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    bmin = (dev(bvh.bmin_x), dev(bvh.bmin_y), dev(bvh.bmin_z))
    bmax = (dev(bvh.bmax_x), dev(bvh.bmax_y), dev(bvh.bmax_z))
    skip = dev(bvh.skip, torch.int64)
    first = dev(bvh.first, torch.int64)
    count = dev(bvh.count, torch.int64)
    tv = tuple(dev(a) for a in bvh.tv)
    prim_id = dev(bvh.prim_id, torch.int64)
    end = bvh.num_nodes
    leaf_size = max(1, bvh.leaf_size)
    n_sorted = tv[0].shape[0]

    def trace(o, d, scene, t_min, t_max, active=None) -> Hit:
        n = o[0].shape[0]
        node = torch.zeros(n, dtype=torch.int64, device=device)
        if active is not None:
            node = torch.where(active, node, end)
        bt = torch.full((n,), float("inf"), device=device)
        bp = torch.full((n,), -1, dtype=torch.int64, device=device)
        bu = torch.zeros(n, device=device)
        bv = torch.zeros(n, device=device)
        inv = tuple(safe_inv(c) for c in d)
        while True:
            idx = torch.nonzero(node < end).squeeze(1)
            if idx.numel() == 0:
                break
            ni = node[idx]
            ro = tuple(c[idx] for c in o)
            rd = tuple(c[idx] for c in d)
            ri = tuple(c[idx] for c in inv)
            rt, rp, ru, rv = bt[idx], bp[idx], bu[idx], bv[idx]
            tnear, tfar = slab(tuple(b[ni] for b in bmin),
                               tuple(b[ni] for b in bmax), ro, ri, t_min,
                               torch.clamp_max(rt, t_max))
            hit_box = tnear <= tfar
            cnt = count[ni]
            is_leaf = cnt > 0
            do_leaf = hit_box & is_leaf
            for j in range(leaf_size):
                tidx = torch.clamp(first[ni] + j, 0, n_sorted - 1)
                in_leaf = do_leaf & (j < cnt)
                p = [c[tidx] for c in tv]
                valid, t, u, v = moller_trumbore_soa(
                    ro, rd, tuple(p[0:3]), tuple(p[3:6]), tuple(p[6:9]),
                    t_min, t_max)
                closer = in_leaf & valid & (t < rt)
                rt = torch.where(closer, t, rt)
                rp = torch.where(closer, tidx, rp)
                ru = torch.where(closer, u, ru)
                rv = torch.where(closer, v, rv)
            descend = hit_box & torch.logical_not(is_leaf)
            node[idx] = torch.where(descend, ni + 1, skip[ni])
            bt[idx], bp[idx], bu[idx], bv[idx] = rt, rp, ru, rv
        prim = torch.where(bp >= 0, prim_id[torch.clamp_min(bp, 0)], -1)
        if active is not None:
            bt = torch.where(active, bt, float("inf"))
            prim = torch.where(active, prim, -1)
        return Hit(t=bt, prim=prim, u=bu, v=bv)

    return trace


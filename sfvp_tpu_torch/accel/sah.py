"""Binned-SAH BVH builder (host NumPy), a copy of sfvp_tpu.accel.sah's NumPy
path: the "prefer fast trace" build behind the reference's
``buildAccelerationStructuresKHR`` (ref main.cpp:418, 440-447). Full binned
surface-area-heuristic sweeps (Wald 2007, 16 bins per axis) instead of
Morton-bit splits, with the LBVH's output format (threaded DFS skip links
+ contiguous sorted-leaf triangle ranges), so the 8-wide collapse takes
either. The arrays equal sfvp_tpu's byte for byte
(tests/test_torch_bvh_build.py), and so do those of the C++ builder that
``native="auto"`` takes when its library loads (native.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .lbvh import BVH, assemble, host_triangles, native_builder

N_BINS = 16
_TRAVERSAL_COST = 1.0
_INTERSECT_COST = 1.0


def sah_bvh_from_arrays(
    tris: np.ndarray,
    leaf_size: int = 8,
    max_leaf: int = 8,
    prim_ids: Optional[np.ndarray] = None,
    native: str = "auto",
) -> BVH:
    """Build a threaded binary BVH over (T, 3, 3) triangles with binned SAH
    splits. ``leaf_size``: preferred leaf size (a leaf is made when SAH says
    splitting does not pay AND count <= max_leaf); ``max_leaf``: hard cap
    (the 8-wide collapse requires <= 8). ``native``: "auto" takes the C++
    builder (native.py, the same arrays) when its library loads, "never"
    NumPy, "require" raises without the library (lbvh.native_builder);
    with ``prim_ids`` NumPy builds, as in sfvp_tpu."""
    tris = np.asarray(tris, np.float32)
    if (prim_ids is None
            and native_builder(native, "SAH builder") is not None):
        from .. import native as native_mod

        return native_mod.build_sah_native(tris, leaf_size, max_leaf)
    t = tris.shape[0]
    if t == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    if prim_ids is None:
        prim_ids = np.arange(t, dtype=np.int32)

    tri_min = tris.min(axis=1)
    tri_max = tris.max(axis=1)
    cent = 0.5 * (tri_min + tri_max)

    order = np.arange(t, dtype=np.int64)  # permutation being built in place

    def half_area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    # DFS emission with an explicit stack; children follow their parent so
    # skip links come from topology_to_links unchanged.
    nodes = []  # rows [lo, hi, left, right]
    stack = [(0, t, -1, 0)]
    while stack:
        lo_i, hi_i, parent, which = stack.pop()
        idx = len(nodes)
        nodes.append([lo_i, hi_i, -1, -1])
        if parent >= 0:
            nodes[parent][2 + which] = idx
        n = hi_i - lo_i
        if n <= 1:
            continue
        ids = order[lo_i:hi_i]
        c = cent[ids]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] <= 0.0:
            # all centroids identical: median split (must split past max_leaf)
            if n <= max_leaf:
                continue
            mid = lo_i + n // 2
            stack.append((mid, hi_i, idx, 1))
            stack.append((lo_i, mid, idx, 0))
            continue

        # binned SAH on the widest centroid axis
        scale = N_BINS * (1.0 - 1e-6) / ext[axis]
        b = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)
        np.clip(b, 0, N_BINS - 1, out=b)
        bin_cnt = np.bincount(b, minlength=N_BINS)
        bmin = np.full((N_BINS, 3), np.inf, np.float32)
        bmax = np.full((N_BINS, 3), -np.inf, np.float32)
        np.minimum.at(bmin, b, tri_min[ids])
        np.maximum.at(bmax, b, tri_max[ids])

        # left/right sweeps over the N_BINS-1 split planes
        lcnt = np.cumsum(bin_cnt)[:-1]
        rcnt = n - lcnt
        lmin = np.minimum.accumulate(bmin, axis=0)[:-1]
        lmax = np.maximum.accumulate(bmax, axis=0)[:-1]
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1][1:]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1][1:]
        cost = np.where(
            (lcnt > 0) & (rcnt > 0),
            half_area(lmin, lmax) * lcnt + half_area(rmin, rmax) * rcnt,
            np.inf,
        )
        best = int(np.argmin(cost))
        leaf_cost = _INTERSECT_COST * n
        parent_area = max(half_area(tri_min[ids].min(axis=0),
                                    tri_max[ids].max(axis=0)), 1e-30)
        split_cost = _TRAVERSAL_COST + _INTERSECT_COST * cost[best] / parent_area
        if n <= max_leaf and (n <= leaf_size or split_cost >= leaf_cost):
            continue
        go_left = b <= best
        if not go_left.any() or go_left.all():
            mid = lo_i + n // 2
            order[lo_i:hi_i] = ids[np.argsort(c[:, axis], kind="stable")]
        else:
            order[lo_i:hi_i] = np.concatenate([ids[go_left], ids[~go_left]])
            mid = lo_i + int(go_left.sum())
        stack.append((mid, hi_i, idx, 1))
        stack.append((lo_i, mid, idx, 0))

    arr = np.asarray(nodes, np.int64)
    return assemble(arr, tris, order, tri_min, tri_max, prim_ids)


def build_sah_bvh(scene_buffers, leaf_size: int = 8,
                  native: str = "auto") -> BVH:
    """Build from SceneBuffers (real triangles only)."""
    return sah_bvh_from_arrays(host_triangles(scene_buffers),
                               leaf_size=leaf_size, native=native)

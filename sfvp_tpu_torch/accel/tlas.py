"""Two-level BVH of an instanced scene, a copy of sfvp_tpu.accel.tlas: the
one builder of the tables that K7, K8 and K9 trace (kernels/bvh_tlas.py,
kernels/megakernel_bvh.py), with arrays and ``max_stack`` byte-identical to
sfvp_tpu's (tests/test_torch_tlas.py).

The reference's TLAS is a hardware-traversed BVH over instances with 3x4
transforms (ref main.cpp:514-538). Here:

  - one wide BLAS per UNIQUE mesh (shared by its instances), node/tri rows
    concatenated into single tables with refs rewritten to global rows;
  - a wide TLAS over instance WORLD AABBs whose leaves carry TAG_INSTANCE
    and the instance id;
  - an instance table, one 128-lane row per instance:
      lanes [ 0:12)  inverse transform (iR row-major 9, it 3)
      lanes [12:24)  forward transform (R row-major 9, t 3)
      lane   24      BLAS root node row (f32)
      lane   25      texture base into the flattened merged pool (f32)

World-measure hit distances survive the object-space transform because the
transformed ray direction is NOT renormalized (t parameters are then
identical in both spaces), the standard instancing trick.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Sequence

import numpy as np

from ..scene.buffers import upload
from .instances import Instance
from .lbvh import bvh_from_arrays
from .wide import (
    TAG_INTERNAL, TAG_LEAF, WideBVH, build_wide, materials_array, uv_array,
)

TAG_INSTANCE = 3.0


class TwoLevelBVH(NamedTuple):
    nodes: np.ndarray   # (M, 128) f32: [TLAS rows | mesh0 rows | ...]
    tris: np.ndarray    # (L, 128) f32 concatenated leaf-triangle rows
    inst: np.ndarray    # (I, 128) f32 instance rows (see module docstring)
    max_stack: int
    num_instances: int
    # parallel uv/texid leaf rows (map_Kd textures, ROADMAP.md A.13): the
    # port's builder leaves it None (upload refuses textured meshes); a
    # table from sfvp_tpu's builder may carry it, and the kernels refuse it
    tris_aux: "np.ndarray | None" = None


def _wide_tlas_rows(inst_bmin: np.ndarray, inst_bmax: np.ndarray):
    """Wide BVH over instance AABBs; leaves are TAG_INSTANCE refs.

    Built by reusing the triangle LBVH machinery on degenerate 'triangles'
    whose vertex min/max equal the instance AABB (v0=bmin, v1=bmax,
    v2=center), then collapsing 3 binary levels per wide node with
    single-instance leaves. Returns the rows and the TLAS depth bound.
    """
    n = inst_bmin.shape[0]
    fake = np.stack(
        [inst_bmin, inst_bmax, 0.5 * (inst_bmin + inst_bmax)], axis=1
    ).astype(np.float32)
    bvh = bvh_from_arrays(fake, leaf_size=1)

    rows: list = []

    def children(i):
        left = i + 1
        return left, int(bvh.skip[left])

    def collect(root, levels=3):
        if int(bvh.count[root]) > 0:
            return [root]
        out = []

        def rec(i, depth):
            if int(bvh.count[i]) > 0 or depth == levels:
                out.append(i)
                return
            a, b = children(i)
            rec(a, depth + 1)
            rec(b, depth + 1)

        a, b = children(root)
        rec(a, 1)
        rec(b, 1)
        return out

    def emit(root):
        my = len(rows)
        row = np.zeros(128, np.float32)
        rows.append(row)
        kids = collect(root)
        for c, b in enumerate(kids):
            row[0 + c] = bvh.bmin_x[b]
            row[8 + c] = bvh.bmin_y[b]
            row[16 + c] = bvh.bmin_z[b]
            row[24 + c] = bvh.bmax_x[b]
            row[32 + c] = bvh.bmax_y[b]
            row[40 + c] = bvh.bmax_z[b]
            if int(bvh.count[b]) > 0:
                row[48 + c] = float(int(bvh.prim_id[int(bvh.first[b])]))
                row[56 + c] = TAG_INSTANCE
            else:
                row[48 + c] = float(emit(b))
                row[56 + c] = TAG_INTERNAL
        for c in range(len(kids), 8):
            row[0 + c] = 1.0
            row[24 + c] = -1.0
            row[56 + c] = 0.0
        return my

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        emit(0)
    finally:
        sys.setrecursionlimit(old)
    depth = max(1, int(np.ceil(np.log2(max(n, 2)))))
    return np.stack(rows).astype(np.float32), depth


def build_two_level(instances: Sequence[Instance],
                    leaf_size: int = 8) -> TwoLevelBVH:
    """Pack shared BLASes + TLAS + instance table (host NumPy): each BLAS
    an LBVH (accel/lbvh.py, not SAH) collapsed by accel/wide.py with its
    mesh's materials, as sfvp_tpu's build_two_level."""
    blas: dict = {}
    for inst in instances:
        key = id(inst.scene)
        if key not in blas:
            buffers = upload(inst.scene, device="cpu")
            blas[key] = build_wide(
                bvh_from_arrays(inst.scene.triangles(), leaf_size=leaf_size),
                materials_array(buffers), aux=uv_array(buffers))
    has_aux = any(w.tris_aux is not None for w in blas.values())

    # instance world AABBs from each BLAS root's 8 child boxes
    inst_bmin = np.zeros((len(instances), 3), np.float32)
    inst_bmax = np.zeros((len(instances), 3), np.float32)
    corners = np.stack(np.meshgrid(
        [0, 1], [0, 1], [0, 1], indexing="ij"), -1).reshape(8, 3)
    for i, inst in enumerate(instances):
        w: WideBVH = blas[id(inst.scene)]
        root = w.nodes[0]
        live = root[56:64] > 0.5
        bmin = np.stack([root[0:8], root[8:16], root[16:24]], 1)[live]
        bmax = np.stack([root[24:32], root[32:40], root[40:48]], 1)[live]
        # the 8 corners of each child box in world space
        rot = inst.transform[:, :3]
        tr = inst.transform[:, 3]
        pts = np.concatenate([
            (lo[None, :] * (1 - corners) + hi[None, :] * corners) @ rot.T + tr
            for lo, hi in zip(bmin, bmax)])
        inst_bmin[i] = pts.min(axis=0)
        inst_bmax[i] = pts.max(axis=0)

    tlas_rows, tlas_depth = _wide_tlas_rows(inst_bmin, inst_bmax)

    # concatenate the BLAS tables, refs rewritten to global rows
    node_parts = [tlas_rows]
    tri_parts = []
    aux_parts = []
    node_base: dict = {}
    nb, tb = tlas_rows.shape[0], 0
    max_blas_stack = 0
    for key, w in blas.items():
        node_base[key] = nb
        rows = w.nodes.copy()
        for c in range(8):
            tag = rows[:, 56 + c]
            rows[:, 48 + c] += np.where(
                tag == TAG_INTERNAL, float(nb),
                np.where(tag == TAG_LEAF, float(tb), 0.0))
        node_parts.append(rows)
        tri_parts.append(w.tris)
        if has_aux:
            aux_parts.append(w.tris_aux if w.tris_aux is not None
                             else np.zeros_like(w.tris))
        nb += rows.shape[0]
        tb += w.tris.shape[0]
        max_blas_stack = max(max_blas_stack, int(w.max_stack))

    # instance rows; lane 25 = this instance's base into the flattened
    # merged texture pool (flatten_instances' running order, duplicates for
    # shared meshes included)
    inst_rows = np.zeros((len(instances), 128), np.float32)
    tex_base = 0
    for i, inst in enumerate(instances):
        rot = inst.transform[:, :3].astype(np.float64)
        tr = inst.transform[:, 3].astype(np.float64)
        inv_rot = np.linalg.inv(rot)
        inst_rows[i, 0:9] = inv_rot.reshape(-1).astype(np.float32)
        inst_rows[i, 9:12] = (-inv_rot @ tr).astype(np.float32)
        inst_rows[i, 12:21] = rot.reshape(-1).astype(np.float32)
        inst_rows[i, 21:24] = tr.astype(np.float32)
        inst_rows[i, 24] = float(node_base[id(inst.scene)])
        inst_rows[i, 25] = float(tex_base)
        tex_base += len(inst.scene.texture_paths or [])

    return TwoLevelBVH(
        nodes=np.concatenate(node_parts).astype(np.float32),
        tris=(np.concatenate(tri_parts).astype(np.float32)
              if tri_parts else np.zeros((1, 128), np.float32)),
        inst=inst_rows,
        max_stack=int((tlas_depth + 1) * 8 + max_blas_stack + 16),
        num_instances=len(instances),
        tris_aux=(np.concatenate(aux_parts).astype(np.float32)
                  if has_aux and aux_parts else None),
    )

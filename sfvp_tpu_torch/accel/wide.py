"""8-wide BVH layout, a copy of sfvp_tpu.accel.wide: the one builder of the
tree that the BVH kernels K3 (kernels/bvh_packet.py) and K5
(kernels/megakernel_bvh.py) trace, with arrays byte-identical to
sfvp_tpu's (tests/test_torch_bvh_build.py).

The 128-lane row layout comes from the TPU (a Mosaic kernel reads a node
as one row with fields at static lane positions). It stays the single
source of truth here: the CUDA kernels read the same rows from device
memory, a node as 16 float4 loads of its first 64 lanes, a triangle as
three float4 loads of its 16-lane slot.

Built host-side by collapsing the binary BVH (accel/lbvh.py or
accel/sah.py); binary leaf_size is forced to 8 so every binary leaf maps
to exactly one triangle row.

Node row layout (f32 lanes):
  [ 0: 8)  child bmin_x   [ 8:16) child bmin_y   [16:24) child bmin_z
  [24:32)  child bmax_x   [32:40) child bmax_y   [40:48) child bmax_z
  [48:56)  child ref (row index into nodes or tris, stored as f32)
  [56:64)  child tag: 0 = invalid, 1 = internal, 2 = leaf
  [64:128) unused
Triangle row layout: tri k occupies lanes [16k, 16k+16):
  v0x v0y v0z v1x v1y v1z v2x v2y v2z kd_r kd_g kd_b ke_r ke_g ke_b mtype
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np

from .lbvh import BVH

TAG_INVALID = 0.0
TAG_INTERNAL = 1.0
TAG_LEAF = 2.0

LEAF_TRIS = 8
TRI_STRIDE = 16
WIDTH = 8
# without the native builder the numpy SAH build is used up to this many
# triangles, the LBVH beyond (sfvp_tpu.accel.wide.build_wide_from_buffers)
SAH_MAX_TRIS = 200_000


class WideBVH(NamedTuple):
    nodes: np.ndarray      # (Mi, 128) f32
    tris: np.ndarray       # (Ml, 128) f32
    prim_rows: np.ndarray  # (Ml, LEAF_TRIS) i32 original prim ids (-1 pad)
    max_stack: int         # worst-case traversal stack depth
    # map_Kd extension: per-corner vt + texid+1 in the lanes of each
    # triangle's slot (uv_array), None on untextured scenes
    tris_aux: "np.ndarray | None" = None  # (Ml, 128) f32

    @property
    def codes_nbytes(self) -> int:
        return self.nodes.shape[0] * WIDTH * 4

    @property
    def codes(self) -> np.ndarray:
        """(Mi, WIDTH) i32 child stack codes: 0 invalid, ref+1 internal,
        -(ref+1) leaf. The kernels decode the same from the ref and tag
        lanes of a node row."""
        w = WIDTH
        ref = self.nodes[:, 6 * w: 7 * w].astype(np.int64)
        tag = self.nodes[:, 7 * w: 8 * w]
        codes = np.where(
            tag > 1.5, -(ref + 1), np.where(tag > 0.5, ref + 1, 0)
        )
        return codes.astype(np.int32)


def reorder_bfs(wide: WideBVH) -> WideBVH:
    """Permute the node table into BFS (level) order and remap child refs.
    Traversal output is invariant to node numbering: push order depends
    only on child slots and tnear keys, and refs are pure addresses. Leaf
    rows (tris / tris_aux / prim_rows) are untouched."""
    nodes = wide.nodes
    m = nodes.shape[0]
    lay = node_layout(WIDTH)
    ref = nodes[:, lay["ref"]:lay["ref"] + WIDTH].astype(np.int64)
    tag = nodes[:, lay["tag"]:lay["tag"] + WIDTH]
    order = np.empty(m, np.int64)
    pos = 0
    frontier = [0]
    while frontier:
        nxt = []
        for i in frontier:
            order[pos] = i
            pos += 1
            for c in range(WIDTH):
                if tag[i, c] == TAG_INTERNAL:
                    nxt.append(int(ref[i, c]))
        frontier = nxt
    assert pos == m, "wide node table contains unreachable rows"
    inv = np.empty(m, np.int64)
    inv[order] = np.arange(m)
    new_nodes = nodes[order].copy()
    nref = new_nodes[:, lay["ref"]:lay["ref"] + WIDTH]
    ntag = new_nodes[:, lay["tag"]:lay["tag"] + WIDTH]
    internal = ntag == TAG_INTERNAL
    nref[internal] = inv[nref[internal].astype(np.int64)].astype(np.float32)
    return wide._replace(nodes=new_nodes)


def _binary_children(bvh: BVH, i: int):
    """Children of internal node i in the DFS skip-link layout:
    left = i+1, right = skip[left]."""
    left = i + 1
    right = int(bvh.skip[left])
    return left, right


def _collect_wide_children(bvh: BVH, root: int, levels: int = 3,
                           width: int = WIDTH, greedy: bool = True,
                           nleaf=None):
    """Children of the wide node rooted at binary node `root`.

    greedy (default): start from root's two binary children and repeatedly
    replace an INTERNAL candidate by its two children until `width`
    candidates exist: whole small subtrees first (smallest leaf count that
    fits the free slots), else the largest box.

    greedy=False: the fixed-depth cut at `levels` below root."""
    if int(bvh.count[root]) > 0:
        return [root]
    l, r = _binary_children(bvh, root)
    if not greedy:
        out = []

        def rec(i, depth):
            if int(bvh.count[i]) > 0 or depth == levels:
                out.append(i)
                return
            a, b = _binary_children(bvh, i)
            rec(a, depth + 1)
            rec(b, depth + 1)

        rec(l, 1)
        rec(r, 1)
        return out

    def area(i):
        dx = float(bvh.bmax_x[i] - bvh.bmin_x[i])
        dy = float(bvh.bmax_y[i] - bvh.bmin_y[i])
        dz = float(bvh.bmax_z[i] - bvh.bmin_z[i])
        return dx * dy + dy * dz + dz * dx

    if nleaf is None:
        nleaf = _subtree_leaves(bvh)
    cand = [l, r]
    while len(cand) < width:
        internals = [
            (k, i) for k, i in enumerate(cand) if int(bvh.count[i]) == 0
        ]
        if not internals:
            break
        budget = width - len(cand)
        fitting = [
            (int(nleaf[i]), k) for k, i in internals
            if int(nleaf[i]) <= budget + 1
        ]
        if fitting:
            best = min(fitting)[1]
        else:
            best = max(internals, key=lambda ki: area(ki[1]))[0]
        i = cand.pop(best)
        a, b = _binary_children(bvh, i)
        cand.append(a)
        cand.append(b)
    return cand


def _subtree_leaves(bvh: BVH) -> np.ndarray:
    """Per binary node: number of leaf nodes in its subtree (the DFS layout
    makes this the leaf count in rows [i, skip[i]))."""
    is_leaf = (bvh.count > 0).astype(np.int64)
    pref = np.concatenate([[0], np.cumsum(is_leaf)])
    return pref[bvh.skip] - pref[np.arange(bvh.num_nodes)]


def node_layout(width: int):
    """Lane offsets of the node-row fields for a given fan-out.

    width 8:  6 box sections of 8 lanes + ref/tag at 48/56 (64 lanes used)
    width 16: 6 box sections of 16 lanes + ref/tag at 96/112 (exactly 128)
    """
    if width not in (8, 16):
        raise ValueError(f"unsupported wide-BVH width {width}")
    return {
        "bmin_x": 0 * width, "bmin_y": 1 * width, "bmin_z": 2 * width,
        "bmax_x": 3 * width, "bmax_y": 4 * width, "bmax_z": 5 * width,
        "ref": 6 * width, "tag": 7 * width,
    }


def build_wide(bvh: BVH, materials: np.ndarray, width: int = WIDTH,
               aux: "np.ndarray | None" = None) -> WideBVH:
    """bvh: binary BVH with leaf_size <= 8.
    materials: (T, 7) f32 per ORIGINAL triangle: kd(3), ke(3), mtype(1).
    width: node fan-out (8 = default; 16 packs one full 128-lane row).
    aux: optional (T, <=16) f32 per-triangle extra fields, emitted as a
    parallel leaf-row table ``tris_aux``.
    """
    if int(bvh.count.max()) > LEAF_TRIS:
        raise ValueError("wide BVH requires binary leaf_size <= 8")
    lay = node_layout(width)
    levels = width.bit_length() - 1  # 8 -> 3, 16 -> 4
    nleaf_table = _subtree_leaves(bvh)

    tv = bvh.tv  # 9 sorted-tri coordinate columns
    prim = bvh.prim_id

    node_rows: list = []
    leaf_ranges: list = []  # (first, count) per leaf row; rows built in bulk

    def emit_leaf_row(first: int, count: int) -> int:
        leaf_ranges.append((first, count))
        return len(leaf_ranges) - 1

    # recursive wide emission (children are emitted after the parent)
    def emit_wide(root: int) -> int:
        my_idx = len(node_rows)
        row = np.zeros(128, np.float32)
        node_rows.append(row)
        kids = _collect_wide_children(
            bvh, root, levels=levels, width=width, nleaf=nleaf_table
        )
        assert 1 <= len(kids) <= width
        for c, b in enumerate(kids):
            row[lay["bmin_x"] + c] = bvh.bmin_x[b]
            row[lay["bmin_y"] + c] = bvh.bmin_y[b]
            row[lay["bmin_z"] + c] = bvh.bmin_z[b]
            row[lay["bmax_x"] + c] = bvh.bmax_x[b]
            row[lay["bmax_y"] + c] = bvh.bmax_y[b]
            row[lay["bmax_z"] + c] = bvh.bmax_z[b]
            if int(bvh.count[b]) > 0:
                ref = emit_leaf_row(int(bvh.first[b]), int(bvh.count[b]))
                row[lay["ref"] + c] = float(ref)
                row[lay["tag"] + c] = TAG_LEAF
            else:
                ref = emit_wide(b)
                row[lay["ref"] + c] = float(ref)
                row[lay["tag"] + c] = TAG_INTERNAL
        # mark remaining slots invalid with never-hit boxes
        for c in range(len(kids), width):
            row[lay["bmin_x"] + c] = 1.0
            row[lay["bmax_x"] + c] = -1.0  # bmin > bmax -> empty slab
            row[lay["tag"] + c] = TAG_INVALID
        return my_idx

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        emit_wide(0)
    finally:
        sys.setrecursionlimit(old)

    nodes = np.stack(node_rows).astype(np.float32)

    # bulk-build all leaf rows
    if leaf_ranges:
        ts = tv[0].shape[0]
        firsts = np.asarray([r[0] for r in leaf_ranges], np.int64)
        counts = np.asarray([r[1] for r in leaf_ranges], np.int64)
        k = np.arange(LEAF_TRIS)
        idx = firsts[:, None] + k[None, :]                 # (L, 8)
        valid = k[None, :] < counts[:, None]
        sidx = np.clip(idx, 0, ts - 1)
        tris = np.zeros((len(leaf_ranges), 128), np.float32)
        vmask = valid.astype(np.float32)
        tris_aux = (
            np.zeros((len(leaf_ranges), 128), np.float32)
            if aux is not None else None
        )
        for kk in range(LEAF_TRIS):
            base = TRI_STRIDE * kk
            for c in range(9):
                tris[:, base + c] = tv[c][sidx[:, kk]] * vmask[:, kk]
            mats = materials[prim[sidx[:, kk]]] * vmask[:, kk, None]
            tris[:, base + 9 : base + 9 + materials.shape[1]] = mats
            if aux is not None:
                arow = aux[prim[sidx[:, kk]]] * vmask[:, kk, None]
                tris_aux[:, base : base + aux.shape[1]] = arow
        prim_rows = np.where(valid, prim[sidx], -1).astype(np.int32)
    else:
        tris = np.zeros((1, 128), np.float32)
        tris_aux = np.zeros((1, 128), np.float32) if aux is not None else None
        prim_rows = np.full((1, LEAF_TRIS), -1, np.int32)

    # worst-case stack: depth * (width-1) + slack; compute exact depth
    depth = _wide_depth(nodes, width)
    max_stack = depth * width + width + 2

    return WideBVH(
        nodes=nodes,
        tris=tris,
        prim_rows=prim_rows,
        max_stack=int(max_stack),
        tris_aux=tris_aux,
    )


def _wide_depth(nodes: np.ndarray, width: int = WIDTH) -> int:
    """Tree depth over the emitted wide nodes (children always have larger
    row indices, so a reverse sweep works)."""
    lay = node_layout(width)
    m = nodes.shape[0]
    depth = np.ones(m, np.int64)
    for i in range(m - 1, -1, -1):
        for c in range(width):
            if nodes[i, lay["tag"] + c] == TAG_INTERNAL:
                depth[i] = max(
                    depth[i], 1 + depth[int(nodes[i, lay["ref"] + c])]
                )
    return int(depth[0])


def materials_array(scene_buffers) -> np.ndarray:
    """(T, 7) albedo/ke/mtype table from SceneBuffers (original tri order).

    The 16-lane tri slot fits one albedo triple, so mirror/glossy/
    dielectric surfaces (mtype >= 1, which never use Kd) store their Ks
    tint in the albedo lanes. The final lane packs ``mtype + roughness``:
    the fraction is clamped to [0, 0.96], so ``floor`` recovers the
    integer material type and the fraction the GGX roughness (mtype 2) or
    the encoded IOR (Ni-1)/4 (mtype 3)."""
    t = scene_buffers.num_tris

    def col(f):
        return np.asarray(getattr(scene_buffers, f)[:t].cpu())

    mtype = col("mtype")
    rough = np.clip(col("rough"), 0.0, 0.96)
    kd = np.stack([col("dr"), col("dg"), col("db")], axis=1)
    ks = np.stack([col("sr"), col("sg"), col("sb")], axis=1)
    ke = np.stack([col("er"), col("eg"), col("eb")], axis=1)
    albedo = np.where(mtype[:, None] >= 1, ks, kd)
    packed = mtype.astype(np.float32) + np.where(mtype >= 2, rough, 0.0)
    return np.concatenate(
        [albedo, ke, packed[:, None]], axis=1
    ).astype(np.float32)


def uv_array(scene_buffers) -> "np.ndarray | None":
    """(T, 7) per-corner vt + texid table [u0 v0 u1 v1 u2 v2 texid+1] in
    original tri order; None when the scene has no textures. texid is
    shifted by +1 so zero-padded leaf slots decode to -1 (untextured) in
    the payload; the leaf row then carries everything shading needs (ref
    closesthit.rchit:50-65 fetches the material by primitive id)."""
    if not scene_buffers.has_textures:
        return None
    t = scene_buffers.num_tris

    def col(f):
        return np.asarray(getattr(scene_buffers, f)[:t].cpu())

    return np.stack(
        [col("u0"), col("v0t"), col("u1"), col("v1t"),
         col("u2"), col("v2t"),
         col("tex").astype(np.float32) + 1.0],
        axis=1,
    ).astype(np.float32)


def binary_bvh(scene_buffers, native: str = "auto", builder: str = "auto"):
    """The binary BVH (leaf_size LEAF_TRIS) that build_wide collapses.
    builder: "sah" = binned-SAH binary tree (best trace quality); "lbvh" =
    Morton build (fastest build). "auto" = SAH whenever the native SAH
    builder is present, else SAH up to SAH_MAX_TRIS triangles and LBVH
    beyond: sfvp_tpu's rule (accel/wide.py:388-394), whatever ``native``
    says, so both packages pick the same tree. ``native``:
    lbvh.native_builder's, which builder builds it (``"never"``: NumPy)."""
    if builder == "auto":
        from .. import native as native_mod

        sah = (native_mod.sah_available()
               or scene_buffers.num_tris <= SAH_MAX_TRIS)
        builder = "sah" if sah else "lbvh"
    if builder == "sah":
        from .lbvh import host_triangles
        from .sah import sah_bvh_from_arrays

        return sah_bvh_from_arrays(host_triangles(scene_buffers),
                                   leaf_size=LEAF_TRIS, native=native)
    if builder == "lbvh":
        from .lbvh import build_bvh

        return build_bvh(scene_buffers, leaf_size=LEAF_TRIS, native=native)
    raise ValueError(f"unknown builder {builder!r}")


def build_wide_from_buffers(
    scene_buffers, native: str = "auto", builder: str = "auto"
) -> WideBVH:
    """The wide BVH of a scene's buffers over ``binary_bvh`` (its
    ``builder`` and ``native``), with the materials and, on a textured
    scene, the vt + texid rows (``tris_aux``)."""
    return build_wide(
        binary_bvh(scene_buffers, native, builder),
        materials_array(scene_buffers), aux=uv_array(scene_buffers))

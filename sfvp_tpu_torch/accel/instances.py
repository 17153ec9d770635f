"""Instancing, a copy of sfvp_tpu.accel.instances: the counterpart of the
reference's TLAS over BLAS instances (ref main.cpp:514-538: one instance,
3x4 transform, cull disable).

Two forms of one instanced scene:

1. *Flattening* (``flatten_instances``): each instance's mesh transformed
   into world space and merged into one triangle soup. The port shades
   from it (materials, light table) and the tests trace it as the
   single-level oracle. The reference's single identity instance is the
   degenerate case.

2. *Two-level tracing*: the port's route is the TLAS over shared BLASes
   (accel/tlas.py, kernels/bvh_tlas.py). ``make_instanced_trace`` keeps
   sfvp_tpu's host-unrolled form, one threaded-BVH trace per instance, as
   a third, independent oracle for the tests.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from ..scene.objload import Scene


@dataclasses.dataclass(frozen=True)
class Instance:
    """A mesh reference with a 3x4 row-major world transform
    (rotation/scale in [:, :3], translation in [:, 3]) — the same shape as
    VkTransformMatrixKHR (ref main.cpp:516-520)."""

    scene: Scene
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.hstack(
            [np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)]
        )
    )

    def __post_init__(self):
        t = np.asarray(self.transform, np.float32)
        if t.shape != (3, 4):
            raise ValueError(f"transform must be (3, 4), got {t.shape}")
        object.__setattr__(self, "transform", t)


def identity_instance(scene: Scene) -> Instance:
    """The reference's exact setup: one instance, identity transform."""
    return Instance(scene=scene)


def make_instanced_trace(instances: Sequence[Instance], *, device,
                         leaf_size: int = 4):
    """Host-unrolled two-level trace over instances sharing per-mesh
    threaded BVHs (kernels/bvh_traverse.py), on ``device``.

    Returns ``trace(o, d, scene, t_min, t_max, active=None) -> Hit`` with
    the interface of kernels.intersect.trace_brute. Hit.prim is the
    FLATTENED primitive id (instance-major, the order of
    flatten_instances), so shading tables built from the flattened scene
    line up."""
    import torch

    from ..kernels.bvh_traverse import make_trace_bvh
    from ..kernels.intersect import Hit
    from .lbvh import bvh_from_arrays

    blas = {}  # one threaded BVH per unique mesh object
    entries = []  # (trace_fn, inv_rot (3,3), inv_trans (3,), prim_offset)
    prim_offset = 0
    for inst in instances:
        key = id(inst.scene)
        if key not in blas:
            blas[key] = make_trace_bvh(
                bvh_from_arrays(inst.scene.triangles(), leaf_size=leaf_size),
                device=device)
        inv_rot = np.linalg.inv(inst.transform[:, :3]).astype(np.float32)
        inv_trans = (-inv_rot @ inst.transform[:, 3]).astype(np.float32)
        entries.append((blas[key], inv_rot, inv_trans, prim_offset))
        prim_offset += inst.scene.num_triangles

    def trace(o, d, scene, t_min, t_max, active=None) -> Hit:
        n = o[0].shape[0]
        dev = o[0].device
        best = Hit(t=torch.full((n,), float("inf"), device=dev),
                   prim=torch.full((n,), -1, dtype=torch.int64, device=dev),
                   u=torch.zeros(n, device=dev), v=torch.zeros(n, device=dev))
        for trace_fn, ir, it, off in entries:
            # object space: o' = iR @ o + it ; d' = iR @ d. t is preserved
            # because intersection distances are measured along d' whose
            # scaling matches the transformed geometry.
            oo = tuple(float(ir[a, 0]) * o[0] + float(ir[a, 1]) * o[1]
                       + float(ir[a, 2]) * o[2] + float(it[a])
                       for a in range(3))
            dd = tuple(float(ir[a, 0]) * d[0] + float(ir[a, 1]) * d[1]
                       + float(ir[a, 2]) * d[2] for a in range(3))
            h = trace_fn(oo, dd, None, t_min, t_max, active=active)
            closer = h.t < best.t
            best = Hit(
                t=torch.where(closer, h.t, best.t),
                prim=torch.where(closer,
                                 torch.where(h.prim >= 0, h.prim + off, -1),
                                 best.prim),
                u=torch.where(closer, h.u, best.u),
                v=torch.where(closer, h.v, best.v))
        return best

    return trace


def flatten_instances(instances: Sequence[Instance]) -> Scene:
    """Merge instances into one world-space Scene (single-level form).

    Carries the FULL material surface: Kd/Ke/Ks, material type, GGX
    roughness, per-corner vt + texture ids (texture lists merged with
    offset ids), and the first env map present."""
    verts: List[np.ndarray] = []
    diff: List[np.ndarray] = []
    emis: List[np.ndarray] = []
    spec: List[np.ndarray] = []
    mtype: List[np.ndarray] = []
    rough: List[np.ndarray] = []
    uvs: List[np.ndarray] = []
    texs: List[np.ndarray] = []
    tex_paths: List[str] = []
    names: List[str] = []
    mat_ids: List[np.ndarray] = []
    name_offset = 0
    env_map = None
    for inst in instances:
        s = inst.scene
        t = s.num_triangles
        rot = inst.transform[:, :3]
        trans = inst.transform[:, 3]
        verts.append(s.vertices @ rot.T + trans)
        diff.append(s.face_diffuse)
        emis.append(s.face_emission)
        spec.append(s.face_specular if s.face_specular is not None
                    else np.zeros_like(s.face_diffuse))
        mtype.append(s.face_mat_type if s.face_mat_type is not None
                     else np.zeros(t, np.int32))
        rough.append(s.face_rough if s.face_rough is not None
                     else np.zeros(t, np.float32))
        uvs.append(s.face_uv if s.face_uv is not None
                   else np.zeros((t, 3, 2), np.float32))
        ftex = s.face_tex if s.face_tex is not None else np.full(t, -1,
                                                                 np.int32)
        texs.append(
            np.where(ftex >= 0, ftex + len(tex_paths), -1).astype(np.int32))
        tex_paths.extend(s.texture_paths or [])
        if env_map is None:
            env_map = s.env_map
        names.extend(s.material_names)
        ids = (s.face_material_id if s.face_material_id is not None
               else np.full(t, -1, np.int32))
        mat_ids.append(
            np.where(ids >= 0, ids + name_offset, -1).astype(np.int32))
        name_offset += len(s.material_names)

    nv = np.concatenate(verts).astype(np.float32)
    return Scene(
        vertices=nv,
        indices=np.arange(len(nv), dtype=np.uint32),
        face_diffuse=np.concatenate(diff).astype(np.float32),
        face_emission=np.concatenate(emis).astype(np.float32),
        face_specular=np.concatenate(spec).astype(np.float32),
        face_mat_type=np.concatenate(mtype).astype(np.int32),
        face_rough=np.concatenate(rough).astype(np.float32),
        face_uv=np.concatenate(uvs).astype(np.float32),
        face_tex=np.concatenate(texs).astype(np.int32),
        texture_paths=tex_paths,
        env_map=env_map,
        material_names=names,
        face_material_id=np.concatenate(mat_ids),
    )

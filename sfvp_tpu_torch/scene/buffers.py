"""Device-side scene buffers: the triangle soup and its materials as
structure-of-arrays float32 / int32 tensors on one device, the counterpart
of sfvp_tpu.scene.buffers (the reference's AccelInput buffers,
ref main.cpp:492-494). Textures and environment maps are not carried over
yet (ROADMAP.md A.13)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

# column order of SceneBuffers, shared with sfvp_tpu.scene.SceneBuffers
FIELDS = (
    "v0x", "v0y", "v0z", "v1x", "v1y", "v1z", "v2x", "v2y", "v2z",
    "dr", "dg", "db", "er", "eg", "eb", "sr", "sg", "sb", "mtype", "rough",
)


class SceneBuffers(NamedTuple):
    """Triangle soup + materials on one device, fully SoA.

    Padded to ``pad_to`` triangles; padded entries are degenerate (all-zero)
    triangles that can never be hit (Moller-Trumbore det == 0) with zero
    material.
    """

    v0x: torch.Tensor
    v0y: torch.Tensor
    v0z: torch.Tensor
    v1x: torch.Tensor
    v1y: torch.Tensor
    v1z: torch.Tensor
    v2x: torch.Tensor
    v2y: torch.Tensor
    v2z: torch.Tensor
    dr: torch.Tensor     # Kd
    dg: torch.Tensor
    db: torch.Tensor
    er: torch.Tensor     # Ke
    eg: torch.Tensor
    eb: torch.Tensor
    sr: torch.Tensor     # Ks (mirror tint)
    sg: torch.Tensor
    sb: torch.Tensor
    mtype: torch.Tensor  # (Tp,) int32: 0=diffuse, 1=mirror, 2=glossy GGX,
    #                      3=smooth dielectric
    rough: torch.Tensor  # (Tp,) f32 GGX roughness or encoded IOR (Ni-1)/4
    num_tris: int        # real (unpadded) triangle count

    @property
    def padded_tris(self) -> int:
        return self.v0x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0x.device


def from_numpy(cols: Dict[str, np.ndarray], num_tris: int,
               device) -> SceneBuffers:
    """Buffers from numpy columns named as in FIELDS, e.g. an
    ``sfvp_tpu`` SceneBuffers read out with ``np.asarray`` per field: the
    tests build both packages' buffers from one scene this way."""
    out = {}
    for k in FIELDS:
        dtype = np.int32 if k == "mtype" else np.float32
        out[k] = torch.tensor(np.asarray(cols[k], dtype), device=device)
    return SceneBuffers(**out, num_tris=int(num_tris))


def from_arrays(tris: np.ndarray, diffuse: np.ndarray, emission: np.ndarray,
                specular: Optional[np.ndarray] = None,
                mat_type: Optional[np.ndarray] = None,
                rough: Optional[np.ndarray] = None,
                pad_to: Optional[int] = None,
                *, device) -> SceneBuffers:
    """tris: (T, 3, 3); diffuse/emission/specular: (T, 3); mat_type/rough:
    (T,)."""
    tris = np.asarray(tris, np.float32)
    t = tris.shape[0]
    if specular is None:
        specular = np.zeros((t, 3), np.float32)
    if mat_type is None:
        mat_type = np.zeros((t,), np.int32)
    if rough is None:
        rough = np.zeros((t,), np.float32)
    tp = t if pad_to is None else max(pad_to, t)

    def pad(a, dtype):
        a = np.asarray(a, dtype)
        out = np.zeros((tp,) + a.shape[1:], dtype)
        out[:t] = a
        return out

    tris_p = pad(tris, np.float32)
    cols = [tris_p[:, corner, axis] for corner in range(3) for axis in range(3)]
    for arr in (diffuse, emission, specular):
        arr_p = pad(arr, np.float32)
        cols += [arr_p[:, axis] for axis in range(3)]
    cols += [pad(mat_type, np.int32), pad(rough, np.float32)]
    return from_numpy(dict(zip(FIELDS, cols)), t, device)


def upload(scene, device, pad_to: Optional[int] = None) -> SceneBuffers:
    face_tex = getattr(scene, "face_tex", None)
    if getattr(scene, "texture_paths", None) and face_tex is not None and (
            np.asarray(face_tex) >= 0).any():
        raise NotImplementedError(
            "map_Kd textures are not ported yet (ROADMAP.md A.13)")
    if getattr(scene, "env_map", None):
        raise NotImplementedError(
            "environment maps are not ported yet (ROADMAP.md A.13)")
    return from_arrays(
        scene.triangles(),
        scene.face_diffuse,
        scene.face_emission,
        getattr(scene, "face_specular", None),
        getattr(scene, "face_mat_type", None),
        getattr(scene, "face_rough", None),
        pad_to=pad_to,
        device=device,
    )

"""Device-side scene buffers: the triangle soup and its materials as
structure-of-arrays float32 / int32 tensors on one device, the counterpart
of sfvp_tpu.scene.buffers (the reference's AccelInput buffers,
ref main.cpp:492-494), with its map_Kd textures (per-corner vt, a texture
id per face and the texel pool, scene/textures.py) and its equirect
environment map."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .textures import TextureTable, build_texture_table, table_from_arrays

# column order of SceneBuffers, shared with sfvp_tpu.scene.SceneBuffers
FIELDS = (
    "v0x", "v0y", "v0z", "v1x", "v1y", "v1z", "v2x", "v2y", "v2z",
    "dr", "dg", "db", "er", "eg", "eb", "sr", "sg", "sb", "mtype", "rough",
)
# the texture columns of a textured scene, in sfvp_tpu's order
UV_FIELDS = ("u0", "v0t", "u1", "v1t", "u2", "v2t")


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
    # texture extension (None on untextured scenes): per-corner vt columns,
    # per-face texture id and the packed texel pool (scene/textures.py)
    u0: Optional[torch.Tensor] = None
    v0t: Optional[torch.Tensor] = None
    u1: Optional[torch.Tensor] = None
    v1t: Optional[torch.Tensor] = None
    u2: Optional[torch.Tensor] = None
    v2t: Optional[torch.Tensor] = None
    tex: Optional[torch.Tensor] = None  # (Tp,) i32, -1 = untextured
    textures: Optional[TextureTable] = None
    env: Optional[TextureTable] = None  # one equirect image

    @property
    def has_textures(self) -> bool:
        return self.textures is not None

    @property
    def padded_tris(self) -> int:
        return self.v0x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0x.device


def _table(t, device) -> Optional[TextureTable]:
    """A texture table on ``device`` from any table with the fields of
    TextureTable (this package's, or sfvp_tpu's read with np.asarray)."""
    if t is None:
        return None
    if isinstance(t, TextureTable):
        return t.to(device)
    return table_from_arrays(*(t[i] for i in range(6)), device=device)


def from_numpy(cols: Dict[str, np.ndarray], num_tris: int, device,
               textures=None, env=None) -> SceneBuffers:
    """Buffers from numpy columns named as in FIELDS, e.g. an
    ``sfvp_tpu`` SceneBuffers read out with ``np.asarray`` per field: the
    tests build both packages' buffers from one scene this way. With
    ``textures`` (a texture table, e.g. sfvp_tpu's), ``cols`` also holds
    UV_FIELDS and "tex"; ``env`` is the environment map's table."""
    out = {}
    for k in FIELDS:
        dtype = np.int32 if k == "mtype" else np.float32
        out[k] = torch.tensor(np.asarray(cols[k], dtype), device=device)
    if textures is not None:
        for k in UV_FIELDS:
            out[k] = torch.tensor(np.asarray(cols[k], np.float32),
                                  device=device)
        out["tex"] = torch.tensor(np.asarray(cols["tex"], np.int32),
                                  device=device)
        out["textures"] = _table(textures, device)
    return SceneBuffers(**out, num_tris=int(num_tris),
                        env=_table(env, device))


def from_arrays(tris: np.ndarray, diffuse: np.ndarray, emission: np.ndarray,
                specular: Optional[np.ndarray] = None,
                mat_type: Optional[np.ndarray] = None,
                rough: Optional[np.ndarray] = None,
                pad_to: Optional[int] = None,
                face_uv: Optional[np.ndarray] = None,
                face_tex: Optional[np.ndarray] = None,
                textures: Optional[TextureTable] = None,
                env: Optional[TextureTable] = None,
                *, device) -> SceneBuffers:
    """tris: (T, 3, 3); diffuse/emission/specular: (T, 3); mat_type/rough:
    (T,); face_uv: (T, 3, 2) per-corner vt and face_tex: (T,) texture ids
    (-1 untextured), used with ``textures``; ``env``: the environment
    map's table."""
    tris = np.asarray(tris, np.float32)
    t = tris.shape[0]
    if specular is None:
        specular = np.zeros((t, 3), np.float32)
    if mat_type is None:
        mat_type = np.zeros((t,), np.int32)
    if rough is None:
        rough = np.zeros((t,), np.float32)
    tp = t if pad_to is None else max(pad_to, t)

    def pad(a, dtype, fill=0):
        a = np.asarray(a, dtype)
        out = np.full((tp,) + a.shape[1:], fill, dtype)
        out[:t] = a
        return out

    tris_p = pad(tris, np.float32)
    cols = [tris_p[:, corner, axis] for corner in range(3) for axis in range(3)]
    for arr in (diffuse, emission, specular):
        arr_p = pad(arr, np.float32)
        cols += [arr_p[:, axis] for axis in range(3)]
    cols += [pad(mat_type, np.int32), pad(rough, np.float32)]
    cols = dict(zip(FIELDS, cols))
    if textures is not None and face_uv is not None and face_tex is not None:
        uv_p = pad(face_uv, np.float32)
        cols.update(zip(UV_FIELDS, (uv_p[:, c, a] for c in range(3)
                                    for a in range(2))))
        cols["tex"] = pad(face_tex, np.int32, fill=-1)  # padding untextured
    else:
        textures = None
    return from_numpy(cols, t, device, textures=textures, env=env)


def upload(scene, device, pad_to: Optional[int] = None) -> SceneBuffers:
    """The buffers of a host Scene on ``device``, with its map_Kd textures
    (when a face has one) and its environment map (``scene.env_map``, a
    PNG, PPM or .hdr path) loaded onto the device."""
    textures = None
    face_tex = getattr(scene, "face_tex", None)
    if getattr(scene, "texture_paths", None) and face_tex is not None and (
            np.asarray(face_tex) >= 0).any():
        textures = build_texture_table(scene.texture_paths, device)
    env_path = getattr(scene, "env_map", None)
    env = build_texture_table([env_path], device) if env_path else None
    return from_arrays(
        scene.triangles(),
        scene.face_diffuse,
        scene.face_emission,
        getattr(scene, "face_specular", None),
        getattr(scene, "face_mat_type", None),
        getattr(scene, "face_rough", None),
        pad_to=pad_to,
        face_uv=getattr(scene, "face_uv", None),
        face_tex=face_tex,
        textures=textures,
        env=env,
        device=device,
    )


def to_device(buffers: SceneBuffers, device) -> SceneBuffers:
    """The same buffers, textures and environment map on ``device``."""
    return SceneBuffers(**{
        k: v.to(device) if isinstance(v, (torch.Tensor, TextureTable)) else v
        for k, v in buffers._asdict().items()})

"""OBJ/MTL scene ingest with the reference's exact flattening semantics.

Mirrors ref main.cpp:28-58 (``loadFromFile`` + tinyobjloader defaults):
  - n-gon faces fan-triangulated: (v0, v_k+1, v_k+2)
  - vertices flattened to a fully NON-indexed stream; indices are 0..N-1
    (ref main.cpp:45)
  - Y axis NEGATED at load (ref main.cpp:42)
  - one material per triangle, resolved post-triangulation from the active
    ``usemtl``; diffuse = Kd, emission = Ke (ref main.cpp:47-56)

This is the pure-Python parser of sfvp_tpu.scene.objload (its
``native="never"`` path) beside the package's C++ loader (native.py), which
``native="auto"`` takes when its library loads. All of them produce
identical arrays (tests/test_torch_scene.py, tests/test_torch_native.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cornell_box_path() -> str:
    """Path to the bundled Cornell Box (same asset family as the reference's
    assets/CornellBox-Original.obj)."""
    return os.path.join(_REPO_ROOT, "assets", "CornellBox-Original.obj")


@dataclasses.dataclass
class Scene:
    """Flat, non-indexed triangle soup + per-face materials (host numpy)."""

    vertices: np.ndarray       # (3T, 3) float32, Y negated
    indices: np.ndarray        # (3T,)  uint32 == arange (ref main.cpp:45)
    face_diffuse: np.ndarray   # (T, 3) float32 (Kd)
    face_emission: np.ndarray  # (T, 3) float32 (Ke)
    # extensions beyond the reference's {Kd, Ke} model (BASELINE config 3):
    face_specular: np.ndarray = None   # (T, 3) float32 (Ks), mirror/F0 tint
    face_mat_type: np.ndarray = None   # (T,) i32: 0=diffuse 1=mirror
    #                                    2=glossy 3=dielectric
    face_rough: np.ndarray = None      # (T,) f32: GGX roughness (mtype 2)
    #                                    or encoded IOR (Ni-1)/4 (mtype 3)
    face_uv: np.ndarray = None         # (T, 3, 2) float32 per-corner vt
    face_tex: np.ndarray = None        # (T,) i32 texture index, -1 = none
    texture_paths: List[str] = dataclasses.field(default_factory=list)
    env_map: "str | None" = None       # equirect sky image path (IBL)
    material_names: List[str] = dataclasses.field(default_factory=list)
    face_material_id: Optional[np.ndarray] = None  # (T,) int32

    @property
    def num_triangles(self) -> int:
        return self.face_diffuse.shape[0]

    def triangles(self) -> np.ndarray:
        """(T, 3, 3) view of the vertex stream."""
        return self.vertices.reshape(-1, 3, 3)


def _parse_mtl(path: str) -> Tuple[Dict[str, Dict[str, np.ndarray]], List[str]]:
    materials: Dict[str, Dict[str, np.ndarray]] = {}
    order: List[str] = []
    cur = None
    with open(path, "r") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                cur = parts[1]
                materials[cur] = {
                    "Kd": np.zeros(3, np.float32),
                    "Ke": np.zeros(3, np.float32),
                    "Ks": np.zeros(3, np.float32),
                    "Ns": np.float32(0.0),
                    "Ni": np.float32(1.0),
                    "illum": np.float32(2.0),
                    "Pr": np.float32(0.0),
                    "map_Kd": None,
                }
                order.append(cur)
            elif cur is not None and key in ("Kd", "Ke", "Ks"):
                materials[cur][key] = np.array(
                    [float(parts[1]), float(parts[2]), float(parts[3])], np.float32
                )
            elif cur is not None and key in ("Ns", "Ni", "illum", "Pr"):
                materials[cur][key] = np.float32(float(parts[1]))
            elif cur is not None and key == "map_Kd":
                # last token = filename (options like -bm are not supported)
                materials[cur]["map_Kd"] = os.path.join(
                    os.path.dirname(os.path.abspath(path)), parts[-1]
                )
    return materials, order


def _resolve_index(tok: str, nverts: int) -> int:
    """OBJ index token 'v', 'v/vt', 'v//vn', 'v/vt/vn'; 1-based; negative =
    relative to the end of the vertex list so far."""
    v = tok.split("/")[0]
    i = int(v)
    return (nverts + i) if i < 0 else (i - 1)


def _resolve_vt_index(tok: str, nvt: int) -> int:
    """vt index from a face token, or -1 when absent ('v' or 'v//vn')."""
    parts = tok.split("/")
    if len(parts) < 2 or not parts[1]:
        return -1
    i = int(parts[1])
    return (nvt + i) if i < 0 else (i - 1)


def load_obj(path: Optional[str] = None, flip_y: bool = True,
             native: str = "auto") -> Scene:
    """Parse an OBJ (+ its mtllib) into the reference's flat layout.
    ``native``: "auto" takes the C++ loader when its library loads,
    "never" this parser, "require" raises RuntimeError without the
    library (sfvp_tpu objload.py:118-140); the outputs are identical."""
    if path is None:
        path = cornell_box_path()
    if native not in ("auto", "never", "require"):
        raise ValueError(f"unknown native={native!r}")
    if native != "never":
        from .. import native as native_mod

        if native == "require":
            native_mod.require("OBJ loader")
        scene = native_mod.load_obj_native(path, flip_y)
        if scene is not None:
            return scene
    base = os.path.dirname(os.path.abspath(path))

    positions: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    tri_indices: List[Tuple[int, int, int]] = []
    tri_vt: List[Tuple[int, int, int]] = []
    tri_material: List[int] = []
    materials: Dict[str, Dict[str, np.ndarray]] = {}
    mat_order: List[str] = []
    cur_mat = -1

    with open(path, "r") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            key = parts[0]
            if key == "v":
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vt":
                texcoords.append((float(parts[1]),
                                  float(parts[2]) if len(parts) > 2 else 0.0))
            elif key == "f":
                idx = [_resolve_index(t, len(positions)) for t in parts[1:]]
                vts = [_resolve_vt_index(t, len(texcoords)) for t in parts[1:]]
                # fan triangulation, tinyobjloader default
                for k in range(len(idx) - 2):
                    tri_indices.append((idx[0], idx[k + 1], idx[k + 2]))
                    tri_vt.append((vts[0], vts[k + 1], vts[k + 2]))
                    tri_material.append(cur_mat)
            elif key == "usemtl":
                name = parts[1]
                cur_mat = mat_order.index(name) if name in mat_order else -1
            elif key == "mtllib":
                mtl_path = os.path.join(base, parts[1])
                if os.path.exists(mtl_path):
                    materials, mat_order = _parse_mtl(mtl_path)

    pos = np.asarray(positions, np.float32)
    if flip_y and len(pos):
        pos = pos * np.array([1.0, -1.0, 1.0], np.float32)  # ref main.cpp:42

    ntris = len(tri_indices)
    vertices = np.zeros((3 * ntris, 3), np.float32)
    diffuse = np.zeros((ntris, 3), np.float32)
    emission = np.zeros((ntris, 3), np.float32)
    specular = np.zeros((ntris, 3), np.float32)
    mat_type = np.zeros((ntris,), np.int32)
    rough = np.zeros((ntris,), np.float32)
    face_uv = np.zeros((ntris, 3, 2), np.float32)
    face_tex = np.full((ntris,), -1, np.int32)
    tex_paths: List[str] = []
    tex_index: Dict[str, int] = {}
    uv = np.asarray(texcoords, np.float32) if texcoords else None
    mat_ids = np.asarray(tri_material, np.int32)
    for t, (a, b, c) in enumerate(tri_indices):
        vertices[3 * t + 0] = pos[a]
        vertices[3 * t + 1] = pos[b]
        vertices[3 * t + 2] = pos[c]
        vta, vtb, vtc = tri_vt[t]
        if uv is not None and vta >= 0 and vtb >= 0 and vtc >= 0:
            face_uv[t, 0] = uv[vta]
            face_uv[t, 1] = uv[vtb]
            face_uv[t, 2] = uv[vtc]
            has_uv = True
        else:
            has_uv = False
        m = tri_material[t]
        if m >= 0:
            mat = materials[mat_order[m]]
            diffuse[t] = mat["Kd"]
            emission[t] = mat["Ke"]
            specular[t] = mat["Ks"]
            map_kd = mat.get("map_Kd")
            if map_kd is not None and has_uv:
                if map_kd not in tex_index:
                    tex_index[map_kd] = len(tex_paths)
                    tex_paths.append(map_kd)
                face_tex[t] = tex_index[map_kd]
            # extensions (the reference's shader model is diffuse+emission
            # only, ref closesthit.rchit:60-62):
            # - classic 'illum >= 4' refraction with Ni > 1 -> smooth
            #   dielectric (mtype 3); the rough column stores the encoded
            #   IOR (Ni-1)/4 and the tint is Ks (white when Ks is zero)
            # - PBR MTL 'Pr' roughness + nonzero Ks -> GGX glossy (mtype 2)
            # - classic 'illum >= 3' ray-traced reflection -> perfect
            #   mirror tinted by Ks (mtype 1)
            if float(mat["illum"]) >= 4.0 and float(mat["Ni"]) > 1.0:
                mat_type[t] = 3
                rough[t] = min((float(mat["Ni"]) - 1.0) / 4.0, 0.96)
                if not np.any(mat["Ks"] > 0):
                    specular[t] = 1.0
            elif float(mat["Pr"]) > 0.0 and np.any(mat["Ks"] > 0):
                mat_type[t] = 2
                rough[t] = min(float(mat["Pr"]), 1.0)
            elif float(mat["illum"]) >= 3.0 and np.any(mat["Ks"] > 0):
                mat_type[t] = 1

    return Scene(
        vertices=vertices,
        indices=np.arange(3 * ntris, dtype=np.uint32),
        face_diffuse=diffuse,
        face_emission=emission,
        face_specular=specular,
        face_mat_type=mat_type,
        face_rough=rough,
        face_uv=face_uv,
        face_tex=face_tex,
        texture_paths=tex_paths,
        material_names=mat_order,
        face_material_id=mat_ids,
    )

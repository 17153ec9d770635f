"""OBJ/MTL ingest of the plain reference: a frozen copy of the parser of
``tools/oracle_ref.py`` (the Vulkan reference's main.cpp:28-58 semantics:
fan triangulation, Y negated at load, one material per triangle, Kd and
Ke only).

The reference shades every face as diffuse plus emission, so a material
that asks for more (a specular tint, an index of refraction behind an
``illum`` of 3 or more, a roughness, a texture) is refused rather than
rendered differently from the program.
"""

from __future__ import annotations

import os

import numpy as np

F = np.float32


def load_scene(obj_path: str):
    """Returns (tris (T, 3, 3) f32, diffuse (T, 3) f32, emission (T, 3)
    f32)."""
    verts = []
    mtl = {}
    cur = None
    tri_v = []
    tri_m = []

    def parse_mtl(path):
        name = None
        with open(path) as f:
            for line in f:
                tok = line.split("#", 1)[0].split()
                if not tok:
                    continue
                if tok[0] == "newmtl":
                    name = tok[1]
                    mtl[name] = {"Kd": (0.0, 0.0, 0.0), "Ke": (0.0, 0.0, 0.0)}
                elif name is None:
                    continue
                elif tok[0] in ("Kd", "Ke"):
                    mtl[name][tok[0]] = tuple(float(x) for x in tok[1:4])
                elif tok[0] == "Ks" and any(float(x) for x in tok[1:4]):
                    raise ValueError(f"{path}: material {name} has a "
                                     "specular tint; the reference is "
                                     "diffuse only")
                elif tok[0] == "illum" and float(tok[1]) >= 3:
                    raise ValueError(f"{path}: material {name} has illum "
                                     f"{tok[1]}; the reference is diffuse "
                                     "only")
                elif tok[0] in ("Pr", "map_Kd"):
                    raise ValueError(f"{path}: material {name} has "
                                     f"{tok[0]}; the reference is diffuse "
                                     "only")

    with open(obj_path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "mtllib":
                parse_mtl(os.path.join(os.path.dirname(obj_path), tok[1]))
            elif tok[0] == "v":
                x, y, z = (float(t) for t in tok[1:4])
                verts.append((x, -y, z))  # Y negated at load, main.cpp:42
            elif tok[0] == "usemtl":
                cur = tok[1]
            elif tok[0] == "f":
                idx = [int(t.split("/")[0]) - 1 for t in tok[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tri_v.append((idx[0], idx[k], idx[k + 1]))
                    tri_m.append(cur)

    v = np.asarray(verts, F)
    tris = v[np.asarray(tri_v, np.int64)]
    kd = np.asarray([mtl[m]["Kd"] for m in tri_m], F)
    ke = np.asarray([mtl[m]["Ke"] for m in tri_m], F)
    return tris, kd, ke

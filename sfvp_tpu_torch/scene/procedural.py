"""Procedural high-poly test scenes (BASELINE configs 2-4: 100k and 500k
spheres, terrain, the city; the instanced field of ``--scene
instanced``), a copy of sfvp_tpu.scene.procedural: pure NumPy generators
that return Scene objects (and Instance lists) byte-identical to the JAX
package's (tests/test_torch_bvh_build.py, tests/test_torch_tlas.py), and
an OBJ exporter."""

from __future__ import annotations

import numpy as np

from .objload import Scene


def _scene_from_grid(verts: np.ndarray, faces: np.ndarray,
                     diffuse=(0.7, 0.7, 0.7),
                     orient_toward=None) -> Scene:
    tris = verts[faces]  # (T, 3, 3)
    if orient_toward is not None:
        # Flip winding so the REFERENCE normal convention
        # n = -normalize(cross(e01, e02)) (ref closesthit.rchit:43-48)
        # points along `orient_toward` (per-tri desired direction array or
        # a constant vector); otherwise hemisphere sampling around the
        # geometric normal would shoot bounce rays into the surface.
        e01 = tris[:, 1] - tris[:, 0]
        e02 = tris[:, 2] - tris[:, 0]
        n = -np.cross(e01, e02)
        want = np.broadcast_to(
            np.asarray(orient_toward, np.float32), n.shape
        ) if np.asarray(orient_toward).ndim == 1 else orient_toward
        flip = (n * want).sum(axis=1) < 0
        tris[flip] = tris[flip][:, [0, 2, 1]]
    t = len(tris)
    return Scene(
        vertices=tris.reshape(-1, 3).astype(np.float32),
        indices=np.arange(3 * t, dtype=np.uint32),
        face_diffuse=np.broadcast_to(
            np.asarray(diffuse, np.float32), (t, 3)
        ).copy(),
        face_emission=np.zeros((t, 3), np.float32),
        face_specular=np.zeros((t, 3), np.float32),
        face_mat_type=np.zeros((t,), np.int32),
        material_names=["default"],
        face_material_id=np.zeros((t,), np.int32),
    )


def sphere_mesh(n_lat: int = 224, n_lon: int = 224, radius: float = 1.0,
                bump: float = 0.0, center=(0.0, 0.0, 0.0)) -> Scene:
    """UV sphere with ~2*n_lat*n_lon triangles; optional sinusoidal
    displacement (``bump``) for a non-convex stress case."""
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon + 1)[:-1]
    th, ph = np.meshgrid(lat, lon, indexing="ij")  # (n_lat+1, n_lon)
    r = radius * (
        1.0 + bump * np.sin(6 * th) * np.cos(6 * ph)
    )
    x = r * np.sin(th) * np.cos(ph) + center[0]
    y = r * np.cos(th) + center[1]
    z = r * np.sin(th) * np.sin(ph) + center[2]
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                faces.append((a, b, c))
            if i < n_lat - 1:
                faces.append((a, c, d))
    faces = np.asarray(faces, np.int64)
    centroid_dir = verts[faces].mean(axis=1) - np.asarray(center, np.float32)
    return _scene_from_grid(verts, faces, orient_toward=centroid_dir)


def terrain_mesh(n: int = 224, size: float = 10.0, height: float = 1.5,
                 seed: int = 0) -> Scene:
    """Heightfield terrain with 2*(n-1)^2 triangles."""
    g = np.random.default_rng(seed)
    # smooth noise: sum of random low-frequency sinusoids
    xs = np.linspace(-size / 2, size / 2, n)
    xx, zz = np.meshgrid(xs, xs, indexing="ij")
    h = np.zeros_like(xx)
    for _ in range(8):
        fx, fz = g.uniform(0.2, 1.5, 2)
        px, pz = g.uniform(0, 2 * np.pi, 2)
        h += g.uniform(0.1, 0.4) * np.sin(fx * xx + px) * np.cos(fz * zz + pz)
    h *= height / max(np.abs(h).max(), 1e-9)
    verts = np.stack([xx, h, zz], axis=-1).reshape(-1, 3)

    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            b = i * n + j + 1
            c = (i + 1) * n + j + 1
            d = (i + 1) * n + j
            faces.append((a, b, c))
            faces.append((a, c, d))
    return _scene_from_grid(
        verts, np.asarray(faces, np.int64), orient_toward=(0.0, 1.0, 0.0)
    )


def city_mesh(n_buildings: int = 100, subdiv: int = 9, size: float = 20.0,
              seed: int = 0, emissive_frac: float = 0.06,
              glossy_ground: bool = False) -> Scene:
    """Architectural stress scene: a subdivided ground plane plus
    ``n_buildings`` axis-aligned towers with tessellated faces
    (~``6 * 2 * subdiv^2`` tris each), so triangle density varies by
    orders of magnitude across space. A few rooftops are emissive;
    ``glossy_ground`` makes the ground a GGX reflector (roughness 0.2,
    the reference suite's glossy city, bench.py:136-195)."""
    g = np.random.default_rng(seed)
    tri_chunks, kd, ke, mtype, rough = [], [], [], [], []

    def face_grid(origin, du, dv, out):
        """Two triangles per cell over origin + [0,1]du + [0,1]dv, wound so
        the reference normal -cross(e01, e02) points along ``out``."""
        s = subdiv
        u = np.linspace(0.0, 1.0, s + 1)
        uu, vv = np.meshgrid(u, u, indexing="ij")
        pts = (np.asarray(origin, np.float32)[None, None]
               + uu[..., None] * np.asarray(du, np.float32)
               + vv[..., None] * np.asarray(dv, np.float32))
        a = pts[:-1, :-1].reshape(-1, 3)
        b = pts[1:, :-1].reshape(-1, 3)
        c = pts[1:, 1:].reshape(-1, 3)
        d = pts[:-1, 1:].reshape(-1, 3)
        tris = np.concatenate(
            [np.stack([a, b, c], axis=1), np.stack([a, c, d], axis=1)]
        ).astype(np.float32)
        n = -np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        flip = (n * np.asarray(out, np.float32)).sum(axis=1) < 0
        tris[flip] = tris[flip][:, [0, 2, 1]]
        return tris

    def add(tris, color, emission=(0, 0, 0), mat=0, rg=0.0):
        tri_chunks.append(tris)
        t = len(tris)
        kd.append(np.broadcast_to(np.asarray(color, np.float32), (t, 3)))
        ke.append(np.broadcast_to(np.asarray(emission, np.float32), (t, 3)))
        mtype.append(np.full(t, mat, np.int32))
        rough.append(np.full(t, rg, np.float32))

    half = size / 2
    add(
        face_grid((-half, 0, -half), (size, 0, 0), (0, 0, size), (0, 1, 0)),
        (0.55, 0.55, 0.58),
        mat=2 if glossy_ground else 0,
        rg=0.2 if glossy_ground else 0.0,
    )
    for i in range(n_buildings):
        w = g.uniform(0.4, 1.6)
        d = g.uniform(0.4, 1.6)
        h = g.uniform(0.6, 4.5)
        x0 = g.uniform(-half + 1, half - 2.6)
        z0 = g.uniform(-half + 1, half - 2.6)
        color = g.uniform(0.25, 0.85, 3)
        lit = g.uniform() < emissive_frac
        walls = [
            ((x0, 0, z0), (w, 0, 0), (0, h, 0), (0, 0, -1)),
            ((x0, 0, z0 + d), (w, 0, 0), (0, h, 0), (0, 0, 1)),
            ((x0, 0, z0), (0, 0, d), (0, h, 0), (-1, 0, 0)),
            ((x0 + w, 0, z0), (0, 0, d), (0, h, 0), (1, 0, 0)),
        ]
        for origin, du, dv, out in walls:
            add(face_grid(origin, du, dv, out), color)
        roof = face_grid((x0, h, z0), (w, 0, 0), (0, 0, d), (0, 1, 0))
        if lit:
            add(roof, (0, 0, 0), emission=g.uniform(4.0, 10.0, 3))
        else:
            add(roof, color * 0.9)

    tris = np.concatenate(tri_chunks)
    t = len(tris)
    return Scene(
        vertices=tris.reshape(-1, 3).astype(np.float32),
        indices=np.arange(3 * t, dtype=np.uint32),
        face_diffuse=np.concatenate(kd).astype(np.float32),
        face_emission=np.concatenate(ke).astype(np.float32),
        face_specular=np.where(
            np.concatenate(mtype)[:, None] == 2,
            np.float32(0.9), np.float32(0.0),
        ) * np.ones((1, 3), np.float32),
        face_mat_type=np.concatenate(mtype),
        face_rough=np.concatenate(rough),
        material_names=["city"],
        face_material_id=np.zeros((t,), np.int32),
    )


def instanced_field(n_tris: int = 100_000, n_inst: int = 49,
                    seed: int = 12) -> list:
    """Demo instanced scene: ``n_inst`` rotated/scaled instances sharing
    TWO displaced-sphere BLAS meshes over a ground slab — the general
    form of the reference's TLAS-over-one-BLAS (ref main.cpp:521-538).
    Returns a list of accel.instances.Instance for the instanced render
    path (dispatch.select_instanced_render_step); ``n_tris`` counts the
    FLATTENED total across instances."""
    from ..accel.instances import Instance

    g = np.random.default_rng(seed)
    n = max(8, int(np.sqrt(max(n_tris, 1) / max(n_inst, 1) / 2.0)))
    ball_a = sphere_mesh(n_lat=n, n_lon=n, bump=0.25)
    ball_a.face_diffuse[:] = (0.75, 0.35, 0.25)
    ball_b = sphere_mesh(n_lat=n, n_lon=n, bump=0.1)
    ball_b.face_diffuse[:] = (0.3, 0.45, 0.8)
    big = 40.0
    ground = Scene(
        vertices=np.asarray([
            [-big, 0, -big], [big, 0, -big], [big, 0, big],
            [-big, 0, -big], [big, 0, big], [-big, 0, big],
        ], np.float32),
        indices=np.arange(6, dtype=np.uint32),
        face_diffuse=np.full((2, 3), 0.55, np.float32),
        face_emission=np.zeros((2, 3), np.float32),
    )
    insts = [Instance(
        scene=ground,
        transform=np.hstack([np.eye(3, dtype=np.float32),
                             np.zeros((3, 1), np.float32)]))]
    cols = max(2, int(np.sqrt(n_inst)))
    span = float(cols - 1)
    for i in range(n_inst):
        ang = g.uniform(0, 2 * np.pi)
        c, sn = np.cos(ang), np.sin(ang)
        rot = np.asarray([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float32)
        sc = float(g.uniform(0.5, 1.1))
        tr = np.asarray([
            (-span / 2 + (i % cols)) * 2.0, sc,
            (-span / 2 + (i // cols)) * 2.0,
        ], np.float32)
        insts.append(Instance(
            scene=ball_a if i % 2 == 0 else ball_b,
            transform=np.hstack([(rot * sc), tr[:, None]]).astype(
                np.float32)))
    return insts


def save_obj(scene: Scene, path: str) -> None:
    """Export a Scene to OBJ (unflips Y so a load_obj round trip matches)."""
    v = scene.vertices * np.asarray([1.0, -1.0, 1.0], np.float32)
    with open(path, "w") as f:
        f.write("# generated by sfvp_tpu.scene.procedural\n")
        for p in v:
            f.write(f"v {p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n")
        for t in range(scene.num_triangles):
            f.write(f"f {3*t+1} {3*t+2} {3*t+3}\n")

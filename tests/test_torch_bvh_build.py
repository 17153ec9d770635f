"""The port's procedural scenes and host BVH builders against sfvp_tpu's,
byte for byte: the meshes, the threaded binary trees (LBVH and binned
SAH) and their 8-wide collapse (nodes, triangle rows, prim rows,
max_stack), for the Cornell Box, sphere_mesh(12, 12) and a small city.

The JAX side is asked for its NumPy builders by name (``native="never"``,
the builder named explicitly): these tests never build, load or write the
JAX package's native library.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.accel import lbvh as j_lbvh  # noqa: E402
from sfvp_tpu.accel.sah import sah_bvh_from_arrays as j_sah  # noqa: E402
from sfvp_tpu.accel.wide import build_wide as j_build_wide  # noqa: E402
from sfvp_tpu.accel.wide import materials_array as j_materials  # noqa: E402
from sfvp_tpu.accel.wide import uv_array as j_uv  # noqa: E402
from sfvp_tpu.scene import procedural as j_proc  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch.accel import lbvh, sah, wide  # noqa: E402
from sfvp_tpu_torch.scene import procedural as t_proc  # noqa: E402
from sfvp_tpu_torch.scene.buffers import FIELDS, from_numpy  # noqa: E402

MESHES = {
    "sphere": lambda m: m.sphere_mesh(12, 12, bump=0.3),
    "sphere_smooth": lambda m: m.sphere_mesh(9, 7),
    "terrain": lambda m: m.terrain_mesh(10),
    "city": lambda m: m.city_mesh(3, 3),
}
SCENE_FIELDS = ("vertices", "indices", "face_diffuse", "face_emission",
                "face_specular", "face_mat_type", "face_material_id")


def _scene(name, mod):
    if name == "cornell":
        return mod.load_obj(native="never") if mod is J else mod.load_obj()
    return MESHES[name](j_proc if mod is J else t_proc)


def _buffers(name):
    """The JAX buffers of scene ``name`` and the port's twin of them."""
    jb = J.upload(_scene(name, J))
    tb = from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS},
                    jb.num_tris, "cpu")
    return jb, tb


def _jax_binary(jb, builder):
    """sfvp_tpu's NumPy binary tree over the triangles of buffers ``jb``."""
    tris = np.stack([np.stack([np.asarray(getattr(jb, f"v{c}{a}"))
                               [: jb.num_tris] for a in "xyz"], -1)
                     for c in range(3)], 1)
    if builder == "sah":
        return j_sah(tris, leaf_size=8, native="never")
    return j_lbvh.bvh_from_arrays(tris, leaf_size=8)


def _assert_bvh_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "tv":
            assert all(np.array_equal(p, q) for p, q in zip(x, y)), f
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("name", sorted(MESHES))
def test_procedural_meshes_equal(name):
    a, b = _scene(name, J), _scene(name, T)
    for f in SCENE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.material_names == b.material_names


def test_save_obj_equal(tmp_path):
    s = MESHES["city"](t_proc)
    j_proc.save_obj(MESHES["city"](j_proc), str(tmp_path / "j.obj"))
    t_proc.save_obj(s, str(tmp_path / "t.obj"))
    assert (tmp_path / "j.obj").read_bytes() == (tmp_path / "t.obj").read_bytes()
    back = T.load_obj(str(tmp_path / "t.obj"), flip_y=False)
    assert back.num_triangles == s.num_triangles


def test_morton3d_equal():
    g = np.random.default_rng(7)
    x, y, z = (g.integers(0, 1024, 500).astype(np.uint32) for _ in range(3))
    assert np.array_equal(lbvh.morton3d(x, y, z), j_lbvh.morton3d(x, y, z))


@pytest.mark.parametrize("builder", ["lbvh", "sah"])
@pytest.mark.parametrize("name", ["cornell", "sphere", "city"])
def test_binary_bvh_equal(name, builder):
    jb, tb = _buffers(name)
    want = _jax_binary(jb, builder)
    got = (sah.build_sah_bvh(tb, leaf_size=8) if builder == "sah"
           else lbvh.build_bvh(tb, leaf_size=8, native="never"))
    _assert_bvh_equal(want, got)
    lbvh.check_invariants(got, lbvh.host_triangles(tb))


@pytest.mark.parametrize("builder", ["lbvh", "sah"])
@pytest.mark.parametrize("name", ["cornell", "sphere", "city"])
def test_wide_bvh_equal(name, builder):
    jb, tb = _buffers(name)
    want = j_build_wide(_jax_binary(jb, builder), j_materials(jb),
                        aux=j_uv(jb))
    got = wide.build_wide_from_buffers(tb, native="never", builder=builder)
    for f in ("nodes", "tris", "prim_rows"):
        x, y = getattr(want, f), getattr(got, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert got.max_stack == want.max_stack
    assert got.tris_aux is None and want.tris_aux is None
    assert np.array_equal(got.codes, want.codes)
    # every triangle sits in exactly one slot
    prims = got.prim_rows[got.prim_rows >= 0]
    assert sorted(prims.tolist()) == list(range(tb.num_tris))


def test_mirror_lanes_pack_specular_and_type():
    """A mirror's albedo lanes hold Ks and its type lane 1 (+ roughness),
    as sfvp_tpu packs them."""
    from test_torch_integrator import mirror_scene_arrays

    jb = J.scene.buffers.from_arrays(*mirror_scene_arrays())
    tb = from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS},
                    jb.num_tris, "cpu")
    assert np.array_equal(wide.materials_array(tb), j_materials(jb))
    got = wide.build_wide_from_buffers(tb, builder="sah")
    want = j_build_wide(_jax_binary(jb, "sah"), j_materials(jb))
    assert np.array_equal(got.tris, want.tris)


def test_reorder_bfs_equal():
    jb, tb = _buffers("city")
    from sfvp_tpu.accel.wide import reorder_bfs as j_reorder

    a = j_reorder(j_build_wide(_jax_binary(jb, "lbvh"), j_materials(jb)))
    b = wide.reorder_bfs(wide.build_wide_from_buffers(tb, builder="lbvh"))
    assert np.array_equal(a.nodes, b.nodes) and np.array_equal(a.tris, b.tris)


def test_builder_auto_picks_sah_then_lbvh(monkeypatch):
    """"auto" chooses as sfvp_tpu does without its native library: SAH up
    to SAH_MAX_TRIS triangles, LBVH beyond."""
    jb, tb = _buffers("sphere")
    sah_tree = wide.build_wide_from_buffers(tb, builder="sah")
    lbvh_tree = wide.build_wide_from_buffers(tb, builder="lbvh")
    auto = wide.build_wide_from_buffers(tb)
    assert np.array_equal(auto.nodes, sah_tree.nodes)
    monkeypatch.setattr(wide, "SAH_MAX_TRIS", tb.num_tris - 1)
    auto = wide.build_wide_from_buffers(tb)
    assert np.array_equal(auto.nodes, lbvh_tree.nodes)


def test_sah_limit_is_sfvp_tpus():
    assert wide.SAH_MAX_TRIS == 200_000


@pytest.mark.parametrize("builder", ["lbvh", "sah"])
def test_native_builder_require_raises(builder):
    _, tb = _buffers("cornell")
    with pytest.raises(NotImplementedError, match="A.9"):
        wide.build_wide_from_buffers(tb, native="require", builder=builder)


def test_unknown_builder_raises():
    _, tb = _buffers("cornell")
    with pytest.raises(ValueError, match="builder"):
        wide.build_wide_from_buffers(tb, builder="octree")


@pytest.mark.parametrize("knobs", [
    dict(), dict(sort_bounce_rays=False), dict(sort_material_key=False),
    dict(sort_bounce_rays=False, sort_material_key=False,
         traversal="bvh", megakernel_regen=False),
    dict(sort_bounce_rays=True), dict(stream_tris=True),
    dict(stream_tris=False), dict(stream_tris=True, sort_bounce_rays=True)])
def test_config_hash_ignores_sort_knobs(knobs):
    """The restored sort knobs, and the stream knob, are execution knobs: the hash equals sfvp_tpu's for every setting, and
    equals the hash without them. By default (None) the port sorts where
    K6 traces and nowhere else (it loses on the H100 on K3, config.py);
    an explicit setting wins."""
    from sfvp_tpu_torch.integrate.wavefront import sort_rays

    kw = dict(width=64, height=32, sampling="cosine", use_rr=True)
    a = J.RenderConfig(**kw, **knobs).config_hash()
    b = T.RenderConfig(**kw, **knobs).config_hash()
    assert a == b == T.RenderConfig(**kw).config_hash()
    cfg = T.RenderConfig(**knobs)
    assert cfg.sort_bounce_rays == knobs.get("sort_bounce_rays")
    for stream in (False, True):
        assert sort_rays(cfg, stream) == knobs.get("sort_bounce_rays",
                                                   stream)

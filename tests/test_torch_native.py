"""The port's native (C++) loader and BVH builders (sfvp_tpu_torch/native.py)
against the port's own Python implementations and sfvp_tpu's
``native="never"`` ones: byte-identical outputs, as tests/test_native.py
holds sfvp_tpu's library. The port's library is built once per process
into the port's build directory (native.build, under a file lock); these
tests never build, load or write the JAX package's csrc/ library.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.accel.lbvh import bvh_from_arrays as j_lbvh  # noqa: E402
from sfvp_tpu.accel.sah import sah_bvh_from_arrays as j_sah  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch import native  # noqa: E402
from sfvp_tpu_torch.accel import wide  # noqa: E402
from sfvp_tpu_torch.accel.lbvh import bvh_from_arrays, check_invariants  # noqa: E402
from sfvp_tpu_torch.accel.sah import sah_bvh_from_arrays  # noqa: E402
from sfvp_tpu_torch.scene import procedural  # noqa: E402

SCENE_FIELDS = ("vertices", "indices", "face_diffuse", "face_emission",
                "face_specular", "face_mat_type", "face_rough", "face_uv",
                "face_tex", "face_material_id")
BVH_FIELDS = ("bmin_x", "bmin_y", "bmin_z", "bmax_x", "bmax_y", "bmax_z",
              "skip", "first", "count", "prim_id")


@pytest.fixture(scope="module", autouse=True)
def library():
    assert native.available(), native._lib_or_error()[1]
    assert native.library_path().parent == native.BUILD_DIR


def _hide_library(monkeypatch):
    monkeypatch.setattr(native, "_get_lib", lambda: None)


def _same_scene(a, b):
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.material_names == b.material_names
    assert a.texture_paths == b.texture_paths


def _same_bvh(a, b):
    assert a.num_nodes == b.num_nodes
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for i in range(9):
        np.testing.assert_array_equal(a.tv[i], b.tv[i])


def _quirks_obj(tmp_path):
    """Relative indices, n-gons, usemtl before/after groups, illum 3,
    dielectric (illum 7 + Ni) with the white-tint default, a GGX face."""
    (tmp_path / "m.mtl").write_text(
        "newmtl a\nKd 0.1 0.2 0.3\nKe 1 2 3\nillum 2\n"
        "newmtl b\nKd 0 0 0\nKs 0.5 0.5 0.5\nillum 3\n"
        "newmtl g\nKd 0 0 0\nKs 0 0 0\nNi 1.5\nillum 7\n"
        "newmtl r\nKd 0 0 0\nKs 0.9 0.8 0.7\nPr 0.3\n"
    )
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "usemtl a\nf 1 2 3 4\n"
        "usemtl b\nf -5 -4 -1\n"
        "g grp\nusemtl g\nf 1 2 5\n"
        "usemtl r\nf 2 3 5\n"
    )
    return str(tmp_path / "q.obj")


def _tris(n, seed):
    g = np.random.default_rng(seed)
    return (g.uniform(-10, 10, (n, 1, 3))
            + g.normal(0, 0.5, (n, 3, 3))).astype(np.float32)


@pytest.mark.parametrize("which", ["cornell", "quirks"])
def test_obj_loader_parity(which, tmp_path):
    path = (T.cornell_box_path() if which == "cornell"
            else _quirks_obj(tmp_path))
    b = native.load_obj_native(path)
    _same_scene(T.load_obj(path, native="never"), b)
    _same_scene(J.load_obj(path, native="never"), b)
    _same_scene(T.load_obj(path), b)  # "auto" takes the library
    if which == "quirks":
        assert list(b.face_mat_type[-2:]) == [3, 2]


def test_obj_loader_missing_file():
    with pytest.raises(FileNotFoundError):
        native.load_obj_native("/nonexistent/x.obj")


@pytest.mark.parametrize("n,leaf", [(36, 4), (500, 4), (5000, 8), (3, 1)])
def test_lbvh_parity(n, leaf):
    tris = _tris(n, n)
    b = native.build_lbvh_native(tris, leaf_size=leaf)
    _same_bvh(bvh_from_arrays(tris, leaf_size=leaf), b)
    _same_bvh(j_lbvh(tris, leaf_size=leaf), b)
    check_invariants(b, tris)


@pytest.mark.parametrize("n", [36, 500, 5000, 3])
def test_sah_parity(n):
    """The native binned-SAH tree is bit-identical to the NumPy builders'
    (the same float32 aggregates, float64 cost math, stable partitions)."""
    tris = _tris(n, n + 17)
    b = native.build_sah_native(tris)
    _same_bvh(sah_bvh_from_arrays(tris, native="never"), b)
    _same_bvh(j_sah(tris, native="never"), b)
    _same_bvh(sah_bvh_from_arrays(tris), b)  # "auto" takes the library
    check_invariants(b, tris)


def test_sah_parity_degenerate_centroids():
    """All-identical centroids: the stable-median fallback agrees."""
    tri = np.random.default_rng(3).normal(size=(1, 3, 3)).astype(np.float32)
    tris = np.repeat(tri, 41, axis=0)
    _same_bvh(sah_bvh_from_arrays(tris, native="never"),
              native.build_sah_native(tris))


def test_emit_topology_parity():
    from sfvp_tpu_torch.accel.lbvh import (
        _morton_codes, emit_topology, topology_to_links)

    tris = _tris(700, 5)
    cent = 0.5 * (tris.min(axis=1) + tris.max(axis=1))
    codes = np.sort(_morton_codes(cent))
    skip, first, count, _ = topology_to_links(emit_topology(codes, 700, 4))
    got = native.emit_topology_native(codes, 4)
    for a, b in zip((skip, first, count), got):
        np.testing.assert_array_equal(a, b)


def _sphere_buffers():
    return T.upload(procedural.sphere_mesh(12, 12, bump=0.3), device="cpu")


def test_builder_auto_takes_sah_with_the_library(monkeypatch):
    """sfvp_tpu's rule (accel/wide.py:388-394): with the native SAH
    builder, "auto" takes SAH at every size, past SAH_MAX_TRIS too."""
    tb = _sphere_buffers()
    monkeypatch.setattr(wide, "SAH_MAX_TRIS", tb.num_tris - 1)
    auto = wide.build_wide_from_buffers(tb)
    sah_tree = wide.build_wide_from_buffers(tb, native="never",
                                            builder="sah")
    assert np.array_equal(auto.nodes, sah_tree.nodes)
    assert np.array_equal(auto.tris, sah_tree.tris)
    # the choice is sfvp_tpu's whatever ``native`` says: with the library
    # loaded, native="never" builds the same SAH tree in NumPy
    never = wide.build_wide_from_buffers(tb, native="never")
    assert np.array_equal(never.nodes, sah_tree.nodes)
    assert np.array_equal(never.tris, sah_tree.tris)


def test_builder_auto_without_the_library(monkeypatch):
    """With the library hidden, "auto" takes LBVH past SAH_MAX_TRIS and
    SAH below it, and the builders fall back to NumPy."""
    _hide_library(monkeypatch)
    assert not native.available() and not native.sah_available()
    tb = _sphere_buffers()
    sah_tree = wide.build_wide_from_buffers(tb, builder="sah")
    assert np.array_equal(wide.build_wide_from_buffers(tb).nodes,
                          sah_tree.nodes)
    monkeypatch.setattr(wide, "SAH_MAX_TRIS", tb.num_tris - 1)
    lbvh_tree = wide.build_wide_from_buffers(tb, builder="lbvh")
    assert np.array_equal(wide.build_wide_from_buffers(tb).nodes,
                          lbvh_tree.nodes)
    assert T.load_obj().num_triangles == 36  # the Python parser


@pytest.mark.parametrize("what", ["obj", "lbvh", "sah"])
def test_require_raises_without_the_library(what, monkeypatch):
    _hide_library(monkeypatch)
    tb = _sphere_buffers()
    with pytest.raises(RuntimeError, match="native .* requested"):
        if what == "obj":
            T.load_obj(native="require")
        else:
            wide.build_wide_from_buffers(tb, native="require", builder=what)


def test_require_takes_the_library():
    tb = _sphere_buffers()
    a = wide.build_wide_from_buffers(tb, native="require", builder="sah")
    b = wide.build_wide_from_buffers(tb, native="never", builder="sah")
    assert np.array_equal(a.nodes, b.nodes) and np.array_equal(a.tris, b.tris)
    _same_scene(T.load_obj(native="require"), T.load_obj(native="never"))


def _code_lines(path):
    """The lines of a C++ source with its // comments and blank lines
    taken away (neither source has a // inside a string or a block
    comment)."""
    lines = (line.split("//", 1)[0].rstrip() for line in open(path))
    return [line for line in lines if line]


def test_native_source_is_the_jax_packages_copy():
    """The port's csrc/sfvp_native.cpp is the JAX package's, apart from
    its comments (which name the port's modules): a fix made to one copy
    and not the other fails here, and the byte-identity tests above then
    say which outputs moved."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ours = _code_lines(os.path.join(root, "sfvp_tpu_torch", "csrc",
                                    "sfvp_native.cpp"))
    theirs = _code_lines(os.path.join(root, "csrc", "sfvp_native.cpp"))
    assert ours == theirs

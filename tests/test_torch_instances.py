"""Instanced scenes in the port against sfvp_tpu: ``Instance``,
``instanced_field`` and ``flatten_instances`` equal array by array; the
two-level build (accel/tlas.py) byte-identical, on the field of ``--scene
instanced`` up to its full 220k-triangle size and on tests/test_tlas.py's
random instances with x tilts and scales; the host-unrolled instanced
trace (the tests' third oracle) against sfvp_tpu's; and the entry points:
the Renderer's instanced routes (K9's twin by default, K7's and K8's with
``megakernel_regen=False``) and ``--scene instanced`` in the CLI.

Bounds: the builds are byte-identical; the unrolled traces name the same
triangle on >= 99.9% of rays (exact ties aside) with t to relative 1e-5
there; renders through the Renderer equal the dispatched step's bitwise.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sfvp_tpu.accel import instances as j_inst  # noqa: E402
from sfvp_tpu.accel.tlas import build_two_level as j_build  # noqa: E402
from sfvp_tpu.scene import procedural as j_proc  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch import cli  # noqa: E402
from sfvp_tpu_torch.accel import instances as t_inst  # noqa: E402
from sfvp_tpu_torch.accel import tlas as t_tlas  # noqa: E402
from sfvp_tpu_torch.dispatch import select_instanced_render_step  # noqa: E402
from sfvp_tpu_torch.kernels.build import MAX_WIDE_STACK  # noqa: E402
from sfvp_tpu_torch.scene.procedural import (  # noqa: E402
    instanced_field as t_field,
)

from test_torch_tlas import NEE, both_scenes  # noqa: E402

SCENE_FIELDS = ("vertices", "indices", "face_diffuse", "face_emission",
                "face_specular", "face_mat_type", "face_rough", "face_uv",
                "face_tex", "face_material_id")


def _same_scene(a, b):
    for f in SCENE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.texture_paths == b.texture_paths
    assert a.material_names == b.material_names
    assert a.env_map == b.env_map


def test_instance_checks_its_transform():
    s = T.load_obj()
    for mod in (t_inst, j_inst):
        ident = mod.identity_instance(s).transform
        assert ident.dtype == np.float32 and ident.shape == (3, 4)
    assert np.array_equal(t_inst.identity_instance(s).transform,
                          j_inst.identity_instance(s).transform)
    with pytest.raises(ValueError, match=r"\(3, 4\)"):
        t_inst.Instance(scene=s, transform=np.eye(3))
    t = t_inst.Instance(scene=s, transform=np.ones((3, 4), np.float64))
    assert t.transform.dtype == np.float32


@pytest.mark.parametrize("n_tris,n_inst", [(300, 4), (220_000, 49)])
def test_instanced_field_matches_jax(n_tris, n_inst):
    """The same RNG draws, so the same transforms, meshes and sharing."""
    jf = j_proc.instanced_field(n_tris=n_tris, n_inst=n_inst)
    tf = t_field(n_tris=n_tris, n_inst=n_inst)
    assert len(tf) == len(jf) == n_inst + 1
    for a, b in zip(tf, jf):
        assert a.transform.dtype == np.float32
        assert np.array_equal(a.transform, b.transform)
        _same_scene(a.scene, b.scene)
    # two shared ball meshes beside the ground
    assert len({id(i.scene) for i in tf}) == len({id(i.scene) for i in jf})


@pytest.mark.parametrize("name", ["field", "random17", "random5_lit"])
def test_flatten_instances_matches_jax(name):
    j_insts, t_insts = both_scenes(name)
    _same_scene(t_inst.flatten_instances(t_insts),
                j_inst.flatten_instances(j_insts))


@pytest.mark.parametrize("name", ["field", "random17", "random5_lit",
                                  "field220k"])
def test_build_two_level_matches_jax(name):
    """Every table and max_stack byte-identical to sfvp_tpu's builder; the
    full-size field of the slice's main path within the kernels' stack."""
    if name == "field220k":
        j_insts = j_proc.instanced_field(n_tris=220_000)
        t_insts = t_field(n_tris=220_000)
    else:
        j_insts, t_insts = both_scenes(name)
    got, want = t_tlas.build_two_level(t_insts), j_build(j_insts)
    for f in ("nodes", "tris", "inst"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert got.max_stack == want.max_stack <= MAX_WIDE_STACK
    assert got.num_instances == want.num_instances == len(t_insts)
    assert got.tris_aux is None and want.tris_aux is None
    # the TLAS leaves are instance refs, one per instance
    tags = got.nodes[:, 56:64]
    assert (tags == t_tlas.TAG_INSTANCE).sum() == len(t_insts)
    if name == "field220k":
        assert (got.nodes.shape[0], got.tris.shape[0], got.max_stack) == (
            372, 1664, 130)


def test_instanced_trace_matches_jax():
    """The host-unrolled instanced trace (one threaded-BVH trace per
    instance) against sfvp_tpu's, on rays toward the instances."""
    j_insts, t_insts = both_scenes("random17")
    g = np.random.default_rng(5)
    o = g.uniform(-6, 6, (1024, 3)).astype(np.float32)
    d = (g.uniform(-3, 3, (1024, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = g.uniform(size=1024) > 0.1
    want = j_inst.make_instanced_trace(j_insts)(
        tuple(jnp.asarray(o[:, i]) for i in range(3)),
        tuple(jnp.asarray(d[:, i]) for i in range(3)), None, 1e-3, 1e4,
        active=jnp.asarray(act))
    got = t_inst.make_instanced_trace(t_insts, device="cpu")(
        tuple(torch.from_numpy(o[:, i].copy()) for i in range(3)),
        tuple(torch.from_numpy(d[:, i].copy()) for i in range(3)), None,
        1e-3, 1e4, active=torch.from_numpy(act))
    jp, tp = np.asarray(want.prim), got.prim.numpy()
    same = jp == tp
    assert same.mean() >= 0.999
    hit = same & (jp >= 0)
    assert hit.sum() > 100 and not (tp[~act] >= 0).any()
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-5)


VIEW = T.CameraConfig.look_at(origin=(6.0, 5.0, 6.0), target=(0.0, 0.6, 0.0),
                              fov_y_deg=50.0)
ROUTES = {
    "k9": (dict(), "megakernel_bvh(fused two-level regen)"),
    "k9-nee": (dict(NEE, use_mis=True),
               "megakernel_bvh(fused two-level regen)"),
    "k7": (dict(megakernel_regen=False), "wavefront(tlas packet)"),
    "k7k8": (dict(NEE, use_mis=True, megakernel_regen=False),
             "wavefront(tlas packet)"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_renderer_takes_the_instanced_routes(route, capsys, monkeypatch):
    """Renderer(cfg, instances, "cpu") flattens them for the shading
    buffers, builds the two-level BVH once (bvh_build_s), names its route
    under SFVP_DISPATCH_DEBUG and renders what the dispatched step
    renders."""
    kw, name = ROUTES[route]
    calls = []
    real = t_tlas.build_two_level

    def counting(insts, **k):
        calls.append(len(insts))
        return real(insts, **k)

    monkeypatch.setattr(t_tlas, "build_two_level", counting)
    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    insts = both_scenes("field_lit")[1]
    cfg = T.RenderConfig(**dict(dict(width=8, height=6, spp_per_step=2,
                                     max_depth=3, sampling="cosine",
                                     camera=VIEW), **kw))
    r = T.Renderer(cfg, insts, "cpu")
    assert f"[sfvp_tpu_torch dispatch] {name}" in capsys.readouterr().err
    assert calls == [len(insts)]
    assert r.wide is None and r.bvh_build_s > 0
    want = real(insts)
    assert all(getattr(r.tl, f).tobytes() == getattr(want, f).tobytes()
               for f in ("nodes", "tris", "inst"))
    assert r.buffers.num_tris == sum(i.scene.num_triangles for i in insts)
    r.step(1)
    step = select_instanced_render_step(cfg, r.buffers, want)
    ref = step(T.init_state(6, 8, "cpu"))
    assert torch.equal(r.state.accum, ref.accum)
    assert float(r.state.mrays) == float(ref.mrays) > 0
    assert calls == [len(insts)]


def test_cli_renders_the_instanced_scene(tmp_path, capsys, monkeypatch):
    """The acceptance command on the CPU (K9's twin): a PNG, the set-up
    line of the two-level build, the route under SFVP_DISPATCH_DEBUG; the
    scene and view are sfvp_tpu's CLI's (cli.py:107-139)."""
    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    out, log = tmp_path / "field.png", tmp_path / "field.jsonl"
    rc = cli.main(["--device", "cpu", "--scene", "instanced", "--scene-tris",
                   "2000", "--width", "16", "--height", "16", "--spp", "2",
                   "--max-depth", "3", "--steps", "1", "--out", str(out),
                   "--log", str(log)])
    assert rc == 0 and out.stat().st_size > 0
    assert len(log.read_text().splitlines()) == 1
    cap = capsys.readouterr()
    assert "set-up: two-level BVH of 50 instances" in cap.out
    assert "megakernel_bvh(fused two-level regen)" in cap.err
    insts, cfg = cli.procedural_scene("instanced", 2000, T.RenderConfig())
    for a, b in zip(insts, j_proc.instanced_field(n_tris=2000)):
        assert np.array_equal(a.transform, b.transform)
        assert np.array_equal(a.scene.vertices, b.scene.vertices)
    assert cfg.camera == T.CameraConfig.look_at(
        origin=(10.5, 7.5, 10.5), target=(0.0, 0.6, 0.0), fov_y_deg=50.0)
    assert cfg.sky_emission == (0.8, 0.85, 1.0)

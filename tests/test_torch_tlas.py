"""The two-level kernels' plain twins against sfvp_tpu: K7's
(kernels/bvh_tlas.py two_level_trace_plain) against the JAX K7 Pallas
kernel make_two_level_trace in interpret mode (as tests/test_tlas.py runs
it), against brute force on the flattened scene and against the
host-unrolled instanced trace; K8's (two_level_occlusion_plain) against the
JAX K8 and K7's twin; K9's (kernels/megakernel_bvh.py
bvh_regen_render_plain over a two-level tree) against the JAX fused
two-level kernel make_bvh_regen_render_step(tl=...); and the port's
wavefront loop over K7's and K8's twins against sfvp_tpu's over its K7
and K8 kernels. The twins trace the JAX builder's arrays, which isolates
the traversal from the build (tests/test_torch_instances.py holds the
builds byte-identical).

Bounds: K7 names the same triangle on every ray but exact ties (>= 99.9%);
there t agrees to relative 1e-5, u and v to 1e-4, the albedo, emission and
material planes are equal and the world-space vertex planes agree to
relative 1e-6: XLA on the CPU may fuse the multiply-adds of the ray's and
the vertices' transforms that the port keeps apart, a 1-ulp difference in
the object-space ray that thin triangles amplify in u and v. Against brute
force on the flattened scene: t to rtol 2e-4, atol 2e-5 (object-space
rounding, tests/test_tlas.py:82). K8: equal on every ray. Images: relative RMSE
< 1e-5 and max abs < 1e-4 (ROADMAP.md §C), traced segments equal.

The kernels' closest-hit walk (csrc/two_level.cuh) keeps one stack and
derives each entry's instance context from its index; a scalar Python
walk of that rule, with the twin's box and triangle tests, is held ray by
ray to the twin's payload and, pop by pop, to the twins' two-stack walk,
on every test scene and on a stress field of small overlapping instances
(where a context misread shows).

The ``cuda`` tests hold the CUDA kernels against their twins and skip
without a card; chip_smoke.py runs the same comparisons on the H100.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.accel.instances import Instance as JInstance  # noqa: E402
from sfvp_tpu.accel.instances import flatten_instances as j_flatten  # noqa: E402
from sfvp_tpu.accel.tlas import build_two_level as j_build  # noqa: E402
from sfvp_tpu.integrate.wavefront import make_render_step as j_make  # noqa: E402
from sfvp_tpu.kernels.bvh_tlas import (  # noqa: E402
    make_two_level_occlusion as j_occlusion,
    make_two_level_trace as j_trace,
)
from sfvp_tpu.kernels.megakernel_bvh import (  # noqa: E402
    make_bvh_regen_render_step as j_k9,
)
from sfvp_tpu.scene import procedural as j_proc  # noqa: E402
from sfvp_tpu.scene.objload import Scene as JScene  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch.accel.instances import (  # noqa: E402
    Instance,
    flatten_instances,
    make_instanced_trace,
)
from sfvp_tpu_torch.dispatch import select_instanced_render_step  # noqa: E402
from sfvp_tpu_torch.kernels import build  # noqa: E402
from sfvp_tpu_torch.kernels.bvh_packet import (  # noqa: E402
    INSTANCE_CODE_BASE,
    DeviceWide,
    _leaf_tests,
    _node_children,
    ray_planes,
)
from sfvp_tpu_torch.kernels.bvh_tlas import (  # noqa: E402
    DeviceTwoLevel,
    _local_rays,
    device_two_level,
    make_two_level_occlusion,
    make_two_level_trace,
    two_level_occlusion,
    two_level_occlusion_plain,
    two_level_trace,
    two_level_trace_plain,
    world_vertices,
)
from sfvp_tpu_torch.kernels.intersect import trace_brute  # noqa: E402
from sfvp_tpu_torch.kernels.megakernel_bvh import (  # noqa: E402
    bvh_regen_render_plain,
    make_bvh_regen_render_step,
    tlas_regen_render,
)
from sfvp_tpu_torch.scene import procedural as t_proc  # noqa: E402
from sfvp_tpu_torch.scene.objload import Scene as TScene  # noqa: E402

from sfvp_tpu_torch.utils.vec import f32  # noqa: E402

from test_torch_integrator import assert_close  # noqa: E402

T_MIN = 1e-3
SAME_TRI = 0.999
H, W = 8, 16
NEE = dict(sampling="cosine", use_nee=True, use_rr=True, rr_start_depth=1,
           sky_emission=(0.05, 0.05, 0.05))


def _mesh(scene_cls, n, seed):
    """tests/test_tlas.py's random mesh, in either package's Scene."""
    g = np.random.default_rng(seed)
    v = (g.uniform(-0.5, 0.5, (n, 1, 3))
         + g.normal(0, 0.15, (n, 3, 3))).astype(np.float32)
    kd = g.uniform(0, 1, (n, 3)).astype(np.float32)
    return scene_cls(vertices=v.reshape(-1, 3),
                     indices=np.arange(3 * n, dtype=np.uint32),
                     face_diffuse=kd,
                     face_emission=np.zeros((n, 3), np.float32),
                     face_specular=np.zeros_like(kd),
                     face_mat_type=np.zeros(n, np.int32))


def _rot(axis, deg):
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def random_instances(inst_cls, n_inst, mesh_a, mesh_b):
    """tests/test_tlas.py's instances: y and x tilts, scales, shifts."""
    g = np.random.default_rng(42)
    out = []
    for i in range(n_inst):
        rot = _rot("y", float(g.uniform(0, 360))) @ _rot(
            "x", float(g.uniform(-40, 40)))
        scale = float(g.uniform(0.6, 1.6))
        tr = g.uniform(-4, 4, 3).astype(np.float32)
        out.append(inst_cls(scene=mesh_a if i % 2 == 0 else mesh_b,
                            transform=np.hstack([(rot * scale).astype(
                                np.float32), tr[:, None]])))
    return out


def stress_instances(inst_cls, n_inst, mesh_a, mesh_b):
    """Small instances of two meshes, randomly turned, scaled 0.15-0.6 and
    packed into [-1.5, 1.5]^3, so that their boxes overlap: walks there
    enter one instance after another at every depth of the stack."""
    g = np.random.default_rng(7)
    out = []
    for i in range(n_inst):
        rot = _rot("y", float(g.uniform(0, 360))) @ _rot(
            "x", float(g.uniform(-40, 40)))
        scale = float(g.uniform(0.15, 0.6))
        tr = g.uniform(-1.5, 1.5, 3).astype(np.float32)
        out.append(inst_cls(scene=mesh_a if i % 2 == 0 else mesh_b,
                            transform=np.hstack([(rot * scale).astype(
                                np.float32), tr[:, None]])))
    return out


def lamp(scene_cls):
    """The lamp of tests/test_tlas.py:131-143: two triangles at y = 4,
    emission 9."""
    return scene_cls(
        vertices=np.asarray([
            [-1.2, 4.0, -1.2], [1.2, 4.0, -1.2], [1.2, 4.0, 1.2],
            [-1.2, 4.0, -1.2], [1.2, 4.0, 1.2], [-1.2, 4.0, 1.2],
        ], np.float32),
        indices=np.arange(6, dtype=np.uint32),
        face_diffuse=np.zeros((2, 3), np.float32),
        face_emission=np.full((2, 3), 9.0, np.float32))


def both_scenes(name):
    """(JAX instances, port instances) of a test scene: the field of
    ``--scene instanced`` at 300 triangles, 4 instances; tests/test_tlas.py's
    17 random instances of two meshes; the field, or 4 instances of one
    mesh, with the lamp instance; the stress field: 60 small overlapping
    instances of two meshes and the lamp."""
    out = []
    for scene_cls, inst_cls, proc in ((JScene, JInstance, j_proc),
                                      (TScene, Instance, t_proc)):
        if name in ("field", "field_lit"):
            insts = proc.instanced_field(n_tris=300, n_inst=4)
        elif name == "random17":
            insts = random_instances(inst_cls, 17, _mesh(scene_cls, 30, 1),
                                     _mesh(scene_cls, 22, 2))
        elif name == "stress":
            insts = stress_instances(inst_cls, 60, _mesh(scene_cls, 30, 1),
                                     _mesh(scene_cls, 22, 2)) + [
                inst_cls(scene=lamp(scene_cls))]
        else:
            mesh = _mesh(scene_cls, 30, 1)
            insts = random_instances(inst_cls, 4, mesh, mesh)
        if name.endswith("_lit"):
            insts = insts + [inst_cls(scene=lamp(scene_cls))]
        out.append(insts)
    return out


_CACHE = {}


def scene(name):
    """JAX instances, JAX two-level BVH and flattened buffers; the port's
    flattened buffers and the JAX tree on the CPU (device_two_level)."""
    if name not in _CACHE:
        j_insts, t_insts = both_scenes(name)
        jtl = j_build(j_insts)
        jflat = J.upload(j_flatten(j_insts))
        tflat = T.upload(flatten_instances(t_insts), device="cpu")
        _CACHE[name] = dict(j_insts=j_insts, t_insts=t_insts, jtl=jtl,
                            jflat=jflat, tflat=tflat,
                            dt=device_two_level(jtl, "cpu"))
    return _CACHE[name]


def _rays(m, seed):
    """Rays from the box [-6, 6]^3 toward points of [-3, 3]^3, where the
    instances are, so that most of them hit."""
    g = np.random.default_rng(seed)
    o = g.uniform(-6, 6, (m, 3)).astype(np.float32)
    d = (g.uniform(-3, 3, (m, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _cols(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                 for i in range(3))


def _jcols(a):
    return tuple(jnp.asarray(np.ascontiguousarray(a[:, i])) for i in range(3))


def _jax_payload(pay):
    return np.stack([np.asarray(x) for x in (
        pay.t, pay.u, pay.v, *pay.p0, *pay.p1, *pay.p2, *pay.albedo,
        *pay.emission, pay.mtype)])


def same_triangle(a, b):
    """Rays whose two (19, N) payloads name the same triangle (or both
    miss): material planes equal, world vertices to 1e-6 relative."""
    miss_a, miss_b = np.isinf(a[0]), np.isinf(b[0])
    verts = np.isclose(a[3:12], b[3:12], rtol=1e-6, atol=1e-6).all(0)
    mats = (a[12:] == b[12:]).all(0)
    return (miss_a & miss_b) | (~miss_a & ~miss_b & verts & mats)


@pytest.mark.parametrize("name", ["field", "random17"])
def test_k7_twin_matches_jax_k7(name):
    s = scene(name)
    o, d = _rays(1024, seed=6)
    want = _jax_payload(j_trace(s["jtl"], t_min=T_MIN, interpret=True)(
        _jcols(o), _jcols(d), 1e4))
    pay = make_two_level_trace(s["dt"], T_MIN)(_cols(o), _cols(d), 1e4)
    got = torch.stack([pay.t, pay.u, pay.v, *pay.p0, *pay.p1, *pay.p2,
                       *pay.albedo, *pay.emission, pay.mtype]).numpy()
    same = same_triangle(got, want)
    assert same.mean() >= SAME_TRI, f"same triangle on {same.mean():.4%}"
    hit = same & np.isfinite(want[0])
    assert hit.sum() > 100
    np.testing.assert_array_equal(got[12:, hit], want[12:, hit])
    np.testing.assert_allclose(got[0, hit], want[0, hit], rtol=1e-5)
    np.testing.assert_allclose(got[1:3, hit], want[1:3, hit], rtol=0,
                               atol=1e-4)
    miss = np.isinf(got[0])
    assert (got[1:, miss] == 0).all()


@pytest.mark.parametrize("name", ["field_lit", "random17"])
def test_k7_twin_matches_flattened_brute_and_unrolled_trace(name):
    """t in world measure against brute force over the flattened scene
    (and the host-unrolled instanced trace, a third oracle); the hit
    triangle's albedo is the flattened triangle's."""
    s = scene(name)
    tflat = s["tflat"]
    o, d = _rays(2048, seed=11)
    got = two_level_trace_plain(s["dt"], T_MIN,
                                ray_planes(_cols(o), _cols(d), 1e4)).numpy()
    for ref in (trace_brute(_cols(o), _cols(d), tflat, T_MIN, 1e4),
                make_instanced_trace(s["t_insts"], device="cpu")(
                    _cols(o), _cols(d), tflat, T_MIN, 1e4)):
        rt = np.where(ref.prim.numpy() >= 0, ref.t.numpy(), np.inf)
        np.testing.assert_allclose(got[0], rt, rtol=2e-4, atol=2e-5)
        hit = np.isfinite(rt)
        assert hit.sum() > 200
        kd = torch.stack([tflat.dr, tflat.dg, tflat.db], 1)[
            ref.prim.clamp_min(0)].numpy()
        assert (got[12:15, hit].T == kd[hit]).all(1).mean() >= SAME_TRI
        # the world vertices reconstruct the hit point
        w = 1.0 - got[1] - got[2]
        px = got[3] * w + got[6] * got[1] + got[9] * got[2]
        np.testing.assert_allclose(px[hit], (o[:, 0] + rt * d[:, 0])[hit],
                                   rtol=1e-3, atol=2e-3)


def _shadow_rays(m, seed):
    o, d = _rays(m, seed)
    g = np.random.default_rng(seed + 100)
    tmax = g.uniform(0, 12, m).astype(np.float32)
    tmax[: m // 10] = g.uniform(-1, T_MIN, m // 10)
    return o, d, tmax, g.uniform(size=m) > 0.2


@pytest.mark.parametrize("name", ["field_lit", "random17"])
def test_k8_twin_matches_jax_k8_and_k7_twin(name):
    """On every ray: K8's twin, sfvp_tpu's K8 (interpret mode), and K7's
    twin's closest t below t_max."""
    s = scene(name)
    o, d, tmax, active = _shadow_rays(1024, seed=21)
    want = np.asarray(j_occlusion(s["jtl"], t_min=T_MIN, interpret=True)(
        _jcols(o), _jcols(d), jnp.asarray(tmax), active=jnp.asarray(active)))
    act = torch.from_numpy(active)
    got = make_two_level_occlusion(s["dt"], T_MIN)(
        _cols(o), _cols(d), torch.from_numpy(tmax), active=act).numpy()
    np.testing.assert_array_equal(got, want)
    assert 20 < got.sum() < act.sum() - 20
    closest = two_level_trace_plain(s["dt"], T_MIN, ray_planes(
        _cols(o), _cols(d), torch.from_numpy(tmax), act))[0]
    np.testing.assert_array_equal(got, torch.isfinite(closest).numpy())


def test_k8_twin_retires_rays_on_their_first_hit():
    """An any-hit walk to t_max never pops more leaves than the closest-hit
    walk of the same rays; an inactive wave pops nothing; both count their
    instance pops."""
    dt = scene("random17")["dt"]
    o, d = _rays(1024, seed=22)
    rays = ray_planes(_cols(o), _cols(d), 1e4)
    any_hit, closest = {}, {}
    occ = two_level_occlusion_plain(dt, T_MIN, rays, any_hit)
    pay = two_level_trace_plain(dt, T_MIN, rays, closest)
    assert torch.equal(occ, torch.isfinite(pay[0]))
    assert any_hit["leaf_pops"] < closest["leaf_pops"]
    assert 0 < any_hit["inst_pops"] <= closest["inst_pops"]
    none = {}
    dead = ray_planes(_cols(o), _cols(d), 1e4,
                      active=torch.zeros(1024, dtype=torch.bool))
    assert not two_level_occlusion_plain(dt, T_MIN, dead, none).any()
    assert none.get("node_pops", 0) == 0


def _walk_ray(dt, rays, i, one_stack, pops):
    """One ray's closest-hit walk, scalar, with the twin's box and
    triangle tests (kernels/bvh_tlas.py, kernels/bvh_packet.py) on that
    ray alone; returns (t, u, v, row, slot, inst) and appends (code,
    context) of every node and leaf pop to ``pops``.

    ``one_stack``: the walk of csrc/two_level.cuh two_level_closest_hit.
    One stack of codes and two registers, ``base`` and ``inst``: the
    entries at or above ``base`` lie in instance ``inst``'s object space,
    those below it in world space. A TLAS has one instance level, so when
    an instance is popped at index k every entry below k is a world entry,
    and the walk sets base = k; a pop below ``base`` is a world entry and
    sets base to none, since every entry of the instance is gone by then
    and world children may be pushed again at or above the old base. The
    instance pop expands its BLAS root (an internal node) in the same
    trip, the root being the next pop anyway.

    Otherwise the parent's walk, the two-stack replay: a context stack
    beside the code stack, and an instance pop that only pushes its BLAS
    root under its context."""
    none = 1 << 30
    stack, ctxs = [1], [-1]
    base, inst = none, -1
    t_min = f32(T_MIN)
    best = torch.tensor([float("inf")])
    hit = (float("inf"), 0.0, 0.0, -1, -1, -1)
    idx = torch.tensor([i])
    while stack:
        k = len(stack) - 1
        code = stack.pop()
        if one_stack:
            ctx = inst
            if k < base:
                ctx, base = -1, none
        else:
            ctx = ctxs.pop()
        if code < 0 and -code - 1 >= INSTANCE_CODE_BASE:
            iid = -code - 1 - INSTANCE_CODE_BASE
            root = int(dt.inst[iid, 24]) + 1
            assert root > 0, "a BLAS root is an internal node"
            if not one_stack:
                stack.append(root)
                ctxs.append(iid)
                continue
            inst, base, ctx, code = iid, k, iid, root
        pops.append((code, ctx))
        ray = _local_rays(dt, rays, idx, torch.tensor([ctx]), t_min)
        if code < 0:
            slot, t, u, v = _leaf_tests(dt.tris, torch.tensor([-code - 1]),
                                        ray, best)
            if bool(t < best):
                hit = (float(t), float(u), float(v), -code - 1, int(slot),
                       ctx)
                best = t
        else:
            for c in _node_children(dt.nodes, torch.tensor([code - 1]), ray,
                                    best, t_min)[0].tolist():
                if c:
                    stack.append(c)
                    ctxs.append(ctx)
    return hit


@pytest.mark.parametrize("name", ["field", "field_lit", "random17",
                                  "random5", "random5_lit", "stress"])
def test_one_stack_walk_matches_twin_and_two_stack_contexts(name):
    """The kernels' one-stack walk, traced ray by ray on a few hundred
    rays: its hits give the twin's payload bit for bit, and at every node
    and leaf pop it has the code and the context of the parent's
    two-stack walk (whose instance pops it folds into the BLAS root's)."""
    dt = scene(name)["dt"]
    o, d = _rays(2048, seed=31)
    rays = ray_planes(_cols(o), _cols(d), 1e4)
    # up to 150 rays that hit and 50 that miss
    t = two_level_trace_plain(dt, T_MIN, rays)[0]
    hit = torch.nonzero(torch.isfinite(t))[:150, 0]
    rays = rays[:, torch.cat([hit, torch.nonzero(torch.isinf(t))[:50, 0]])]
    want = two_level_trace_plain(dt, T_MIN, rays)
    hits, n_pops, in_inst = [], 0, 0
    for i in range(rays.shape[1]):
        one, two = [], []
        hits.append(_walk_ray(dt, rays, i, True, one))
        _walk_ray(dt, rays, i, False, two)
        assert one == two, f"ray {i}: pops and contexts differ"
        n_pops += len(one)
        in_inst += sum(ctx >= 0 for _, ctx in one)
    t, u, v, row, slot, inst = (torch.tensor(c) for c in zip(*hits))
    got = torch.zeros_like(want)
    got[0], got[1], got[2] = t, u, v
    ok = row >= 0
    lanes = 16 * slot[ok][:, None] + torch.arange(16)
    slots = torch.gather(dt.tris[row[ok]], 1, lanes)
    got[3:12, ok] = world_vertices(dt, slots[:, :9], inst[ok]).T
    got[12:, ok] = slots[:, 9:].T
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert ok.sum() == hit.numel() >= 30 and 0 < in_inst < n_pops


VIEW = dict(origin=(0.0, 2.0, 9.0), target=(0.0, 0.0, 0.0), fov_y_deg=50.0)
FIELD_VIEW = dict(origin=(6.0, 5.0, 6.0), target=(0.0, 0.6, 0.0),
                  fov_y_deg=50.0)


def configs(kw, view):
    """The same RenderConfig in both packages (the JAX side with the small
    packets of tests/test_tlas.py)."""
    kw = dict(dict(width=W, height=H, spp_per_step=2, max_depth=3,
                   sampling="cosine", sky_emission=(0.8, 0.85, 1.0)), **kw)
    return (J.RenderConfig(camera=J.CameraConfig.look_at(**view),
                           packet_tile_size=8, **kw),
            T.RenderConfig(camera=T.CameraConfig.look_at(**view), **kw))


def _run(step):
    return step(T.init_state(H, W, "cpu"))


K9_CASES = {
    "field-cosine": ("field", {}, FIELD_VIEW),
    "random5-cosine": ("random5", {}, VIEW),
    "lit-nee": ("random5_lit", dict(NEE, use_mis=False), VIEW),
    "lit-mis": ("random5_lit", dict(NEE, use_mis=True), VIEW),
}


@pytest.mark.parametrize("case", sorted(K9_CASES))
def test_k9_twin_matches_jax_k9(case):
    """The fused two-level kernel: K9's twin against sfvp_tpu's
    make_bvh_regen_render_step(cfg, flat, tl=tl, interpret=True), the cases
    of tests/test_tlas.py:276-358."""
    name, kw, view = K9_CASES[case]
    s = scene(name)
    jcfg, tcfg = configs(kw, view)
    want = jax.jit(j_k9(jcfg, s["jflat"], tl=s["jtl"], interpret=True))(
        J.init_state(H, W))
    got = _run(make_bvh_regen_render_step(tcfg, s["tflat"], tl=s["dt"]))
    assert_close(got.accum.numpy(), np.asarray(want.accum),
                 f"K9 twin vs jax K9 ({case})")
    assert float(got.mrays) == float(want.mrays), "traced segments differ"
    assert float(got.accum.max()) > 0


@pytest.mark.parametrize("case", ["random5-cosine", "lit-mis"])
def test_wavefront_route_matches_jax(case):
    """The port's wavefront loop over K7's twin (and K8's under NEE)
    against sfvp_tpu's make_render_step(trace_payload_fn=...,
    occlusion_fn=...) over its interpret-mode K7 and K8; and the fused
    twin against the wavefront loop, the port's form of
    test_fused_two_level_regen_matches_wavefront."""
    name, kw, view = K9_CASES[case]
    s = scene(name)
    jcfg, tcfg = configs(dict(kw, megakernel_regen=False), view)
    want = jax.jit(j_make(
        jcfg, s["jflat"],
        trace_payload_fn=j_trace(s["jtl"], t_min=jcfg.t_min, interpret=True),
        occlusion_fn=(j_occlusion(s["jtl"], t_min=jcfg.t_min, interpret=True)
                      if jcfg.use_nee else None)))(J.init_state(H, W))
    got = _run(select_instanced_render_step(tcfg, s["tflat"], s["jtl"]))
    assert_close(got.accum.numpy(), np.asarray(want.accum),
                 f"wavefront over K7 twin vs jax ({case})")
    assert float(got.mrays) == float(want.mrays)
    fused = _run(make_bvh_regen_render_step(
        dataclasses.replace(tcfg, megakernel_regen=True), s["tflat"],
        tl=s["dt"]))
    assert_close(fused.accum.numpy(), got.accum.numpy(),
                 f"K9 twin vs the wavefront loop ({case})")
    assert float(fused.mrays) == float(got.mrays)


def test_k9_twin_near_k5_twin_on_the_flattened_scene():
    """Two-level and flattened traces differ by object-space rounding, so
    K9 on the instances and K5 on flatten_instances agree by image
    statistics, not bitwise."""
    from sfvp_tpu_torch.accel.wide import build_wide_from_buffers
    from sfvp_tpu_torch.kernels.bvh_packet import device_wide

    s = scene("field")
    _, cfg = configs(dict(spp_per_step=4), FIELD_VIEW)
    k9 = _run(make_bvh_regen_render_step(cfg, s["tflat"], tl=s["dt"])).accum
    k5 = _run(make_bvh_regen_render_step(
        dataclasses.replace(cfg, traversal="bvh"), s["tflat"],
        device_wide(build_wide_from_buffers(s["tflat"]), "cpu"))).accum
    assert abs(float(k9.mean()) / float(k5.mean()) - 1.0) < 1e-3
    assert float(((k9 - k5).abs().amax(-1) > 1e-3).float().mean()) < 0.01


def test_cpu_wrappers_run_twins_and_count_no_launch():
    s = scene("random5_lit")
    dt = s["dt"]
    o, d, tmax, active = _shadow_rays(256, seed=23)
    rays = ray_planes(_cols(o), _cols(d), torch.from_numpy(tmax),
                      torch.from_numpy(active))
    before = (two_level_trace.launches, two_level_occlusion.launches,
              tlas_regen_render.launches)
    assert torch.equal(two_level_trace(dt, T_MIN, rays),
                       two_level_trace_plain(dt, T_MIN, rays))
    assert torch.equal(two_level_occlusion(dt, T_MIN, rays),
                       two_level_occlusion_plain(dt, T_MIN, rays))
    _, cfg = configs({}, VIEW)
    kw = dict(cfg=cfg, global_shape=(H, W), npix=H * W, has_mirrors=False)
    a = tlas_regen_render(dt, 2, 0, **kw)
    b = bvh_regen_render_plain(dt, 2, 0, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (two_level_trace.launches, two_level_occlusion.launches,
            tlas_regen_render.launches) == before


def test_wrappers_refuse_what_the_kernels_cannot_take():
    """A tensor not on the CPU never reaches a twin; a CPU-less meta tree
    raises before a launch, as do a stack past the kernels' and textured
    BLASes (ROADMAP.md A.13)."""

    def meta(max_stack=130, n_inst=3):
        return DeviceTwoLevel(
            nodes=torch.empty((4, 128), device="meta"),
            tris=torch.empty((4, 128), device="meta"),
            inst=torch.empty((n_inst, 128), device="meta"),
            max_stack=max_stack, num_instances=3)

    rays = torch.empty((7, 16), device="meta")
    for fn in (two_level_trace, two_level_occlusion):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(meta(), T_MIN, rays)
        with pytest.raises(ValueError, match="max_stack"):
            fn(meta(max_stack=10_000), T_MIN, rays)
        with pytest.raises(ValueError, match="7, N"):
            fn(meta(), T_MIN, torch.empty((6, 16), device="meta"))
    _, cfg = configs({}, VIEW)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tlas_regen_render(meta(), 0, 0, cfg=cfg, global_shape=(H, W),
                          npix=H * W, has_mirrors=False)
    tl = scene("random5")["jtl"]
    with pytest.raises(NotImplementedError, match="A.13"):
        device_two_level(tl._replace(tris_aux=np.zeros_like(tl.tris)), "cpu")
    with pytest.raises(ValueError, match="rows"):
        build.two_level_params(meta(n_inst=2), T_MIN)


class _FakeCudaTable:
    """What build._check_tables reads of a (rows, 128) float32 table on a
    CUDA device, starting at ``ptr``: a stand-in for one without a card."""

    def __init__(self, rows, ptr):
        self.shape, self.ptr = (rows, 128), ptr
        self.device, self.dtype = torch.device("cuda"), torch.float32

    def dim(self):
        return 2

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.ptr


@pytest.mark.parametrize("table", ["nodes", "tris", "inst"])
def test_two_level_params_refuses_unaligned_tables(table):
    """The closest-hit walk reads node and leaf rows by 16-byte loads
    (csrc/two_level.cuh), so two_level_params refuses a table that does
    not start on a 16-byte boundary, and takes aligned ones."""
    ptrs = dict(nodes=0x10000, tris=0x20000, inst=0x30000)

    def tree(**shift):
        return DeviceTwoLevel(**{
            k: _FakeCudaTable(4, p + shift.get(k, 0)) for k, p in ptrs.items()},
            max_stack=40, num_instances=4)

    tp = build.two_level_params(tree(), T_MIN)
    assert (tp.nodes, tp.tris, tp.inst) == tuple(ptrs.values())
    for off in (4, 8, 12):
        with pytest.raises(ValueError, match=f"{table} must start on a "
                                             "16-byte boundary"):
            build.two_level_params(tree(**{table: off}), T_MIN)


@pytest.mark.parametrize("table", ["nodes", "tris", "tris_aux"])
def test_wide_params_refuses_unaligned_tables(table):
    """The single-level walks read node rows and leaf slots by 16-byte
    loads (csrc/wide_bvh.cuh), so wide_params refuses a table that does
    not start on a 16-byte boundary, and takes aligned ones."""
    ptrs = dict(nodes=0x10000, tris=0x20000, tris_aux=0x30000)

    def tree(**shift):
        return DeviceWide(**{k: _FakeCudaTable(4, p + shift.get(k, 0))
                             for k, p in ptrs.items()}, max_stack=40)

    wp = build.wide_params(tree(), T_MIN)
    assert (wp.nodes, wp.tris, wp.aux) == tuple(ptrs.values())
    for off in (4, 8, 12):
        with pytest.raises(ValueError, match=f"{table} must start on a "
                                             "16-byte boundary"):
            build.wide_params(tree(**{table: off}), T_MIN)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["field_lit", "random17", "stress"])
def test_cuda_k7_k8_match_twins(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    s = scene(name)
    o, d, tmax, active = _shadow_rays(8192, seed=24)
    rays = ray_planes(_cols(o), _cols(d), torch.from_numpy(tmax),
                      torch.from_numpy(active))
    gpu = device_two_level(s["jtl"], "cuda")
    got = two_level_trace(gpu, T_MIN, rays.cuda()).cpu().numpy()
    want = two_level_trace_plain(s["dt"], T_MIN, rays).numpy()
    assert same_triangle(got, want).mean() >= 0.9999
    assert torch.equal(two_level_occlusion(gpu, T_MIN, rays.cuda()).cpu(),
                       two_level_occlusion_plain(s["dt"], T_MIN, rays))
    # K8 on a wave whose rays are mostly inactive
    idle = ray_planes(_cols(o), _cols(d), torch.from_numpy(tmax),
                      torch.from_numpy(active) & (torch.arange(8192) % 8 == 0))
    assert torch.equal(two_level_occlusion(gpu, T_MIN, idle.cuda()).cpu(),
                       two_level_occlusion_plain(s["dt"], T_MIN, idle))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["field-cosine", "lit-mis", "stress-mis"])
def test_cuda_k9_matches_twin(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    name, kw, view = dict(
        K9_CASES, **{"stress-mis": ("stress", dict(NEE, use_mis=True),
                                    VIEW)})[case]
    s = scene(name)
    _, cfg = configs(dict(kw, width=64, height=48, max_depth=8), view)
    gpu_flat = T.upload(flatten_instances(s["t_insts"]), device="cuda")
    cpu = make_bvh_regen_render_step(cfg, s["tflat"], tl=s["dt"])(
        T.init_state(48, 64, "cpu"))
    gpu = make_bvh_regen_render_step(
        cfg, gpu_flat, tl=device_two_level(s["jtl"], "cuda"))(
        T.init_state(48, 64, "cuda"))
    assert_close(gpu.accum.cpu().numpy(), cpu.accum.numpy(),
                 f"K9 CUDA vs twin ({case})", rel=1e-5, max_abs=1e-4)


@pytest.mark.parametrize("fused", [True, False], ids=["k9", "k7_k8"])
@pytest.mark.parametrize("image", ["env", "texture"])
def test_instanced_env_or_textures_raise_naming_a13b(image, fused, tmp_path):
    """Environment maps and map_Kd textures on an instanced scene: its
    routes, K9 and the wavefront loop over K7 + K8, refuse them, naming
    ROADMAP.md A.13b, before anything is traced."""
    from sfvp_tpu.render.png import encode_png

    png = tmp_path / "img.png"
    png.write_bytes(encode_png(np.full((4, 8, 3), 128, np.uint8)))
    mesh = _mesh(TScene, 6, seed=1)
    if image == "env":
        mesh = dataclasses.replace(mesh, env_map=str(png))
    else:
        mesh = dataclasses.replace(
            mesh, face_uv=np.zeros((6, 3, 2), np.float32),
            face_tex=np.zeros(6, np.int32), texture_paths=[str(png)])
    insts = random_instances(Instance, 3, mesh, mesh)
    flat = T.upload(flatten_instances(insts), device="cpu")
    assert (flat.env is not None) == (image == "env")
    assert flat.has_textures == (image == "texture")
    cfg = T.RenderConfig(width=8, height=8, spp_per_step=1, max_depth=2,
                         use_nee=True, megakernel_regen=fused)
    # the refusal comes before the two-level tree is read
    with pytest.raises(NotImplementedError, match="A.13b"):
        select_instanced_render_step(cfg, flat, None)

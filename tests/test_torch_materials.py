"""GGX glossy and smooth dielectric materials in the port against sfvp_tpu:
the microfacet and Fresnel functions on seeded inputs, the cases of
tests/test_ggx.py and tests/test_dielectric.py run on the port, images of
the port's eager loop against sfvp_tpu's jnp integrator, the fused
kernels' twins (K1, K5, K9) against the eager loop, the wavefront loop
over the payload trace (the packed material lane), and the routes.

Tolerances: the functions within 1e-6 relative (torch-CPU and XLA-CPU
round sqrt, rsqrt, sin and cos apart by an ulp or two), 1e-5 on the 0.1%
of VNDF samples by the rim of its disk, where the warp amplifies such an
ulp; images within
relative RMSE 1e-5 with fewer than 0.1% of pixels apart by more than
1e-4, traced segments equal (a glass path may part at a refraction
threshold after such an ulp, hence the pixel share); estimator checks
(furnace, NEE against BSDF sampling) at sfvp_tpu's own bounds.

The ``cuda`` tests hold the kernels against their twins and skip without a
card; chip_smoke.py runs the same comparisons on the H100.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu import sampling as j_sampling  # noqa: E402
from sfvp_tpu.integrate.wavefront import make_render_step as j_make  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch import sampling as t_sampling  # noqa: E402
from sfvp_tpu_torch.accel.instances import Instance  # noqa: E402
from sfvp_tpu_torch.accel.wide import build_wide_from_buffers  # noqa: E402
from sfvp_tpu_torch.dispatch import select_render_step  # noqa: E402
from sfvp_tpu_torch.integrate.wavefront import (  # noqa: E402
    make_render_step, material_flags)
from sfvp_tpu_torch.kernels.bvh_packet import (  # noqa: E402
    device_wide, make_packet_trace)
from sfvp_tpu_torch.kernels.megakernel_bvh import (  # noqa: E402
    make_bvh_regen_render_step)
from sfvp_tpu_torch.kernels.megakernel_regen import (  # noqa: E402
    make_regen_render_step)
from sfvp_tpu_torch.scene.buffers import FIELDS, from_numpy  # noqa: E402
from sfvp_tpu_torch.scene.objload import Scene  # noqa: E402

IOR_GLASS = 1.5
ENC_GLASS = (IOR_GLASS - 1.0) / 4.0  # the rough column's encoding
WALL = [
    [[-100.0, -100, 0], [100, -100, 0], [100, 100, 0]],
    [[-100.0, -100, 0], [100, 100, 0], [-100, 100, 0]],
]
# Cornell Box materials: a GGX floor, a glass short box, a mirror tall box
MATERIALS = {
    "floor": "Kd 0 0 0\nKs 0.8 0.75 0.7\nPr 0.25\n",
    "shortBox": "Kd 0 0 0\nKs 0 0 0\nNi 1.5\nillum 7\n",
    "tallBox": "Kd 0 0 0\nKs 0.9 0.9 0.9\nillum 3\n",
}


# ---- scenes ----

def rel_rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()) / np.sqrt((b ** 2).mean()))


def assert_image(got, exp, what, rel=1e-5):
    r = rel_rmse(got, exp)
    off = float((np.abs(got - exp) > 1e-4).any(-1).mean())
    assert r <= rel and off < 1e-3, (
        f"{what}: relative RMSE {r:.3g} (bound {rel}), {off:.3%} of pixels "
        "apart by more than 1e-4 (bound 0.1%)")
    assert float(exp.max()) > 0


def material_cornell(tmp_path, materials=MATERIALS):
    """The Cornell Box with the materials of ``materials`` (name -> MTL
    lines replacing that material's), written beside a copy of its OBJ."""
    src = T.cornell_box_path()
    mtl = open(src[:-4] + ".mtl").read()
    out = []
    for block in mtl.split("newmtl ")[1:]:
        name = block.split("\n", 1)[0].strip()
        body = materials.get(name, block.split("\n", 1)[1])
        out.append(f"newmtl {name}\n{body}\n")
    (tmp_path / "CornellBox-Original.mtl").write_text("".join(out))
    obj = tmp_path / "CornellBox-Original.obj"
    obj.write_text(open(src).read())
    return str(obj)


def scene_of(tris, specular, mat_type, rough, emission=0.0):
    tris = np.asarray(tris, np.float32)
    t = len(tris)

    def full(x, shape):
        return np.broadcast_to(np.asarray(x, np.float32), shape).copy()

    return dict(
        vertices=tris.reshape(-1, 3),
        indices=np.arange(3 * t, dtype=np.uint32),
        face_diffuse=np.zeros((t, 3), np.float32),
        face_emission=full(emission, (t, 3)),
        face_specular=full(specular, (t, 3)),
        face_mat_type=np.asarray(mat_type, np.int32),
        face_rough=full(rough, (t,)),
    )


def both(jb):
    """The port's CPU buffers of sfvp_tpu buffers ``jb``."""
    return from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS},
                      jb.num_tris, "cpu")


def cornell_pair(tmp_path):
    jb = J.upload(J.load_obj(material_cornell(tmp_path), native="never"))
    return jb, both(jb)


def port_render(cfg, tb, steps=1):
    step = make_render_step(cfg, tb)
    st = T.init_state(cfg.height, cfg.width, "cpu")
    for _ in range(steps):
        st = step(st)
    return st.accum.numpy()


def port_scene(**kw):
    return T.upload(Scene(**kw), device="cpu")


# ---- the functions against sfvp_tpu's ----

def _inputs(n=4096, seed=11):
    g = np.random.default_rng(seed)
    r1, r2 = g.random(n, np.float32), g.random(n, np.float32)
    th = g.uniform(0.0, 1.5, n).astype(np.float32)
    ph = g.uniform(0.0, 6.28, n).astype(np.float32)
    wo = (np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th))
    alpha = g.uniform(1e-2, 1.0, n).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    nrm = g.normal(size=(3, n)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0)
    ior = g.uniform(1.05, 2.4, n).astype(np.float32)
    return dict(r1=r1, r2=r2, cos=np.cos(th), wo=tuple(map(np.float32, wo)),
                alpha=alpha, d=tuple(d), n=tuple(nrm), ior=ior)


def _call(mod, name, x):
    arr = jnp.asarray if mod is j_sampling else torch.from_numpy
    a = {k: (tuple(arr(np.ascontiguousarray(c)) for c in v)
             if isinstance(v, tuple) else arr(v)) for k, v in x.items()}
    f = getattr(mod, name)
    if name == "ggx_lambda":
        out = f(a["cos"], a["alpha"])
    elif name == "ggx_d":
        out = f(a["cos"], a["alpha"])
    elif name == "ggx_sample_vndf_local":
        out = f(a["r1"], a["r2"], a["wo"], a["alpha"])
    elif name == "ggx_vndf_pdf":
        out = f(a["cos"], a["r1"], a["alpha"])
    else:
        out = f(a["d"], a["n"], a["ior"])
    flat = []
    for o in (out if isinstance(out, tuple) else (out,)):
        flat += list(o) if isinstance(o, tuple) else [o]
    return [np.asarray(o) for o in flat]


@pytest.mark.parametrize("name", [
    "ggx_lambda", "ggx_d", "ggx_sample_vndf_local", "ggx_vndf_pdf",
    "dielectric_reflect_refract_soa"])
def test_torch_material_functions_match_jax(name):
    x = _inputs()
    want = _call(j_sampling, name, x)
    got = _call(t_sampling, name, x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.dtype == bool or g.dtype == bool:
            assert np.array_equal(g, w)
            continue
        err = (np.abs(g.astype(np.float64) - w)
               / np.maximum(np.abs(w.astype(np.float64)), 1.0))
        # near the disk's rim (r1 -> 1) the VNDF's p3 = sqrt(1 - p1^2 -
        # p2^2) multiplies an ulp of cos or sin by ~1/p3: there, and only
        # there, 1e-5
        assert float(np.quantile(err, 0.999)) <= 1e-6, name
        assert float(err.max()) <= 1e-5, name


# ---- tests/test_ggx.py on the port ----

def test_torch_mtl_pr_and_illum7_parse():
    """Pr with a nonzero Ks is GGX (roughness in the rough column), illum
    7 with Ni > 1 glass (the IOR encoded, a zero Ks made white), illum 3 a
    mirror; the C++ loader and the Python parser agree."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        p = material_cornell(Path(d))
        for native in ("never", "auto"):
            s = T.load_obj(p, native=native)
            names = [s.material_names[i] for i in s.face_material_id]
            mt = dict(zip(names, s.face_mat_type.tolist()))
            rough = dict(zip(names, s.face_rough.tolist()))
            spec = dict(zip(names, s.face_specular.tolist()))
            assert (mt["floor"], mt["shortBox"], mt["tallBox"]) == (2, 3, 1)
            np.testing.assert_allclose(rough["floor"], 0.25, rtol=1e-6)
            np.testing.assert_allclose(rough["shortBox"], ENC_GLASS,
                                       rtol=1e-6)
            assert spec["shortBox"] == [1.0, 1.0, 1.0]


def _vndf_wo(n, c):
    return (torch.full((n,), c), torch.zeros(n),
            torch.full((n,), float(np.sqrt(1 - c * c))))


def test_torch_vndf_pdf_integrates_to_one():
    """E[f / pdf_h] over VNDF half-vectors equals the uniform-hemisphere
    estimate of the same integral (tests/test_ggx.py:71-108)."""
    g = np.random.default_rng(5)
    n = 200_000
    r1, r2 = (torch.from_numpy(g.uniform(size=n).astype(np.float32))
              for _ in range(2))
    alpha = torch.tensor(0.3)
    wo = _vndf_wo(n, 0.45)
    h = t_sampling.ggx_sample_vndf_local(r1, r2, wo, alpha)
    cos_oh = wo[0] * h[0] + wo[1] * h[1] + wo[2] * h[2]
    g1 = 1.0 / (1.0 + t_sampling.ggx_lambda(wo[2], alpha))
    pdf_h = (g1 * t_sampling.ggx_d(h[2], alpha)
             * torch.clamp_min(cos_oh, 0.0) / wo[2])
    f = torch.clamp_min(cos_oh, 0.0) ** 2
    est_vndf = float(torch.mean(f / torch.clamp_min(pdf_h, 1e-12)))
    u1 = g.uniform(size=n)
    u2 = g.uniform(size=n)
    s = np.sqrt(np.maximum(0.0, 1 - u1 * u1))
    phi = 2 * np.pi * u2
    cos_u = 0.45 * np.cos(phi) * s + float(wo[2][0]) * u1
    est_unif = float(np.mean(np.maximum(cos_u, 0.0) ** 2) * 2 * np.pi)
    assert abs(est_vndf - est_unif) / est_unif < 0.02, (est_vndf, est_unif)


def test_torch_reflected_pdf_jacobian():
    """ggx_vndf_pdf (of the reflected direction) = pdf_h / (4 cos_oh)."""
    g = np.random.default_rng(6)
    n = 1000
    r1, r2 = (torch.from_numpy(g.uniform(size=n).astype(np.float32))
              for _ in range(2))
    alpha = torch.tensor(0.45)
    wo = (torch.full((n,), 0.6), torch.zeros(n), torch.full((n,), 0.8))
    h = t_sampling.ggx_sample_vndf_local(r1, r2, wo, alpha)
    cos_oh = wo[0] * h[0] + wo[1] * h[1] + wo[2] * h[2]
    g1 = 1.0 / (1.0 + t_sampling.ggx_lambda(wo[2], alpha))
    pdf_h = (g1 * t_sampling.ggx_d(h[2], alpha)
             * torch.clamp_min(cos_oh, 0.0) / wo[2])
    pdf_wi = t_sampling.ggx_vndf_pdf(wo[2], h[2], alpha)
    np.testing.assert_allclose(pdf_wi.numpy(), (pdf_h / (4 * cos_oh)).numpy(),
                               rtol=1e-4)


def test_torch_rough_zero_limit_matches_mirror():
    """rough -> 0 GGX with F0 = Ks converges to the perfect mirror."""
    spec = [0.5, 0.25, 0.125]
    cfg = T.RenderConfig(width=8, height=8, spp_per_step=32, max_depth=3)
    a = port_render(cfg, port_scene(**scene_of(WALL, spec, [1, 1], 0.0)))
    b = port_render(cfg, port_scene(**scene_of(WALL, spec, [2, 2], 0.015)))
    np.testing.assert_allclose(b, a, rtol=0.05, atol=5e-3)


@pytest.mark.parametrize("rough", [0.1, 0.5, 0.9])
def test_torch_white_furnace_energy_bounded(rough):
    """F0 = 1 glossy wall under a unit-white sky: never above the sky,
    well above zero (single-scattering GGX loses a little energy)."""
    cfg = T.RenderConfig(width=8, height=8, spp_per_step=64, max_depth=4,
                         sky_emission=(1.0, 1.0, 1.0))
    img = port_render(cfg, port_scene(**scene_of(WALL, 1.0, [2, 2], rough)))
    assert img.max() <= 1.0 + 1e-4, img.max()
    # pixel (0, 0) repeats one sample (the reference's seed formula)
    assert img.reshape(-1, 3)[1:].min() >= 0.2


def _lit_glossy_floor(mat=2, rough=0.4, spec=0.9):
    big = 4.0
    tris = [
        [[-big, 0, -big], [big, 0, -big], [big, 0, big]],
        [[-big, 0, -big], [big, 0, big], [-big, 0, big]],
        [[-0.4, 2.0, -0.4], [0.4, 2.0, -0.4], [0.4, 2.0, 0.4]],
        [[-0.4, 2.0, -0.4], [0.4, 2.0, 0.4], [-0.4, 2.0, 0.4]],
    ]
    kw = scene_of(tris, [[spec] * 3] * 2 + [[0, 0, 0]] * 2,
                  [mat, mat, 0, 0], [rough, rough, 0, 0],
                  emission=[[0, 0, 0]] * 2 + [[8, 8, 8]] * 2)
    cam = dict(origin=(0.0, 1.4, 3.2), target=(0, 0, 0), fov_y_deg=45)
    return kw, cam


def test_torch_glossy_nee_matches_bsdf_only():
    """A glossy floor under an area light: NEE and NEE + MIS agree with
    BSDF sampling alone (the unbiasedness of the GGX eval)."""
    kw, cam = _lit_glossy_floor()
    base = T.RenderConfig(width=12, height=12, spp_per_step=256, max_depth=3,
                          camera=T.CameraConfig.look_at(**cam),
                          sampling="cosine", sky_emission=(0.0, 0.0, 0.0))
    tb = port_scene(**kw)
    mb = port_render(base, tb).mean()
    mn = port_render(dataclasses.replace(base, use_nee=True), tb).mean()
    mm = port_render(dataclasses.replace(base, use_nee=True, use_mis=True),
                     tb).mean()
    assert mb > 0
    assert abs(mn - mb) / mb < 0.15 and abs(mm - mb) / mb < 0.15, (mb, mn, mm)


# ---- tests/test_dielectric.py on the port ----

def _diel(d, n, ior):
    t = lambda v: tuple(torch.as_tensor(np.asarray(c, np.float32))  # noqa: E731
                        for c in v)
    return t_sampling.dielectric_reflect_refract_soa(t(d), t(n),
                                                     torch.tensor(ior))


def test_torch_fresnel_normal_incidence():
    refl, refr, f, tir = _diel(([0.0], [0.0], [-1.0]), ([0.0], [0.0], [1.0]),
                               1.5)
    np.testing.assert_allclose(f.numpy(), [0.04], rtol=1e-5)
    assert not bool(tir[0])
    np.testing.assert_allclose(refl[2].numpy(), [1.0], atol=1e-6)
    np.testing.assert_allclose(refr[2].numpy(), [-1.0], atol=1e-6)


def test_torch_snell_law_and_unit_norm():
    th = np.linspace(0.01, 1.55, 64).astype(np.float32)
    z, o = np.zeros(64), np.ones(64)
    d = (np.sin(th), z, -np.cos(th))
    _, refr, _, tir = _diel(d, (z, z, o), 1.5)
    np.testing.assert_allclose(refr[0].numpy(), np.sin(th) / 1.5, atol=1e-5)
    norm = np.sqrt(sum(c.numpy().astype(np.float64) ** 2 for c in refr))
    np.testing.assert_allclose(norm, 1.0, atol=1e-5)
    assert not tir.any()
    _, refr2, _, tir2 = _diel(d, (z, z, -o), 1.5)
    out = ~tir2.numpy()
    assert out.any() and not out.all()
    np.testing.assert_allclose(refr2[0].numpy()[out],
                               (np.sin(th) * 1.5)[out], atol=1e-5)


def test_torch_total_internal_reflection():
    th = np.asarray([0.6, 0.8, 1.0, 1.2], np.float32)
    z, o = np.zeros(4), np.ones(4)
    refl, _, f, tir = _diel((np.sin(th), z, np.cos(th)), (z, z, o), 1.5)
    crit = np.arcsin(1.0 / 1.5)
    np.testing.assert_array_equal(tir.numpy(), th > crit)
    np.testing.assert_allclose(f.numpy()[th > crit], 1.0)
    np.testing.assert_allclose(refl[0].numpy(), np.sin(th), atol=1e-6)
    np.testing.assert_allclose(refl[2].numpy(), -np.cos(th), atol=1e-6)


def _pane_cfg(w, spp, sky, origin, fov):
    return T.RenderConfig(width=w, height=w, spp_per_step=spp, max_depth=6,
                          sampling="cosine", sky_emission=sky,
                          camera=T.CameraConfig.look_at(
                              origin=origin, target=(0, 0, 0),
                              fov_y_deg=fov))


def test_torch_glass_pane_furnace_energy():
    """A glass pane in a uniform sky: every path escapes with throughput
    1, so the image is the sky."""
    tb = port_scene(**scene_of(WALL, 1.0, [3, 3], ENC_GLASS))
    img = port_render(_pane_cfg(8, 128, (0.6, 0.7, 0.8), (0.3, 0.1, 3.0),
                                40), tb)
    for c, sky in enumerate((0.6, 0.7, 0.8)):
        np.testing.assert_allclose(img[..., c], sky, rtol=2e-2)


def test_torch_glass_tint_applies_per_interface():
    """A tinted pane is one interface: the image is tint * sky exactly."""
    tb = port_scene(**scene_of(WALL, 0.8, [3, 3], ENC_GLASS))
    img = port_render(_pane_cfg(6, 256, (1.0, 1.0, 1.0), (0.0, 0.0, 3.0),
                                10), tb)
    np.testing.assert_allclose(img, 0.8, rtol=1e-4)


def test_torch_glass_with_nee_mis_finite_and_consistent(tmp_path):
    """The Cornell Box with its tall block of glass: NEE and NEE + MIS
    agree with BSDF sampling alone and stay finite (specular faces take no
    light sample, and their bounce counts the emission in full)."""
    tb = T.upload(T.load_obj(material_cornell(
        tmp_path, {"tallBox": MATERIALS["shortBox"]})), device="cpu")
    assert material_flags(tb) == {"has_glossy": False, "has_diel": True}
    base = T.RenderConfig(width=12, height=12, spp_per_step=192, max_depth=5,
                          sampling="cosine")
    imgs = [port_render(dataclasses.replace(base, **kw), tb)
            for kw in ({}, dict(use_nee=True),
                       dict(use_nee=True, use_mis=True))]
    mb = imgs[0].mean()
    assert mb > 0 and all(np.isfinite(i).all() for i in imgs)
    for img in imgs[1:]:
        assert abs(img.mean() - mb) / mb < 0.15, (img.mean(), mb)


# ---- images against sfvp_tpu's jnp integrator ----

EAGER_CASES = {
    "parity": dict(),
    "cosine_rr": dict(sampling="cosine", use_rr=True, rr_start_depth=1),
    "nee": dict(sampling="cosine", use_nee=True),
    "nee_mis_rr": dict(sampling="uniform", use_nee=True, use_mis=True,
                       use_rr=True, rr_start_depth=1),
}


@pytest.mark.parametrize("case", sorted(EAGER_CASES))
def test_torch_eager_materials_match_jax(case, tmp_path):
    """The Cornell Box with a GGX floor, a glass and a mirror box: the
    port's eager loop against sfvp_tpu's jnp integrator."""
    jb, tb = cornell_pair(tmp_path)
    kw = dict(EAGER_CASES[case], width=32, height=32, spp_per_step=2,
              max_depth=4)
    st = jax.jit(j_make(J.RenderConfig(**kw), jb))(J.init_state(32, 32))
    got = make_render_step(T.RenderConfig(**kw), tb)(
        T.init_state(32, 32, "cpu"))
    assert_image(got.accum.numpy(), np.asarray(st.accum),
                 f"eager loop vs jax ({case})")
    assert float(got.mrays) == float(st.mrays), "traced segments differ"


@pytest.mark.parametrize("nee", [False, True])
def test_torch_glossy_city_payload_loop_matches_jax(nee):
    """The glossy-ground city (bench.py's city rows) through the wavefront
    loop over K3's twin, the material lane decoded from the payload,
    against sfvp_tpu's jnp integrator over brute force."""
    from sfvp_tpu.scene import procedural as j_proc

    jb = J.upload(j_proc.city_mesh(n_buildings=3, subdiv=3,
                                   glossy_ground=True, emissive_frac=0.3))
    tb = both(jb)
    assert material_flags(tb)["has_glossy"]
    view = dict(origin=(13.0, 9.0, 13.0), target=(0.0, 0.8, 0.0),
                fov_y_deg=55.0)
    kw = dict(width=16, height=16, spp_per_step=2, max_depth=3,
              sampling="cosine", use_rr=nee, use_nee=nee, use_mis=nee,
              sky_emission=(0.8, 0.85, 1.0))
    st = jax.jit(j_make(J.RenderConfig(**kw, camera=J.CameraConfig.look_at(
        **view)), jb))(J.init_state(16, 16))
    cfg = T.RenderConfig(**kw, camera=T.CameraConfig.look_at(**view),
                         megakernel_regen=False, traversal="bvh")
    step = select_render_step(cfg, tb, wide=build_wide_from_buffers(tb))
    got = step(T.init_state(16, 16, "cpu"))
    assert_image(got.accum.numpy(), np.asarray(st.accum),
                 f"payload loop vs jax (nee={nee})")


def test_torch_payload_lane_decodes_materials():
    """shade_from_payload splits the packed lane: the floor is the
    material, the fraction the roughness or encoded IOR."""
    from sfvp_tpu_torch.integrate.wavefront import shade_from_payload

    lane = torch.tensor([0.0, 1.0, 2.25, 2.96, 3.125])
    out = shade_from_payload(_payload(lane))
    mtype, rough = out[6], out[7]
    assert mtype.tolist() == [0.0, 1.0, 2.0, 2.0, 3.0]
    np.testing.assert_allclose(rough.numpy(), [0, 0, 0.25, 0.96, 0.125],
                               atol=1e-6)


def _payload(lane):
    """A payload whose hit lanes are zeros but for the material lane."""
    from sfvp_tpu_torch.kernels.bvh_packet import payload_from_planes

    planes = torch.zeros((19, lane.shape[0]))
    planes[0] = 1.0
    planes[18] = lane
    return payload_from_planes(planes)


# ---- the fused kernels' twins against the eager loop ----

@pytest.mark.parametrize("case", ["parity", "nee_mis_rr"])
def test_torch_k1_twin_materials_match_eager(case, tmp_path):
    """K1's twin (the fused NEE order) on the material Cornell Box."""
    _, tb = cornell_pair(tmp_path)
    cfg = T.RenderConfig(**EAGER_CASES[case], width=16, height=16,
                         spp_per_step=2, max_depth=4)
    a = make_regen_render_step(cfg, tb)(T.init_state(16, 16, "cpu"))
    b = make_render_step(cfg, tb)(T.init_state(16, 16, "cpu"))
    assert_image(a.accum.numpy(), b.accum.numpy(), f"K1 twin ({case})")
    assert float(a.mrays) == float(b.mrays)


@pytest.mark.parametrize("case", ["parity", "nee_mis_rr"])
def test_torch_k5_twin_materials_match_eager(case, tmp_path):
    """K5's twin over the wide BVH (the packed lane) on the material
    Cornell Box, against the eager loop over brute force."""
    _, tb = cornell_pair(tmp_path)
    cfg = T.RenderConfig(**EAGER_CASES[case], width=16, height=16,
                         spp_per_step=2, max_depth=4)
    dw = device_wide(build_wide_from_buffers(tb), "cpu")
    a = make_bvh_regen_render_step(cfg, tb, dw)(T.init_state(16, 16, "cpu"))
    b = make_render_step(cfg, tb)(T.init_state(16, 16, "cpu"))
    assert_image(a.accum.numpy(), b.accum.numpy(), f"K5 twin ({case})")
    assert float(a.mrays) == float(b.mrays)


def glossy_field(n_tris=600, nee=False):
    """The instanced field (procedural.instanced_field) with its first
    ball mesh GGX and its second glass, both meshes still shared by their
    instances; under ``nee`` the lamp of tests/test_tlas.py:131-143."""
    from sfvp_tpu_torch.scene.procedural import instanced_field

    insts = instanced_field(n_tris=n_tris)
    meshes = {}
    for inst in insts[1:]:
        s = inst.scene
        if id(s) in meshes:
            continue
        t = s.num_triangles
        glass = len(meshes) == 1
        meshes[id(s)] = dataclasses.replace(
            s, face_mat_type=np.full(t, 3 if glass else 2, np.int32),
            face_rough=np.full(t, ENC_GLASS if glass else 0.3, np.float32),
            face_specular=np.full((t, 3), 1.0 if glass else 0.85,
                                  np.float32))
    out = [insts[0]] + [dataclasses.replace(i, scene=meshes[id(i.scene)])
                        for i in insts[1:]]
    if nee:
        lamp = Scene(
            vertices=np.asarray([
                [-1.2, 4.0, -1.2], [1.2, 4.0, -1.2], [1.2, 4.0, 1.2],
                [-1.2, 4.0, -1.2], [1.2, 4.0, 1.2], [-1.2, 4.0, 1.2],
            ], np.float32),
            indices=np.arange(6, dtype=np.uint32),
            face_diffuse=np.zeros((2, 3), np.float32),
            face_emission=np.full((2, 3), 9.0, np.float32))
        out.append(Instance(scene=lamp))
    return out


@pytest.mark.parametrize("nee", [False, True])
def test_torch_k9_twin_materials_match_wavefront(nee):
    """K9's twin on an instanced field of glossy and glass balls, against
    the wavefront loop over K7's twin on the same two-level tree (and K8's
    under NEE)."""
    from sfvp_tpu_torch.render.driver import Renderer

    view = T.CameraConfig.look_at(origin=(10.5, 7.5, 10.5),
                                  target=(0.0, 0.6, 0.0), fov_y_deg=50.0)
    kw = dict(width=16, height=16, spp_per_step=2, max_depth=4,
              sampling="cosine", camera=view, use_rr=nee, use_nee=nee,
              use_mis=nee, sky_emission=(0.05, 0.05, 0.05) if nee
              else (0.8, 0.85, 1.0))
    insts = glossy_field(nee=nee)
    a = Renderer(T.RenderConfig(**kw), insts, "cpu")
    b = Renderer(T.RenderConfig(**kw, megakernel_regen=False), insts, "cpu")
    assert material_flags(a.buffers) == {"has_glossy": True, "has_diel": True}
    a.step(1)
    b.step(1)
    assert_image(a.state.accum.numpy(), b.state.accum.numpy(),
                 f"K9 twin vs wavefront (nee={nee})")
    assert float(a.state.mrays) == float(b.state.mrays)


# ---- routes ----

@pytest.mark.parametrize("kw,route", [
    (dict(), "megakernel_regen(brute)"),
    (dict(megakernel_regen=False), "wavefront(brute)"),
    (dict(traversal="bvh"), "megakernel_bvh(fused regen)"),
    (dict(traversal="bvh", megakernel_regen=False),
     "wavefront(packet kernels)")],
    ids=["k1", "eager", "k5", "k3"])
def test_torch_material_routes(kw, route, tmp_path, capfd, monkeypatch):
    """GGX and glass stay on K1 and K5, and brute force with
    megakernel_regen=False takes the eager loop (K2 has neither, as
    sfvp_tpu's dispatch.py:242-256; tests/test_ggx.py:229)."""
    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    _, tb = cornell_pair(tmp_path)
    cfg = T.RenderConfig(width=8, height=8, spp_per_step=1, max_depth=3, **kw)
    wide = build_wide_from_buffers(tb) if "traversal" in kw else None
    st = select_render_step(cfg, tb, wide=wide)(T.init_state(8, 8, "cpu"))
    assert route in capfd.readouterr().err
    assert np.isfinite(st.accum.numpy()).all() and float(st.accum.max()) > 0


def test_torch_k2_refuses_materials(tmp_path):
    from sfvp_tpu_torch.kernels.megakernel import make_wave_render_step

    _, tb = cornell_pair(tmp_path)
    with pytest.raises(ValueError, match="GGX"):
        make_wave_render_step(T.RenderConfig(width=8, height=8), tb)


def test_torch_material_sort_key_engages(tmp_path):
    """The per-bounce sort keys the material on scenes with any specular
    face (sfvp_tpu's _sort_key, wavefront.py:217); the image is the
    unsorted one."""
    from sfvp_tpu_torch.integrate.wavefront import make_sort_key

    _, tb = cornell_pair(tmp_path)
    cfg = T.RenderConfig(width=8, height=8, spp_per_step=2, max_depth=3)
    key = make_sort_key(cfg, tb, True)
    o = (torch.zeros(4),) * 3
    d = (torch.ones(4),) * 3
    k = key(o, d, torch.zeros(4, dtype=torch.bool),
            torch.tensor([0.0, 1.0, 2.0, 3.0]))
    assert (k >> 24).tolist() == [0, 1, 2, 3]
    wide = build_wide_from_buffers(tb)
    trace = make_packet_trace(device_wide(wide, "cpu"), t_min=cfg.t_min)
    imgs = [make_render_step(dataclasses.replace(cfg, sort_bounce_rays=on),
                             tb, trace_payload_fn=trace)(
        T.init_state(8, 8, "cpu")).accum for on in (False, True)]
    assert torch.equal(imgs[0], imgs[1])


# ---- the kernels on the card ----

def on_card_twins(monkeypatch):
    """Route the fused kernels' wrappers to their twins, which then run
    on the card's tensors: the comparison chip_smoke.py makes (torch's
    CUDA sin, cos and sqrt are the kernels' own, so the two agree bit for
    bit; the CPU's differ in the last ulp)."""
    from sfvp_tpu_torch.kernels import megakernel_bvh as mb
    from sfvp_tpu_torch.kernels import megakernel_regen as mr

    monkeypatch.setattr(mr, "regen_render", mr.regen_render_plain)
    monkeypatch.setattr(mb, "bvh_regen_render", mb.bvh_regen_render_plain)
    monkeypatch.setattr(mb, "tlas_regen_render", mb.bvh_regen_render_plain)


def kernel_and_twin(monkeypatch, render):
    """``render()`` through the kernels, then through the twins on the
    card."""
    got = render()
    with monkeypatch.context() as m:
        on_card_twins(m)
        exp = render()
    return got, exp


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["parity", "nee_mis_rr"])
def test_cuda_k1_k5_materials_match_twins(case, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    _, tb = cornell_pair(tmp_path)
    cfg = T.RenderConfig(**EAGER_CASES[case], width=64, height=48,
                         spp_per_step=2, max_depth=8)
    gpu_tb = T.scene.to_device(tb, "cuda")
    dw = device_wide(build_wide_from_buffers(tb), "cuda")
    for name, render in (
            ("K1", lambda: make_regen_render_step(cfg, gpu_tb)(
                T.init_state(48, 64, "cuda"))),
            ("K5", lambda: make_bvh_regen_render_step(cfg, gpu_tb, dw)(
                T.init_state(48, 64, "cuda")))):
        got, exp = kernel_and_twin(monkeypatch, render)
        assert torch.equal(got.accum, exp.accum), f"{name} ({case})"


@pytest.mark.cuda
def test_cuda_k9_glossy_field_matches_twin(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    from sfvp_tpu_torch.render.driver import Renderer

    view = T.CameraConfig.look_at(origin=(10.5, 7.5, 10.5),
                                  target=(0.0, 0.6, 0.0), fov_y_deg=50.0)
    cfg = T.RenderConfig(width=32, height=32, spp_per_step=2, max_depth=8,
                         sampling="cosine", camera=view, use_rr=True,
                         use_nee=True, use_mis=True)
    insts = glossy_field(n_tris=5000, nee=True)

    def render():
        r = Renderer(cfg, insts, "cuda")
        r.step(1)
        return r.state

    got, exp = kernel_and_twin(monkeypatch, render)
    assert torch.equal(got.accum, exp.accum)

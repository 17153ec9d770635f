"""The port's plain wavefront integrator against sfvp_tpu's jnp integrator,
the independent numpy oracle (tools/oracle_ref.py) and the committed golden
image.

Tolerances: against the JAX integrator and the oracle, relative RMSE
< 1e-5 and max abs < 1e-4, the bound tests/test_oracle.py holds two
independent f32 implementations to (torch-CPU and XLA-CPU round
transcendentals differently in the last ulp). The 64² golden traces
~262k paths, where a 1-ulp hit/miss flip can send a path elsewhere: there
relative RMSE < 1e-4 and under 0.5% of pixels off by more than 1e-4.
"""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.integrate.wavefront import make_render_step as j_make  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch.integrate.wavefront import make_render_step  # noqa: E402
from sfvp_tpu_torch.scene.buffers import FIELDS, from_numpy  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
import oracle_ref  # noqa: E402

# the test configurations shared with test_torch_megakernel.py
CASES = {
    "parity": dict(scene="cornell"),
    "cosine_rr": dict(scene="cornell", sampling="cosine", use_rr=True,
                      rr_start_depth=1),
    "mirror": dict(scene="mirror"),
}


def mirror_scene_arrays():
    """Cornell with the tall box and back wall as tinted mirrors (mtype 1):
    the bundled MTL is illum 2 throughout and never reaches the mirror
    branch."""
    s = J.load_obj(native="never")
    names = [s.material_names[i] for i in s.face_material_id]
    mt = np.asarray([1 if n in ("tallBox", "backWall") else 0 for n in names],
                    np.int32)
    spec = np.where(mt[:, None] == 1, np.float32([0.9, 0.85, 0.8]),
                    np.float32(0.0)).astype(np.float32)
    return (s.triangles(), s.face_diffuse, s.face_emission, spec, mt)


def both_buffers(scene):
    if scene == "mirror":
        jb = J.scene.buffers.from_arrays(*mirror_scene_arrays())
    else:
        jb = J.upload(J.load_obj(native="never"))
    tb = from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS},
                    jb.num_tris, "cpu")
    return jb, tb


def rel_rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()) / np.sqrt((b ** 2).mean()))


def assert_close(got, exp, what, rel=1e-5, max_abs=1e-4):
    r = rel_rmse(got, exp)
    m = float(np.abs(got - exp).max())
    assert r < rel and m < max_abs, (
        f"{what}: relative RMSE {r:.3g} (bound {rel}), max abs {m:.3g} "
        f"(bound {max_abs})")


def jax_render(cfg_kw, jb, h, w, steps=1):
    step = jax.jit(j_make(J.RenderConfig(**cfg_kw), jb))
    st = J.init_state(h, w)
    for _ in range(steps):
        st = step(st)
    return np.asarray(st.accum), float(st.mrays)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wavefront_matches_jax(case):
    kw = dict(CASES[case])
    jb, tb = both_buffers(kw.pop("scene"))
    kw.update(width=16, height=8, spp_per_step=3, max_depth=3)
    exp, exp_mrays = jax_render(kw, jb, 8, 16, steps=2)
    step = make_render_step(T.RenderConfig(**kw), tb)
    st = T.init_state(8, 16, "cpu")
    st = step(step(st))
    assert st.frame == 2
    assert_close(st.accum.numpy(), exp, f"wavefront vs jax ({case})")
    assert float(st.mrays) == exp_mrays, "traced segments differ"


def test_wavefront_spp_chunk_matches_jax():
    jb, tb = both_buffers("cornell")
    kw = dict(width=16, height=8, spp_per_step=4, max_depth=3, spp_chunk=2)
    exp, exp_mrays = jax_render(kw, jb, 8, 16)
    st = make_render_step(T.RenderConfig(**kw), tb)(T.init_state(8, 16, "cpu"))
    assert_close(st.accum.numpy(), exp, "wavefront spp_chunk=2 vs jax")
    assert float(st.mrays) == exp_mrays


def test_wavefront_matches_independent_oracle():
    size, spp, frames = 32, 32, 2
    exp = oracle_ref.render(T.cornell_box_path(), size, size, frames, spp=spp)
    cfg = T.RenderConfig(width=size, height=size, spp_per_step=spp,
                         max_depth=8)
    step = make_render_step(cfg, T.upload(T.load_obj(), device="cpu"))
    st = T.init_state(size, size, "cpu")
    for _ in range(frames):
        st = step(st)
    assert_close(st.accum.numpy(), exp, "wavefront vs numpy oracle")


def test_wavefront_matches_golden():
    with np.load(os.path.join(ROOT, "tests", "golden",
                              "cornell64_64spp.npz")) as z:
        golden = z["accum"]
        golden_hash = bytes(z["config_hash"]).decode()
    cfg = T.RenderConfig(width=64, height=64, spp_per_step=16, max_depth=8)
    assert cfg.config_hash() == golden_hash
    step = make_render_step(cfg, T.upload(T.load_obj(), device="cpu"))
    st = T.init_state(64, 64, "cpu")
    for _ in range(4):
        st = step(st)
    img = st.accum.numpy()
    r = rel_rmse(img, golden)
    off = float((np.abs(img - golden) > 1e-4).mean())
    assert r < 1e-4 and off < 0.005, (
        f"vs golden: relative RMSE {r:.3g} (bound 1e-4), {off:.3%} of "
        "pixels off by > 1e-4 (bound 0.5%)")


def test_band_equals_rows_of_full_image():
    """row0 + global_shape: a band of rows renders bitwise those rows of
    the full image (rays are generated in global pixel coordinates)."""
    tb = T.upload(T.load_obj(), device="cpu")
    cfg = T.RenderConfig(width=16, height=8, spp_per_step=2, max_depth=3)
    full = make_render_step(cfg, tb)(T.init_state(8, 16, "cpu")).accum
    band_step = make_render_step(cfg, tb, global_shape=(8, 16))
    band = band_step(T.init_state(4, 16, "cpu"), row0=4).accum
    assert torch.equal(band, full[4:])


@pytest.mark.parametrize("change", ["nee", "mis", "dof", "glossy", "bvh",
                                    "too_many_tris"])
def test_out_of_slice_raises(change):
    """NEE, MIS, GGX and depth of field all render now (the "nee" case
    pairs NEE with a GGX material, "mis" MIS with depth of field;
    tests/test_torch_materials.py, test_torch_dof.py): each config renders
    a finite image, and the same config with an open lens and no focal
    plane in front of it (focus_dist 0) raises ValueError, as sfvp_tpu's
    camera does, on the BVH route before it asks for the tree."""
    import dataclasses

    from sfvp_tpu_torch.scene.buffers import from_arrays

    s = T.load_obj()
    tb = T.upload(s, device="cpu")
    dof = dataclasses.replace(T.CameraConfig(), lens_radius=0.1,
                              focus_dist=3.0)
    mt = np.zeros(36, np.int32)
    mt[0] = 2
    glossy = from_arrays(s.triangles(), s.face_diffuse, s.face_emission,
                         mat_type=mt, device="cpu")
    cfg = T.RenderConfig(width=8, height=8, spp_per_step=1, max_depth=2)
    if change == "nee":
        cfg, tb = dataclasses.replace(cfg, use_nee=True), glossy
    elif change == "mis":
        cfg = dataclasses.replace(cfg, use_nee=True, use_mis=True,
                                  camera=dof)
    elif change == "dof":
        cfg = dataclasses.replace(cfg, camera=dof)
    elif change == "glossy":
        tb = glossy
    else:
        from sfvp_tpu_torch.dispatch import select_render_step

        bvh = (dict(traversal="bvh") if change == "bvh"
               else dict(brute_force_max_tris=20))
        bad = dataclasses.replace(dof, focus_dist=0.0)
        with pytest.raises(ValueError, match="focus_dist"):
            select_render_step(T.RenderConfig(use_nee=True, camera=bad,
                                              **bvh), tb)
        with pytest.raises(ValueError, match="wide BVH"):
            select_render_step(T.RenderConfig(use_nee=True, camera=dof,
                                              **bvh), tb)
        return
    img = make_render_step(cfg, tb)(T.init_state(8, 8, "cpu")).accum
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0
    bad = dataclasses.replace(cfg.camera, lens_radius=0.1, focus_dist=0.0)
    with pytest.raises(ValueError, match="focus_dist"):
        make_render_step(dataclasses.replace(cfg, camera=bad), tb)

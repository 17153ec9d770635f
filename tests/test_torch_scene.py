"""Config, scene ingest, device buffers and the kernels' scene table of the
PyTorch port against sfvp_tpu (integer and copied data: exact equality)."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.kernels.megakernel import scene_table as j_scene_table  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch.kernels.megakernel import (  # noqa: E402
    buffers_from_table,
    scene_table,
)
from sfvp_tpu_torch.scene.buffers import FIELDS, from_numpy  # noqa: E402

CONFIGS = {
    "default": {},
    "small": dict(width=64, height=48, spp_per_step=16, max_depth=5),
    "cosine_rr": dict(sampling="cosine", use_rr=True, rr_start_depth=2),
    "nee_mis": dict(use_nee=True, use_mis=True),
    "sky": dict(sky_emission=(0.1, 0.2, 0.3), t_min=0.01, t_max=100.0),
    "knobs": dict(spp_chunk=4, megakernel_regen=False, traversal="brute"),
    "dof": dict(camera=dict(lens_radius=0.12, focus_dist=3.0)),
    "look_at": dict(camera="look_at"),
}


def _cfg(mod, kw):
    kw = dict(kw)
    cam = kw.pop("camera", None)
    if cam == "look_at":
        kw["camera"] = mod.CameraConfig.look_at(
            origin=(0.0, 2.2, 5.0), target=(0.0, 0.0, 0.0), fov_y_deg=50.0)
    elif cam is not None:
        kw["camera"] = dataclasses.replace(mod.CameraConfig(), **cam)
    return mod.RenderConfig(**kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_hash_equal(name):
    a = _cfg(J, CONFIGS[name]).config_hash()
    b = _cfg(T, CONFIGS[name]).config_hash()
    assert a == b, f"config_hash differs for {name}: jax {a} torch {b}"


def test_config_hash_refuses_image_changes():
    base = T.RenderConfig().config_hash()
    assert T.RenderConfig(spp_chunk=8).config_hash() == base
    assert T.RenderConfig(max_depth=7).config_hash() != base


@pytest.fixture(scope="module")
def scenes():
    return J.load_obj(native="never"), T.load_obj()


def test_load_obj_equal(scenes):
    js, ts = scenes
    for f in ("vertices", "indices", "face_diffuse", "face_emission",
              "face_specular", "face_mat_type", "face_rough", "face_uv",
              "face_tex", "face_material_id"):
        a, b = getattr(js, f), getattr(ts, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert js.material_names == ts.material_names
    assert js.texture_paths == ts.texture_paths == []
    assert ts.num_triangles == 36


@pytest.mark.parametrize("pad_to", [None, 64])
def test_carry_across_buffers_equal_upload(scenes, pad_to):
    js, ts = scenes
    jb = J.upload(js, pad_to=pad_to)
    carried = from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS},
                         jb.num_tris, "cpu")
    tb = T.upload(ts, device="cpu", pad_to=pad_to)
    assert tb.num_tris == carried.num_tris == 36
    assert tb.padded_tris == jb.padded_tris
    for k in FIELDS:
        a, b = getattr(tb, k), getattr(carried, k)
        assert a.dtype == b.dtype == (torch.int32 if k == "mtype"
                                      else torch.float32), k
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jb, k)),
                                      err_msg=k)
        assert torch.equal(a, b), k


def test_from_arrays_mirror_columns():
    tris = np.random.default_rng(0).normal(size=(5, 3, 3)).astype(np.float32)
    kw = dict(specular=np.full((5, 3), 0.9, np.float32),
              mat_type=np.asarray([0, 1, 0, 1, 1], np.int32), pad_to=8)
    jb = J.scene.buffers.from_arrays(tris, np.ones((5, 3)), np.zeros((5, 3)),
                                     **kw)
    tb = T.scene.from_arrays(tris, np.ones((5, 3)), np.zeros((5, 3)), **kw,
                             device="cpu")
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)


def test_scene_table_equal(scenes):
    js, ts = scenes
    jt = np.asarray(j_scene_table(J.upload(js)))
    tt = scene_table(T.upload(ts, device="cpu"))
    assert tt.shape == (20, 36) and tt.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy(), jt)
    back = buffers_from_table(tt, 36)
    for k in FIELDS:
        assert torch.equal(getattr(back, k),
                           getattr(T.upload(ts, device="cpu"), k)), k


def test_upload_refuses_env_map(scenes):
    _, ts = scenes
    env_scene = dataclasses.replace(ts, env_map="sky.hdr")
    with pytest.raises(NotImplementedError, match="A.13"):
        T.upload(env_scene, device="cpu")

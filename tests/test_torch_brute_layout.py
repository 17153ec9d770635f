"""The brute-force table of K1 and K2 (csrc/common.cuh load_table,
kernels/build.py table_plan) and the 16-byte row loads of the single-level
walks of K3, K4 and K5 (csrc/wide_bvh.cuh, build.wide_params).

A scene may carry all-zero triangles (``upload(pad_to=...)``, as the JAX
package pads its tables for the TPU's lanes): no ray hits one
(Moller-Trumbore's det is 0), so the CPU tests hold the plain twins of K1
and K2 over a table padded with them to a multiple of 4 against the twins
over the table as it is, bit for bit. The tests marked ``cuda`` hold the kernels to their
twins at triangle counts on both sides of the shared-memory table's limit
and on a textured tree, and skip without a card; chip_smoke.py runs the
same comparisons on the H100. wide_params's alignment refusal is held in
test_torch_tlas.py, beside two_level_params's.
"""

import numpy as np
import pytest
import torch

import sfvp_tpu_torch as T
from sfvp_tpu_torch.accel.wide import build_wide_from_buffers
from sfvp_tpu_torch.dispatch import select_render_step
from sfvp_tpu_torch.integrate.lights import build_light_table_from_buffers
from sfvp_tpu_torch.kernels.bvh_packet import (
    device_wide,
    packet_occlusion,
    packet_trace,
    ray_planes,
)
from sfvp_tpu_torch.kernels.megakernel import scene_table, wave_render_plain
from sfvp_tpu_torch.kernels.megakernel_bvh import make_bvh_regen_render_step
from sfvp_tpu_torch.kernels.megakernel_regen import regen_render_plain
from sfvp_tpu_torch.render.png import encode_png
from sfvp_tpu_torch.scene.objload import Scene

T_MIN = 1e-3
SOUP_VIEW = T.CameraConfig.look_at(origin=(0.0, 0.3, 3.5),
                                   target=(0.0, 0.0, 0.0), fov_y_deg=50.0)
ESTIMATORS = {
    "parity": {},
    "nee": dict(sampling="cosine", use_rr=True, use_nee=True, use_mis=True),
}


def soup(n, seed, textured_dir=None):
    """``n`` random triangles in a box, every tenth emissive; with
    ``textured_dir`` every face wears a checker written there."""
    g = np.random.default_rng(seed)
    centers = g.uniform(-1.0, 1.0, (n, 1, 3))
    tris = (centers + g.normal(0.0, 0.25, (n, 3, 3))).astype(np.float32)
    emission = np.zeros((n, 3), np.float32)
    emission[::10] = g.uniform(1.0, 4.0, (len(emission[::10]), 3))
    kw = {}
    if textured_dir is not None:
        cells = (np.indices((16, 16)).sum(0) // 4) % 2
        img = np.where(cells[..., None] > 0, [255, 255, 255],
                       [40, 90, 230]).astype(np.uint8)
        path = textured_dir / "check.png"
        path.write_bytes(encode_png(img))
        kw = dict(face_uv=g.uniform(0.0, 2.0, (n, 3, 2)).astype(np.float32),
                  face_tex=np.zeros((n,), np.int32),
                  texture_paths=[str(path)])
    return Scene(vertices=tris.reshape(-1, 3),
                 indices=np.arange(3 * n, dtype=np.uint32),
                 face_diffuse=g.uniform(0.2, 0.9, (n, 3)).astype(np.float32),
                 face_emission=emission, **kw)


def scene_and_view(name):
    if name == "cornell":
        return T.load_obj(), T.CameraConfig()
    return soup(int(name[4:]), seed=3), SOUP_VIEW


def next_four(n):
    """The padded count past ``n``: its next multiple of 4, and 4 more for
    a count that is one already, so that every table gets pads."""
    return n + 4 - n % 4


@pytest.mark.parametrize("est", sorted(ESTIMATORS))
@pytest.mark.parametrize("name", ["cornell", "soup37"])
def test_k1_twin_over_a_padded_table_is_the_unpadded_twin(name, est):
    """K1's twin over a table padded with zero triangles to a multiple of
    4 gives the bits of its twin over the table as it is: the pads are
    never hit, never shadow and are not lights."""
    scene, view = scene_and_view(name)
    tb = T.upload(scene, device="cpu")
    n = tb.num_tris
    tp = T.upload(scene, device="cpu", pad_to=next_four(n))
    cfg = T.RenderConfig(width=16, height=12, spp_per_step=2, max_depth=4,
                         camera=view, **ESTIMATORS[est])
    lights = build_light_table_from_buffers(tb) if cfg.use_nee else None
    args = dict(cfg=cfg, global_shape=(12, 16), npix=16 * 12,
                has_mirrors=False, lights=lights)
    want = regen_render_plain(scene_table(tb), 1, 0, num_tris=n, **args)
    got = regen_render_plain(scene_table(tp), 1, 0,
                             num_tris=tp.v0x.shape[0], **args)
    assert tp.v0x.shape[0] % 4 == 0 and tp.v0x.shape[0] > n
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["cornell", "soup37"])
def test_k2_twin_over_a_padded_table_is_the_unpadded_twin(name):
    """The same for K2's twin, one wave of two samples."""
    scene, view = scene_and_view(name)
    tb = T.upload(scene, device="cpu")
    n = tb.num_tris
    tp = T.upload(scene, device="cpu", pad_to=next_four(n))
    cfg = T.RenderConfig(width=16, height=12, spp_per_step=2, spp_chunk=2,
                         max_depth=4, camera=view)
    args = dict(cfg=cfg, global_shape=(12, 16), npix=16 * 12,
                has_mirrors=False)
    want = wave_render_plain(scene_table(tb), 1, 0, 0, num_tris=n, **args)
    got = wave_render_plain(scene_table(tp), 1, 0, 0,
                            num_tris=tp.v0x.shape[0], **args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")


def assert_image(got, want, what):
    """A kernel's image against its twin's across devices, as the other
    kernel tests hold them: the card's sin, cos and atan2 may differ from
    the host's by an ulp, which moves a few paths (relative RMSE < 1e-4,
    no pixel apart by more than 0.1)."""
    got, want = got.cpu().double(), want.double()
    rel = float((got - want).square().mean().sqrt()
                / want.square().mean().sqrt())
    assert rel < 1e-4 and float((got - want).abs().max()) < 0.1, (what, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 4842, 4843])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_cuda_brute_matches_twin_at_any_count(kernel, n):
    """K1 and K2 against their twins on soups of 37 triangles (not a
    multiple of 4), 4,842 (the most the shared-memory table holds) and
    4,843 (the first count in tiles), at 32x32."""
    _cuda()
    scene, view = scene_and_view(f"soup{n}")
    tb = T.upload(scene, device="cpu")
    cfg = T.RenderConfig(width=32, height=32, spp_per_step=2, max_depth=6,
                         camera=view, traversal="brute",
                         megakernel_regen=kernel == "K1",
                         **ESTIMATORS["nee" if kernel == "K1" else "parity"])
    cpu = select_render_step(cfg, tb)(T.init_state(32, 32, "cpu"))
    gpu = select_render_step(cfg, T.scene.to_device(tb, "cuda"))(
        T.init_state(32, 32, "cuda"))
    assert_image(gpu.accum, cpu.accum, f"{kernel} CUDA vs twin ({n} tris)")
    assert abs(float(gpu.mrays) - float(cpu.mrays)) <= 1e-4 * float(cpu.mrays)


@pytest.mark.cuda
def test_cuda_single_level_walks_match_twins_on_a_textured_tree(tmp_path):
    """K3 (payload planes) and K4 (every ray) bit for bit, and K5 under
    NEE + MIS, against their twins on the wide tree of a textured soup."""
    _cuda()
    tb = T.upload(soup(600, seed=11, textured_dir=tmp_path), device="cpu")
    tw = build_wide_from_buffers(tb)
    assert tw.tris_aux is not None
    cpu_w, gpu_w = device_wide(tw, "cpu"), device_wide(tw, "cuda")
    g = np.random.default_rng(5)
    o = torch.from_numpy(g.uniform(-2.0, 2.0, (3, 8192)).astype(np.float32))
    d = torch.from_numpy(g.normal(size=(3, 8192)).astype(np.float32))
    d = d / d.norm(dim=0)
    tmax = torch.from_numpy(g.uniform(-0.5, 4.0, 8192).astype(np.float32))
    rays = ray_planes(tuple(o), tuple(d), tmax)
    assert torch.equal(packet_trace(gpu_w, T_MIN, rays.cuda()).cpu(),
                       packet_trace(cpu_w, T_MIN, rays))
    assert torch.equal(packet_occlusion(gpu_w, T_MIN, rays.cuda()).cpu(),
                       packet_occlusion(cpu_w, T_MIN, rays))
    cfg = T.RenderConfig(width=32, height=32, spp_per_step=2, max_depth=6,
                         camera=SOUP_VIEW, **ESTIMATORS["nee"])
    cpu = make_bvh_regen_render_step(cfg, tb, cpu_w)(
        T.init_state(32, 32, "cpu"))
    gpu = make_bvh_regen_render_step(cfg, T.scene.to_device(tb, "cuda"),
                                     gpu_w)(T.init_state(32, 32, "cuda"))
    assert_image(gpu.accum, cpu.accum, "K5 CUDA vs twin (textured soup)")

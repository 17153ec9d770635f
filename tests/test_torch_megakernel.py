"""K1 and K2 of the port. On the CPU their wrappers run the plain PyTorch
twins, which are held here against sfvp_tpu: the K2 twin against the JAX
K2 Pallas kernel run in interpret mode (as tests/test_megakernel.py runs
it), and both twins against the jnp integrator. Tolerances as in
test_torch_integrator.py (relative RMSE < 1e-5, max abs < 1e-4, traced
segments exact).

The tests marked ``cuda`` hold the CUDA kernels against their twins and
skip without a card; chip_smoke.py runs the same comparison on the H100.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.integrate.wavefront import make_render_step as j_make  # noqa: E402
from sfvp_tpu.kernels.megakernel import make_render_step_pallas  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch.dispatch import select_render_step  # noqa: E402
from sfvp_tpu_torch.kernels import build  # noqa: E402
from sfvp_tpu_torch.kernels.megakernel import (  # noqa: E402
    make_wave_render_step,
    scene_table,
    wave_render,
    wave_render_plain,
)
from sfvp_tpu_torch.kernels.megakernel_regen import (  # noqa: E402
    make_regen_render_step,
    regen_render,
    regen_render_plain,
)

from test_torch_integrator import CASES, assert_close, both_buffers  # noqa: E402

MAKERS = {"K1": make_regen_render_step, "K2": make_wave_render_step}
# K2 draws its roulette number only from rr_start_depth on
# (sfvp_tpu/kernels/megakernel.py:336) where the jnp integrator draws one at
# every depth, so against the jnp integrator K2's RR case starts at depth 0,
# where the two draw alike; test_k2_twin_matches_jax_k2_interpret holds K2's
# own RR semantics at rr_start_depth=1.
K2_CASES = dict(CASES, cosine_rr=dict(CASES["cosine_rr"], rr_start_depth=0))


def _run(make, cfg_kw, tb, h, w, steps=1):
    step = make(T.RenderConfig(**cfg_kw), tb)
    st = T.init_state(h, w, tb.device)
    for _ in range(steps):
        st = step(st)
    return st


def test_k2_twin_matches_jax_k2_interpret():
    """Cosine sampling + RR from depth 1 at 8x8, 1 spp, depth 2: the K2
    draw policy (a roulette number only where RR applies)."""
    jb, tb = both_buffers("cornell")
    kw = dict(width=8, height=8, spp_per_step=1, max_depth=2,
              sampling="cosine", use_rr=True, rr_start_depth=1)
    b = jax.jit(make_render_step_pallas(J.RenderConfig(**kw), jb,
                                        interpret=True))(J.init_state(8, 8))
    st = _run(make_wave_render_step, kw, tb, 8, 8)
    assert_close(st.accum.numpy(), np.asarray(b.accum), "K2 twin vs jax K2")
    assert float(st.mrays) == float(b.mrays)


@pytest.mark.parametrize("kernel,case", [
    ("K1", "parity"), ("K1", "cosine_rr"), ("K1", "mirror"),
    ("K2", "parity"), ("K2", "cosine_rr"), ("K2", "mirror")])
def test_twin_matches_jnp_integrator(kernel, case):
    kw = dict((K2_CASES if kernel == "K2" else CASES)[case])
    jb, tb = both_buffers(kw.pop("scene"))
    kw.update(width=16, height=8, spp_per_step=3, max_depth=3)
    a = jax.jit(j_make(J.RenderConfig(**kw), jb))
    ja = a(a(J.init_state(8, 16)))
    st = _run(MAKERS[kernel], kw, tb, 8, 16, steps=2)
    assert_close(st.accum.numpy(), np.asarray(ja.accum),
                 f"{kernel} twin vs jnp ({case})")
    assert float(st.mrays) == float(ja.mrays), "traced segments differ"


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_pixels_not_a_multiple_of_the_block(kernel):
    """24x7 = 168 pixels (the kernels' blocks are 128 threads), K2 with
    3-sample waves."""
    jb, tb = both_buffers("cornell")
    kw = dict(width=24, height=7, spp_per_step=3, max_depth=3,
              spp_chunk=3 if kernel == "K2" else 1)
    ja = jax.jit(j_make(J.RenderConfig(**kw), jb))(J.init_state(7, 24))
    st = _run(MAKERS[kernel], kw, tb, 7, 24)
    assert_close(st.accum.numpy(), np.asarray(ja.accum), f"{kernel} 24x7")
    assert float(st.mrays) == float(ja.mrays)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_row_offset_band(kernel):
    """row0 + global_shape: rows [4, 8) rendered as a band equal, bitwise,
    rows 4-7 of the full 16x8 render."""
    tb = T.upload(T.load_obj(), device="cpu")
    cfg = T.RenderConfig(width=16, height=8, spp_per_step=2, max_depth=3)
    full = MAKERS[kernel](cfg, tb)(T.init_state(8, 16, "cpu")).accum
    band_step = MAKERS[kernel](cfg, tb, global_shape=(8, 16))
    band = band_step(T.init_state(4, 16, "cpu"), row0=4).accum
    assert torch.equal(band, full[4:])


def test_dispatch_routes():
    tb = T.upload(T.load_obj(), device="cpu")
    kw = dict(width=8, height=8, spp_per_step=2, max_depth=3)
    k1 = select_render_step(T.RenderConfig(**kw), tb)
    k2 = select_render_step(T.RenderConfig(megakernel_regen=False, **kw), tb)
    assert "make_regen_render_step" in k1.__qualname__
    assert "make_wave_render_step" in k2.__qualname__


def test_cpu_runs_twin_and_counts_no_launch():
    tb = T.upload(T.load_obj(), device="cpu")
    table = scene_table(tb)
    cfg = T.RenderConfig(width=8, height=8, spp_per_step=2, max_depth=3)
    kw = dict(cfg=cfg, num_tris=36, global_shape=(8, 8), npix=64,
              has_mirrors=False)
    before = (regen_render.launches, wave_render.launches)
    a = regen_render(table, 0, 0, **kw)
    b = regen_render_plain(table, 0, 0, **kw)
    c = wave_render(table, 0, 0, 0, **kw)
    d = wave_render_plain(table, 0, 0, 0, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    assert (regen_render.launches, wave_render.launches) == before


@pytest.mark.parametrize("wrapper", ["K1", "K2"])
def test_non_cpu_non_cuda_tensor_is_refused(wrapper):
    """A tensor that is not on the CPU never reaches a twin: off CUDA the
    wrapper raises instead of falling back."""
    table = torch.empty((20, 36), device="meta")
    cfg = T.RenderConfig(width=8, height=8)
    kw = dict(cfg=cfg, num_tris=36, global_shape=(8, 8), npix=64,
              has_mirrors=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if wrapper == "K1":
            regen_render(table, 0, 0, **kw)
        else:
            wave_render(table, 0, 0, 0, **kw)


def test_kernel_params_layout():
    """The ctypes mirror of sfvp::Params (csrc/common.cuh): 14 ints,
    7 floats and 5 float[3], then next-event estimation's 3 ints and 4
    floats, then the environment's and the textures' 9 ints and 6 floats,
    4-byte fields without padding, and their 11 pointers from an 8-byte
    boundary; then the materials' and the thin lens's 2 ints, 2 floats and
    3 float[3], the struct padded to a multiple of 8 bytes."""
    import ctypes

    assert len(build.Params._fields_) == 26 + 7 + 15 + 11 + 7
    assert build.Params.t_min.offset == 4 * 14
    assert build.Params.cam_c.offset == 4 * (14 + 7)
    assert build.Params.use_nee.offset == 4 * (14 + 7 + 15)
    assert build.Params.total_area.offset == 4 * (14 + 7 + 15 + 3)
    assert build.Params.use_env.offset == 4 * (14 + 7 + 15 + 3 + 4)
    assert build.Params.env_inv_patch.offset == 4 * (14 + 7 + 15 + 3 + 4 + 9)
    assert build.Params.env_r.offset == 4 * (14 + 7 + 15 + 3 + 4 + 9 + 6)
    assert build.Params.env_r.offset % 8 == 0
    ext = build.Params.env_r.offset + 8 * 11
    assert build.Params.use_mat.offset == ext
    assert build.Params.lens_r.offset == ext + 4 * 2
    assert build.Params.lens_rn.offset == ext + 4 * 4
    assert ctypes.sizeof(build.Params) == -(-(ext + 4 * (2 + 2 + 9)) // 8) * 8


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,case", [
    ("K1", "parity"), ("K1", "cosine_rr"), ("K1", "mirror"),
    ("K2", "parity"), ("K2", "cosine_rr"), ("K2", "mirror")])
def test_cuda_kernel_matches_twin(kernel, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    kw = dict(K2_CASES[case] if kernel == "K2" else CASES[case])
    _, tb = both_buffers(kw.pop("scene"))
    kw.update(width=64, height=48, spp_per_step=4, max_depth=8)
    cpu = _run(MAKERS[kernel], kw, tb, 48, 64)
    gpu_tb = T.scene.to_device(tb, "cuda")
    gpu = _run(MAKERS[kernel], kw, gpu_tb, 48, 64)
    assert_close(gpu.accum.cpu().numpy(), cpu.accum.numpy(),
                 f"{kernel} CUDA vs twin ({case})", rel=1e-4, max_abs=0.1)
    assert abs(float(gpu.mrays) - float(cpu.mrays)) <= 1e-4 * float(cpu.mrays)

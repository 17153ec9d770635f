"""K6's plain twin (kernels/bvh_packet2.py packet_trace2_plain) against
sfvp_tpu: its K6 Pallas kernel make_packet_trace2 in interpret mode (as
tests/test_bvh_packet2.py runs it), resident and streamed, with one or two
interleaved packets (a knob of the JAX side only), leaf queues of 64 and 2
entries (the spill path), a partial last packet and an active mask; the
port's brute force and K3's twin; the wavefront loop over K6's twin
against sfvp_tpu's over its K6; the pixel-tile swizzle; and the stream
decision of dispatch.

Bounds: the same triangle on at least 99.9% of the rays (the bound of
tests/test_torch_bvh_trace.py). Both sides visit the tree in the same
order, so only a near-tie that XLA's fused multiply-adds on the CPU flip
can pick another; the tests print how many rays differ. Where the triangle
is the same, every payload plane that comes from the triangle row is equal
and t agrees within rtol 1e-5; the barycentrics u, v within 1e-5, absolute
(they lie in [0, 1], and where they cancel XLA's fused multiply-adds move
them by a few 1e-6: 5.8e-6 on one of 2,013 hits of the soup). The
wavefront loops: relative RMSE < 1e-5 and max abs < 1e-4 (ROADMAP.md §C),
traced segments equal.

The ``cuda`` tests hold the CUDA kernel against its twin and skip without
a card; chip_smoke.py runs the same comparisons on the H100.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.accel.sah import sah_bvh_from_arrays as j_sah  # noqa: E402
from sfvp_tpu.accel.wide import build_wide as j_build_wide  # noqa: E402
from sfvp_tpu.accel.wide import materials_array as j_materials  # noqa: E402
from sfvp_tpu.integrate.wavefront import make_render_step as j_make  # noqa: E402
from sfvp_tpu.kernels.bvh_packet2 import make_packet_trace2 as j_k6  # noqa: E402
from sfvp_tpu.scene import procedural as j_proc  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch import dispatch  # noqa: E402
from sfvp_tpu_torch.accel.wide import WideBVH, build_wide_from_buffers  # noqa: E402
from sfvp_tpu_torch.dispatch import select_render_step  # noqa: E402
from sfvp_tpu_torch.integrate import wavefront  # noqa: E402
from sfvp_tpu_torch.kernels import build  # noqa: E402
from sfvp_tpu_torch.kernels import bvh_packet, bvh_packet2  # noqa: E402
from sfvp_tpu_torch.kernels.bvh_packet import (  # noqa: E402
    DeviceWide,
    device_wide,
    packet_trace_plain,
    ray_planes,
)
from sfvp_tpu_torch.kernels.bvh_packet2 import (  # noqa: E402
    make_packet_trace2,
    packet_trace2,
    packet_trace2_plain,
)
from sfvp_tpu_torch.kernels.intersect import trace_brute  # noqa: E402
from sfvp_tpu_torch.scene.buffers import FIELDS, from_numpy  # noqa: E402

from test_torch_bvh_trace import (  # noqa: E402
    _cols,
    _jax_payload,
    _port_payload,
    _rays,
    _same_triangle,
    _soup,
)
from test_torch_integrator import assert_close  # noqa: E402

T_MIN = 1e-3
SAME_TRI = 0.999
SPHERE_VIEW = dict(origin=(0.0, 2.2, 5.0), target=(0.0, 0.0, 0.0),
                   fov_y_deg=50.0)


def _sphere():
    s = j_proc.sphere_mesh(12, 12, bump=0.3)
    return np.asarray(s.triangles(), np.float32), J.upload(s)


_SCENES = {}


def scene(name):
    """Both packages' buffers and SAH wide BVHs (the JAX side on its NumPy
    builder) of the soup or the sphere, built once per module."""
    if name not in _SCENES:
        tris, jb = _soup(200, seed=3) if name == "soup" else _sphere()
        tb = from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS},
                        jb.num_tris, "cpu")
        jw = j_build_wide(j_sah(tris, leaf_size=8, native="never"),
                          j_materials(jb))
        tw = build_wide_from_buffers(tb, builder="sah")
        assert np.array_equal(jw.nodes, tw.nodes)
        assert np.array_equal(jw.tris, tw.tris)
        _SCENES[name] = dict(jb=jb, tb=tb, jw=jw, tw=tw,
                             dw=device_wide(tw, "cpu"),
                             spread=2.0 if name == "sphere" else 6.0)
    return _SCENES[name]


def _wave(s, m, seed, active_frac=None):
    """m random rays over the scene (numpy), with an active mask."""
    o, d = _rays(m, seed=seed, spread=s["spread"])
    act = None
    if active_frac is not None:
        act = np.random.default_rng(seed + 1).uniform(size=m) < active_frac
    return o, d, act


# (scene, streamed, n_packets, leaf_q, rays, active fraction): 2,560 rays
# leave the last packet half full
JAX_CASES = {
    "resident-p1-q64": ("soup", False, 1, 64, 2560, None),
    "streamed-p2-q2-active": ("soup", True, 2, 2, 2560, 0.6),
    "sphere-resident-p1-q2": ("sphere", False, 1, 2, 2560, None),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_twin_matches_jax_k6(case):
    name, stream, n_packets, leaf_q, m, frac = JAX_CASES[case]
    s = scene(name)
    o, d, act = _wave(s, m, seed=6, active_frac=frac)
    jt = j_k6(s["jw"], t_min=T_MIN, n_packets=n_packets, leaf_q=leaf_q,
              interpret=True, stream_tris=stream)
    want = _jax_payload(jt(
        tuple(jnp.asarray(o[:, i]) for i in range(3)),
        tuple(jnp.asarray(d[:, i]) for i in range(3)), 1e4,
        active=None if act is None else jnp.asarray(act)))
    got = _port_payload(make_packet_trace2(s["dw"], T_MIN, leaf_q=leaf_q)(
        _cols(o), _cols(d), 1e4,
        active=None if act is None else torch.from_numpy(act)))
    same = _same_triangle(got, want)
    print(f"{case}: {int((~same).sum())} of {m} rays on another triangle")
    assert same.mean() >= SAME_TRI, f"same triangle on {same.mean():.4%}"
    hit = same & np.isfinite(want[0])
    assert hit.sum() > 200
    np.testing.assert_array_equal(got[3:, hit], want[3:, hit])
    np.testing.assert_allclose(got[0, hit], want[0, hit], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[1:3, hit], want[1:3, hit], rtol=1e-5,
                               atol=1e-5)
    miss = np.isinf(got[0])
    assert (got[1:, miss] == 0).all()
    if act is not None:
        assert np.isinf(got[0, ~act]).all()


@pytest.mark.parametrize("name", ["soup", "sphere"])
def test_twin_matches_port_brute_and_k3(name):
    """The closest t against the port's brute force (same hit or miss, t
    within float rounding, the triangle's albedo), and the same triangle
    as K3's twin: the two walks differ only in order."""
    s = scene(name)
    o, d, _ = _wave(s, 3000, seed=11)
    rays = ray_planes(_cols(o), _cols(d), 1e4)
    got = packet_trace2_plain(s["dw"], T_MIN, rays)
    tb = s["tb"]
    ref = trace_brute(_cols(o), _cols(d), tb, T_MIN, 1e4)
    fin = torch.isfinite(ref.t)
    assert torch.equal(torch.isfinite(got[0]), fin)
    torch.testing.assert_close(got[0, fin], ref.t[fin], rtol=1e-5, atol=1e-6)
    kd = torch.stack([tb.dr, tb.dg, tb.db], 1)[ref.prim[fin]]
    assert float((got[12:15, fin].T == kd).all(1).float().mean()) >= SAME_TRI
    k3 = packet_trace_plain(s["dw"], T_MIN, rays)
    assert _same_triangle(got.numpy(), k3.numpy()).mean() >= SAME_TRI


def test_twin_honours_tmax_active_and_partial_packets():
    """A per-ray t_max, inactive rays, and waves shorter than one packet
    (the center ray then a padding ray) or ending in a partial one."""
    s = scene("soup")
    o, d, _ = _wave(s, 1500, seed=8)
    trace = make_packet_trace2(s["dw"], T_MIN)
    full = trace(_cols(o), _cols(d), 1e4)
    fin = torch.isfinite(full.t)
    assert fin.sum() > 100
    tmax = torch.where(fin, full.t * 0.99, 1.0)
    assert torch.isinf(trace(_cols(o), _cols(d), tmax).t).all()
    kept = trace(_cols(o), _cols(d), torch.where(fin, full.t * 1.01, 1e4))
    assert torch.equal(kept.t[fin], full.t[fin])
    act = torch.from_numpy(np.random.default_rng(9).uniform(size=1500) > 0.5)
    part = trace(_cols(o), _cols(d), 1e4, active=act)
    assert torch.isinf(part.t[~act]).all()
    assert (torch.stack(part.albedo)[:, ~act] == 0).all()
    same = _same_triangle(_port_payload(part)[:, act.numpy()],
                          _port_payload(full)[:, act.numpy()])
    assert same.mean() >= SAME_TRI
    for m in (300, 1024, 1025):
        short = trace(tuple(c[:m] for c in _cols(o)),
                      tuple(c[:m] for c in _cols(d)), 1e4)
        assert short.t.shape == (m,)
        k3 = packet_trace_plain(s["dw"], T_MIN, ray_planes(
            tuple(c[:m] for c in _cols(o)), tuple(c[:m] for c in _cols(d)),
            1e4))
        assert _same_triangle(_port_payload(short), k3.numpy()).mean() >= SAME_TRI


def test_tiny_leaf_queue_spills_and_agrees():
    """A 2-entry leaf queue drives the spill path (leaf codes on the stack,
    re-enqueued or put back) on every pop; the answer is the same as with
    64 entries, and the pops are counted."""
    s = scene("sphere")
    o, d, _ = _wave(s, 2048, seed=10)
    rays = ray_planes(_cols(o), _cols(d), 1e4)
    c64, c2 = {}, {}
    a = packet_trace2_plain(s["dw"], T_MIN, rays, 64, c64)
    b = packet_trace2_plain(s["dw"], T_MIN, rays, 2, c2)
    assert _same_triangle(a.numpy(), b.numpy()).mean() >= SAME_TRI
    assert c2["spill_pops"] > 0 and c64["spill_pops"] == 0
    for c in (c2, c64):
        assert c["leaf_pops"] > 0
        assert c["node_pops"] >= 2  # two packets pop the root at least
        # one node pop and one leaf pop at most an iteration
        assert c["iterations"] >= max(c["leaf_pops"], c["node_pops"])


def test_cpu_wrapper_runs_twin_and_counts_no_launch():
    s = scene("soup")
    o, d, _ = _wave(s, 700, seed=15)
    rays = ray_planes(_cols(o), _cols(d), 1e4)
    before = packet_trace2.launches
    got = packet_trace2(s["dw"], T_MIN, rays)
    assert got.shape == (19, 700)
    assert torch.equal(got, packet_trace2_plain(s["dw"], T_MIN, rays))
    assert packet_trace2.launches == before


def _meta_wide(rows=4, max_stack=26):
    return DeviceWide(nodes=torch.empty((rows, 128), device="meta"),
                      tris=torch.empty((rows, 128), device="meta"),
                      max_stack=max_stack)


@pytest.mark.parametrize("bad", ["device", "leaf_q", "stack"])
def test_wrapper_refuses_what_the_kernel_cannot_take(bad):
    """A non-CPU, non-CUDA tensor; a leaf queue that is not a power of two
    or beyond the kernel's; a tree whose max_stack + leaf_q exceeds the
    packet stack: each raises before any launch, naming what it needs."""
    rays = torch.empty((7, 16), device="meta")
    if bad == "device":
        with pytest.raises(ValueError, match="CUDA tensor"):
            packet_trace2(_meta_wide(), T_MIN, rays)
    elif bad == "leaf_q":
        for q in (3, 0, 2 * build.MAX_LEAF_Q):
            with pytest.raises(ValueError, match="power of two"):
                packet_trace2(_meta_wide(), T_MIN, rays, leaf_q=q)
            with pytest.raises(ValueError, match="power of two"):
                make_packet_trace2(_meta_wide(), T_MIN, leaf_q=q)
    else:
        big = _meta_wide(max_stack=build.MAX_PACKET_STACK - 63)
        with pytest.raises(ValueError, match="max_stack .* leaf_q 64"):
            packet_trace2(big, T_MIN, rays)


def test_textured_tree_raises_naming_a13():
    """A textured single-level tree goes to the device with its aux rows
    now (K3 and K6 write the texture planes, tests/test_torch_textures.py);
    the textured two-level tree, a route this slice leaves out, still
    raises, naming ROADMAP.md A.13b."""
    from sfvp_tpu_torch.accel.tlas import TwoLevelBVH
    from sfvp_tpu_torch.kernels.bvh_tlas import device_two_level

    rows = np.zeros((1, 128), np.float32)
    w = WideBVH(nodes=rows, tris=rows,
                prim_rows=np.zeros((1, 8), np.int32), max_stack=10,
                tris_aux=np.ones((1, 128), np.float32))
    dw = device_wide(w, "cpu")
    assert dw.n_payload == 22 and torch.equal(dw.tris_aux,
                                              torch.ones((1, 128)))
    tl = TwoLevelBVH(nodes=rows, tris=rows, inst=rows, max_stack=10,
                     num_instances=1, tris_aux=rows)
    with pytest.raises(NotImplementedError, match="A.13b"):
        device_two_level(tl, "cpu")


def _loop_configs(**kw):
    """The same 32x32, 1-spp, depth-2 sphere config in both packages, the
    per-bounce sort off on both (its key tie order is not portable)."""
    base = dict(width=32, height=32, spp_per_step=1, max_depth=2,
                traversal="bvh", megakernel_regen=False,
                sort_bounce_rays=False, sampling="cosine", **kw)
    return [mod.RenderConfig(**base, sky_emission=(0.8, 0.85, 1.0),
                             camera=mod.CameraConfig.look_at(**SPHERE_VIEW))
            for mod in (J, T)]


def test_wavefront_over_k6_matches_jax():
    """The port's wavefront loop over K6's twin (stream_tris=True) against
    sfvp_tpu's over its K6 kernel: one 32x32 tile, so both trace the same
    1024-ray packets."""
    s = scene("sphere")
    jcfg, tcfg = _loop_configs()
    trace = j_k6(s["jw"], t_min=jcfg.t_min, interpret=True, stream_tris=True)
    want = jax.jit(j_make(jcfg, s["jb"], trace_payload_fn=trace))(
        J.init_state(32, 32))
    got = select_render_step(dataclasses.replace(tcfg, stream_tris=True),
                             s["tb"], wide=s["tw"])(T.init_state(32, 32, "cpu"))
    assert_close(got.accum.numpy(), np.asarray(want.accum),
                 "wavefront over K6 vs jax")
    assert float(got.mrays) == float(want.mrays)
    assert float(got.accum.max()) > 0


def test_swizzle_changes_no_pixel(monkeypatch):
    """The pixel-tile swizzle over K3's twin (16-pixel tiles on a 32x64
    image) against no swizzle: bitwise the same image and segments; and it
    engages only when the tile divides both sides. The tile of a 32x32 one
    is K6's packet."""
    assert wavefront.PACKET_TILE ** 2 == bvh_packet2.PACKET
    s = scene("sphere")
    _, cfg = _loop_configs(use_rr=True)
    cfg = dataclasses.replace(cfg, width=64, spp_per_step=2)
    out = {}
    for ts in (16, 0, 24):
        monkeypatch.setattr(wavefront, "PACKET_TILE", ts)
        step = select_render_step(cfg, s["tb"], wide=s["tw"])
        out[ts] = step(T.init_state(32, 64, "cpu"))
    for ts in (0, 24):
        assert torch.equal(out[16].accum, out[ts].accum)
        assert float(out[16].mrays) == float(out[ts].mrays)
    assert float(out[16].accum.max()) > 0


def _fake_wide(nbytes):
    rows = nbytes // (128 * 4)
    return WideBVH(nodes=np.empty((rows // 4, 128), np.float32),
                   tris=np.empty((rows - rows // 4, 128), np.float32),
                   prim_rows=np.empty((1, 8), np.int32), max_stack=10)


def test_stream_decision_equals_jax():
    """sfvp_tpu streams (and takes K6) when the wide BVH's rows exceed its
    vmem_scene_budget; the port decides the same, on byte counts alone:
    the 100k sphere's 10.4 MB tree stays on K3, the 500k sphere's 57.8 MB
    one goes to K6. ``stream_tris`` True or False forces it."""
    budget = J.RenderConfig().vmem_scene_budget
    assert dispatch.STREAM_SCENE_BYTES == budget
    for nbytes in (10_381_824, budget - 512, budget + 512, 57_775_616):
        w = _fake_wide(nbytes)
        size = w.nodes.nbytes + w.tris.nbytes
        want = size > budget
        assert dispatch.stream_tris(T.RenderConfig(), w) == want
        assert dispatch.stream_tris(T.RenderConfig(stream_tris=True), w)
        assert not dispatch.stream_tris(T.RenderConfig(stream_tris=False), w)
        assert (J.RenderConfig(stream_tris=None).stream_tris is None
                and T.RenderConfig().stream_tris is None)


@pytest.mark.parametrize("stream", [True, False])
def test_streamed_route_traces_shadows_through_k6(stream, capsys,
                                                  monkeypatch):
    """Under NEE the streamed route has no any-hit kernel: its shadow rays
    go through K6's payload trace (isfinite(t)), as in sfvp_tpu; the
    resident route takes K3 and K4. Both render the same image up to
    exact ties."""
    from sfvp_tpu_torch.cli import procedural_scene

    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    scn, cfg = procedural_scene("city", 20000, T.RenderConfig(
        width=16, height=16, spp_per_step=1, max_depth=3, sampling="cosine",
        use_rr=True, use_nee=True, use_mis=True, megakernel_regen=False))
    tb = T.upload(scn, device="cpu")
    wide = build_wide_from_buffers(tb)
    calls = {"k6": 0, "k3": 0, "k4": 0}

    def spy(name, real):
        def fn(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return fn

    monkeypatch.setattr(bvh_packet2, "packet_trace2",
                        spy("k6", bvh_packet2.packet_trace2))
    monkeypatch.setattr(bvh_packet, "packet_trace",
                        spy("k3", bvh_packet.packet_trace))
    monkeypatch.setattr(bvh_packet, "packet_occlusion",
                        spy("k4", bvh_packet.packet_occlusion))
    step = select_render_step(dataclasses.replace(cfg, stream_tris=stream),
                              tb, wide=wide)
    assert f"wavefront(packet kernels) stream={stream}" in capsys.readouterr().err
    img = step(T.init_state(16, 16, "cpu"))
    # one payload trace and one shadow trace a bounce
    if stream:
        assert calls == {"k6": 2 * cfg.max_depth, "k3": 0, "k4": 0}
    else:
        assert calls == {"k6": 0, "k3": cfg.max_depth, "k4": cfg.max_depth}
    assert float(img.accum.max()) > 0
    other = select_render_step(dataclasses.replace(cfg, stream_tris=not stream),
                               tb, wide=wide)(T.init_state(16, 16, "cpu"))
    assert_close(img.accum.numpy(), other.accum.numpy(),
                 f"stream={stream} vs stream={not stream}")


def _cuda_scene(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    return scene(name)


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_q", [64, 2])
@pytest.mark.parametrize("name", ["soup", "sphere"])
def test_cuda_kernel_matches_twin(name, leaf_q):
    s = _cuda_scene(name)
    o, d, act = _wave(s, 5000, seed=16, active_frac=0.8)
    dw = device_wide(s["tw"], "cuda")
    rays = ray_planes(_cols(o), _cols(d), 1e4,
                      torch.from_numpy(act)).cuda()
    got = packet_trace2(dw, T_MIN, rays, leaf_q).cpu()
    want = packet_trace2_plain(s["dw"], T_MIN, rays.cpu(), leaf_q)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_wrapper_counts_launches():
    s = _cuda_scene("soup")
    o, d, _ = _wave(s, 300, seed=17)
    rays = ray_planes(_cols(o), _cols(d), 1e4).cuda()
    before = packet_trace2.launches
    packet_trace2(device_wide(s["tw"], "cuda"), T_MIN, rays)
    torch.cuda.synchronize()
    assert packet_trace2.launches == before + 1


def test_streamed_route_sorts_bounce_rays_as_jax(monkeypatch):
    """On the streamed route both packages sort the bounce rays by
    default, so K6's 1024-ray packets hold the same rays: at a 32x32, 2-spp,
    depth-3 wavefront step over K6 (sfvp_tpu's in interpret mode), every
    bounce wave reaches the payload trace in the same order (the same
    active mask bitwise, each slot's ray within float rounding), and the
    images agree."""
    s = scene("sphere")
    base = dict(width=32, height=32, spp_per_step=2, max_depth=3,
                traversal="bvh", megakernel_regen=False, sampling="cosine")
    jcfg, tcfg = (mod.RenderConfig(**base, sky_emission=(0.8, 0.85, 1.0),
                                   camera=mod.CameraConfig.look_at(
                                       **SPHERE_VIEW)) for mod in (J, T))
    assert jcfg.sort_bounce_rays and tcfg.sort_bounce_rays is None
    jrec, trec = [], []
    jk6 = j_k6(s["jw"], t_min=jcfg.t_min, interpret=True, stream_tris=True)

    def jtrace(o, d, t_max, active=None):
        jax.debug.callback(
            lambda *a: jrec.append([np.asarray(x) for x in a]), *o, active,
            ordered=True)
        return jk6(o, d, t_max, active=active)

    want = jax.jit(j_make(jcfg, s["jb"], trace_payload_fn=jtrace))(
        J.init_state(32, 32))
    make = bvh_packet2.make_packet_trace2

    def spy(dw, t_min, **kw):
        trace = make(dw, t_min, **kw)

        def traced(o, d, t_max, active=None):
            trec.append([c.numpy().copy() for c in (*o, active)])
            return trace(o, d, t_max, active=active)

        return traced

    monkeypatch.setattr(bvh_packet2, "make_packet_trace2", spy)
    got = select_render_step(dataclasses.replace(tcfg, stream_tris=True),
                             s["tb"], wide=s["tw"])(T.init_state(32, 32, "cpu"))
    assert len(trec) == len(jrec) == 2 * 3
    for k, (a, b) in enumerate(zip(trec, jrec)):
        np.testing.assert_array_equal(a[3], b[3], err_msg=f"wave {k}")
        act = a[3]
        for c in range(3):
            np.testing.assert_allclose(a[c][act], b[c][act], rtol=0,
                                       atol=1e-4, err_msg=f"wave {k}")
    assert not all(np.array_equal(trec[1][c], trec[0][c]) for c in range(3))
    assert_close(got.accum.numpy(), np.asarray(want.accum),
                 "sorted wavefront over K6 vs jax")

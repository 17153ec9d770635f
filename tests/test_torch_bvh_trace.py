"""K3's plain twin (kernels/bvh_packet.py packet_trace_plain) and the
port's threaded-BVH oracle (kernels/bvh_traverse.py) against sfvp_tpu:
its K3 Pallas kernel make_packet_trace in interpret mode (as
tests/test_bvh_packet.py runs it), its make_trace_bvh_jnp and its brute
force. Random rays from numpy seeds go to both packages over the same
wide-BVH arrays.

Bounds: the same triangle on at least 99.9% of the rays (only exact ties
in t may pick another, and the port's per-ray walk and the JAX packet
walk visit leaves in different orders); where the triangle is the same,
every payload lane that comes from the triangle row is equal, and t, u, v
agree to float32 rounding (XLA on the CPU may fuse the multiply-adds that
the port keeps apart).

The ``cuda`` tests hold the CUDA kernel against its twin and skip without
a card; chip_smoke.py runs the same comparison on the H100.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.accel.lbvh import bvh_from_arrays as j_lbvh  # noqa: E402
from sfvp_tpu.accel.sah import sah_bvh_from_arrays as j_sah  # noqa: E402
from sfvp_tpu.accel.wide import build_wide as j_build_wide  # noqa: E402
from sfvp_tpu.accel.wide import materials_array as j_materials  # noqa: E402
from sfvp_tpu.kernels.bvh_packet import make_packet_trace as j_packet  # noqa: E402
from sfvp_tpu.kernels.bvh_traverse import make_trace_bvh_jnp  # noqa: E402
from sfvp_tpu.kernels.intersect import trace_brute_jnp  # noqa: E402
from sfvp_tpu.scene import procedural as j_proc  # noqa: E402

from sfvp_tpu_torch.accel.lbvh import bvh_from_arrays  # noqa: E402
from sfvp_tpu_torch.accel.wide import WideBVH, build_wide_from_buffers  # noqa: E402
from sfvp_tpu_torch.kernels import build  # noqa: E402
from sfvp_tpu_torch.kernels.bvh_packet import (  # noqa: E402
    N_PAYLOAD,
    DeviceWide,
    device_wide,
    make_packet_occlusion,
    make_packet_trace,
    packet_trace,
    packet_trace_plain,
    ray_planes,
)
from sfvp_tpu_torch.kernels.bvh_traverse import make_trace_bvh  # noqa: E402
from sfvp_tpu_torch.kernels.intersect import trace_brute  # noqa: E402
from sfvp_tpu_torch.scene.buffers import FIELDS, from_numpy  # noqa: E402

T_MIN = 1e-3
SAME_TRI = 0.999


def _soup(n, seed):
    """A random triangle soup with random albedo and emission (JAX
    buffers, port buffers, the (n, 3, 3) triangles)."""
    g = np.random.default_rng(seed)
    tris = (g.uniform(-5, 5, (n, 1, 3))
            + g.normal(0, 0.8, (n, 3, 3))).astype(np.float32)
    kd = g.uniform(0, 1, (n, 3)).astype(np.float32)
    ke = g.uniform(0, 1, (n, 3)).astype(np.float32)
    return tris, J.scene.buffers.from_arrays(tris, kd, ke)


def _sphere():
    s = j_proc.sphere_mesh(12, 12, bump=0.3)
    return np.asarray(s.triangles(), np.float32), J.upload(s)


SCENES = {"soup": lambda: _soup(200, seed=3), "sphere": _sphere}


def _rays(m, seed, spread):
    g = np.random.default_rng(seed)
    o = g.uniform(-spread, spread, (m, 3)).astype(np.float32)
    d = g.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _port(jb):
    return from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS},
                      jb.num_tris, "cpu")


def _cols(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                 for i in range(3))


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    tris, jb = SCENES[request.param]()
    tb = _port(jb)
    jw = j_build_wide(j_sah(tris, leaf_size=8, native="never"),
                      j_materials(jb))
    tw = build_wide_from_buffers(tb, builder="sah")
    assert np.array_equal(jw.nodes, tw.nodes)
    return dict(tris=tris, jb=jb, tb=tb, jw=jw, tw=tw,
                spread=2.0 if request.param == "sphere" else 6.0)


def _jax_payload(pay):
    return np.stack([np.asarray(x) for x in (
        pay.t, pay.u, pay.v, *pay.p0, *pay.p1, *pay.p2, *pay.albedo,
        *pay.emission, pay.mtype)])


def _port_payload(pay):
    return torch.stack([pay.t, pay.u, pay.v, *pay.p0, *pay.p1, *pay.p2,
                        *pay.albedo, *pay.emission, pay.mtype]).numpy()


def _same_triangle(a, b):
    """Rays whose two payloads name the same triangle (or both miss)."""
    miss_a, miss_b = np.isinf(a[0]), np.isinf(b[0])
    same_row = (a[3:] == b[3:]).all(0)
    return (miss_a & miss_b) | (~miss_a & ~miss_b & same_row)


def test_twin_matches_jax_packet_kernel(scene):
    o, d = _rays(512, seed=6, spread=scene["spread"])
    jt = j_packet(scene["jw"], t_min=T_MIN, interpret=True)
    want = _jax_payload(jt((jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]),
                            jnp.asarray(o[:, 2])),
                           (jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]),
                            jnp.asarray(d[:, 2])), 1e4))
    got = _port_payload(make_packet_trace(device_wide(scene["tw"], "cpu"),
                                          T_MIN)(
        _cols(o), _cols(d), 1e4))
    same = _same_triangle(got, want)
    assert same.mean() >= SAME_TRI, f"same triangle on {same.mean():.4%}"
    hit = same & np.isfinite(want[0])
    assert hit.sum() > 50
    np.testing.assert_array_equal(got[3:, hit], want[3:, hit])
    np.testing.assert_allclose(got[:3, hit], want[:3, hit], rtol=1e-5,
                               atol=1e-6)
    miss = np.isinf(got[0])
    assert (got[1:, miss] == 0).all()


def test_twin_matches_jax_brute_and_threaded_bvh(scene):
    """Closest t against sfvp_tpu's brute force and threaded-BVH trace, and
    the hit triangle's albedo against the scene's."""
    o, d = _rays(2048, seed=11, spread=scene["spread"])
    jb = scene["jb"]
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    brute = trace_brute_jnp(jo, jd, jb, T_MIN, 1e4)
    threaded = make_trace_bvh_jnp(j_lbvh(scene["tris"], leaf_size=4))(
        jo, jd, jb, T_MIN, 1e4)
    got = packet_trace_plain(
        device_wide(scene["tw"], "cpu"), T_MIN,
        ray_planes(_cols(o), _cols(d), 1e4)).numpy()
    for ref in (brute, threaded):
        bt, prim = np.asarray(ref.t), np.asarray(ref.prim)
        np.testing.assert_array_equal(np.isinf(got[0]), np.isinf(bt))
        fin = np.isfinite(bt)
        np.testing.assert_allclose(got[0, fin], bt[fin], rtol=1e-5,
                                   atol=1e-6)
        kd = np.stack([np.asarray(jb.dr), np.asarray(jb.dg),
                       np.asarray(jb.db)], 1)[prim[fin]]
        agree = (got[12:15, fin].T == kd).all(1).mean()
        assert agree >= SAME_TRI


def test_port_threaded_bvh_matches_port_brute(scene):
    """kernels/bvh_traverse.py, the port's independent oracle, against the
    port's brute force: the same triangle and t."""
    o, d = _rays(1024, seed=12, spread=scene["spread"])
    tb = scene["tb"]
    act = torch.from_numpy(np.random.default_rng(2).uniform(size=1024) > 0.2)
    ref = trace_brute(_cols(o), _cols(d), tb, T_MIN, 1e4, active=act)
    hit = make_trace_bvh(bvh_from_arrays(scene["tris"], leaf_size=4),
                         "cpu")(
        _cols(o), _cols(d), tb, T_MIN, 1e4, active=act)
    assert torch.equal(hit.prim, ref.prim)
    fin = torch.isfinite(ref.t)
    assert torch.equal(torch.isfinite(hit.t), fin)
    torch.testing.assert_close(hit.t[fin], ref.t[fin], rtol=1e-6, atol=0)
    assert not torch.isfinite(hit.t[~act]).any()


def test_twin_matches_port_threaded_bvh(scene):
    o, d = _rays(1024, seed=13, spread=scene["spread"])
    tb = scene["tb"]
    ref = make_trace_bvh(bvh_from_arrays(scene["tris"], leaf_size=4),
                         "cpu")(
        _cols(o), _cols(d), tb, T_MIN, 1e4)
    got = packet_trace_plain(device_wide(scene["tw"], "cpu"), T_MIN,
                             ray_planes(_cols(o), _cols(d), 1e4))
    fin = torch.isfinite(ref.t)
    assert torch.equal(torch.isfinite(got[0]), fin)
    assert torch.equal(got[0][fin], ref.t[fin])
    prim = ref.prim[fin]
    kd = torch.stack([tb.dr, tb.dg, tb.db], 1)[prim]
    assert float((got[12:15, fin].T == kd).all(1).float().mean()) >= SAME_TRI


def test_twin_honours_tmax_and_active(scene):
    o, d = _rays(512, seed=8, spread=scene["spread"])
    dw = device_wide(scene["tw"], "cpu")
    trace = make_packet_trace(dw, T_MIN)
    full = trace(_cols(o), _cols(d), 1e4)
    fin = torch.isfinite(full.t)
    assert fin.sum() > 50
    # a per-ray t_max just below each hit: everything misses
    tmax = torch.where(fin, full.t * 0.99, 1.0)
    assert torch.isinf(trace(_cols(o), _cols(d), tmax).t).all()
    # a t_max just above each hit keeps the hit
    kept = trace(_cols(o), _cols(d), torch.where(fin, full.t * 1.01, 1e4))
    assert torch.equal(kept.t[fin], full.t[fin])
    # inactive rays report a miss with zero payload; active ones are as if
    # alone
    act = torch.from_numpy(np.random.default_rng(9).uniform(size=512) > 0.5)
    part = trace(_cols(o), _cols(d), 1e4, active=act)
    assert torch.isinf(part.t[~act]).all()
    assert (torch.stack(part.albedo)[:, ~act] == 0).all()
    assert torch.equal(part.t[act], full.t[act])
    assert torch.isinf(trace(_cols(o), _cols(d), 1e4,
                             active=torch.zeros(512, dtype=torch.bool)).t).all()


def test_twin_counts_pops(scene):
    o, d = _rays(256, seed=14, spread=scene["spread"])
    counts = {}
    packet_trace_plain(device_wide(scene["tw"], "cpu"), T_MIN,
                       ray_planes(_cols(o), _cols(d), 1e4), counts)
    # every ray pops the root; a hit needs a leaf pop
    assert counts["node_pops"] >= 256
    assert counts["leaf_pops"] > 0


def test_cpu_wrapper_runs_twin_and_counts_no_launch(scene):
    dw = device_wide(scene["tw"], "cpu")
    o, d = _rays(128, seed=15, spread=scene["spread"])
    rays = ray_planes(_cols(o), _cols(d), 1e4)
    before = packet_trace.launches
    got = packet_trace(dw, T_MIN, rays)
    assert got.shape == (N_PAYLOAD, 128)
    assert torch.equal(got, packet_trace_plain(dw, T_MIN, rays))
    assert packet_trace.launches == before


def _meta_wide(rows=4, max_stack=26):
    return DeviceWide(nodes=torch.empty((rows, 128), device="meta"),
                      tris=torch.empty((rows, 128), device="meta"),
                      max_stack=max_stack)


def test_non_cpu_non_cuda_tensor_is_refused():
    rays = torch.empty((7, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        packet_trace(_meta_wide(), T_MIN, rays)


def test_oversized_stack_raises():
    """A tree deeper than the kernels' stack raises; it is never cut."""
    rays = torch.empty((7, 16), device="meta")
    with pytest.raises(ValueError, match="max_stack"):
        packet_trace(_meta_wide(max_stack=build.MAX_WIDE_STACK + 1), T_MIN,
                     rays)


def test_too_many_rows_raise():
    """Child refs are float32 in the rows: 2**24 rows or more raise."""
    big = np.empty((build.MAX_WIDE_ROWS, 0), np.float32)
    w = WideBVH(nodes=big, tris=np.empty((1, 128), np.float32),
                prim_rows=np.empty((1, 8), np.int32), max_stack=10)
    with pytest.raises(ValueError, match="2\\*\\*24|float32"):
        device_wide(w, "cpu")
    rays = torch.empty((7, 16), device="meta")
    with pytest.raises(ValueError, match="rows"):
        packet_trace(_meta_wide(rows=build.MAX_WIDE_ROWS), T_MIN, rays)


def test_bad_ray_planes_raise():
    with pytest.raises(ValueError, match="7, N"):
        packet_trace(_meta_wide(), T_MIN, torch.empty((6, 16), device="meta"))


def test_oversized_wave_raises():
    """The kernel takes its ray count as a C int: a wave of 2**31 rays or
    more raises before anything is launched."""
    rays = torch.empty((7, build.MAX_WAVE_RAYS), device="meta")
    with pytest.raises(ValueError, match="fewer than"):
        build.launch_bvh_trace(None, rays)


def test_occlusion_raises_naming_nee():
    """K4 is ported (tests/test_torch_occlusion.py): its wrapper no longer
    refuses, and like K3's refuses a tensor it cannot take before any
    launch, naming what it needs."""
    occluded = make_packet_occlusion(_meta_wide(), T_MIN)
    o = tuple(torch.empty(16, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        occluded(o, o, torch.empty(16, device="meta"))


def test_wide_params_layout():
    """The ctypes mirror of sfvp::Wide (csrc/wide_bvh.cuh): two pointers,
    three ints, two floats, then the pointer to a textured tree's aux rows
    from an 8-byte boundary."""
    import ctypes

    assert [f for f, _ in build.WideParams._fields_] == [
        "nodes", "tris", "n_nodes", "n_leaf_rows", "max_stack", "t_min",
        "det_eps", "aux"]
    assert build.WideParams.n_nodes.offset == 16
    assert build.WideParams.t_min.offset == 28
    assert build.WideParams.aux.offset == 40
    assert ctypes.sizeof(build.WideParams) == 48


@pytest.mark.cuda
def test_cuda_kernel_matches_twin(scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    o, d = _rays(4096, seed=16, spread=scene["spread"])
    dw = device_wide(scene["tw"], "cuda")
    rays = ray_planes(_cols(o), _cols(d), 1e4).cuda()
    got = packet_trace(dw, T_MIN, rays).cpu().numpy()
    want = packet_trace_plain(device_wide(scene["tw"], "cpu"), T_MIN,
                              rays.cpu()).numpy()
    assert _same_triangle(got, want).mean() >= 0.9999

"""P1, the stripped packet walk (kernels/stripped_trace.py), against the
TPU probe itself: benchmarks/probe_carry.py ``make_stripped_trace``,
imported by path and run unedited under
``jax.experimental.pallas.tpu.force_tpu_interpret_mode()`` on the CPU, on
the same numpy rays and the same wide tree (the port's SAH tree equals
sfvp_tpu's byte for byte, asserted here as in tests/test_torch_bvh_build.py).

For each of the six variants, on a wave of two full packets and on a wave
with a partial last packet and inactive rays: the per-packet iteration
counts equal, hit or miss equal on every ray, t within rtol 1e-5 and atol
1e-6 on hits (the bound tests/test_torch_bvh_trace.py:138-140 holds K3 to:
XLA may fuse a multiply-add on the CPU). The probe returns t and the counts
only, so u and v are held to the port's K3 twin, bit for bit, on the rays
whose triangle is K3's.

The ``cuda`` test holds the kernel against its twin and skips without a
card; chip_smoke.py runs the same comparison on the H100.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.accel.sah import sah_bvh_from_arrays as j_sah  # noqa: E402
from sfvp_tpu.accel.wide import build_wide as j_build_wide  # noqa: E402
from sfvp_tpu.accel.wide import materials_array as j_materials  # noqa: E402
from sfvp_tpu.scene import procedural as j_proc  # noqa: E402

from sfvp_tpu_torch.accel.wide import build_wide_from_buffers  # noqa: E402
from sfvp_tpu_torch.kernels import stripped_trace as st  # noqa: E402
from sfvp_tpu_torch.kernels.bvh_packet import (  # noqa: E402
    device_wide,
    packet_trace_plain,
    ray_planes,
)
from sfvp_tpu_torch.scene.buffers import FIELDS, from_numpy  # noqa: E402

T_MIN, T_MAX = 1e-3, 1e4
PROBE = Path(__file__).resolve().parents[1] / "benchmarks" / "probe_carry.py"
# (rays, share of inactive rays): 2,048 rays are two full packets; 2,648
# leave the last packet with 600 rays, its center ray a padding ray
WAVES = {"two_packets": (2048, None), "partial_inactive": (2648, 0.3)}
SAME_TRI = 0.999

_CACHE = {}


def probe_carry():
    if "probe" not in _CACHE:
        spec = importlib.util.spec_from_file_location("probe_carry", PROBE)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _CACHE["probe"] = mod
    return _CACHE["probe"]


def tree():
    """The bumpy 16 x 16 sphere's SAH wide BVH, from both packages."""
    if "tree" not in _CACHE:
        s = j_proc.sphere_mesh(16, 16, bump=0.3)
        jb = J.upload(s)
        tris = np.asarray(s.triangles(), np.float32)
        jw = j_build_wide(j_sah(tris, leaf_size=8, native="never"),
                          j_materials(jb))
        tb = from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS},
                        jb.num_tris, "cpu")
        tw = build_wide_from_buffers(tb, builder="sah")
        assert np.array_equal(jw.nodes, tw.nodes)
        assert np.array_equal(jw.tris, tw.tris)
        assert jw.max_stack == tw.max_stack
        _CACHE["tree"] = (jw, device_wide(tw, "cpu"))
    return _CACHE["tree"]


def wave(name):
    """Camera-like rays from one eye toward a grid over the sphere, rows of
    the grid in order (a packet is a band of it), some missing it; with an
    active mask where the wave has one."""
    m, inactive = WAVES[name]
    g = np.random.default_rng(len(name))
    cols = 64
    k = np.arange(m)
    x = (k % cols) / (cols - 1) * 2.6 - 1.3
    y = 1.3 - (k // cols) / (m // cols) * 2.6
    tgt = np.stack([x, y, np.zeros(m)]) + g.normal(0.0, 0.01, (3, m))
    o = np.array([[0.1], [0.4], [3.0]]) + g.normal(0.0, 0.02, (3, m))
    d = tgt - o
    d /= np.linalg.norm(d, axis=0)
    act = None if inactive is None else g.uniform(size=m) >= inactive
    return o.astype(np.float32), d.astype(np.float32), act


def jax_trace(variant, name):
    key = (variant, name)
    if key not in _CACHE:
        jw, _ = tree()
        o, d, act = wave(name)
        kw = {f: True for f in st.VARIANTS[variant]}
        trace = probe_carry().make_stripped_trace(jw, T_MIN, **kw)
        with pltpu.force_tpu_interpret_mode():
            t, cnt = trace(tuple(jax.numpy.asarray(c) for c in o),
                           tuple(jax.numpy.asarray(c) for c in d), T_MAX,
                           None if act is None else jax.numpy.asarray(act))
        _CACHE[key] = (np.asarray(t), np.asarray(cnt).astype(np.int64))
    return _CACHE[key]


def port_rays(name):
    o, d, act = wave(name)
    return ray_planes(tuple(torch.from_numpy(c) for c in o),
                      tuple(torch.from_numpy(c) for c in d), T_MAX,
                      None if act is None else torch.from_numpy(act))


@pytest.mark.parametrize("name", sorted(WAVES))
@pytest.mark.parametrize("variant", list(st.VARIANTS))
def test_torch_stripped_twin_is_the_tpu_probe(variant, name):
    _, dw = tree()
    rays = port_rays(name)
    hits = {}
    out, cnt = st.stripped_trace_plain(dw, T_MIN, rays, variant, hits=hits)
    # the CPU wrapper is the twin
    w_out, w_cnt = st.stripped_trace(dw, T_MIN, rays, variant)
    assert torch.equal(w_out, out) and torch.equal(w_cnt, cnt)
    jt, jcnt = jax_trace(variant, name)
    n = rays.shape[1]
    assert out.shape == (3, n) and cnt.dtype == torch.int32
    assert cnt.tolist() == jcnt.tolist(), (cnt.tolist(), jcnt.tolist())
    t = out[0].numpy()
    assert np.array_equal(np.isfinite(t), np.isfinite(jt))
    hit = np.isfinite(jt)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=1e-6)
    if variant == "no_leaf":
        assert not hit.any() and (out[1:] == 0).all()
        return
    assert hit.sum() > n // 3 and (~hit).sum() > 0
    # u and v against K3's twin where the triangle is K3's
    k3 = packet_trace_plain(dw, T_MIN, rays)
    row, slot = hits["row"], hits["slot"]
    lanes = 16 * slot.clamp_min(0)[:, None] + torch.arange(16)
    mine = torch.gather(dw.tris[row.clamp_min(0)], 1, lanes).T
    both_miss = (row < 0) & torch.isinf(k3[0])
    same = both_miss | ((row >= 0) & (mine == k3[3:]).all(0))
    print(f"{variant} {name}: counts {cnt.tolist()}, {int(hit.sum())} hits,"
          f" same triangle as K3 on {float(same.float().mean()):.5f}")
    assert float(same.float().mean()) >= SAME_TRI
    assert torch.equal(out[:, same], k3[:3, same])


def test_torch_stripped_counts_follow_the_variants():
    """What the variants change, on the two-packet wave: packed pushes
    what stripped pushes in the same order (the same t and counts);
    packed_center and no_sortnet find the same hits in another order;
    pushall_center pops every row of the tree once, whatever the rays;
    no_leaf never prunes, so it pops at least what stripped pops."""
    _, dw = tree()
    rays = port_rays("two_packets")
    run = {v: st.stripped_trace_plain(dw, T_MIN, rays, v)
           for v in st.VARIANTS}
    assert torch.equal(run["packed"][0], run["stripped"][0])
    assert torch.equal(run["packed"][1], run["stripped"][1])
    whole = dw.nodes.shape[0] + dw.tris.shape[0]
    assert run["pushall_center"][1].tolist() == [whole, whole]
    assert (run["stripped"][1] < whole).all()
    assert (run["no_leaf"][1] >= run["stripped"][1]).all()
    for v in ("packed_center", "no_sortnet"):
        assert torch.equal(torch.isinf(run[v][0][0]),
                           torch.isinf(run["stripped"][0][0]))


def test_torch_stripped_refuses_bad_arguments():
    _, dw = tree()
    rays = port_rays("two_packets")
    with pytest.raises(ValueError, match="pushall_center"):
        st.stripped_trace(dw, T_MIN, rays, "ring")
    with pytest.raises(ValueError, match="t_min must be > 0"):
        st.stripped_trace(dw, 0.0, rays)
    assert st.variant_of({"no_leaf"}) == "no_leaf"
    with pytest.raises(ValueError, match="no variant"):
        st.variant_of({"push_all"})
    with pytest.raises(ValueError, match="CUDA tensor"):
        st.stripped_trace(dw._replace(nodes=dw.nodes.to("meta")), T_MIN,
                          rays.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(st.VARIANTS))
def test_cuda_stripped_trace_matches_twin(variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    _, dw = tree()
    dwc = dw._replace(nodes=dw.nodes.cuda(), tris=dw.tris.cuda())
    for name in sorted(WAVES):
        rays = port_rays(name)
        out, cnt = st.stripped_trace(dwc, T_MIN, rays.cuda(), variant)
        exp, ecnt = st.stripped_trace_plain(dwc, T_MIN, rays.cuda(), variant)
        assert torch.equal(out, exp) and torch.equal(cnt, ecnt)

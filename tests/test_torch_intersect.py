"""Brute-force closest hit of the PyTorch port against sfvp_tpu's
trace_brute_jnp on the same numpy rays: primitive ids equal, t within
rtol 1e-6 plus atol 1e-7. XLA-CPU may fuse a multiply-add where eager torch
rounds twice, and t = dot(e2, qv) / det cancels digits when the origin lies
near the hit triangle, so a short t can be off by ~1e-7 absolute (one ulp
at the scene's unit scale): measured 3 of 4000 rays, at most 7.5e-8."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.kernels.intersect import (  # noqa: E402
    moller_trumbore_soa as j_mt,
    trace_brute_jnp,
)

from sfvp_tpu_torch.kernels.intersect import (  # noqa: E402
    moller_trumbore_soa as t_mt,
    trace_brute,
)
from sfvp_tpu_torch.scene.buffers import FIELDS, from_numpy  # noqa: E402


@pytest.fixture(scope="module")
def buffers():
    jb = J.upload(J.load_obj(native="never"), pad_to=40)
    tb = from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS},
                    jb.num_tris, "cpu")
    return jb, tb


def _rays(seed, n, target=None):
    """Origins inside the box (a quarter at the camera), aimed at random
    points of the box or at ``target`` (n, 3)."""
    g = np.random.default_rng(seed)
    o = np.stack([g.uniform(-0.9, 0.9, n), g.uniform(-1.9, -0.1, n),
                  g.uniform(-0.9, 0.9, n)], axis=1)
    o[: n // 4] = [0.0, -1.0, 5.0]
    if target is None:
        target = np.stack([g.uniform(-1.2, 1.2, n), g.uniform(-2.2, 0.2, n),
                           g.uniform(-1.2, 1.2, n)], axis=1)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tuple(o[:, i].astype(np.float32) for i in range(3)), tuple(
        d[:, i].astype(np.float32) for i in range(3))


@pytest.mark.parametrize("masked", [False, True])
def test_trace_brute_matches(buffers, masked):
    jb, tb = buffers
    o, d = _rays(7, 4000)
    active = np.random.default_rng(8).random(4000) < 0.8 if masked else None
    jh = trace_brute_jnp(tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)),
                         jb, np.float32(0.001), np.float32(10000.0),
                         active=None if active is None else jnp.asarray(active))
    th = trace_brute(tuple(map(torch.from_numpy, o)),
                     tuple(map(torch.from_numpy, d)), tb, 0.001, 10000.0,
                     active=None if active is None else torch.from_numpy(active))
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    hit = th.prim.numpy() >= 0
    assert hit.mean() > 0.5
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-6,
                               atol=1e-7, err_msg="t beyond rtol 1e-6 + 1e-7")
    # barycentrics lie in [0, 1] and cancel the same way (measured up to
    # 1.1e-6); they only place the hit point
    np.testing.assert_allclose(th.u.numpy()[hit], np.asarray(jh.u)[hit],
                               atol=4e-6)
    np.testing.assert_allclose(th.v.numpy()[hit], np.asarray(jh.v)[hit],
                               atol=4e-6)


def test_moller_trumbore_elementwise():
    g = np.random.default_rng(9)
    n = 5000
    corners = g.uniform(-1, 1, (3, n, 3)).astype(np.float32)
    aim = corners.mean(axis=0) + g.normal(0.0, 0.3, (n, 3))
    o, d = _rays(10, n, target=aim)
    tri = [tuple(c[:, i] for i in range(3)) for c in corners]
    jv, jt, ju, jw = j_mt(tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)),
                          *[tuple(map(jnp.asarray, p)) for p in tri],
                          np.float32(0.001), np.float32(10000.0))
    tv, tt, tu, tw = t_mt(tuple(map(torch.from_numpy, o)),
                          tuple(map(torch.from_numpy, d)),
                          *[tuple(map(torch.from_numpy, p)) for p in tri],
                          0.001, 10000.0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ok = tv.numpy()
    assert ok.sum() > 100
    np.testing.assert_allclose(tt.numpy()[ok], np.asarray(jt)[ok],
                               rtol=1e-6, atol=1e-7)
    for got, exp in ((tu, ju), (tw, jw)):
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(exp)[ok],
                                   atol=4e-6)


def test_equal_distance_picks_lowest_id():
    """Two copies of one triangle: the closest hit is the first copy, as
    the JAX package's sequential strict ``t < best`` scan keeps it."""
    from sfvp_tpu_torch.scene.buffers import from_arrays

    tri = np.asarray([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32)
    sb = from_arrays(np.concatenate([tri, tri, tri]), np.ones((3, 3)),
                     np.zeros((3, 3)), device="cpu")
    o = tuple(torch.tensor([v], dtype=torch.float32) for v in (0.0, 0.0, 2.0))
    d = tuple(torch.tensor([v], dtype=torch.float32) for v in (0.0, 0.0, -1.0))
    h = trace_brute(o, d, sb, 0.001, 100.0)
    assert h.prim.item() == 0 and h.t.item() == 2.0

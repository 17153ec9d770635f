"""Camera rays and hemisphere sampling of the PyTorch port against
sfvp_tpu on the same numpy inputs.

Tolerance: 4 ulp. torch-CPU and XLA-CPU round sqrt, rsqrt, cos and sin
differently in the last bits (up to 2 ulp each), so bitwise equality is not
expected. The ulp is taken at max(|value|, 1): the components of a unit
vector are measured in ulps of the vector's length, so a component near 0
is not held to the ulp of its own tiny magnitude.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from sfvp_tpu import camera as jcam, sampling as jsam  # noqa: E402
from sfvp_tpu.config import CameraConfig as JCam  # noqa: E402

from sfvp_tpu_torch import camera as tcam, sampling as tsam  # noqa: E402
from sfvp_tpu_torch.config import CameraConfig as TCam  # noqa: E402

ULP = 4


def _close(got, exp, what):
    got = np.asarray(got, np.float32)
    exp = np.asarray(exp, np.float32)
    tol = ULP * np.spacing(np.maximum(np.abs(exp), np.float32(1.0)))
    bad = np.abs(got - exp) > tol
    assert not bad.any(), (
        f"{what}: {bad.sum()} values beyond {ULP} ulp, max diff "
        f"{np.abs(got - exp).max()}")


def _u01(g, n):
    r = g.random(n, dtype=np.float32)
    r[:4] = [0.0, 1.0, 0.5, np.float32(1.0) - np.float32(2.0**-24)]
    return r


def _normals(g, n):
    v = g.normal(size=(n, 3))
    v[:6] = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, -1, 0], [-1, 0, 0],
             [0.6, 0.6, 0.0]]
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    return tuple(v[:, i].copy() for i in range(3))


@pytest.mark.parametrize("cam", ["reference", "look_at"])
def test_generate_rays(cam):
    g = np.random.default_rng(0)
    w, h = 64, 48
    px = g.integers(0, w, 2000).astype(np.int32)
    py = g.integers(0, h, 2000).astype(np.int32)
    r1, r2 = _u01(g, 2000), _u01(g, 2000)
    if cam == "look_at":
        kw = dict(origin=(0.3, 2.2, 5.0), target=(0.0, 0.1, 0.0),
                  fov_y_deg=50.0, aspect=4 / 3)
        jc, tc = JCam.look_at(**kw), TCam.look_at(**kw)
    else:
        jc, tc = JCam(), TCam()
    jo, jd = jcam.generate_rays_soa(jnp.asarray(px), jnp.asarray(py),
                                    jnp.asarray(r1), jnp.asarray(r2), jc, w, h)
    to, td = tcam.generate_rays_soa(torch.from_numpy(px), torch.from_numpy(py),
                                    torch.from_numpy(r1), torch.from_numpy(r2),
                                    tc, w, h)
    for a in range(3):
        np.testing.assert_array_equal(to[a].numpy(), np.asarray(jo[a]))
        _close(td[a].numpy(), jd[a], f"direction[{a}]")


def test_coordinate_system():
    n = _normals(np.random.default_rng(1), 3000)
    jt, jb = jsam.coordinate_system_soa(tuple(jnp.asarray(c) for c in n))
    tt, tb = tsam.coordinate_system_soa(tuple(torch.from_numpy(c) for c in n))
    for a in range(3):
        _close(tt[a].numpy(), jt[a], f"tangent[{a}]")
        _close(tb[a].numpy(), jb[a], f"bitangent[{a}]")


@pytest.mark.parametrize("kind", ["uniform", "cosine"])
def test_hemisphere_local(kind):
    g = np.random.default_rng(2)
    r1, r2 = _u01(g, 4000), _u01(g, 4000)
    jf = getattr(jsam, f"hemisphere_{kind}_local")
    tf = getattr(tsam, f"hemisphere_{kind}_local")
    got = tf(torch.from_numpy(r1), torch.from_numpy(r2))
    exp = jf(jnp.asarray(r1), jnp.asarray(r2))
    for a in range(3):
        _close(got[a].numpy(), exp[a], f"{kind} local[{a}]")


@pytest.mark.parametrize("kind", ["uniform", "cosine"])
def test_sample_direction(kind):
    g = np.random.default_rng(3)
    r1, r2 = _u01(g, 3000), _u01(g, 3000)
    n = _normals(g, 3000)
    jf = getattr(jsam, f"sample_direction_{kind}_soa")
    tf = getattr(tsam, f"sample_direction_{kind}_soa")
    got = tf(torch.from_numpy(r1), torch.from_numpy(r2),
             tuple(torch.from_numpy(c) for c in n))
    exp = jf(jnp.asarray(r1), jnp.asarray(r2),
             tuple(jnp.asarray(c) for c in n))
    for a in range(3):
        _close(got[a].numpy(), exp[a], f"{kind} direction[{a}]")

"""sfvp_tpu_torch.rng is bit-exact with sfvp_tpu.rng and its numpy
mirrors (integer path: exact equality)."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from sfvp_tpu import rng as jrng  # noqa: E402
from sfvp_tpu_torch import rng as trng  # noqa: E402

EDGES = np.asarray([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF,
                    2**32 - 2, 2**32 - 1], np.uint32)


def _words(seed, n=4096):
    g = np.random.default_rng(seed)
    return np.concatenate(
        [EDGES, g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)])


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


def test_pcg_bitwise():
    s = _words(1)
    val, st = trng.pcg(_t(s))
    jv, js = jrng.pcg(jnp.asarray(s))
    nv, ns = jrng.pcg_np(s)
    np.testing.assert_array_equal(_np(val), np.asarray(jv))
    np.testing.assert_array_equal(_np(st), np.asarray(js))
    np.testing.assert_array_equal(_np(val), nv)
    np.testing.assert_array_equal(_np(st), ns)


def test_pcg2d_bitwise():
    a, b = _words(2), _words(3)
    tx, ty = trng.pcg2d(_t(a), _t(b))
    jx, jy = jrng.pcg2d(jnp.asarray(a), jnp.asarray(b))
    nx, ny = jrng.pcg2d_np(a, b)
    np.testing.assert_array_equal(_np(tx), np.asarray(jx))
    np.testing.assert_array_equal(_np(ty), np.asarray(jy))
    np.testing.assert_array_equal(_np(tx), nx)
    np.testing.assert_array_equal(_np(ty), ny)


def test_rand_bitwise_including_one():
    s = _words(4)
    u, st = trng.rand(_t(s))
    ju, js = jrng.rand(jnp.asarray(s))
    nu, ns = jrng.rand_np(s)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(u.numpy(), nu)
    np.testing.assert_array_equal(_np(st), np.asarray(js))
    # the fp32 scale quirk: the largest words round to exactly 1.0
    big = _t([0xFFFFFFFF])
    val, _ = trng.pcg(big)
    assert trng.rand(big)[0].item() == np.float32(
        np.float32(_np(val)[0]) * np.float32(2.0**-32))


@pytest.mark.parametrize("frame,spp", [(0, 32), (7, 32), (123456, 1),
                                       (2**31 - 1, 64)])
def test_sample_seed_bitwise(frame, spp):
    g = np.random.default_rng(frame)
    px = np.concatenate([[0, 1, 4095], g.integers(0, 4096, 500)])
    py = np.concatenate([[0, 4095, 1], g.integers(0, 4096, 500)])
    s = np.concatenate([[0, spp - 1, 0], g.integers(0, spp, 500)])
    got = trng.sample_seed(torch.from_numpy(px), torch.from_numpy(py),
                           torch.from_numpy(s), frame, spp)
    exp = jrng.sample_seed(jnp.asarray(px, jnp.int32),
                           jnp.asarray(py, jnp.int32),
                           jnp.asarray(s, jnp.uint32), frame, spp)
    np.testing.assert_array_equal(_np(got), np.asarray(exp))


def test_sample_seed_scalar_sample_index():
    px = torch.arange(64)
    py = torch.arange(64).flip(0)
    got = trng.sample_seed(px, py, 5, 3, 32)
    exp = jrng.sample_seed(jnp.arange(64), jnp.arange(64)[::-1], 5, 3, 32)
    np.testing.assert_array_equal(_np(got), np.asarray(exp))

"""The two-level any-hit walk of K8 and K9's shadow rays
(csrc/two_level.cuh two_level_any_hit), modelled ray by ray in Python
with the twin's box and triangle tests (kernels/bvh_tlas.py,
kernels/bvh_packet.py), against K8's twin (two_level_occlusion_plain) and
sfvp_tpu's K8 (make_two_level_occlusion in interpret mode, as
tests/test_tlas.py runs it).

The kernel's walk keeps one stack of codes and derives each entry's
instance context from its index (the registers ``base`` and ``id``, as
the closest hit does), and an instance pop walks its BLAS root in the same
trip. The twins keep a context stack beside the code stack and push the
root. The model runs both forms: on every test scene, the stress field of
small overlapping instances included, and on waves with inactive rays and
empty windows, the one-stack walk gives the twin's and sfvp_tpu's answer on
every ray and pops the two-stack walk's (code, context) entries in their
order.

Equal on every ray (ROADMAP.md §C: integer and boolean paths bitwise).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sfvp_tpu.kernels.bvh_tlas import (  # noqa: E402
    make_two_level_occlusion as j_occlusion,
)

from sfvp_tpu_torch.kernels.bvh_packet import (  # noqa: E402
    INSTANCE_CODE_BASE,
    _leaf_tests,
    _node_children,
    ray_planes,
)
from sfvp_tpu_torch.kernels.bvh_tlas import (  # noqa: E402
    _local_rays,
    two_level_occlusion_plain,
)
from sfvp_tpu_torch.utils.vec import f32  # noqa: E402

from test_torch_tlas import (  # noqa: E402
    T_MIN,
    _cols,
    _jcols,
    _shadow_rays,
    scene,
)

SCENES = ["field_lit", "random17", "random5_lit", "stress"]
RAYS = 384


def any_hit_walk(dt, rays, i, pops, one_stack=True):
    """One ray's any-hit walk over a two-level tree; returns whether a
    triangle lies in (t_min, tmax) along it and appends (code, context) of
    every node and leaf pop to ``pops``. Children a ray enters are pushed
    in slot order; the walk ends at its first hit.

    ``one_stack``: the kernels' walk. One stack of codes and two
    registers, ``base`` and ``inst``: the entries at or above ``base`` lie
    in instance ``inst``'s object space, those below it in world space. A
    TLAS has one instance level, so when an instance is popped at index k
    every entry below k is a world entry, and the walk sets base = k; a pop
    below ``base`` is a world entry and sets base to none (every entry of
    the instance is gone by then, and world children may be pushed again
    at or above the old base). The instance pop walks its BLAS root (an
    internal node, the next pop anyway) in the same trip.

    Otherwise the twins' walk: a context stack beside the code stack, and
    an instance pop that only pushes its BLAS root under its context."""
    none = 1 << 30
    t_min = f32(T_MIN)
    if not bool(rays[6, i] > t_min):
        return False
    stack, ctxs = [1], [-1]
    base, inst = none, -1
    idx = torch.tensor([i])
    inf = torch.tensor([float("inf")])
    while stack:
        k = len(stack) - 1
        code = stack.pop()
        if one_stack:
            ctx = inst
            if k < base:
                ctx, base = -1, none
        else:
            ctx = ctxs.pop()
        if code < 0 and -code - 1 >= INSTANCE_CODE_BASE:
            iid = -code - 1 - INSTANCE_CODE_BASE
            root = int(dt.inst[iid, 24]) + 1
            assert root > 0, "a BLAS root is an internal node"
            if not one_stack:
                stack.append(root)
                ctxs.append(iid)
                continue
            inst, base, ctx, code = iid, k, iid, root
        pops.append((code, ctx))
        ray = _local_rays(dt, rays, idx, torch.tensor([ctx]), t_min)
        if code < 0:
            t = _leaf_tests(dt.tris, torch.tensor([-code - 1]), ray, inf)[1]
            if bool(torch.isfinite(t)):
                return True
        else:
            for c in _node_children(dt.nodes, torch.tensor([code - 1]), ray,
                                    inf, t_min, ordered=False)[0].tolist():
                if c:
                    stack.append(c)
                    ctxs.append(ctx)
    return False


def shadow_wave(name):
    """``RAYS`` shadow rays over a test scene (tests/test_torch_tlas.py's:
    random windows, a tenth of them empty, a fifth of the rays inactive)
    as numpy columns and the port's (7, N) planes."""
    o, d, tmax, active = _shadow_rays(RAYS, seed=41)
    planes = ray_planes(_cols(o), _cols(d), torch.from_numpy(tmax),
                        torch.from_numpy(active))
    return (o, d, tmax, active), planes


@pytest.mark.parametrize("name", SCENES)
def test_one_stack_any_hit_matches_twin_and_jax_k8(name):
    """The kernels' one-stack any-hit walk, ray by ray, gives K8's twin's
    answer and sfvp_tpu's K8's (interpret mode) on every ray of a wave
    with inactive rays and empty windows."""
    s = scene(name)
    dt = s["dt"]
    (o, d, tmax, active), rays = shadow_wave(name)
    want = two_level_occlusion_plain(dt, T_MIN, rays)
    jax_k8 = np.asarray(j_occlusion(s["jtl"], t_min=T_MIN, interpret=True)(
        _jcols(o), _jcols(d), jnp.asarray(tmax), active=jnp.asarray(active)))
    got = torch.tensor([any_hit_walk(dt, rays, i, [])
                        for i in range(rays.shape[1])])
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), jax_k8)
    windowed = int((rays[6] > T_MIN).sum())
    assert windowed < RAYS and 0 < int(got.sum()) < windowed


@pytest.mark.parametrize("name", SCENES)
def test_one_stack_any_hit_pops_the_two_stack_walks_entries(name):
    """Pop by pop, the one-stack walk has the code and the instance
    context of the twins' two-stack walk (whose instance pops it folds
    into the BLAS root's), on every ray of the wave."""
    dt = scene(name)["dt"]
    rays = shadow_wave(name)[1]
    n_pops, in_inst = 0, 0
    for i in range(rays.shape[1]):
        one, two = [], []
        assert (any_hit_walk(dt, rays, i, one)
                == any_hit_walk(dt, rays, i, two, one_stack=False))
        assert one == two, f"ray {i}: pops and contexts differ"
        n_pops += len(one)
        in_inst += sum(ctx >= 0 for _, ctx in one)
    assert 0 < in_inst < n_pops

"""P6, the walk-loop iteration probe (kernels/itercost.py), against a
numpy transcription of the TPU probe's kernel body
(benchmarks/probe_iter_cost.py:41-140), bit for bit (NaN for NaN), for
all ten variants at 1, 5, 15 and 2,000 iterations, from the probe's zero
state and from a nonzero one.

The probe builds its pallas_call inside main() (``build`` is nested there)
and cannot be imported, so its body is transcribed here. Where it reads
what no kernel wrote (``rays = out_ref[:]``, the unset output buffer), the
port defines zeros, and the transcription does too. The probe binds
``row`` only for v0-v3 and v5 (probe_iter_cost.py:54), so its v6-v9 raise
when traced and the TPU never ran them; the port and the transcription
bind it for them as for v0, so for v6-v9 the twin is held to that reading
of the body, not to a body that ran. From the zero state v6
is inf after one iteration and v3 stays zero whatever the loop does, so
every variant is also held from a nonzero state; v3 grows ~7x an iteration
there and is NaN past ~50, so 1, 5 and 15 iterations hold it while finite.

The ``cuda`` test holds the kernel against its twin and skips without a
card; chip_smoke.py runs the same comparison on the H100.
"""

import numpy as np
import pytest
import torch

from sfvp_tpu_torch.kernels import itercost

M = 64  # rows 0..M-1 of an (8 M, 128) table; the probe's M is 2048
ITERS = (1, 5, 15, 2000)
NET = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
       (1, 2), (5, 6), (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6),
       (2, 4), (3, 5), (3, 4)]


def table():
    # the probe's data: default_rng(0).normal, float32
    return np.random.default_rng(0).normal(size=(8 * M, 128)).astype(
        np.float32)


def state0(nonzero):
    if not nonzero:
        return np.zeros((8, 128), np.float32)
    return np.random.default_rng(5).normal(size=(8, 128)).astype(np.float32)


def np_probe(nodes, variant, iters, acc):
    """The body of probe_iter_cost.py build(variant), transcribed."""
    f32, inf = np.float32, np.float32(np.inf)
    m = nodes.shape[0] // 8
    sp = [iters, 0]
    rays = np.zeros((8, 128), np.float32)  # out_ref, unset: zeros
    it = iters
    acc = acc.copy()
    while it > 0:
        i = sp[0]
        sp[0] = i - 1
        idx = max(i % m, 0)
        # the probe binds row for (0, 1, 2, 3, 5) only, and its v6-v9
        # raise; here, as in the port, they read it as v0 does
        if variant in (0, 1, 2, 3, 5, 6, 7, 8, 9):
            row = nodes[idx:idx + 1, :]
        if variant == 0:
            acc = acc + row
        elif variant in (1, 2):
            s = f32(0.0)
            for c2 in range(48 if variant == 1 else 128):
                s = s + row[0, c2]
            acc = acc + s
        elif variant == 3:
            t = np.zeros((8, 128), np.float32)
            for c2 in range(48):
                t = t + row[0:1, c2:c2 + 1] * acc
            acc = t
        elif variant == 4:
            nb = nodes[idx * 8:idx * 8 + 8, :]
            lim = np.max(acc)
            tn = np.full((8, 128), -np.inf, np.float32)
            tf = np.full((8, 128), np.inf, np.float32)
            for f in range(0, 6, 2):
                lo = nb[:, f:f + 1]
                hi = nb[:, f + 1:f + 2]
                t0 = (lo - rays) * rays
                t1 = (hi - rays) * rays
                tn = np.maximum(tn, np.minimum(t0, t1))
                tf = np.minimum(tf, np.maximum(np.maximum(t0, t1), lim))
            hit = tn <= tf
            key = np.min(np.where(hit, tn, inf), axis=1, keepdims=True)
            anyh = np.sum(hit.astype(np.float32), axis=1, keepdims=True)
            acc = acc + key + anyh
        elif variant == 5:
            acc = acc + row * f32(2.0) if i % 2 == 0 else acc - row * f32(3.0)
        elif variant == 6:
            s = f32(0.0)
            for _ in range(8):
                hit = (row * acc) > 0.0
                s = s + np.min(np.where(hit, acc, inf))
                s = s + f32(np.any(hit))
            acc = acc + s
        elif variant == 7:
            spn = i % 100
            for c2 in range(8):
                do = row[0, c2] > 0.0
                if do:
                    sp[1] = c2
                spn = spn + int(do)
            acc = acc + f32(spn)
        elif variant == 8:
            keys = [row[0, c2] for c2 in range(8)]
            codes = [row[0, 8 + c2] for c2 in range(8)]
            for a2, b2 in NET:
                if keys[a2] < keys[b2]:
                    keys[a2], keys[b2] = keys[b2], keys[a2]
                    codes[a2], codes[b2] = codes[b2], codes[a2]
            acc = acc + sum(keys) + sum(codes)
        else:
            hit = (row * acc) > 0.0
            key = np.min(np.where(hit, acc, inf), axis=1, keepdims=True)
            anyh = np.max(hit.astype(np.float32), axis=1, keepdims=True)
            acc = acc + key + anyh
        assert acc.dtype == np.float32
        it -= 1
    return acc


def same_bits(got, want):
    """Equal bit for bit where finite or infinite, NaN where NaN (the NaN
    payloads of two machines may differ)."""
    got = np.asarray(got, np.float32)
    nan = np.isnan(want)
    return (np.array_equal(np.isnan(got), nan)
            and np.array_equal(got[~nan].view(np.uint32),
                               want[~nan].view(np.uint32)))


@pytest.mark.parametrize("nonzero", [False, True], ids=["zero", "nonzero"])
@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("variant", itercost.VARIANTS)
def test_torch_iter_cost_twin_is_the_tpu_body(variant, iters, nonzero):
    nodes, acc0 = table(), state0(nonzero)
    v = itercost.VARIANTS.index(variant)
    with np.errstate(over="ignore", invalid="ignore"):
        want = np_probe(nodes, v, iters, acc0)
    got = itercost.iter_cost(torch.from_numpy(nodes), variant, iters,
                             torch.from_numpy(acc0))
    assert got.shape == (8, 128) and got.dtype == torch.float32
    assert same_bits(got.numpy(), want), (variant, iters)
    if variant == "v3_slice_bcast" and nonzero and iters <= 15:
        assert np.isfinite(want).all()


def test_torch_iter_cost_defaults_to_the_probes_zero_state():
    nodes = torch.from_numpy(table())
    got = itercost.iter_cost(nodes, "v0_loop", 15)
    assert torch.equal(got, itercost.iter_cost(
        nodes, "v0_loop", 15, torch.zeros(8, 128)))
    assert torch.isinf(itercost.iter_cost(nodes, "v6_reduce16", 1)).all()


def test_torch_iter_cost_refuses_bad_inputs():
    nodes = torch.from_numpy(table())
    with pytest.raises(ValueError, match="v9"):
        itercost.iter_cost(nodes, "v10", 3)
    with pytest.raises(ValueError, match="8 M"):
        itercost.iter_cost(nodes[:12], "v0_loop", 3)
    with pytest.raises(ValueError, match="acc0"):
        itercost.iter_cost(nodes, "v0_loop", 3, torch.zeros(4, 128))
    with pytest.raises(ValueError, match="CUDA tensor"):
        itercost.iter_cost(nodes.to("meta"), "v0_loop", 3)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", itercost.VARIANTS)
def test_cuda_iter_cost_matches_twin(variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    nodes = torch.from_numpy(table())
    for nonzero in (False, True):
        acc0 = torch.from_numpy(state0(nonzero))
        for iters in ITERS:
            got = itercost.iter_cost(nodes.cuda(), variant, iters,
                                     acc0.cuda()).cpu()
            exp = itercost.iter_cost(nodes, variant, iters, acc0)
            assert same_bits(got.numpy(), exp.numpy()), (variant, iters)

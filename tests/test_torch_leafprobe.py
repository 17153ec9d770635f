"""P2 and P5, the leaf-row probes (kernels/leafprobe.py), against numpy
transcriptions of the TPU probes' kernel bodies: benchmarks/
micro_leaf_cost.py:56-131 (the int32 LCG row pick with jax.lax.rem's
truncating remainder, the 128-add chain in order) and
benchmarks/micro_smem_dma.py:26-50 (its exact ``want``), bit for bit.

The JAX probes build their pallas_call inside main() with TPU memory
spaces (pltpu.VMEM, pltpu.SMEM scratch, DMA semaphores) and cannot run on
the CPU unedited, so their bodies are transcribed here. Where they read
what no kernel wrote (smemload's unset SMEM scratch), the port stages
the table's rows 0 and 1 before the loop, and the transcription does too.

The ``cuda`` test holds the kernels against their twins and skips without
a card; chip_smoke.py runs the same comparison on the H100.
"""

import numpy as np
import pytest
import torch

from sfvp_tpu_torch.kernels import leafprobe

NR, K = 64, 1000
# base's and dmaonly's accumulator grows ~129x an iteration (acc + the sum
# of acc + c) and is inf past 17 iterations, where any chain agrees; they
# are also held at these counts, where it is finite
FINITE_ITERS = (1, 5, 15)
CHAIN_MODES = ("base", "dmaonly")


def table(nr=NR, seed=7):
    return np.random.default_rng(seed).random((nr, 128), np.float32)


def np_lcg(rnd):
    """micro_leaf_cost.py:119-120 in numpy int32: the product wraps,
    abs(INT_MIN) stays INT_MIN, rem truncates (np.fmod, jax.lax.rem)."""
    with np.errstate(over="ignore"):
        rnd = np.int32(rnd) * np.int32(1103515245) + np.int32(12345)
        return np.fmod(np.abs(np.int32(rnd)), np.int32(2 ** 30))


def np_probe(rows, iters, mode):
    """The body of micro_leaf_cost.py make(mode), transcribed."""
    nr = rows.shape[0]
    lbuf = rows[:2].copy()  # staged rows (the TPU's scratch is unset)
    rnd, acc = np.int32(1), np.float32(0.0)
    for _ in range(iters):
        lrow = np.fmod(rnd, np.int32(nr))
        if mode in ("extract", "smemdma"):
            sc = list(rows[lrow])
        elif mode == "smemload":
            sc = list(lbuf[np.fmod(rnd, np.int32(2))])
        else:
            sc = [acc + np.float32(cc) for cc in range(128)]
        s = sc[0]
        with np.errstate(over="ignore"):  # base's chain reaches inf, as
            for v in sc[1:]:              # the TPU probe's does
                s = np.float32(s + v)
        rnd = np_lcg(rnd)
        acc = np.float32(acc + s)
    return acc


@pytest.mark.parametrize("mode", leafprobe.MODES)
def test_torch_leaf_probe_twin_is_the_tpu_body(mode):
    rows = table()
    got = leafprobe.leaf_probe(torch.from_numpy(rows), K, mode)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    want = np_probe(rows, K, mode)
    assert torch.equal(got, torch.full((8, 128), float(want))), (
        float(got[0, 0]), float(want))
    if mode not in CHAIN_MODES:
        assert np.isfinite(want)


@pytest.mark.parametrize("iters", FINITE_ITERS)
@pytest.mark.parametrize("mode", CHAIN_MODES)
def test_torch_leaf_probe_chain_while_finite(mode, iters):
    """base and dmaonly before their accumulator overflows: a chain with
    other constants, or fewer terms, gives other bits here."""
    rows = table()
    got = leafprobe.leaf_probe(torch.from_numpy(rows), iters, mode)
    want = np_probe(rows, iters, mode)
    assert np.isfinite(want) and want > 0
    assert torch.equal(got, torch.full((8, 128), float(want))), (
        float(got[0, 0]), float(want))


def test_torch_lcg_matches_int32_semantics():
    """The twin's int64-masked LCG equals numpy's int32 one on its own
    stream and at the edges: the state whose product wraps to INT_MIN
    (|INT_MIN| = INT_MIN, truncating rem 0) and negative states."""
    inv = pow(1103515245, -1, 2 ** 32)
    to_min = ((2 ** 31 - 12345) * inv) % 2 ** 32
    starts = [1, 0, 2 ** 30 - 1, to_min - 2 ** 32, -5, 2 ** 31 - 1]
    for r in starts:
        r = int(np.int32(np.uint32(r % 2 ** 32)))
        assert int(leafprobe.lcg_next(torch.tensor(r))) == int(np_lcg(r)), r
    assert int(np_lcg(int(np.int32(np.uint32(to_min))))) == 0
    seq = leafprobe.rnd_sequence(500)
    rnd = np.int32(1)
    for r in seq:
        assert r == int(rnd) and r >= 0
        rnd = np_lcg(rnd)


def test_torch_smem_dma_twin_is_the_probes_want():
    x = np.arange(16 * 128, dtype=np.float32).reshape(16, 128)
    got = leafprobe.smem_dma(torch.from_numpy(x))
    row1 = np.arange(128, dtype=np.float32) + 128.0
    want = row1[np.arange(8) * 16].sum()  # micro_smem_dma.py:45-46
    assert torch.equal(got, torch.full((8, 128), float(want)))


def test_torch_probe_refuses_bad_inputs():
    with pytest.raises(ValueError, match="mode"):
        leafprobe.leaf_probe(torch.zeros(4, 128), 3, "ring")
    with pytest.raises(ValueError, match="CUDA tensor"):
        leafprobe.leaf_probe(torch.zeros(4, 128, device="meta"), 3, "base")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", leafprobe.MODES)
def test_cuda_leaf_probe_matches_twin(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    rows = torch.from_numpy(table(8192))
    # no transcendental: the CPU twin gives the kernel's bits; the chain
    # modes while their accumulator is finite
    for iters in FINITE_ITERS if mode in CHAIN_MODES else (2000,):
        got = leafprobe.leaf_probe(rows.cuda(), iters, mode).cpu()
        exp = leafprobe.leaf_probe(rows, iters, mode)
        assert torch.isfinite(exp).all() and torch.equal(got, exp)
    x = torch.arange(16 * 128, dtype=torch.float32).reshape(16, 128)
    assert torch.equal(leafprobe.smem_dma(x.cuda()).cpu(),
                       leafprobe.smem_dma(x))

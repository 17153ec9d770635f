"""P2 and P5, the leaf-row probes: what reading a popped leaf row costs,
straight from device memory against staged in shared memory.

``leaf_probe(table, iters, mode)`` (P2, benchmarks/micro_leaf_cost.py) runs
one serial loop of ``iters`` iterations over an (nr, 128) float32 table:
each picks a row by an int32 LCG and adds its 128 floats (or, in "base"
and "dmaonly", 128 constants) into an accumulator through one serial
chain. ``smem_dma(x)`` (P5, benchmarks/micro_smem_dma.py) copies row 1 of
a (16, 128) table into shared memory and sums its elements 0, 16, ...,
112. Both return an (8, 128) float32 tensor filled with the result, the
TPU probes' output. On a CUDA tensor they launch the hand-written kernels
of csrc/leaf_probe.cu (one thread: a latency probe), on a CPU tensor their
plain twins, which give the same bits (the adds in the kernel's order).
``leaf_probe.launches`` and ``smem_dma.launches`` count launches.

The modes (``MODES``): base, the chain over constants; extract, the row
read through L1 (the leaf pop of K3, K5, K6 and K9); smemdma, the row
copied into shared memory by cp.async, then read there; smemload, shared
loads of one of two rows staged before the loop; dmaonly, the copy and
the chain over constants. extract - base and smemdma - base are the per-pop
costs a leaf prefetch ring would start from (chip_smoke.py prints them).
"""

from __future__ import annotations

import torch

from . import build

MODES = ("base", "extract", "smemdma", "smemload", "dmaonly")
LANES = 128
# the LCG of the TPU probe (micro_leaf_cost.py:119-120), in int32
LCG_MUL, LCG_ADD, LCG_MOD = 1103515245, 12345, 2 ** 30


def lcg_next(rnd: torch.Tensor) -> torch.Tensor:
    """One step of the probe's int32 LCG on a 0-d int64 tensor holding an
    int32: rnd * 1103515245 + 12345 wrapped to int32 (int64 masked to 32
    bits), |.| with |INT_MIN| staying INT_MIN as in int32, then the
    truncating remainder by 2^30 (torch.fmod, jax.lax.rem; not Python's
    %)."""
    w = (rnd * LCG_MUL + LCG_ADD) & 0xFFFFFFFF
    w = torch.where(w >= 2 ** 31, w - 2 ** 32, w)
    a = torch.abs(w)
    a = torch.where(a == 2 ** 31, w, a)  # int32 abs(INT_MIN) = INT_MIN
    return torch.fmod(a, LCG_MOD)


def rnd_sequence(iters: int) -> list:
    """The LCG's state at each iteration, from 1 (never negative: the only
    negative |rnd|, INT_MIN, leaves remainder 0). Iteration i reads row
    rnd mod nr (smemload: staged row rnd mod 2)."""
    rnd = torch.tensor(1, dtype=torch.int64)
    out = []
    for _ in range(iters):
        out.append(int(rnd))
        rnd = lcg_next(rnd)
    return out


def _serial_sum(terms: torch.Tensor) -> torch.Tensor:
    """t[..., 0] + t[..., 1] + ... + t[..., 127] added one term at a time
    in float32, as the kernel's chain (a library sum reorders)."""
    s = terms[..., 0].clone()
    for c in range(1, terms.shape[-1]):
        s = s + terms[..., c]
    return s


def leaf_probe_plain(table: torch.Tensor, iters: int, mode: str):
    """Plain PyTorch twin of P2: the same accumulator, bit for bit."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}, one of {MODES}")
    nr = table.shape[0]
    acc = torch.zeros((), dtype=torch.float32, device=table.device)
    if mode in ("base", "dmaonly"):
        consts = torch.arange(LANES, dtype=torch.float32, device=table.device)
        for _ in range(iters):
            acc = acc + _serial_sum(acc + consts)
    else:
        # a row's sum does not depend on the accumulator: sum every row once
        row_sum = _serial_sum(table)
        for rnd in rnd_sequence(iters):
            acc = acc + row_sum[rnd % (2 if mode == "smemload" else nr)]
    return torch.full((8, LANES), float(acc), dtype=torch.float32,
                      device=table.device)


def smem_dma_plain(x: torch.Tensor):
    """Plain PyTorch twin of P5: row 1's elements 0, 16, ..., 112 added in
    order."""
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(8):
        acc = acc + x[1, 16 * i]
    return torch.full((8, LANES), float(acc), dtype=torch.float32,
                      device=x.device)


def _check(t: torch.Tensor, rows: int = None) -> None:
    if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != LANES
            or not t.is_contiguous() or (rows is not None
                                         and t.shape[0] != rows)):
        want = f"({rows}, {LANES})" if rows else f"(rows, {LANES})"
        raise ValueError(f"the probe takes a contiguous float32 {want} "
                         f"table, got {t.dtype} {tuple(t.shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take a CUDA tensor, got "
                         f"{t.device}")


def _launch(fn_name: str, t: torch.Tensor, *args):
    out = torch.empty((8, LANES), dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = getattr(build.library(), fn_name)(t.data_ptr(), *args,
                                               out.data_ptr(), stream)
    build.check_launch(fn_name, err)
    return out


def leaf_probe(table: torch.Tensor, iters: int, mode: str):
    """P2 on ``table``'s device: the kernel for a CUDA tensor (or an
    error), the twin for a CPU tensor."""
    if table.device.type == "cpu":
        return leaf_probe_plain(table, iters, mode)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}, one of {MODES}")
    _check(table)
    if not 2 <= table.shape[0] < 2 ** 31 // LANES or iters < 0:
        raise ValueError(f"the probe takes 2 <= rows < {2 ** 31 // LANES} "
                         f"and iters >= 0, got {table.shape[0]}, {iters}")
    out = _launch("sfvp_leaf_probe", table, table.shape[0], iters,
                  MODES.index(mode))
    leaf_probe.launches += 1
    return out


leaf_probe.launches = 0


def smem_dma(x: torch.Tensor):
    """P5 on ``x``'s device ((16, 128) float32): the kernel for a CUDA
    tensor (or an error), the twin for a CPU tensor."""
    if x.device.type == "cpu":
        return smem_dma_plain(x)
    _check(x, 16)
    out = _launch("sfvp_smem_dma", x)
    smem_dma.launches += 1
    return out


smem_dma.launches = 0


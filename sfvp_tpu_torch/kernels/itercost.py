"""P6, the walk-loop iteration probe: ns per iteration of the steps of a
traversal loop (a pop, a row read, scalar extracts, block reductions,
conditional pushes, the sorting network).

``iter_cost(table, variant, iters=20_000)`` runs one loop of ``iters``
iterations over an (8, 128) float32 state and an (8 M, 128) float32 table
and returns the state. On a CUDA tensor it launches the hand-written
kernel of csrc/iter_cost.cu (one block of 1024 threads, a thread an
element, thread 0 owning the scalar state: a latency probe), on a CPU
tensor its plain twin ``iter_cost_plain``, which gives the same bits (NaN
where the kernel has NaN). ``iter_cost.launches`` counts launches.

Counterpart of benchmarks/probe_iter_cost.py ``main`` -> ``build(variant)``
(kernel body :41-140). Iteration k pops i = iters - k and reads row
idx = max(i % M, 0) of the table (v4: rows 8 idx .. 8 idx + 7); the
variants (``VARIANTS``, the probe's names, and ``v9``, the tenth branch
of its body, which its main never runs):

  v0_loop        acc + row
  v1_scalars48   acc + the serial sum of row[0:48]
  v2_scalars128  acc + the serial sum of row[0:128]
  v3_slice_bcast t = 0, t + row[c] * acc for c < 48, in order
  v4_rowslice8   slab tests of the rays against rows 8 idx.., with the
                 state's max as limit; per row a min and a count of hits
  v5_cond        acc + 2 row or acc - 3 row by the parity of i
  v6_reduce16    8 times: + the min of the state where row * acc > 0,
                 + whether any is
  v7_when8       + (i % 100 + the count of row[0:8] > 0)
  v8_sortnet     + the sums of row[0:8] and row[8:16] after the network
  v9             per row: + the min of the state where row * acc > 0, +
                 whether any is

``rays`` (v4) is the output buffer read before it is written
(probe_iter_cost.py:44), unset on the TPU: the port defines it as zeros.
v6-v9 depart from the probe as it runs: its body binds ``row`` only for
v0-v3 and v5 (probe_iter_cost.py:54), so v6, v7 and v8 raise when traced
(its main reports them as failed) and the TPU never measured them; the
port reads row idx for them as v0 does.
``acc0`` is the initial state, zeros as the probe's; the tests also give
a nonzero one, since from zeros v6 is inf after one iteration and v3
stays zero, whatever the loop does.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .bvh_packet import NET_LAYERS

VARIANTS = ("v0_loop", "v1_scalars48", "v2_scalars128", "v3_slice_bcast",
            "v4_rowslice8", "v5_cond", "v6_reduce16", "v7_when8",
            "v8_sortnet", "v9")
LANES = 128
ITERS = 20_000


def _serial_sum(terms: torch.Tensor) -> torch.Tensor:
    """0 + t[..., 0] + t[..., 1] + ... one term at a time in float32, as
    the kernel's chain and Python's ``sum`` (a library sum reorders)."""
    s = torch.zeros(terms.shape[:-1], dtype=torch.float32,
                    device=terms.device)
    for c in range(terms.shape[-1]):
        s = s + terms[..., c]
    return s


def _sorted_sums(rows: torch.Tensor):
    """v8's two sums of every row: row[0:8] as keys and row[8:16] as codes
    through the 19-comparator network (swap where key a < key b), each
    summed in order."""
    key, code = rows[:, :8].clone(), rows[:, 8:16].clone()
    for layer in NET_LAYERS:
        for a, b in layer:
            swap = key[:, a] < key[:, b]
            ka, kb, ca, cb = key[:, a], key[:, b], code[:, a], code[:, b]
            key[:, a], key[:, b] = (torch.where(swap, kb, ka),
                                    torch.where(swap, ka, kb))
            code[:, a], code[:, b] = (torch.where(swap, cb, ca),
                                      torch.where(swap, ca, cb))
    return _serial_sum(key), _serial_sum(code)


def _v3_fixed(acc: torch.Tensor) -> bool:
    """Whether v3's state no longer changes: every element +0 (0 + row *
    +0 is +0) or NaN (NaN stays NaN)."""
    zero = (acc == 0) & ~torch.signbit(acc)
    return bool((zero | torch.isnan(acc)).all())


def _check(table: torch.Tensor, variant: str, iters: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}, one of "
                         f"{', '.join(VARIANTS)}")
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.shape[1] != LANES or not table.is_contiguous()
            or table.shape[0] < 8 or table.shape[0] % 8):
        raise ValueError(f"the probe takes a contiguous float32 (8 M, "
                         f"{LANES}) table, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if not 0 <= iters < 2 ** 31:
        raise ValueError(f"iters must be in 0..2**31-1, got {iters}")


def _acc0(table: torch.Tensor, acc0: Optional[torch.Tensor]):
    if acc0 is None:
        return torch.zeros((8, LANES), dtype=torch.float32,
                           device=table.device)
    if (acc0.shape != (8, LANES) or acc0.dtype != torch.float32
            or acc0.device != table.device):
        raise ValueError(f"acc0 must be a float32 (8, {LANES}) tensor on "
                         f"{table.device}, got {acc0.dtype} "
                         f"{tuple(acc0.shape)} on {acc0.device}")
    return acc0.contiguous()


def iter_cost_plain(table: torch.Tensor, variant: str, iters: int = ITERS,
                    acc0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch twin of P6: the same state, bit for bit (NaN for
    NaN). What does not depend on the state (v1's, v2's, v7's and v8's
    scalars of each row) is computed once per row; v3 stops where its
    state is fixed (``_v3_fixed``). Run it on the CPU: on a CUDA tensor
    each of its tens of thousands of small ops is a launch."""
    _check(table, variant, iters)
    v = VARIANTS.index(variant)
    acc = _acc0(table, acc0).clone()
    dev = table.device
    m = table.shape[0] // 8
    rows = table[:m]
    rays = torch.zeros((8, LANES), dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    if v in (1, 2):
        per_row = _serial_sum(rows[:, :48 if v == 1 else LANES])
    elif v == 7:
        positive = (rows[:, :8] > 0.0).sum(dim=1).tolist()
    elif v == 8:
        sk, sc = _sorted_sums(rows)
    for i in range(iters, 0, -1):
        idx = max(i % m, 0)
        row = rows[idx]
        if v == 0:
            acc = acc + row
        elif v in (1, 2):
            acc = acc + per_row[idx]
        elif v == 3:
            if _v3_fixed(acc):
                break
            t = torch.zeros_like(acc)
            for c in range(48):
                t = t + row[c] * acc
            acc = t
        elif v == 4:
            nb = table[8 * idx:8 * idx + 8]
            lim = torch.amax(acc)
            tn = torch.full_like(acc, float("-inf"))
            tf = torch.full_like(acc, float("inf"))
            for f in range(0, 6, 2):
                t0 = (nb[:, f:f + 1] - rays) * rays
                t1 = (nb[:, f + 1:f + 2] - rays) * rays
                tn = torch.maximum(tn, torch.minimum(t0, t1))
                tf = torch.minimum(tf, torch.maximum(torch.maximum(t0, t1),
                                                     lim))
            hit = tn <= tf
            key = torch.amin(torch.where(hit, tn, inf), dim=1, keepdim=True)
            anyh = hit.to(torch.float32).sum(dim=1, keepdim=True)
            acc = acc + key + anyh
        elif v == 5:
            acc = acc + row * 2.0 if i % 2 == 0 else acc - row * 3.0
        elif v == 6:
            hit = (row * acc) > 0.0
            # the 8 repeats reduce the same values
            mn = torch.amin(torch.where(hit, acc, inf))
            anyh = hit.any().to(torch.float32)
            s = torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(8):
                s = s + mn
                s = s + anyh
            acc = acc + s
        elif v == 7:
            acc = acc + float(i % 100 + positive[idx])
        elif v == 8:
            acc = acc + sk[idx] + sc[idx]
        else:
            hit = (row * acc) > 0.0
            key = torch.amin(torch.where(hit, acc, inf), dim=1, keepdim=True)
            anyh = torch.amax(hit.to(torch.float32), dim=1, keepdim=True)
            acc = acc + key + anyh
    return acc


def iter_cost(table: torch.Tensor, variant: str, iters: int = ITERS,
              acc0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P6 on ``table``'s device: the kernel for a CUDA tensor (or an
    error), the twin for a CPU tensor. ``acc0``: the initial (8, 128)
    state, zeros by default as the probe's."""
    if table.device.type == "cpu":
        return iter_cost_plain(table, variant, iters, acc0)
    _check(table, variant, iters)
    if table.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take a CUDA tensor, got "
                         f"{table.device}")
    if table.shape[0] >= 2 ** 31 // LANES:
        raise ValueError(f"the probe takes fewer than {2 ** 31 // LANES} "
                         f"rows, got {table.shape[0]}")
    acc0 = _acc0(table, acc0)
    # zeros: v4 reads the output before writing it (its rays)
    out = torch.zeros((8, LANES), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = build.library().sfvp_iter_cost(
            table.data_ptr(), table.shape[0] // 8, iters,
            VARIANTS.index(variant), acc0.data_ptr(), out.data_ptr(), stream)
    build.check_launch("sfvp_iter_cost", err)
    iter_cost.launches += 1
    return out


iter_cost.launches = 0

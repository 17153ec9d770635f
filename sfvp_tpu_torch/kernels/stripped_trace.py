"""P1, the packet walk stripped of its payload: (t, u, v) and an exact
count of iterations per packet, with the ablations of the TPU probe.

``stripped_trace(dw, t_min, rays, variant)`` traces one (N,) wave of K6's
ray planes (kernels/bvh_packet.py ``ray_planes``: 7 planes, t_max = -inf
for an inactive ray) over a wide BVH (``DeviceWide``) per packet of 1024
consecutive rays, and returns the (3, N) planes t, u, v (t = inf, u = v = 0
on a miss) and the (packets,) int32 pops of each packet. On a CUDA tensor
it launches the hand-written kernel of csrc/stripped_trace.cu, on a CPU
tensor its plain twin ``stripped_trace_plain``, which gives the same bits
and counts. ``stripped_trace.launches`` counts launches.

Counterpart of benchmarks/probe_carry.py ``make_stripped_trace`` (kernel
body :56-217): sfvp_tpu's K3 packet walk with one stack a packet. A node
pop pushes the children that any ray of the packet enters within its own
[t_min, min(best t, t_max)], keyed by the least entry distance over those
rays, far to near through the 19-comparator network; a leaf pop tests
every ray against the row's 8 triangles (strict t < best). ``VARIANTS``
names the probe's six runs as combinations of its flags:

  stripped        none
  packed          packed_push: the vote counted as two children's hits
                  packed in one int (the same pushes as stripped)
  packed_center   packed_push, center_key: each child keyed by the center
                  ray's (4 * 128 + 64) entry distance, K6's key
  pushall_center  push_all, center_key: every child with a tag pushed,
                  whether a ray enters it or not (the whole tree a packet)
  no_sortnet      no_sortnet: children pushed in slot order
  no_leaf         no_leaf: no triangle test (t stays inf, nothing prunes)

Padding rays of the last packet have o = d = 0 and t_max = -inf, as the
TPU probe's (probe_carry.py:232-239), and still key a packet whose center
they are. The kernel orders entry distances by their bits, which needs
t_min > 0: both sides refuse t_min <= 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.vec import f32
from . import build
from .bvh_packet import (
    DeviceWide,
    _check_rays,
    _child_codes,
    _push,
    _slot_tests,
    _sort_desc,
)
from .bvh_packet2 import CENTER, PACKET
from .bvh_traverse import safe_inv, slab

# variant -> the flags of make_stripped_trace it sets; the kernel's
# template instance is the variant's index (csrc/stripped_trace.cu)
VARIANTS = {
    "stripped": frozenset(),
    "packed": frozenset({"packed_push"}),
    "packed_center": frozenset({"packed_push", "center_key"}),
    "pushall_center": frozenset({"push_all", "center_key"}),
    "no_sortnet": frozenset({"no_sortnet"}),
    "no_leaf": frozenset({"no_leaf"}),
}
# the leaf rows a pass of the twin pops at most from one packet's stack;
# the leaf rows pushall_center's twin tests a pass
_RUN, _CHUNK = 8, 256


def variant_of(flags) -> str:
    """The variant whose flags are ``flags`` (names of
    make_stripped_trace's keyword flags that are set); raises for a
    combination the probe does not run."""
    flags = frozenset(flags)
    for name, f in VARIANTS.items():
        if f == flags:
            return name
    raise ValueError(f"no variant sets exactly {sorted(flags)}; the "
                     f"variants are {', '.join(VARIANTS)}")


def _check_args(variant: str, t_min: float) -> frozenset:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}, one of "
                         f"{', '.join(VARIANTS)}")
    if not t_min > 0.0:
        raise ValueError(f"t_min must be > 0 (entry distances are ordered "
                         f"by their bits), got {t_min}")
    return VARIANTS[variant]


def stripped_trace_plain(dw: DeviceWide, t_min: float, rays: torch.Tensor,
                         variant: str = "stripped",
                         counts: Optional[dict] = None,
                         hits: Optional[dict] = None):
    """Plain PyTorch twin of the P1 kernel: same arguments, same results.

    Vectorised over packets: each pass pops, from every packet whose
    stack is not empty, one node or the run of leaf rows on its top (at
    most 8): a leaf pop pushes nothing, so the kernel pops such a run one
    row after another with no node in between, and the first least t over
    the run's triangles in pop order is what its strict t < best scan
    keeps. pushall_center, whose pops depend on no ray, takes
    ``_walk_whole_tree``. ``counts``, when given, gains the pops
    ("node_pops": 1024 x 8 slab tests and the network each, "leaf_pops":
    1024 x 8 triangle tests); ``hits`` gains each ray's leaf row and slot
    ("row", "slot", -1 on a miss).
    """
    flags = _check_args(variant, t_min)
    t_min = f32(t_min)
    dev = rays.device
    n = rays.shape[1]
    n_pk = -(-n // PACKET)
    planes = torch.zeros((7, n_pk * PACKET), dtype=torch.float32, device=dev)
    planes[:, :n] = rays
    planes[6, n:] = float("-inf")
    ray = tuple(planes.view(7, n_pk, PACKET))
    o, d, tmax = ray[:3], ray[3:6], ray[6]
    inv = tuple(safe_inv(c) for c in d)
    c_o = tuple(c[:, CENTER, None] for c in o)
    c_inv = tuple(c[:, CENTER, None] for c in inv)
    no_limit = torch.tensor(float("inf"), device=dev)

    i64 = dict(dtype=torch.int64, device=dev)
    stack = torch.zeros((n_pk, dw.max_stack), **i64)
    stack[:, 0] = 1  # the root, internal node 0
    sp = torch.ones(n_pk, **i64)
    pops = torch.zeros(n_pk, **i64)
    bt = torch.full((n_pk, PACKET), float("inf"), device=dev)
    bu = torch.zeros((n_pk, PACKET), device=dev)
    bv = torch.zeros((n_pk, PACKET), device=dev)
    brow = torch.full((n_pk, PACKET), -1, **i64)
    bslot = torch.full((n_pk, PACKET), -1, **i64)
    tally = {"node_pops": 0, "leaf_pops": 0}
    steps = torch.arange(_RUN, device=dev)
    if "push_all" in flags:
        _walk_whole_tree(dw, t_min, ray, c_o, c_inv, pops, bt, bu, bv,
                         brow, bslot, tally)
    else:
        while True:
            a = torch.nonzero(sp > 0).squeeze(1)
            if a.numel() == 0:
                break
            top = stack[a, sp[a] - 1]
            ni, code = a[top > 0], top[top > 0]
            li = a[top < 0]
            if ni.numel():
                sp[ni] -= 1
                pops[ni] += 1
                f = dw.nodes[code - 1, :64].view(-1, 8, 8)  # field, child
                child = _child_codes(f)
                box = tuple(f[:, k, None, :] for k in range(6))  # (M, 1, 8)
                limit = torch.minimum(bt[ni], tmax[ni])[..., None]
                tnear, tfar = slab(box[:3], box[3:],
                                   tuple(c[ni][..., None] for c in o),
                                   tuple(c[ni][..., None] for c in inv),
                                   t_min, limit)                # (M, 1024, 8)
                hit = tnear <= tfar
                push = (child != 0) & hit.any(dim=1)
                if "center_key" in flags:
                    key = slab(tuple(f[:, k] for k in range(3)),
                               tuple(f[:, k] for k in range(3, 6)),
                               tuple(c[ni] for c in c_o),
                               tuple(c[ni] for c in c_inv), t_min, no_limit)[0]
                else:
                    key = torch.where(hit, tnear, float("inf")).amin(dim=1)
                key = torch.where(push, key, float("-inf"))
                child = torch.where(push, child, 0)
                if "no_sortnet" not in flags:
                    _sort_desc(key, child)
                _push(stack, sp, ni, child)
                tally["node_pops"] += ni.numel()
            if li.numel():
                # the run of leaf codes on each stack's top, top first
                at = sp[li, None] - 1 - steps                       # (L, R)
                codes = stack[li[:, None], at.clamp_min(0)]
                run = torch.cumprod((at >= 0) & (codes < 0), dim=1).bool()
                width = int(run.sum(dim=1).max())
                run, codes = run[:, :width], codes[:, :width]
                rows = torch.where(run, -codes - 1, 0)
                sp[li] -= run.sum(dim=1)
                pops[li] += run.sum(dim=1)
                tally["leaf_pops"] += int(run.sum())
                if "no_leaf" in flags:
                    # the row read, as the TPU probe's (t stays inf)
                    for j in range(width):
                        bt[li] = torch.where(
                            run[:, j, None],
                            bt[li] + 0.0 * dw.tris[rows[:, j], 0][:, None],
                            bt[li])
                else:
                    s = dw.tris[rows].view(-1, 1, width * 8, 16)
                    # the triangles of rows past a packet's run never win
                    live = run.repeat_interleave(8, dim=1)[:, None, :]
                    slot, t, u, v = _slot_tests(
                        s, tuple(c[li][..., None] for c in ray), t_min,
                        torch.where(live, bt[li][..., None], float("-inf")))
                    better = t < bt[li]
                    bt[li] = torch.where(better, t, bt[li])
                    bu[li] = torch.where(better, u, bu[li])
                    bv[li] = torch.where(better, v, bv[li])
                    brow[li] = torch.where(
                        better, torch.gather(rows, 1, slot // 8), brow[li])
                    bslot[li] = torch.where(better, slot % 8, bslot[li])
    if counts is not None:
        for k, v in tally.items():
            counts[k] = counts.get(k, 0) + v
    if hits is not None:
        hits["row"] = brow.reshape(-1)[:n]
        hits["slot"] = bslot.reshape(-1)[:n]
    out = torch.stack([bt, bu, bv]).reshape(3, -1)[:, :n].contiguous()
    return out, pops.to(torch.int32)


def _walk_whole_tree(dw, t_min, ray, c_o, c_inv, pops, bt, bu, bv, brow,
                     bslot, tally):
    """pushall_center's walk, in place: no pop depends on a ray (every
    child with a tag is pushed, keyed by the center ray), so each packet's
    order of pops is its depth-first walk with the children of every node
    sorted once, and every ray then tests the leaf rows in that order, a
    chunk of rows at a time: the first least t, as the kernel's strict
    t < best scan over the same rows keeps."""
    dev = bt.device
    n_pk = bt.shape[0]
    f = dw.nodes[:, :64].view(-1, 8, 8)                   # node, field, child
    child = _child_codes(f).expand(n_pk, -1, -1).reshape(-1, 8)
    key = slab(tuple(f[None, :, k] for k in range(3)),
               tuple(f[None, :, k] for k in range(3, 6)),
               tuple(c[:, :, None] for c in c_o),
               tuple(c[:, :, None] for c in c_inv), t_min,
               torch.tensor(float("inf"), device=dev))[0].reshape(-1, 8)
    key = torch.where(child != 0, key, float("-inf"))
    _sort_desc(key, child)
    order = child.view(n_pk, -1, 8).tolist()
    seqs = []
    for p in range(n_pk):
        stack, seq, n_pops = [1], [], 0
        while stack:
            code = stack.pop()
            n_pops += 1
            if code > 0:
                stack.extend(c for c in order[p][code - 1] if c != 0)
                if len(stack) > dw.max_stack:
                    raise ValueError(f"the walk passed max_stack "
                                     f"{dw.max_stack}")
            else:
                seq.append(-code - 1)
        pops[p] = n_pops
        seqs.append(seq)
    rows_all = torch.tensor(seqs, dtype=torch.int64, device=dev)
    tally["leaf_pops"] += rows_all.numel()
    tally["node_pops"] += int(pops.sum()) - rows_all.numel()
    for j in range(0, rows_all.shape[1], _CHUNK):
        rows = rows_all[:, j:j + _CHUNK]
        s = dw.tris[rows].view(n_pk, 1, -1, 16)
        slot, t, u, v = _slot_tests(s, tuple(c[..., None] for c in ray),
                                    t_min, bt[..., None])
        better = t < bt
        bt.copy_(torch.where(better, t, bt))
        bu.copy_(torch.where(better, u, bu))
        bv.copy_(torch.where(better, v, bv))
        brow.copy_(torch.where(better, torch.gather(rows, 1, slot // 8),
                               brow))
        bslot.copy_(torch.where(better, slot % 8, bslot))


def stripped_trace(dw: DeviceWide, t_min: float, rays: torch.Tensor,
                   variant: str = "stripped"):
    """P1 on the rays' device: the CUDA kernel for a CUDA tensor (or an
    error), the plain twin for a CPU tensor. Returns ((3, N) planes t, u,
    v; (packets,) int32 pops)."""
    if rays.device.type == "cpu":
        return stripped_trace_plain(dw, t_min, rays, variant)
    _check_args(variant, t_min)
    _check_rays(rays)
    wp = build.wide_params(dw, t_min)
    if rays.device != wp.device:
        raise ValueError(f"rays on {rays.device}, BVH on {wp.device}")
    out = build.launch_stripped_trace(wp, rays,
                                      list(VARIANTS).index(variant))
    stripped_trace.launches += 1
    return out


stripped_trace.launches = 0

"""K6, the packet trace of the 8-wide BVH with a leaf queue: the wavefront
loop's per-bounce payload trace, and its shadow-ray trace, on the scenes
whose wide BVH sfvp_tpu streams (``stream_tris``, dispatch.py
``stream_tris``).

``packet_trace2`` traces one (N,) wave: on a CUDA tensor through the
hand-written kernel csrc/packet_trace2.cu, on a CPU tensor through its
plain PyTorch twin ``packet_trace2_plain``. It takes and returns the planes
of K3 (kernels/bvh_packet.py): 7 ray planes in, the 19 payload planes out.

Counterpart of sfvp_tpu/kernels/bvh_packet2.py (``make_packet_trace2``).
Where K3 walks each ray alone, K6 walks the tree per packet of 1024
consecutive rays of the wave, as the TPU kernel does, so its visit order,
and with it the triangle that wins an exact tie in t, is the JAX kernel's:
  - a node pop pushes every child whose box ANY ray of the packet enters
    within its own [t_min, min(best t, t_max)];
  - the pushed children are ordered by the slab entry distance of the
    packet's CENTER ray (ray 576: row 4, lane 64 of the TPU's 8 x 128
    tile), descending, through the 19-comparator network, whether or not
    that ray enters them;
  - internal codes go to the packet's node stack and leaf rows to its FIFO
    leaf queue of ``leaf_q`` entries; a leaf that finds the queue full
    goes to the stack as a negative code, and when popped is re-enqueued
    if there is room, or else put back, that pop pushing nothing;
  - every iteration runs one node pop and then one leaf pop, in which
    every ray of the packet tests the 8 triangles of the queue's head row
    (strict t < best, the lowest slot winning an equal t).
Padding rays (the last packet's) have o = d = 0 and t_max = -inf, as the
TPU kernel's, and still order a packet whose center they are.

The TPU kernel's interleave of packets, payload carry and SMEM code table
(``n_packets``, ``payload_in_carry``, ``smem_codes``) change no packet's
result, since each packet's work is gated by its own counters
(bvh_packet2.py:168-173), and have no counterpart here. Its HBM-to-VMEM
leaf ring is the streaming itself: here every tree lives in device memory.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.vec import f32
from . import build
from .bvh_packet import (
    DeviceWide,
    Payload,
    _check_rays,
    _child_codes,
    _slot_tests,
    _sort_desc,
    payload_from_planes,
    payload_planes,
    ray_planes,
)
from .bvh_traverse import safe_inv, slab

PACKET = 1024             # rays of a packet: 8 rows x 128 lanes on the TPU
CENTER = 4 * 128 + 64     # the packet's ray whose entry distances order it
LEAF_Q = 64               # sfvp_tpu's default leaf-queue capacity


def check_leaf_q(leaf_q: int) -> None:
    """The leaf queue's capacity: a power of two (its index is masked), at
    most build.MAX_LEAF_Q (the kernel's shared-memory queue)."""
    if not 1 <= leaf_q <= build.MAX_LEAF_Q or leaf_q & (leaf_q - 1):
        raise ValueError(f"leaf_q must be a power of two in 1.."
                         f"{build.MAX_LEAF_Q}, got {leaf_q}")


def _to_queue(lq, lt, qmask, idx, rows, mask):
    """Append leaf row ``rows`` to the queue of each packet ``idx`` where
    ``mask`` is set."""
    slot = lt[idx] & qmask
    lq[idx, slot] = torch.where(mask, rows, lq[idx, slot])
    lt[idx] += mask.to(lt.dtype)


def _to_stack(stack, sp, idx, codes, mask):
    """Push ``codes`` onto the stack of each packet ``idx`` where ``mask``
    is set (an index past the stack raises where one is pushed)."""
    top = torch.where(mask, sp[idx], torch.clamp_max(sp[idx],
                                                     stack.shape[1] - 1))
    stack[idx, top] = torch.where(mask, codes, stack[idx, top])
    sp[idx] += mask.to(sp.dtype)


def _push_children(stack, sp, lq, lt, lh, qmask, ii, child):
    """Push the (M, 8) child codes of packets ``ii`` in slot order (0 =
    none): the k-th leaf row goes to the queue while it has room for it,
    every other code to the stack, as one code after another would."""
    leaf_q = lq.shape[1]
    is_leaf = child < 0
    room = leaf_q - (lt[ii] - lh[ii])
    to_q = is_leaf & (torch.cumsum(is_leaf, dim=1) <= room[:, None])
    to_s = (child != 0) & ~to_q
    rows = ii[:, None].expand(-1, 8)
    qpos = (lt[ii][:, None] + torch.cumsum(to_q, dim=1) - 1) & qmask
    spos = sp[ii][:, None] + torch.cumsum(to_s, dim=1) - 1
    lq[rows[to_q], qpos[to_q]] = -child[to_q] - 1
    stack[rows[to_s], spos[to_s]] = child[to_s]
    lt[ii] += to_q.sum(dim=1)
    sp[ii] += to_s.sum(dim=1)


def packet_trace2_plain(dw: DeviceWide, t_min: float, rays: torch.Tensor,
                        leaf_q: int = LEAF_Q,
                        counts: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch twin of the K6 kernel: same arguments, same results.

    rays: (7, N) float32 planes ox oy oz dx dy dz tmax (tmax = -inf for an
    inactive ray). Returns the (19, N) payload planes of K3 (t, u, v, p0,
    p1, p2, albedo, emission, mtype).

    Vectorised over packets: each pass runs one iteration of every packet
    that has work left, with (P, max_stack + leaf_q) stacks, (P, leaf_q)
    queues and the box and triangle tests on (P, 1024, 8) tensors.
    ``counts``, when given, gains the packets' internal-node pops
    ("node_pops": 1024 x 8 box tests and the network each), leaf pops
    ("leaf_pops": 1024 x 8 triangle tests), pops of spilled leaves
    ("spill_pops") and iterations ("iterations").
    """
    check_leaf_q(leaf_q)
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
    stack = torch.zeros((n_pk, dw.max_stack + leaf_q), **i64)
    stack[:, 0] = 1  # the root, internal node 0
    sp = torch.ones(n_pk, **i64)
    lq = torch.zeros((n_pk, leaf_q), **i64)
    lh = torch.zeros(n_pk, **i64)
    lt = torch.zeros(n_pk, **i64)
    qmask = leaf_q - 1
    bt = torch.full((n_pk, PACKET), float("inf"), device=dev)
    bu = torch.zeros((n_pk, PACKET), device=dev)
    bv = torch.zeros((n_pk, PACKET), device=dev)
    brow = torch.full((n_pk, PACKET), -1, **i64)
    bslot = torch.zeros((n_pk, PACKET), **i64)
    tally = dict.fromkeys(("node_pops", "leaf_pops", "spill_pops",
                           "iterations"), 0)
    while True:
        a = torch.nonzero(sp + lt - lh > 0).squeeze(1)
        if a.numel() == 0:
            break
        # node phase: pop one code of every packet with a non-empty stack
        ni = a[sp[a] > 0]
        sp[ni] -= 1
        code = stack[ni, sp[ni]]
        inner = torch.nonzero(code > 0).squeeze(1)
        ii = ni[inner]
        if ii.numel():
            f = dw.nodes[code[inner] - 1, :64].view(-1, 8, 8)  # field, child
            box = tuple(f[:, k, None, :] for k in range(6))     # (M, 1, 8)
            limit = torch.minimum(bt[ii], tmax[ii])[..., None]
            tnear, tfar = slab(box[:3], box[3:],
                               tuple(c[ii][..., None] for c in o),
                               tuple(c[ii][..., None] for c in inv),
                               t_min, limit)
            vote = (tnear <= tfar).any(dim=1)                  # any ray
            key = slab(tuple(f[:, k] for k in range(3)),
                       tuple(f[:, k] for k in range(3, 6)),
                       tuple(c[ii] for c in c_o), tuple(c[ii] for c in c_inv),
                       t_min, no_limit)[0]                     # center ray
            child = _child_codes(f)
            push = vote & (child != 0)
            key = torch.where(push, key, float("-inf"))
            child = torch.where(push, child, 0)
            _sort_desc(key, child)
            # far to near: internal codes to the stack, leaf rows to the
            # queue while it has room, to the stack when it is full
            _push_children(stack, sp, lq, lt, lh, qmask, ii, child)
        # a spilled leaf surfaced by the pop: re-enqueue it, or put it back
        spilled = code < 0
        room = (lt[ni] - lh[ni]) < leaf_q
        _to_queue(lq, lt, qmask, ni, -code - 1, spilled & room)
        _to_stack(stack, sp, ni, code, spilled & ~room)
        # leaf phase: every ray of the packet against the head row
        la = a[lt[a] > lh[a]]
        if la.numel():
            lrow = lq[la, lh[la] & qmask]
            lh[la] += 1
            slot, t, u, v = _slot_tests(
                dw.tris[lrow].view(-1, 1, 8, 16),
                tuple(c[la][..., None] for c in ray), t_min,
                bt[la][..., None])
            better = t < bt[la]
            bt[la] = torch.where(better, t, bt[la])
            bu[la] = torch.where(better, u, bu[la])
            bv[la] = torch.where(better, v, bv[la])
            brow[la] = torch.where(better, lrow[:, None], brow[la])
            bslot[la] = torch.where(better, slot, bslot[la])
        tally["node_pops"] += ii.numel()
        tally["leaf_pops"] += la.numel()
        tally["spill_pops"] += ni.numel() - ii.numel()
        tally["iterations"] += a.numel()
    if counts is not None:
        for k, v in tally.items():
            counts[k] = counts.get(k, 0) + v

    def flat(x):
        return x.reshape(-1)[:n]

    return payload_planes(dw.tris, flat(bt), flat(bu), flat(bv), flat(brow),
                          flat(bslot), dw.tris_aux)


def packet_trace2(dw: DeviceWide, t_min: float, rays: torch.Tensor,
                  leaf_q: int = LEAF_Q):
    """K6 on the rays' device: the CUDA kernel for a CUDA tensor (or an
    error), the plain twin for a CPU tensor. ``packet_trace2.launches``
    counts kernel launches."""
    if rays.device.type == "cpu":
        return packet_trace2_plain(dw, t_min, rays, leaf_q)
    _check_rays(rays)
    check_leaf_q(leaf_q)
    wp = build.wide_params(dw, t_min, leaf_q=leaf_q)
    if rays.device != wp.device:
        raise ValueError(f"rays on {rays.device}, BVH on {wp.device}")
    out = build.launch_packet_trace2(wp, rays, leaf_q)
    packet_trace2.launches += 1
    return out


packet_trace2.launches = 0


def make_packet_trace2(dw: DeviceWide, t_min: float, leaf_q: int = LEAF_Q):
    """Build ``trace(o, d, t_max, active=None) -> Payload`` over (N,) SoA
    rays on the device of ``dw``, as sfvp_tpu's make_packet_trace2.
    Inactive rays report a miss."""
    check_leaf_q(leaf_q)

    def trace(o, d, t_max, active=None) -> Payload:
        rays = ray_planes(o, d, t_max, active)
        return payload_from_planes(packet_trace2(dw, t_min, rays, leaf_q))

    return trace

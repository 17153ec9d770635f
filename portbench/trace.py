"""What a torch.profiler Chrome trace says about the card over the traced
steps: its busy time, its operations by name, its idle gaps with what
the host was doing in each, and the host's own work in each step's issue.

A span counts as the card's only if the card ran it: a kernel, copy or
set category, a stream and a launch's correlation id in its args, and no
operator's name (``aten::``), so no operator's span that wraps its
kernels is counted beside them (the filter of ``chip_smoke.py``
``device_activity``, which ``sfvp_tpu_torch/utils/profiling.py`` traces
for).
"""

from __future__ import annotations

import json
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP = "portbench.step"
ISSUE = "portbench.issue"
TOP = 10
# CUDA runtime and driver calls in which the host waits for the card: a
# copy to or from pageable memory waits for the stream, a synchronise for
# the device
WAITS = ("Memcpy", "Synchronize")


class Activity(NamedTuple):
    window_s: float    # first traced step's start to the last one's end
    busy_s: float      # union of the card's spans inside the window
    device_s: float    # sum of the card's spans inside the window
    steps: int         # traced steps
    device_ops: list   # [[name, seconds], ...], the most time first
    idle_gaps: list    # [[what the host did, seconds], ...], longest first
    host_work_s: list  # a traced step's issue less its waits, in order


def device_spans(events):
    return [e for e in events
            if "dur" in e and e.get("cat") in DEVICE_CATS
            and "stream" in (e.get("args") or {})
            and "correlation" in (e.get("args") or {})
            and not e["name"].startswith("aten::")]


def union(intervals):
    """Merged [(start, end)] of intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def host_label(events, t):
    """The harness's phase and the innermost host operation running at
    time ``t`` (microseconds), e.g. ``sync: cudaDeviceSynchronize``."""
    phase, inner, inner_dur = "between steps", None, float("inf")
    for e in events:
        if "dur" not in e or not e["ts"] <= t < e["ts"] + e["dur"]:
            continue
        cat = e.get("cat")
        if cat == "user_annotation" and e["name"].startswith("portbench."):
            if e["name"] != STEP:
                phase = e["name"].split(".", 1)[1]
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver",
                     "python_function") and e["dur"] < inner_dur:
            inner, inner_dur = e["name"], e["dur"]
    return phase if inner is None else f"{phase}: {inner}"


def host_work(events):
    """Seconds of each ``portbench.issue`` span in which the host worked:
    the span less the union of the runtime and driver calls inside it
    that wait for the card (``WAITS``)."""
    waits = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if "dur" in e and e.get("cat") in ("cuda_runtime", "cuda_driver")
             and any(w in e["name"] for w in WAITS)]
    out = []
    for e in sorted((e for e in events
                     if e.get("name") == ISSUE and "dur" in e),
                    key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        inside = [(max(s, a), min(t, b)) for s, t in waits
                  if min(t, b) > max(s, a)]
        waited = sum(y - x for x, y in union(inside))
        out.append((b - a - waited) * 1e-6)
    return out


def activity(events) -> Activity:
    """Read the trace's events; the window is spanned by the harness's
    ``portbench.step`` annotations."""
    steps = [e for e in events if e.get("name") == STEP and "dur" in e]
    if not steps:
        raise ValueError("the trace holds no traced step")
    t0 = min(e["ts"] for e in steps)
    t1 = max(e["ts"] + e["dur"] for e in steps)
    clipped = [(max(e["ts"], t0), min(e["ts"] + e["dur"], t1), e["name"])
               for e in device_spans(events)]
    clipped = [(a, b, n) for a, b, n in clipped if b > a]
    merged = union((a, b) for a, b, _ in clipped)
    busy = sum(b - a for a, b in merged)
    by_name = {}
    for a, b, name in clipped:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host = [e for e in events if e.get("cat") not in DEVICE_CATS]
    idle = [[host_label(host, (a + b) / 2), (b - a) * 1e-6] for a, b in gaps]
    return Activity(window_s=(t1 - t0) * 1e-6, busy_s=busy * 1e-6,
                    device_s=sum(by_name.values()) * 1e-6, steps=len(steps),
                    device_ops=[[n, us * 1e-6] for n, us in ops],
                    idle_gaps=idle, host_work_s=host_work(events))


def read_trace(path) -> Activity:
    with open(path) as f:
        return activity(json.load(f)["traceEvents"])

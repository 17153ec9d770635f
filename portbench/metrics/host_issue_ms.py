"""The host's own work a step in the progressive loop, in milliseconds:
the median over the profiled steps of a --trace 1 run of the time in
``Renderer.step()`` (the harness's ``portbench.issue`` span) less the
CUDA calls inside it that wait for the card (trace.host_work). What the
loop, the step wrapper, the launch and the accumulation cost the host,
with the profiler's own cost a recorded operation; not the time the
host is held by a copy that waits for the kernel."""

import numpy as np


def read(rec):
    act = rec.activity
    if act is None or not act.host_work_s:
        return None
    return float(np.median(act.host_work_s) * 1e3)

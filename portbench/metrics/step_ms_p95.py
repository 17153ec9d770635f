"""The 95th percentile (numpy's linear interpolation) of every observed
step's latency in the window, issue to the synchronise's return, in
milliseconds: the frame interval a viewer waits."""

import numpy as np


def read(rec):
    if not rec.step_s:
        return None
    return float(np.percentile(np.asarray(rec.step_s) * 1e3, 95))

"""Camera samples completed over the window (width x height x spp a step,
times the observed steps), divided by the window's wall time, in
millions a second."""


def read(rec):
    if not rec.step_s:
        return None
    return rec.samples_per_step * len(rec.step_s) / rec.window_s / 1e6

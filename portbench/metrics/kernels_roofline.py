"""The least time a step could take on the card (roofline.py: the frozen
rays of the cell times a floor per ray over the FP32 peak, or its bytes
over the memory bandwidth) over the card's time in the operations of a
traced step (kernels, copies and sets, summed), in percent. Nothing for a
card not in peaks.json or a run without a trace."""


def read(rec):
    act = rec.activity
    least = rec.least_step_s()
    if act is None or least is None or act.device_s <= 0:
        return None
    return 100.0 * least / (act.device_s / act.steps)

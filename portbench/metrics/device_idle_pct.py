"""The share of the traced steps' window (first step's issue to the last
one's synchronise) in which the card ran no operation, in percent."""


def read(rec):
    act = rec.activity
    if act is None or act.window_s <= 0:
        return None
    return 100.0 * (1.0 - act.busy_s / act.window_s)

"""The share of the traced window in which no kernel, copy or set runs on
the card, in %."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)

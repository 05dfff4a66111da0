"""GB/s: the must-move bytes of every request that completed in the
window, over the window's seconds."""


def read(w):
    return w.must_move_bytes * len(w.latencies) / w.seconds / 1e9

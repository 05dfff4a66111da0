"""GiB: ``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start."""


def read(w):
    return w.peak_bytes / 2**30

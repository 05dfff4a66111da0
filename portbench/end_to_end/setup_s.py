"""s: from the process's start to the first timed request: importing the
port, the CUDA context, loading (the first time in a checkout: building)
the kernels, making and holding the field, the warm requests."""


def read(w):
    return w.setup_s

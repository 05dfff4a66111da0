"""The block functions a mix may name, copied from the port's
``models/pipelines.py`` (the forms a user writes): a mix's ``"func"`` is
a name in ``FUNCS``."""

import torch


def laplace_roll(b):
    """The depth-1 Laplace as shifted windows of the padded block (the form
    the band-stencil kernel takes)."""
    return (
        torch.roll(b, 1, 0) + torch.roll(b, -1, 0)
        + torch.roll(b, 1, 1) + torch.roll(b, -1, 1)
        - 4 * b
    )


def laplace_slices(p):
    """The depth-1 Laplace of a block with a 1-cell ghost ring: five
    shifted windows of ``p``, already the trimmed output shape."""
    return (
        p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
        - 4 * p[1:-1, 1:-1]
    )


FUNCS = {f.__name__: f for f in (laplace_roll, laplace_slices)}

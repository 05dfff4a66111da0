"""Small sizes of each configuration for runs on the CPU (the port's
plain versions); the field of ``reduction_tree`` is not square, so its
three answers differ in shape."""

SMALL = {
    "stencil2d_64k": {"shape": [64, 64], "chunks": [16, 16]},
    "stencil2d_32k": {"shape": [48, 48], "chunks": [12, 12]},
    "reduction_tree": {"shape": [120, 90], "chunks": [12, 9]},
}

"""The band stencil of the PyTorch port (kernels/stencil.py, BandStencil).

Mirrors tests/test_band_stencil.py: the same numpy inputs go through the
JAX package's Pallas band kernel in interpret mode (or its plain Overlap
path) and through the port, whose BandStencil runs the kernel's plain
version on a CPU tensor.  Tolerance: atol 1e-5 for float32, 1e-12 for
float64 (the two packages sum the shifted windows in different orders).
The CUDA kernel itself runs in tests/test_torch_gpu.py, on a card.
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu import config as jconfig
from dask_array_tpu.kernels.stencil import band_stencil_call as jax_band_stencil_call
from dask_array_tpu.ops._overlap import BandStencil as JaxBandStencil
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.kernels import stencil
from dask_array_tpu_torch.ops._overlap import BandStencil

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield

MODES = ["reflect", "nearest", "periodic", 0.0, 2.5]
_NP_MODE = {"reflect": "symmetric", "nearest": "edge", "periodic": "wrap"}


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def t_laplace(b):
    return (
        torch.roll(b, 1, 0) + torch.roll(b, -1, 0) + torch.roll(b, 1, 1) + torch.roll(b, -1, 1)
        - 4 * b
    )


def j_laplace(b):
    import jax.numpy as jnp

    return (
        jnp.roll(b, 1, 0) + jnp.roll(b, -1, 0) + jnp.roll(b, 1, 1) + jnp.roll(b, -1, 1)
        - 4 * b
    )


def np_pad(x, depth, boundary):
    """numpy's pad, rows first, then columns on the row-padded array."""
    for ax, (d, mode) in enumerate(zip(depth, boundary)):
        if not d:
            continue
        pw = [(0, 0), (0, 0)]
        pw[ax] = (d, d)
        if isinstance(mode, str):
            x = np.pad(x, pw, mode=_NP_MODE[mode])
        else:
            x = np.pad(x, pw, mode="constant", constant_values=mode)
    return x


def np_stencil(x, taps, depth, boundary):
    """sum_k w_k * x_pad[i + dy_k, j + dx_k] over the interior, in float64."""
    p = np_pad(x.astype(np.float64), depth, boundary)
    d0, d1 = depth
    M, N = x.shape
    out = np.zeros((M, N))
    for dy, dx, w in taps:
        out += w * p[d0 + dy : d0 + dy + M, d1 + dx : d1 + dx + N]
    return out


LAPLACE_TAPS = ((-1, 0, 1.0), (1, 0, 1.0), (0, -1, 1.0), (0, 1, 1.0), (0, 0, -4.0))


def _both(rng, boundary, depth, shape=(64, 96), chunks=(16, 48), tfunc=t_laplace, jfunc=j_laplace):
    x = rng.standard_normal(shape).astype(np.float32)
    got = tda.map_overlap(tfunc, tda.from_array(x, chunks=chunks), depth=depth, boundary=boundary, dtype="float32")
    assert isinstance(got.expr, BandStencil)
    with jconfig.set({"tpu.stencil-kernel": "interpret"}):
        ref = jda.map_overlap(jfunc, jda.from_array(x, chunks=chunks), depth=depth, boundary=boundary, dtype="float32")
        assert isinstance(ref.expr, JaxBandStencil)
        want = ref.compute()
    return x, got.compute(), want


# ---------------------------------------------------------------------------
# through map_overlap, against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("boundary", MODES)
def test_band_stencil_boundaries(rng, boundary):
    x, got, want = _both(rng, boundary, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np_stencil(x, LAPLACE_TAPS, (1, 1), (boundary, boundary)), atol=1e-5)


def test_band_stencil_mixed_depth(rng):
    x, got, want = _both(rng, "reflect", {0: 2, 1: 1})
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_band_stencil_depth_zero_axis(rng):
    # depth-0 axis: the function must be local along it, so a vertical stencil
    def tvert(b):
        return torch.roll(b, 1, 0) + torch.roll(b, -1, 0) - 2 * b

    def jvert(b):
        import jax.numpy as jnp

        return jnp.roll(b, 1, 0) + jnp.roll(b, -1, 0) - 2 * b

    x, got, want = _both(rng, "reflect", {0: 1, 1: 0}, tfunc=tvert, jfunc=jvert)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_band_stencil_depth_zero_axis_boundary_none(rng):
    # boundary={0: ...} leaves axis 1 at "none"; with depth 0 there it pads nothing
    def tvert(b):
        return torch.roll(b, 1, 0) + torch.roll(b, -1, 0) - 2 * b

    def jvert(b):
        import jax.numpy as jnp

        return jnp.roll(b, 1, 0) + jnp.roll(b, -1, 0) - 2 * b

    x = rng.standard_normal((64, 96)).astype(np.float32)
    got = tda.map_overlap(tvert, tda.from_array(x, chunks=(16, 48)), depth={0: 1}, boundary={0: "periodic"},
                          dtype="float32")
    assert isinstance(got.expr, BandStencil)
    want = jda.map_overlap(jvert, jda.from_array(x, chunks=(16, 48)), depth={0: 1}, boundary={0: "periodic"},
                           dtype="float32").compute()
    np.testing.assert_allclose(got.compute(), want, atol=1e-5)
    taps = ((-1, 0, 1.0), (1, 0, 1.0), (0, 0, -2.0))
    np.testing.assert_allclose(got.compute(), np_stencil(x, taps, (1, 0), ("periodic", 0.0)), atol=1e-5)
    plain = stencil.band_stencil_plain(torch.from_numpy(x), tvert, (1, 0), ("periodic", "none"))
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5)


def test_pad_axis_boundary_names():
    t = torch.arange(6.0).reshape(2, 3)
    assert stencil.pad_axis(t, 1, 0, 0, "none") is t
    for bad in ("none", "symmetric", "bogus"):
        with pytest.raises(ValueError, match="unknown boundary mode"):
            stencil.pad_axis(t, 1, 1, 0, bad)


def test_band_stencil_depth_eight(rng):
    def tfar(b):
        return torch.roll(b, 8, 0) - torch.roll(b, -8, 1) * 0.5 + torch.roll(torch.roll(b, -3, 0), 5, 1) / 4

    def jfar(b):
        import jax.numpy as jnp

        return jnp.roll(b, 8, 0) - jnp.roll(b, -8, 1) * 0.5 + jnp.roll(jnp.roll(b, -3, 0), 5, 1) / 4

    x, got, want = _both(rng, "periodic", 8, tfunc=tfar, jfunc=jfar)
    np.testing.assert_allclose(got, want, atol=1e-5)
    taps = ((-8, 0, 1.0), (0, 8, -0.5), (3, -5, 0.25))
    np.testing.assert_allclose(got, np_stencil(x, taps, (8, 8), ("periodic", "periodic")), atol=1e-5)


# ---------------------------------------------------------------------------
# every mixed pair of boundaries (the corners), against numpy and Overlap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b0", MODES)
@pytest.mark.parametrize("b1", MODES)
def test_band_stencil_boundary_pairs(rng, b0, b1):
    def corner(b):
        return torch.roll(torch.roll(b, 1, 0), -1, 1) * 0.5 - torch.roll(b, -1, 0) + 2 * b

    taps = stencil.capture_taps(corner, (1, 1))
    assert sorted(taps) == sorted(((-1, 1, 0.5), (1, 0, -1.0), (0, 0, 2.0)))
    x = rng.standard_normal((20, 28))
    d = tda.from_array(x, chunks=(10, 14))
    fast = tda.map_overlap(corner, d, depth=1, boundary={0: b0, 1: b1}, dtype="float64")
    assert isinstance(fast.expr, BandStencil)
    with tconfig.set({"stencil-kernel": "off"}):
        slow = tda.map_overlap(corner, d, depth=1, boundary={0: b0, 1: b1}, dtype="float64")
    assert not isinstance(slow.expr, BandStencil)
    want = np_stencil(x, taps, (1, 1), (b0, b1))
    np.testing.assert_allclose(fast.compute(), want, atol=1e-12)
    np.testing.assert_allclose(slow.compute(), want, atol=1e-12)


# ---------------------------------------------------------------------------
# the plain version against the JAX kernel called directly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "depth, boundary",
    [((1, 1), ("reflect", "reflect")), ((2, 1), ("periodic", 0.0)), ((1, 2), ("nearest", 2.5))],
)
def test_plain_matches_jax_band_stencil_call(rng, depth, boundary):
    import jax.numpy as jnp

    x = rng.standard_normal((32, 128)).astype(np.float32)

    def tf(b):
        return torch.roll(b, depth[0], 0) - 0.5 * torch.roll(b, -depth[1], 1) + b

    def jf(b):
        return jnp.roll(b, depth[0], 0) - 0.5 * jnp.roll(b, -depth[1], 1) + b

    want = np.asarray(jax_band_stencil_call(jnp.asarray(x), jf, depth, boundary, band=16, interpret=True))
    got = stencil.band_stencil_plain(torch.from_numpy(x), tf, depth, boundary).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mode", ["reflect", "nearest", "periodic", -1.5])
@pytest.mark.parametrize("lo, hi", [(1, 2), (3, 0), (7, 9)])
def test_pad_axis_matches_numpy(mode, lo, hi):
    x = np.arange(15.0).reshape(3, 5)
    for axis in (0, 1):
        pw = [(0, 0), (0, 0)]
        pw[axis] = (lo, hi)
        if isinstance(mode, str):
            want = np.pad(x, pw, mode=_NP_MODE[mode])
        else:
            want = np.pad(x, pw, mode="constant", constant_values=mode)
        got = stencil.pad_axis(torch.from_numpy(x), axis, lo, hi, mode).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# tap capture
# ---------------------------------------------------------------------------


def test_capture_taps_roll_signs():
    # torch.roll(b, 1, 0)[i] == b[i - 1]: offset -1
    assert stencil.capture_taps(lambda b: torch.roll(b, 1, 0), (1, 1)) == ((-1, 0, 1.0),)
    assert stencil.capture_taps(lambda b: torch.roll(b, -1, 1), (1, 1)) == ((0, 1, 1.0),)
    assert stencil.capture_taps(lambda b: b.roll(2, dims=0), (2, 0)) == ((-2, 0, 1.0),)
    assert stencil.capture_taps(lambda b: torch.roll(b, (1, -1), (0, 1)), (1, 1)) == ((-1, 1, 1.0),)
    assert stencil.capture_taps(lambda b: torch.roll(b, shifts=1, dims=-2), (1, 1)) == ((-1, 0, 1.0),)
    assert stencil.capture_taps(t_laplace, (1, 1)) == LAPLACE_TAPS


def test_capture_taps_scalar_scaling():
    taps = stencil.capture_taps(lambda b: -(3 * torch.roll(b, 1, 1) - b / 4) * 2, (1, 1))
    assert dict(((dy, dx), w) for dy, dx, w in taps) == {(0, -1): -6.0, (0, 0): 0.5}
    assert stencil.capture_taps(lambda b: b - b, (1, 1)) == ((0, 0, 0.0),)


@pytest.mark.parametrize(
    "func, depth",
    [
        (lambda b: torch.sin(b), (1, 1)),
        (lambda b: torch.roll(b, 2, 0), (1, 1)),
        (lambda b: torch.roll(torch.roll(b, 1, 0), 1, 0), (1, 1)),
        (lambda b: b * b, (1, 1)),
        (lambda b: b + 1.0, (1, 1)),
        (lambda b: torch.roll(b, 1), (1, 1)),
        (lambda b: torch.roll(b, 1, 1), (1, 0)),
        (lambda b: b[1:], (1, 1)),
    ],
)
def test_capture_taps_declines(func, depth):
    assert stencil.capture_taps(func, depth) is None


def _row8(b):
    return torch.roll(b, 8, 0) - 2 * b + torch.roll(b, -8, 0)


@pytest.mark.parametrize(
    "cfg, ndim, dtype, depth, boundary, kwargs, takes",
    [
        ({}, 2, "float32", ((8, 8), (0, 0)), ("reflect", None), {}, True),
        ({}, 2, "bfloat16", ((8, 8), (0, 0)), (2.5, None), {}, True),
        ({}, 2, "float32", ((9, 9), (0, 0)), ("reflect", None), {}, False),
        ({"stencil-kernel": "off"}, 2, "float32", ((8, 8), (0, 0)), ("reflect", None), {}, False),
        ({}, 2, "int32", ((8, 8), (0, 0)), ("reflect", None), {}, False),
        ({}, 3, "float32", ((8, 8), (0, 0), (0, 0)), ("reflect", None, None), {}, False),
        ({}, 2, "float32", ((8, 7), (0, 0)), ("reflect", None), {}, False),
        ({}, 2, "float32", ((8, 8), (0, 0)), ("none", None), {}, False),
        ({}, 2, "float32", ((8, 8), (0, 0)), ("reflect", None), {"scale": 2.0}, False),
    ],
    ids=["depth8", "bf16_constant", "depth9", "kernel_off", "int", "three_d", "asymmetric", "boundary_none",
         "kwargs"],
)
def test_stencil_taps_gate(cfg, ndim, dtype, depth, boundary, kwargs, takes):
    """The one gate of every route to the band-stencil kernel: the config,
    the dtype, the rank, symmetric depth at most 8, the boundary and the
    func kwargs, then ``capture_taps``."""
    with tconfig.set(cfg):
        taps = stencil.stencil_taps(ndim, dtype, depth, boundary, _row8, kwargs)
    assert (taps is not None) == takes
    if takes:
        assert sorted(taps) == [(-8, 0, 1.0), (0, 0, -2.0), (8, 0, 1.0)]


# ---------------------------------------------------------------------------
# routes that are not eligible take Overlap, and still agree
# ---------------------------------------------------------------------------


def test_ineligible_three_d(rng):
    x = rng.standard_normal((8, 8, 8))
    got = tda.map_overlap(lambda b: b * 2.0, tda.from_array(x, chunks=4), depth=1, boundary="reflect", dtype="float64")
    assert not isinstance(got.expr, BandStencil)
    ref = jda.map_overlap(lambda b: b * 2.0, jda.from_array(x, chunks=4), depth=1, boundary="reflect", dtype="float64")
    np.testing.assert_allclose(got.compute(), ref.compute(), atol=1e-12)
    np.testing.assert_allclose(got.compute(), x * 2.0, atol=1e-12)


def test_ineligible_asymmetric_none(rng):
    x = rng.standard_normal((64, 64)).astype("f4")
    got = tda.map_overlap(lambda b: b, tda.from_array(x, chunks=16), depth={0: (1, 0), 1: 0}, boundary="none", dtype="float32")
    assert not isinstance(got.expr, BandStencil)
    ref = jda.map_overlap(lambda b: b, jda.from_array(x, chunks=16), depth={0: (1, 0), 1: 0}, boundary="none", dtype="float32")
    np.testing.assert_array_equal(got.compute(), ref.compute())


def test_ineligible_nonlinear_func(rng):
    """A non-linear func is no stencil of taps, but the band kernel takes it
    as a program (tests/test_torch_band_program.py); it agrees with the JAX
    package's Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    x = rng.standard_normal((64, 64)).astype("f4")
    got = tda.map_overlap(lambda b: torch.sin(torch.roll(b, 1, 0)) * b, tda.from_array(x, chunks=16),
                          depth=1, boundary="nearest", dtype="float32")
    assert isinstance(got.expr, BandStencil) and stencil.is_program(got.expr.taps)
    with jconfig.set({"tpu.stencil-kernel": "interpret"}):
        ref = jda.map_overlap(lambda b: jnp.sin(jnp.roll(b, 1, 0)) * b, jda.from_array(x, chunks=16),
                              depth=1, boundary="nearest", dtype="float32")
        assert isinstance(ref.expr, JaxBandStencil)
        want = ref.compute()
    np.testing.assert_allclose(got.compute(), want, atol=1e-5)


def test_ineligible_median_filter_keeps_overlap(rng):
    """A func the capture declines (a stack and a median) keeps the
    ``Overlap`` route and agrees with the JAX package."""
    import jax.numpy as jnp

    offsets = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    x = rng.standard_normal((64, 64)).astype("f4")
    got = tda.map_overlap(lambda b: torch.stack([torch.roll(b, o, (0, 1)) for o in offsets]).median(0).values,
                          tda.from_array(x, chunks=16), depth=1, boundary="reflect", dtype="float32")
    assert not isinstance(got.expr, BandStencil)
    ref = jda.map_overlap(lambda b: jnp.median(jnp.stack([jnp.roll(b, o, (0, 1)) for o in offsets]), axis=0),
                          jda.from_array(x, chunks=16), depth=1, boundary="reflect", dtype="float32")
    np.testing.assert_array_equal(got.compute(), ref.compute())


def test_stencil_kernel_off_keeps_overlap(rng):
    x = rng.standard_normal((64, 64)).astype("f4")
    with tconfig.set({"stencil-kernel": "off"}):
        o = tda.map_overlap(t_laplace, tda.from_array(x, chunks=16), depth=1, boundary="reflect", dtype="float32")
    assert not isinstance(o.expr, BandStencil)
    np.testing.assert_allclose(o.compute(), np_stencil(x, LAPLACE_TAPS, (1, 1), ("reflect",) * 2), atol=1e-5)


# ---------------------------------------------------------------------------
# the CUDA wrapper
# ---------------------------------------------------------------------------


def test_cuda_wrapper_refuses_cpu_tensor():
    # the kernel itself runs in tests/test_torch_gpu.py, on a card
    with pytest.raises(ValueError, match="CUDA tensor"):
        stencil.band_stencil_cuda(torch.zeros(8, 8), LAPLACE_TAPS, (1, 1), ("reflect", "reflect"))


# ---------------------------------------------------------------------------
# what the launcher gets: the tap table, the kernel variant, the row path
# ---------------------------------------------------------------------------


def unpack_table(table):
    """``band_stencil_launch``'s reading of a tap table."""
    import struct

    head = struct.unpack("<8i", table[:32])
    n = head[4]
    fills = struct.unpack("<2d", table[32:48])
    window = struct.unpack("<9d", table[48:120])
    weights = struct.unpack(f"<{n}d", table[120:120 + 8 * n])
    offs = struct.unpack(f"<{2 * n}i", table[120 + 8 * n:])
    assert len(table) == 120 + 16 * n
    return head, fills, window, weights, offs[:n], offs[n:]


@pytest.mark.parametrize("depth, variant", [((1, 1), 1), ((2, 2), 0), ((1, 0), 0), ((0, 1), 0), ((2, 1), 0),
                                            ((8, 8), 0), ((0, 0), 0), ((3, 3), 0)])
def test_kernel_variant_by_depth(depth, variant):
    assert stencil.kernel_variant(depth) == variant


def test_tap_table_of_the_five_point_stencil():
    head, fills, window, weights, dys, dxs = unpack_table(
        stencil._tap_table(LAPLACE_TAPS, (1, 1), ("reflect", 2.5), torch.float32))
    assert head[:6] == (1, 1, 0, 3, 5, 1)  # depths, reflect, constant, 5 taps, window (1,1)
    assert fills == (0.0, 2.5)
    taps = {(dy, dx): w for dy, dx, w in LAPLACE_TAPS}
    # the dense 3x3 window holds each tap at (dy + 1) * 3 + dx + 1, its mask
    # bit set there and nowhere else: the empty corners are skipped, not
    # multiplied by 0 (an inf input stays an inf)
    for a in range(3):
        for b in range(3):
            slot = a * 3 + b
            assert bool(head[6] >> slot & 1) == ((a - 1, b - 1) in taps)
            assert window[slot] == taps.get((a - 1, b - 1), 0.0)
    assert list(zip(dys, dxs, weights)) == [(dy, dx, w) for dy, dx, w in LAPLACE_TAPS]


def test_tap_table_of_the_tap_list_kernel():
    taps = stencil.capture_taps(lambda b: torch.roll(b, 2, 0) - torch.roll(b, -1, 1) * 0.5, (2, 1))
    head, _, window, weights, dys, dxs = unpack_table(
        stencil._tap_table(taps, (2, 1), ("periodic", "nearest"), torch.float64))
    assert head[:7] == (2, 1, 2, 1, 2, 0, 0)  # no window: variant 0 and an empty mask
    assert window == (0.0,) * 9
    assert sorted(zip(dys, dxs, weights)) == [(-2, 0, 1.0), (0, 1, -0.5)]


def test_tap_table_rounds_a_fill_to_the_dtype():
    _, fills, *_ = unpack_table(stencil._tap_table(LAPLACE_TAPS, (1, 1), (0.1, 1e-8), torch.float16))
    assert fills == (float(np.float16(0.1)), float(np.float16(1e-8)))


@pytest.mark.parametrize("taps, depth, boundary, match", [
    (LAPLACE_TAPS, (9, 1), ("reflect", "reflect"), "depths"),
    (((2, 0, 1.0),), (1, 1), ("reflect", "reflect"), "do not fit"),
    (LAPLACE_TAPS, (1, 1), ("wrap", "reflect"), "boundary"),
    (LAPLACE_TAPS, (1, 1), ("none", "reflect"), "boundary"),
])
def test_tap_table_refuses(taps, depth, boundary, match):
    with pytest.raises(ValueError, match=match):
        stencil._tap_table(taps, depth, boundary, torch.float32)


def test_tap_tables_are_cached_by_value_keys():
    """A fill of -0.0 and one of 0.0 compare equal but give other bits: the
    cache keeps them apart."""
    code, pos = stencil._launch_args(LAPLACE_TAPS, (1, 1), (0.0, "reflect"), torch.float32)
    _, neg = stencil._launch_args(LAPLACE_TAPS, (1, 1), (-0.0, "reflect"), torch.float32)
    assert code == 1 and pos[32:40] != neg[32:40]
    assert stencil._launch_args(LAPLACE_TAPS, (1, 1), (0.0, "reflect"), torch.float32)[1] is pos
    # taps as lists are read, not cached
    assert stencil._launch_args([[0, 0, -4.0], [1, 0, 1.0]], [1, 1], ["reflect", "reflect"], torch.float64)[0] == 2
    assert stencil._tap_key([[0, 1, 2]]) == ((0, 1, 2.0),)
    with pytest.raises(TypeError, match="does not take"):
        stencil._launch_args(LAPLACE_TAPS, (1, 1), ("reflect", "reflect"), torch.int32)


@pytest.mark.parametrize("shape, dtype, offset, vector", [
    ((64, 1024), torch.float32, 0, True),
    ((64, 1003), torch.float32, 0, False),   # a row of 4012 bytes
    ((64, 1024), torch.float32, 1, False),   # one element into its storage
    ((64, 1024), torch.float32, 4, True),
    ((64, 1024), torch.float16, 0, True),
    ((64, 1028), torch.float16, 0, False),   # 2056 bytes: 8-byte rows only
    ((64, 1026), torch.float64, 0, True),
    ((64, 1027), torch.float64, 0, False),
])
def test_vector_path_needs_16_byte_rows_and_pointers(shape, dtype, offset, vector):
    base = torch.zeros(shape[0] * shape[1] + 16, dtype=dtype)
    x = base[offset:offset + shape[0] * shape[1]].view(shape)
    aligned = torch.zeros(shape, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    assert stencil.vector_ok(x, aligned) is vector

"""The halo assembly of the PyTorch port (kernels/halo.py).

``halo_pad_plain`` (the kernel's plain version, what a CPU tensor runs)
against ``np.pad`` and the JAX package's ``jnp.pad`` for every mode, widths
past the axis, constant corners against index-map axes, per-side fills,
every dtype and ranks 1 to 4.  ``kernel_model`` transcribes the CUDA
kernel's rule (csrc/halo.cu: each output element maps every coordinate on
its own, and the highest constant axis in its pad gives the fill) over the
wrapper's merged axes, and is held against the plain version, so the
kernel's arithmetic is checked here although it runs only on a card
(tests/test_torch_gpu.py runs it there).  ``probe_band`` writes in numpy
what the Pallas probes bench/probe_band_bisect.py and probe_band_bisect2.py
assemble: a band of T rows with its H-row halo views above and below and
its flipped edge columns.  Everything moves bytes: results are equal, not
close.
"""

import numpy as np
import pytest
import torch

import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.kernels import halo

torch.set_num_threads(1)

INDEX_MODES = ["symmetric", "reflect", "edge", "wrap"]
DTYPES = [np.bool_, np.int8, np.float16, np.float32, np.float64, np.int64, np.complex64, np.complex128]


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def random_array(rng, shape, dtype):
    if np.dtype(dtype) == np.bool_:
        return rng.random(shape) < 0.5
    if np.dtype(dtype).kind == "c":
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    return (rng.standard_normal(shape) * 50).astype(dtype)


def np_pad_per_axis(x, widths, modes):
    """numpy's pad, one axis at a time (np.pad takes one mode for all)."""
    for ax, (w, mode) in enumerate(zip(widths, modes)):
        pw = [(0, 0)] * x.ndim
        pw[ax] = w
        if isinstance(mode, str):
            x = np.pad(x, pw, mode=mode)
        else:
            x = np.pad(x, pw, mode="constant", constant_values=halo.fill_pair(mode))
    return x


def kernel_model(x, widths, modes):
    """The CUDA kernel's loop in Python, over the wrapper's merged axes and
    the input's strides: each output coordinate maps on its own, and the
    highest axis whose constant pad holds the element gives its value."""
    t = torch.from_numpy(x)
    axes = halo._merged_axes(t, widths, modes)
    storage = torch.as_strided(t, (t.untyped_storage().nbytes() // t.element_size(),), (1,), 0).numpy()
    maps = [
        halo._source_index(n, lo, hi, mode, "cpu").numpy() if isinstance(mode, str) and (lo or hi) else None
        for n, _s, (lo, hi), mode in axes
    ]
    out_shape = [n + lo + hi for n, _s, (lo, hi), _m in axes]
    out = np.empty(out_shape, dtype=x.dtype)
    for idx in np.ndindex(*out_shape):
        src, value = t.storage_offset(), None
        for a in reversed(range(len(axes))):
            n, stride, (lo, _hi), mode = axes[a]
            i = idx[a] - lo
            if 0 <= i < n:
                src += i * stride
            elif maps[a] is not None:
                src += int(maps[a][idx[a]]) * stride
            elif value is None:
                value = halo.fill_scalar(halo.fill_pair(mode)[int(i >= 0)], t.dtype).numpy()
        out[idx] = storage[src] if value is None else value
    return out.reshape([n + lo + hi for n, (lo, hi) in zip(x.shape, widths)])


def plain(x, widths, modes):
    return halo.halo_pad_plain(torch.from_numpy(x), widths, modes).numpy()


# ---------------------------------------------------------------------------
# the plain version against numpy and jnp.pad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", INDEX_MODES + ["constant"])
@pytest.mark.parametrize("shape", [(9,), (5, 7), (3, 4, 6), (2, 3, 2, 5)], ids=str)
def test_plain_matches_np_pad_in_one_mode(mode, shape):
    rng = np.random.default_rng(len(shape))
    x = random_array(rng, shape, np.float64)
    widths = [tuple(int(v) for v in rng.integers(0, 4, 2)) for _ in shape]
    modes = [mode if mode != "constant" else 2.5] * len(shape)
    want = np.pad(x, widths, mode=mode, **({"constant_values": 2.5} if mode == "constant" else {}))
    np.testing.assert_array_equal(plain(x, widths, modes), want)
    np.testing.assert_array_equal(kernel_model(x, widths, modes), want)


@pytest.mark.parametrize("mode", INDEX_MODES)
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_widths_past_the_axis_follow_numpy(mode, n):
    x = np.arange(n, dtype=np.float64) * 10 + 1
    for lo, hi in [(7, 0), (0, 7), (13, 11), (2 * n + 1, 3 * n)]:
        want = np.pad(x, (lo, hi), mode=mode)
        np.testing.assert_array_equal(plain(x, [(lo, hi)], [mode]), want)
        np.testing.assert_array_equal(kernel_model(x, [(lo, hi)], [mode]), want)


@pytest.mark.parametrize("seed", range(12))
def test_mixed_modes_and_constant_corners(seed):
    rng = np.random.default_rng(100 + seed)
    nd = int(rng.integers(1, 5))
    shape = tuple(int(v) for v in rng.integers(1, 6, nd))
    x = random_array(rng, shape, np.float64)
    widths, modes = [], []
    for _ in range(nd):
        widths.append(tuple(int(v) for v in rng.integers(0, 9 if nd <= 2 else 4, 2)))
        pick = int(rng.integers(0, 6))
        modes.append(INDEX_MODES[pick] if pick < 4 else
                     float(rng.integers(-9, 9)) if pick == 4 else
                     (float(rng.integers(-9, 9)), float(rng.integers(-9, 9))))
    want = np_pad_per_axis(x, widths, modes)
    np.testing.assert_array_equal(plain(x, widths, modes), want)
    np.testing.assert_array_equal(kernel_model(x, widths, modes), want)


def test_constant_corner_rules():
    x = np.arange(12, dtype=np.float64).reshape(3, 4)
    # axis 1's constant wins over axis 0's at the corners
    got = plain(x, [(1, 1), (1, 1)], [-1.0, -2.0])
    assert got[0, 0] == got[-1, -1] == -2.0 and got[0, 2] == -1.0
    # a constant axis 0 wins over an edge axis 1 at the corners
    got = plain(x, [(1, 1), (1, 1)], [-1.0, "edge"])
    assert (got[0] == -1.0).all() and (got[-1] == -1.0).all()
    # an edge axis 0 loses to a constant axis 1
    got = plain(x, [(1, 1), (1, 1)], ["edge", -2.0])
    assert (got[:, 0] == -2.0).all() and (got[:, -1] == -2.0).all()
    for modes in ([-1.0, -2.0], [-1.0, "edge"], ["edge", -2.0], [(-1.0, 5.0), ("wrap")]):
        np.testing.assert_array_equal(kernel_model(x, [(1, 1), (1, 1)], modes),
                                      np_pad_per_axis(x, [(1, 1), (1, 1)], modes))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_every_dtype(dtype):
    rng = np.random.default_rng(7)
    x = random_array(rng, (6, 5), dtype)
    for modes in (["symmetric", "wrap"], [(1, 0), "reflect"], ["edge", 1]):
        widths = [(2, 3), (4, 1)]
        want = np_pad_per_axis(x, widths, modes)
        got = plain(x, widths, modes)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(kernel_model(x, widths, modes), want)


def test_fill_converts_like_numpy_and_jax():
    import jax.numpy as jnp

    x = np.arange(12, dtype=np.int64).reshape(3, 4)
    for fill in (0.5, -1.5, 7):
        want = np.pad(x, 1, mode="constant", constant_values=fill)
        np.testing.assert_array_equal(plain(x, [(1, 1), (1, 1)], [fill, fill]), want)
        np.testing.assert_array_equal(np.asarray(jnp.pad(x, 1, constant_values=fill)), want)
        got = tda.pad(tda.from_array(x, chunks=2), 1, constant_values=fill).compute()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", INDEX_MODES + ["constant"])
def test_plain_matches_jnp_pad(mode):
    import jax.numpy as jnp

    x = random_array(np.random.default_rng(3), (7, 6, 5), np.float32)
    widths = [(2, 1), (0, 3), (4, 4)]
    want = np.asarray(jnp.pad(x, widths, mode=mode))
    np.testing.assert_array_equal(plain(x, widths, [mode if mode != "constant" else 0.0] * 3), want)


def test_merged_axes():
    t = torch.zeros((2, 3, 4, 5, 6))
    axes = halo._merged_axes(t, [(0, 0), (0, 0), (1, 1), (0, 0), (0, 2)], ["edge"] * 5)
    assert [(n, s) for n, s, _w, _m in axes] == [(6, 120), (4, 30), (5, 6), (6, 1)]
    # a column-sliced view keeps its row stride; unpadded size-1 axes drop
    v = torch.zeros((30, 20))[:, 5:12]
    assert [(n, s) for n, s, _w, _m in halo._merged_axes(v, [(1, 1), (0, 0)], ["edge"] * 2)] == [(30, 20), (7, 1)]
    assert len(halo._merged_axes(torch.zeros((1, 5, 1)), [(0, 0), (1, 0), (0, 0)], ["edge"] * 3)) == 1


def test_views_and_empty_axes():
    base = np.arange(60, dtype=np.float32).reshape(6, 10)
    view = base[:, 2:7]
    widths, modes = [(1, 2), (3, 1)], ["wrap", "symmetric"]
    np.testing.assert_array_equal(kernel_model(view, widths, modes), np_pad_per_axis(view, widths, modes))
    empty = np.zeros((0, 3))
    np.testing.assert_array_equal(plain(empty, [(2, 1), (1, 1)], [3.0, "edge"]),
                                  np_pad_per_axis(empty, [(2, 1), (1, 1)], [3.0, "edge"]))
    with pytest.raises(ValueError, match="empty axis"):
        plain(empty, [(1, 0), (0, 0)], ["edge", "edge"])
    with pytest.raises(ValueError, match="unknown mode"):
        plain(base, [(1, 0), (0, 0)], ["nearest", "edge"])


def test_halo_pad_returns_the_input_for_zero_widths():
    t = torch.zeros((4, 5))
    assert halo.halo_pad(t, [(0, 0), (0, 0)], ["edge", "bogus"]) is t


def test_cuda_wrapper_refuses_a_cpu_tensor():
    before = halo.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        halo.halo_pad_cuda(torch.zeros((4, 4)), [(1, 1), (1, 1)], ["edge", "edge"])
    assert halo.LAUNCHES == before


# ---------------------------------------------------------------------------
# the Pallas probes' halo assembly (P1, P2) written in numpy
# ---------------------------------------------------------------------------


def probe_band(x, i, T=128, H=8, d=1, dc=2):
    """Band ``i`` of T rows with ``d`` halo rows each side and ``dc``
    reflected columns, as the probes assemble it: the halo views' index maps
    ``i*(T//H) - 1`` and ``(i+1)*(T//H)`` (raw in the interior, clamped at
    the array's ends, bisect2 ``clamped_offset``), the ``program_id`` select
    of the edge fill at the ends (``pid_select``; the edge rows repeat, the
    ``nearest`` boundary), the row concatenation (``concat0``) and the
    columns built by flipping slices (``concat1_flip``)."""
    M, N = x.shape
    nb = M // T
    top_block = max(i * (T // H) - 1, 0)
    bot_block = min((i + 1) * (T // H), M // H - 1)
    top = x[top_block * H:(top_block + 1) * H]
    bot = x[bot_block * H:(bot_block + 1) * H]
    if i == 0:
        top = np.repeat(x[:1], H, axis=0)
    if i == nb - 1:
        bot = np.repeat(x[-1:], H, axis=0)
    rows = np.concatenate([top[H - d:], x[i * T:(i + 1) * T], bot[:d]], axis=0)
    left = np.concatenate([rows[:, k:k + 1] for k in range(dc - 1, -1, -1)], axis=1)
    right = np.concatenate([rows[:, N - 1 - k:N - k] for k in range(dc)], axis=1)
    return np.concatenate([left, rows, right], axis=1)


@pytest.mark.parametrize("d", [1, 8])
def test_probe_band_assembly_is_a_slice_of_halo_pad(d):
    T = 128
    x = np.random.default_rng(0).standard_normal((512, 512)).astype(np.float32)
    padded = halo.halo_pad(torch.from_numpy(x), [(d, d), (2, 2)], ["edge", "symmetric"]).numpy()
    for i in range(512 // T):
        np.testing.assert_array_equal(padded[i * T:i * T + T + 2 * d], probe_band(x, i, T=T, d=d))


# ---------------------------------------------------------------------------
# what the launcher gets: the plan and the fills
# ---------------------------------------------------------------------------


def test_launch_plan_merges_unpadded_axes():
    plan, fills = halo.launch_plan((5, 6, 7), (42, 7, 1), ((1, 2), (0, 0), (0, 0)), ("wrap", "edge", "edge"),
                                   torch.float32)
    # axes 1 and 2 merge into one of 42; the unpadded axis's fills are zeros
    assert plan.tolist() == [2, 4, 5, 42, 42, 1, 1, 0, 2, 0, 3, 4]
    assert fills == bytes(16)


def test_launch_plan_fills_are_the_dtype_bytes():
    plan, fills = halo.launch_plan((3, 4), (4, 1), ((1, 1), (2, 0)), ((1.5, -0.0), "symmetric"), torch.float16)
    assert plan.tolist() == [2, 2, 3, 4, 4, 1, 1, 2, 1, 0, 4, 0]
    want = np.array([1.5, -0.0], dtype=np.float16).tobytes() + bytes(4)
    assert fills == want


def test_launch_plan_reads_a_view_through_its_strides():
    base = torch.zeros((30, 20))
    view = base.mT  # (20, 30) with a last axis of stride 20: the strided kernel reads it
    plan, _ = halo.launch_plan(tuple(view.shape), view.stride(), ((1, 1), (1, 1)), ("edge", "edge"), torch.float32)
    assert plan.tolist() == [2, 4, 20, 30, 1, 20, 1, 1, 1, 1, 2, 2]


def test_launch_plan_refuses_more_than_eight_axes():
    shape = (2,) * 9
    stride = tuple(2 ** (8 - a) for a in range(9))
    with pytest.raises(ValueError, match="at most 8 axes"):
        halo.launch_plan(shape, stride, ((1, 1),) * 9, ("edge",) * 9, torch.float32)


@pytest.mark.parametrize("a, b", [(0.0, -0.0), (1, 1.0), (True, 1), (np.float32(1.0), 1.0)])
def test_plans_are_cached_by_value_keys(a, b):
    """Fills that compare equal but may give other bits get their own plans."""
    assert halo.value_key((a, "edge")) != halo.value_key((b, "edge"))
    x = torch.zeros((3, 4))
    pa = halo._launch_args(x, ((1, 1), (1, 1)), (a, "edge"))
    pb = halo._launch_args(x, ((1, 1), (1, 1)), (b, "edge"))
    assert pa is not pb
    assert halo._launch_args(x, [(1, 1), (1, 1)], [a, "edge"]) is pa  # lists key as tuples
    assert pa[0] == (5, 6) and pa[1] == pa[3].ctypes.data


def test_launch_args_of_an_empty_output_plan_no_launch():
    assert halo._launch_args(torch.zeros((0, 4)), ((0, 0), (1, 1)), ("edge", 2.0))[:2] == ((0, 6), None)
    with pytest.raises(ValueError, match="negative width"):
        halo._launch_args(torch.zeros((3, 4)), ((-1, 0), (1, 1)), ("edge", "edge"))

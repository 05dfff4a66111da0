"""K3, the step-rounded scan (``kernels/scan.py``), on the CPU: its plain
version and the route ``CumReduction`` takes to it, against numpy.

numpy rounds a float16, bfloat16 (ml_dtypes) or 1-byte float scan to the
type after every step: a 2-byte step is one float32 add or multiply rounded
to the type, a 1-byte step a lookup in the type's table of rounded
results.  Every comparison here is byte for byte, NaN payloads, ±0 and
subnormals included, with one allowance: from the first step of a chain
whose running value and term are both NaN, a NaN there may be any NaN
(which operand's bits survive is the host's choice; numpy on x86-64 keeps
the term's, and so does K3).  A nan-scan of a float16 or bfloat16 block
replaces NaN with the identity first, as the JAX package's ``jnp.nancumsum``
does (numpy's replaces none in bfloat16, which ml_dtypes keeps outside
numpy's float types), and is held to numpy's scan of the replaced terms and
to the JAX package along an axis.  The JAX package's raveled (``axis=None``)
2-byte scans do not round every step (``HALF_SCAN_REFERENCE_FAULTS`` in
``test_torch_reductions.py`` for float16; ``test_raveled_reference_differs``
here for bfloat16).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch._chunks import array_of, tensor_of
from dask_array_tpu_torch.kernels import scan

torch.set_num_threads(1)

BF16 = np.dtype(ml_dtypes.bfloat16)
F16 = np.dtype(np.float16)
TWO_BYTE = {"float16": F16, "bfloat16": BF16}
KINDS = ("cumsum", "cumprod", "nancumsum", "nancumprod")
BYTE_TYPES = ("float8_e4m3fn", "float8_e5m2", "float4_e2m1fn", "float8_e4m3b11fnuz", "float8_e8m0fnu")

# running values of the one-step pass, as bits: ±0, the smallest and the
# largest subnormal, the smallest normal, ±1, a plain value, the largest
# finite of each sign, ±inf, quiet NaNs of both signs and a signaling NaN
# and a negative NaN with payloads
RUNNING = {
    "float16": [0x0000, 0x8000, 0x0001, 0x8001, 0x03FF, 0x0400, 0x3C00, 0xBC00, 0x3555, 0x7BFF, 0xFBFF, 0x7C00,
                0xFC00, 0x7E00, 0xFE00, 0x7C01, 0xFD55],
    "bfloat16": [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x0080, 0x3F80, 0xBF80, 0x3EAB, 0x7F7F, 0xFF7F, 0x7F80,
                 0xFF80, 0x7FC0, 0xFFC0, 0x7F81, 0xFFD5],
}


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def _isnan(a):
    return np.isnan(a.astype(np.float32))


def assert_scan_bytes(got, want, x, axis):
    """``got`` equals numpy's ``want`` byte for byte, except that a NaN may
    be any NaN from the first step of its chain at which both operands
    were NaN (``x``: the terms the scan stepped over, along ``axis``)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if axis is None:
        got, want, x, axis = got.ravel(), want.ravel(), x.ravel(), 0
    both = np.zeros(want.shape, dtype=bool)
    if want.shape[axis] > 1:
        prev = np.take(want, np.arange(want.shape[axis] - 1), axis=axis)
        terms = np.take(x, np.arange(1, want.shape[axis]), axis=axis)
        pad = [(0, 0)] * want.ndim
        pad[axis] = (1, 0)
        both = np.pad(_isnan(prev) & _isnan(terms), pad)
    free = np.logical_or.accumulate(both, axis=axis)
    width = "u2" if want.itemsize == 2 else "u1"
    exact = got.view(width) == want.view(width)
    assert np.all(exact | (free & _isnan(got) & _isnan(want)))


def scan_data(dtype, kind, shape=(12, 10), seed=0):
    """Values of ``shape`` in ``dtype``: sums of sizeable values, products
    near 1, and for the nan-scans a NaN of each sign."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape) * 10
    if kind.endswith("cumprod"):
        x = 0.9 + x / 50
    x = x.astype(dtype)
    if kind.startswith("nan"):
        x.flat[23] = np.nan
        x.flat[57] = -np.nan
    return x


def base_scan(kind):
    return "cumsum" if kind.endswith("cumsum") else "cumprod"


def replaced(x, kind):
    """The terms a scan of ``kind`` steps over: NaN replaced with the
    identity for a 2-byte nan-scan."""
    if not kind.startswith("nan"):
        return x
    return np.where(_isnan(x), 0 if kind.endswith("sum") else 1, x).astype(x.dtype)


@pytest.mark.parametrize("chunks", [5, (12, 3), 1])
@pytest.mark.parametrize("axis", [0, 1, None])
@pytest.mark.parametrize("name", sorted(TWO_BYTE))
@pytest.mark.parametrize("kind", KINDS)
def test_two_byte_scans_equal_numpy(kind, name, axis, chunks):
    x = scan_data(TWO_BYTE[name], kind)
    with np.errstate(all="ignore"):
        want = getattr(np, base_scan(kind))(replaced(x, kind), axis=axis)
    got = getattr(tda, kind)(tda.from_array(x, chunks=chunks), axis=axis).compute()
    assert got.tobytes() == want.tobytes()
    if axis is not None and chunks == 5:
        ref = np.asarray(getattr(jda, kind)(jda.from_array(x, chunks=chunks), axis=axis).compute())
        assert ref.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_raveled_reference_differs(kind):
    """The JAX package's raveled bfloat16 scan does not round every step,
    so ``test_two_byte_scans_equal_numpy`` holds ``axis=None`` to numpy
    alone."""
    x = scan_data(BF16, kind)
    with np.errstate(all="ignore"):
        want = getattr(np, base_scan(kind))(replaced(x, kind), axis=None)
    ref = np.asarray(getattr(jda, kind)(jda.from_array(x, chunks=5), axis=None).compute())
    assert ref.tobytes() != want.tobytes()


def one_step(name):
    """Every running value of ``RUNNING[name]`` against every one of the
    65536 terms: a (2, 17 * 65536) block whose scan along axis 0 takes one
    step a column."""
    dt = TWO_BYTE[name]
    running = np.repeat(np.array(RUNNING[name], dtype=np.uint16), 65536)
    terms = np.tile(np.arange(65536, dtype=np.uint16), len(RUNNING[name]))
    return np.stack([running, terms]).view(dt)


@pytest.mark.parametrize("kind", ["cumsum", "cumprod"])
@pytest.mark.parametrize("name", sorted(TWO_BYTE))
def test_one_step_over_every_term(name, kind):
    """The plain version's one step against numpy's (ml_dtypes' for
    bfloat16) for each running value and each of the 65536 terms."""
    x = one_step(name)
    with np.errstate(all="ignore"):
        want = getattr(np, kind)(x, axis=0)
    got = scan.rounded_scan_plain(tensor_of(x), kind, 0, x.dtype)
    assert_scan_bytes(array_of(got), want, x, 0)
    assert scan.LAUNCHES == 0


def special_grid(dt, kind, seed):
    """A (40, 24) block of values, NaNs of both signs with payloads, ±inf,
    ±0, the smallest subnormals and runs of them, and values that overflow
    the type when summed or multiplied."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((40, 24)) * (3000 if kind.endswith("cumsum") else 4)).astype(dt)
    bits = x.view(np.uint16)
    nan_bits = (0x7E01, 0xFD55, 0x7C02) if dt == F16 else (0x7FC1, 0xFFD5, 0x7F82)
    tiny, neg_tiny = 0x0001, 0x8001
    inf, neg_inf = (0x7C00, 0xFC00) if dt == F16 else (0x7F80, 0xFF80)
    bits[5, 0], bits[31, 0], bits[7, 3], bits[2, 9] = nan_bits[0], nan_bits[1], nan_bits[2], nan_bits[1]
    bits[4, 1], bits[9, 1] = inf, neg_inf  # inf - inf
    bits[11, 2], bits[13, 5] = 0x0000, 0x8000
    bits[:, 6] = tiny  # a column of the smallest subnormal
    bits[::2, 7] = neg_tiny
    bits[:20, 8] = 0x8000  # sums of -0
    bits[3, 10] = 0x0000
    bits[8, 10] = inf  # 0 * inf
    bits[0, 11] = nan_bits[2]  # a signaling NaN first: copied, then quieted
    return x


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(TWO_BYTE))
def test_special_values_through_the_route(name, kind, axis):
    dt = TWO_BYTE[name]
    x = special_grid(dt, kind, seed=axis)
    terms = replaced(x, kind)
    with np.errstate(all="ignore"):
        want = getattr(np, base_scan(kind))(terms, axis=axis)
    got = getattr(tda, kind)(tda.from_array(x, chunks=(7, 5)), axis=axis).compute()
    assert_scan_bytes(got, want, terms, axis)


def test_scan_plan_views_blocks_around_the_axis():
    assert scan.scan_plan((12, 10), 0) == (1, 12, 10)
    assert scan.scan_plan((12, 10), 1) == (12, 10, 1)
    assert scan.scan_plan((2, 3, 4), 1) == (2, 3, 4)
    assert scan.scan_plan((2, 3, 4, 5), 0) == (1, 2, 60)
    assert scan.scan_plan((2, 3, 4, 5), 2) == (6, 4, 5)
    assert scan.scan_plan((2, 3, 4, 5), 3) == (24, 5, 1)
    assert scan.scan_plan((7,), 0) == (1, 7, 1)


@pytest.mark.parametrize("shape", [(3, 5, 4), (2, 3, 4, 5)], ids=str)
@pytest.mark.parametrize("name", ["float16", "bfloat16", "float8_e4m3fn", "float8_e4m3"])
def test_plain_version_on_three_and_four_axes(name, shape):
    dt = TWO_BYTE.get(name) or np.dtype(getattr(ml_dtypes, name))
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 8).astype(dt)
    x.flat[5] = np.nan
    for axis in range(len(shape)):
        for kind in ("cumsum", "cumprod"):
            with np.errstate(all="ignore"):
                want = getattr(np, kind)(x, axis=axis)
            got = array_of(scan.rounded_scan_plain(tensor_of(x), kind, axis, dt), dt)
            assert_scan_bytes(got, want, x, axis)


@pytest.mark.parametrize("kind", ["cumsum", "cumprod"])
@pytest.mark.parametrize("name", BYTE_TYPES)
def test_byte_table_is_the_types_own_rounding(name, kind):
    """``step_table`` holds numpy's rounded sum (product) of every pair of
    patterns (a NaN as any NaN: its sign is the host's choice)."""
    dt = np.dtype(getattr(ml_dtypes, name))
    pats = np.arange(256, dtype=np.uint8).view(dt)
    with np.errstate(all="ignore"):
        want = (getattr(np, "add" if kind == "cumsum" else "multiply"))(pats[:, None], pats[None, :]).reshape(-1)
    got = scan.step_table(dt, kind).numpy().view(dt)
    same = got.view(np.uint8) == want.view(np.uint8)
    assert np.all(same | (_isnan(got) & _isnan(want)))


@pytest.mark.parametrize("name", BYTE_TYPES)
def test_byte_scans_of_the_plain_version_equal_numpy(name):
    dt = np.dtype(getattr(ml_dtypes, name))
    x = (np.random.default_rng(3).standard_normal((9, 14)) * 16).astype(dt)
    x[4, 4] = np.nan
    for axis in (0, 1):
        for kind in KINDS:
            with np.errstate(all="ignore"):
                want = getattr(np, kind)(x, axis=axis)
            got = array_of(scan.rounded_scan_plain(tensor_of(x), kind, axis, dt), dt)
            assert_scan_bytes(got, want, x, axis)


@pytest.mark.parametrize("name", sorted(TWO_BYTE))
def test_two_byte_scan_stays_off_the_host(name, monkeypatch):
    """The walk of a 2-byte scan calls neither ``Tensor.cpu`` nor numpy's
    scans on its data (the expression's dtype probe scans one element), and
    launches nothing on the CPU (the plain version runs)."""
    x = scan_data(TWO_BYTE[name], "cumsum", shape=(30, 20))
    want = np.cumsum(x, axis=0)
    arr = tda.cumsum(tda.from_array(x, chunks=(7, 20)), axis=0)
    calls = []

    def refuse(mod, attr):
        original = getattr(mod, attr)

        def call(*args, **kwargs):
            if attr != "cpu" and np.size(args[0]) <= 1:
                return original(*args, **kwargs)
            calls.append(attr)
            raise AssertionError(f"{attr} called during a 2-byte scan")
        return call

    for mod, attr in ((torch.Tensor, "cpu"), (np, "cumsum"), (np, "cumprod")):
        monkeypatch.setattr(mod, attr, refuse(mod, attr))
    held = arr.compute_device()
    monkeypatch.undo()
    assert not calls and scan.LAUNCHES == 0
    assert array_of(held).tobytes() == want.tobytes()


def test_result_dtype_picks_the_route():
    """``dtype=`` names the type numpy scans in: a float32 scan of float16
    data is torch's, a float16 scan of float32 data K3's."""
    x = scan_data(F16, "cumsum", shape=(40, 6))
    wide = tda.cumsum(tda.from_array(x, chunks=7), axis=0, dtype="f4").compute()
    assert wide.dtype == np.float32
    np.testing.assert_allclose(wide, np.cumsum(x, axis=0, dtype="f4"), rtol=1e-6)
    x32 = x.astype(np.float32) * 1.001
    narrow = tda.cumsum(tda.from_array(x32, chunks=7), axis=0, dtype="f2").compute()
    assert narrow.tobytes() == np.cumsum(x32, axis=0, dtype="f2").tobytes()
    assert tda.nancumprod(tda.from_array(x32, chunks=7), axis=1, dtype=BF16).compute().tobytes() == \
        np.nancumprod(x32, axis=1, dtype=BF16).tobytes()


def test_wrappers_refuse_what_they_do_not_take():
    with pytest.raises(TypeError, match="rounded_scan takes"):
        scan.rounded_scan_plain(torch.zeros(4), "cumsum", 0, np.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scan.rounded_scan_cuda(torch.zeros(4, dtype=torch.float16), "cumsum", 0, F16)
    with pytest.raises(ValueError, match="unknown scan"):
        scan.rounded_scan_plain(torch.zeros(4, dtype=torch.float16), "cummax", 0, F16)
    with pytest.raises(TypeError, match="rounded_scan takes"):
        scan.rounded_scan_plain(torch.zeros(4, dtype=torch.int16), "cumsum", 0, F16)
    assert scan.scan_type(np.int8) is None
    assert scan.scan_type(np.float32) is None
    assert scan.scan_type(np.dtype(ml_dtypes.int4)) is None
    assert scan.scan_type(F16) == 0 and scan.scan_type(BF16) == 1
    assert scan.scan_type(np.dtype(ml_dtypes.float4_e2m1fn)) == 2
    assert scan.scan_type(np.dtype(ml_dtypes.float8_e4m3fn)) == 2

"""K3, the step-rounded scan (``kernels/scan.py``), on the CPU: its plain
version and the route ``CumReduction`` takes to it, against numpy; the
rounding fact the kernel's one native op a step rests on; and the
kernel's launch plan, picked on the host.

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


# -- the step's rounding: the float32 route equals one rounding ------------------
#
# K3 steps a 2-byte carry with one native add or multiply, rounded once;
# numpy and the plain version round the float32 op to the type.  float32
# keeps at least 2p + 2 bits of the type's p (24 for float16's 11, 18 for
# bfloat16's 8), so the two roundings agree: pinned here on 2**24 seeded
# pattern pairs a case (half with equal exponent fields, where sums tie
# often), the pairs one ulp either side of every tie found, and every
# pattern against ±0, subnormals, ±1, the largest finite, ±inf and NaNs
# (overflow included).  Then the plain version stands for the native op.

FORMATS = {  # precision bits, least normal exponent, largest finite, exponent field
    "float16": (11, -14, 65504.0, 0x7C00),
    "bfloat16": (8, -126, float(ml_dtypes.finfo(ml_dtypes.bfloat16).max), 0x7F80),
}


def round_once(v, name):
    """float64 ``v`` rounded once to ``name``: nearest, ties to even, past
    the largest finite to ±inf."""
    p, emin, top, _ = FORMATS[name]
    finite = np.isfinite(v)
    w = np.where(finite, v, 0.0)
    _, e = np.frexp(w)
    u = np.maximum(e - p, emin - p + 1)  # the exponent of w's ulp in the type
    r = np.ldexp(np.rint(np.ldexp(w, -u)), u)
    r = np.where(np.abs(r) > top, np.copysign(np.inf, w), r)
    return np.where(finite, r, v).astype(TWO_BYTE[name])


def ties_of(v, name):
    """Where float64 ``v`` lies halfway between two values of ``name``."""
    p, emin, _, _ = FORMATS[name]
    w = np.where(np.isfinite(v), v, 0.0)
    _, e = np.frexp(w)
    t = np.ldexp(w, -np.maximum(e - p, emin - p + 1))
    return (t - np.floor(t)) == 0.5


def assert_rounds_once(a, b, name, op):
    dt = TWO_BYTE[name]
    fa, fb = a.view(dt), b.view(dt)
    with np.errstate(all="ignore"):
        wide = op(fa.astype(np.float32), fb.astype(np.float32)).astype(dt)
        once = round_once(op(fa.astype(np.float64), fb.astype(np.float64)), name)
    same = (wide.view(np.uint16) == once.view(np.uint16)) | (_isnan(wide) & _isnan(once))
    assert same.all(), (a[~same][:5], b[~same][:5])


@pytest.mark.parametrize("op", [np.add, np.multiply], ids=["add", "multiply"])
@pytest.mark.parametrize("name", sorted(TWO_BYTE))
def test_float32_route_rounds_once(name, op):
    rng = np.random.default_rng(23)
    expo = FORMATS[name][3]
    ties = 0
    for _ in range(4):  # 4 x 2**22 pairs
        a = rng.integers(0, 1 << 16, 1 << 22, dtype=np.uint16)
        b = rng.integers(0, 1 << 16, 1 << 22, dtype=np.uint16)
        half = len(b) // 2
        b[:half] = (b[:half] & ~np.uint16(expo)) | (a[:half] & np.uint16(expo))
        assert_rounds_once(a, b, name, op)
        with np.errstate(all="ignore"):
            tie = ties_of(op(a.view(TWO_BYTE[name]).astype(np.float64), b.view(TWO_BYTE[name]).astype(np.float64)),
                          name)
        ta, tb = a[tie], b[tie]
        ties += len(ta)
        for step in (1, 0xFFFF):  # one ulp either side (the pattern's neighbours)
            assert_rounds_once(ta, (tb + np.uint16(step)).astype(np.uint16), name, op)
    assert ties > 10_000
    every = np.arange(1 << 16, dtype=np.uint16)
    for r in RUNNING[name]:
        fixed = np.full(every.shape, r, dtype=np.uint16)
        assert_rounds_once(fixed, every, name, op)
        assert_rounds_once(every, fixed, name, op)


def test_round_once_is_numpys_rounding_where_that_is_exact():
    """The reference rounding agrees with numpy's float32 -> float16 and
    ml_dtypes' float32 -> bfloat16 conversions on float32 values."""
    v = np.random.default_rng(4).standard_normal(1 << 16).astype(np.float32) * np.float32(3e4)
    v[:4] = [65519.0, 65520.0, 2.0 ** -25, -(2.0 ** -25) * 3]
    with np.errstate(over="ignore"):  # past float16's largest finite: inf both ways
        assert round_once(v.astype(np.float64), "float16").tobytes() == v.astype(np.float16).tobytes()
    w = v * np.float32(1e33)
    assert round_once(w.astype(np.float64), "bfloat16").tobytes() == w.astype(BF16).tobytes()


# -- K3's launch plan -------------------------------------------------------------


def _stage_depth(P, Q, es):
    """Steps a tile of a block with chains this long holds."""
    return scan.launch_plan(P, 10**7, Q, es).depth


# ((P, L, Q), itemsize, x pointer offset): P > 1; Q no multiple of the
# strip; L of 1, 2 and one more than a stage; rows or pointers not 16-byte
# aligned; 128 chains of 1e6 steps; one chain; 16384^2 along both axes
PLAN_CASES = [
    ((6, 700, 40), 2, 0), ((6, 700, 40), 1, 0), ((4, 300, 5), 2, 0),
    ((1, 300, 200), 2, 0), ((1, 300, 70), 1, 0), ((3, 50, 600), 1, 0),
    ((1, 1, 300), 2, 0), ((1, 2, 300), 1, 0), ((5, 1, 1), 2, 0), ((70, 2, 1), 1, 0),
    ((1, _stage_depth(1, 64, 2) + 1, 64), 2, 0), ((1, _stage_depth(1, 64, 1) + 1, 64), 1, 0),
    ((200, _stage_depth(200, 1, 2) + 1, 1), 2, 0), ((200, _stage_depth(200, 1, 1) + 1, 1), 1, 0),
    ((64, 333, 1), 2, 0), ((300, 70, 1), 1, 0), ((1, 300, 70), 2, 0), ((1, 4096, 512), 2, 2),
    ((512, 4096, 1), 2, 6), ((512, 4096, 1), 1, 3),
    ((1, 10**6, 128), 2, 0), ((1, 10**6, 128), 1, 0),
    ((1, 1 << 24, 1), 2, 0), ((1, 1 << 24, 1), 1, 0),
    ((1, 16384, 16384), 2, 0), ((1, 16384, 16384), 1, 0), ((16384, 16384, 1), 2, 0), ((16384, 16384, 1), 1, 0),
]


@pytest.mark.parametrize("shape,es,offset", PLAN_CASES, ids=str)
def test_launch_plan(shape, es, offset):
    P, L, Q = shape
    x_ptr, out_ptr = (1 << 20) + offset, 1 << 24
    plan = scan.launch_plan(P, L, Q, es, 132, x_ptr, out_ptr)
    assert plan.cols == (Q > 1) and plan.itemsize == es
    assert plan.aligned == (offset == 0 and ((Q if Q > 1 else L) * es) % 16 == 0)
    assert plan.batches == (P == 1 and Q == 1 and es == 1 and plan.aligned)
    if plan.batches:  # the row-batch route: a lone row, one thread, the table beside it
        assert plan.mode == 2 and plan.grid == 1 and plan.smem == scan.TABLE_BYTES and L % 16 == 0
        return
    assert plan.mode == int(plan.cols)
    # it fits: threads, shared memory beside a 1-byte table, the grid
    assert plan.threads <= scan.MAX_THREADS and 1 <= plan.stages <= scan.STAGES
    assert plan.smem == (scan.TABLE_BYTES if es == 1 else 0) + plan.stages * plan.slots * plan.pitch + 16 * plan.stages
    assert plan.smem <= scan.SMEM_LIMIT
    assert 1 <= plan.grid <= plan.units and plan.pitch % 16 == 0
    assert plan.depth * plan.tiles >= L > plan.depth * (plan.tiles - 1)
    run_bytes = (plan.width if plan.cols else plan.depth) * es
    assert run_bytes % (16 if plan.cols else 128) == 0 and plan.pitch == run_bytes + 16
    # every chain is scanned by exactly one thread
    seen = np.zeros(P * Q, dtype=np.int64)
    for b in range(plan.grid):
        for u in range(b, plan.units, plan.grid):
            p, q0, chains = scan.unit_chains(plan, u)
            assert 0 < chains <= plan.width <= plan.consumers
            t = np.arange(chains)
            seen[p * Q + q0 + t if plan.cols else (p + t) * Q] += 1
    assert (seen == 1).all()
    # each bulk copy is 16-byte aligned, fits its slot and covers its run,
    # which lies within one row; with aligned rows the copy is the run
    total = P * L * Q * es
    for u in sorted({0, plan.units // 2, plan.units - 1}):
        for k in sorted({0, 1, plan.tiles - 1} & set(range(plan.tiles))):
            runs = scan.slot_runs(plan, u, k)
            assert len(runs) == (min(plan.depth, L - k * plan.depth) if plan.cols else scan.unit_chains(plan, u)[2])
            for slot, first, n in runs:
                start, nbytes, lead = scan.envelope(x_ptr, first, n, es)
                assert start % 16 == 0 and nbytes % 16 == 0 and (slot * plan.pitch) % 16 == 0
                assert lead + n * es <= nbytes <= plan.pitch and lead < 16 and nbytes - lead - n * es < 16
                row = Q if plan.cols else L
                assert first // row == (first + n - 1) // row
                assert x_ptr & ~15 <= start and start + nbytes <= (x_ptr + total + 15) & ~15
                if plan.aligned:
                    assert lead == 0 and nbytes == n * es
                    assert (out_ptr + first * es) % 16 == 0
    if not plan.cols:  # a quarter-warp's 16-byte reads of eight rows: eight bank groups
        assert len({(t * plan.pitch // 16) % 8 for t in range(8)}) == 8


def test_launch_plan_spreads_few_chains_and_fills_the_card():
    """128 chains of 1e6 steps spread over several blocks (one 32-byte
    sector a step each); at 16384^2 8 MB or more is in flight."""
    for es, width in ((2, 16), (1, 32)):
        plan = scan.launch_plan(1, 10**6, 128, es)
        assert plan.width == width and plan.grid == 128 // width
    for shape in ((1, 16384, 16384), (16384, 16384, 1)):
        for es in (2, 1):
            plan = scan.launch_plan(*shape, es)
            assert plan.width == 128 and plan.grid == 128
            assert (plan.stages - 1) * plan.slots * plan.pitch * plan.grid >= 8e6
    one = scan.launch_plan(1, 1 << 24, 1, 2)
    assert one.width == 1 and one.grid == 1 and one.consumers == 32 and not one.batches
    assert scan.launch_plan(1, 1 << 24, 1, 1).batches  # a lone 1-byte row: the row-batch route
    assert not scan.launch_plan(1, (1 << 24) + 3, 1, 1).batches  # unaligned rows stay in the ring
    assert not scan.launch_plan(16384, 16384, 1, 1).batches
    for rows in (2, 8, 64):  # more 1-byte rows, each alone in a unit, take the ring: a block each
        plan = scan.launch_plan(rows, 1 << 20, 1, 1)
        assert not plan.batches and plan.width == 1 and plan.grid == rows

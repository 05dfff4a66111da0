"""The port's native plan algebra (plankit) against its Python paths.

``dask_array_tpu_torch/native`` builds ``plankit.cpp`` with g++ at first
use into ``build/plankit/`` (keyed by the source's hash, written through a
temporary file and ``os.replace``).  These tests do not skip when the
library is missing: they fail, since g++ is where the port runs.

Every entry point against the Python it stands in for, on the random axes
of the JAX package's ``tests/test_native.py``: the native paths of
``_slicing.sliced_blockdim``, ``_rechunk.old_to_new``,
``_rechunk._axis_moved_fraction``, ``_rechunk._stage_degree``,
``_chunks.common_blockdim`` and ``_chunks.unify_blockdims`` against the
same functions with the library withheld (``native._load`` returning
None), and against the JAX package's functions on their Python paths
(its library is never built from here); ``expand_grid``,
``hash_bytes``, ``fingerprint128`` and ``plan_encode``/``plan_validate``
against Python implementations of the same definitions.  The generation
guard raises on skew; two processes that build at once both load a whole
library.

Tolerance: exact, but moved fractions (floats from the same sums: rtol
1e-12).
"""

import itertools
import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from dask_array_tpu import _chunks as jchunks
from dask_array_tpu import _rechunk as jrechunk
from dask_array_tpu import _slicing as jslicing
from dask_array_tpu_torch import _chunks, _rechunk, _slicing, native


@pytest.fixture(autouse=True)
def _jax_package_on_python_paths(monkeypatch):
    """The JAX package's functions are the reference on their Python
    paths: its own library is neither built nor loaded from here."""
    from dask_array_tpu import native as jnative

    monkeypatch.setattr(jnative, "_load", lambda: None)


@pytest.fixture
def python_only(monkeypatch):
    """Run a block of code on the Python paths: the library withheld."""

    def run(fn, *args):
        with monkeypatch.context() as m:
            m.setattr(native, "_load", lambda: None)
            return fn(*args)

    return run


def _partition(r, n, k):
    cuts = np.sort(r.choice(np.arange(1, n), size=min(n - 1, k), replace=False))
    return tuple(int(c) for c in np.diff(np.concatenate([[0], cuts, [n]])))


def test_the_library_loads():
    assert native.available()
    assert native._load() is not None
    assert native.library_path().exists()
    assert native.library_path().parent == native.BUILD_DIR
    assert native._lib.plankit_generation() == native.PLANKIT_GENERATION


def test_the_generation_guard_raises_on_skew():
    native.check_generation(native._load())
    with pytest.raises(native.StaleNativeBuild, match="generation"):
        native.check_generation(native._load(), expected=native.PLANKIT_GENERATION + 1)

    class Stale:
        class plankit_generation:  # noqa: N801 - a ctypes function's stand-in
            restype = None

            def __call__(self):
                return 4

    stale = Stale()
    stale.plankit_generation = Stale.plankit_generation()
    with pytest.raises(native.StaleNativeBuild, match="4 != wrapper generation 5"):
        native.check_generation(stale)


def test_the_port_and_the_jax_package_share_a_generation():
    src = open(os.path.join(os.path.dirname(native.__file__), "plankit.cpp")).read()
    assert f"int64_t plankit_generation() {{ return {native.PLANKIT_GENERATION}; }}" in src
    from dask_array_tpu import native as jnative

    assert jnative.PLANKIT_GENERATION == native.PLANKIT_GENERATION


def _py_sliced_counts(chunks, sl):
    total = sum(chunks)
    start, stop, step = sl.indices(total)
    counts = []
    lo = 0
    for c in chunks:
        hi = lo + c
        lo_eff, hi_eff = max(lo, start), min(hi, stop)
        cnt = 0
        if hi_eff > lo_eff:
            k0 = -(-(lo_eff - start) // step)
            first = start + k0 * step
            if first < hi_eff:
                cnt = (hi_eff - first - 1) // step + 1
        counts.append(cnt)
        lo = hi
    return counts


@pytest.mark.parametrize("seed", range(5))
def test_sliced_blockdim_native_matches_python(seed, python_only):
    rng = np.random.default_rng(seed)
    chunks = tuple(int(c) for c in rng.integers(1, 40, size=300))
    total = sum(chunks)
    for _ in range(20):
        a, b = sorted(rng.integers(0, total, size=2).tolist())
        sl = slice(a, b, int(rng.integers(1, 7)))
        start, stop, st = sl.indices(total)
        counts = native.sliced_blockdim_counts(chunks, start, stop, st)
        assert counts.tolist() == _py_sliced_counts(chunks, sl)
        got, kept = _slicing.sliced_blockdim(chunks, sl)  # > 256 blocks: native
        assert kept is None
        want, _ = python_only(_slicing.sliced_blockdim, chunks, sl)
        assert got == want == jslicing.sliced_blockdim(chunks, sl)[0]
    # a negative step declines to the Python path
    assert native.sliced_blockdim_counts(chunks, 10, 0, -1) is None
    sl = slice(total - 3, 5, -4)
    got, kept = _slicing.sliced_blockdim(chunks, sl)
    assert kept is not None and got == python_only(_slicing.sliced_blockdim, chunks, sl)[0]


@pytest.mark.parametrize("seed", range(4))
def test_old_to_new_native_matches_python(seed, python_only):
    rng = np.random.default_rng(100 + seed)
    old = tuple(int(c) for c in rng.integers(1, 30, size=400))
    new = _partition(rng, sum(old), 350)
    got = _rechunk.old_to_new((old,), (new,))  # > 512 blocks: native
    assert got == python_only(_rechunk.old_to_new, (old,), (new,))
    assert got == jrechunk.old_to_new((old,), (new,))


def test_refine_axis_native_matches_python(python_only):
    rng = np.random.default_rng(7)
    a, b = _partition(rng, 10000, 400), _partition(rng, 10000, 300)
    got = native.refine_axis(a, b)
    bounds = sorted(set(np.cumsum(a)) | set(np.cumsum(b)))
    assert got == tuple(int(x - y) for x, y in zip(bounds, [0] + bounds[:-1]))
    assert _chunks.common_blockdim([a, b]) == got == python_only(_chunks.common_blockdim, [a, b])
    assert got == jchunks.common_blockdim([a, b])


def test_expand_grid():
    got = native.expand_grid((3, 4, 2))
    np.testing.assert_array_equal(got, np.array(list(itertools.product(range(3), range(4), range(2)))))
    assert native.expand_grid(()).shape == (1, 0)


def _fnv1a(data, bits):
    if bits == 64:
        h, prime, mask = 1469598103934665603, 1099511628211, (1 << 64) - 1
    else:
        h = 0x6C62272E07BB014262B821756295C58D
        prime, mask = (0x1000000 << 64) | 0x13B, (1 << 128) - 1
    for byte in data:
        h = ((h ^ byte) * prime) & mask
    return h


@pytest.mark.parametrize("data", [b"", b"hello world", b"hello worle", bytes(range(256)) * 3])
def test_hash_bytes_and_fingerprint128_are_fnv1a(data):
    assert native.hash_bytes(data) == _fnv1a(data, 64)
    assert native.fingerprint128(data) == f"{_fnv1a(data, 128):032x}"
    assert native.hash_bytes(b"hello world") != native.hash_bytes(b"hello worle")


@pytest.mark.parametrize("seed", range(25))
def test_moved_fraction_native_matches_python(seed, python_only):
    r = np.random.default_rng(seed)
    n = int(r.integers(20, 400))
    a = _partition(r, n, int(r.integers(1, 30)))
    b = _partition(r, n, int(r.integers(1, 30)))
    want = python_only(_rechunk._axis_moved_fraction, a, b)
    assert native.moved_fraction_axis(a, b) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(jrechunk._axis_moved_fraction(a, b), rel=1e-12)


def test_moved_fraction_cases_and_transfer_bytes(python_only):
    cases = [((1, 719, 720), (720, 720)), ((10,) * 6, (30, 30)), ((30, 30), (10,) * 6),
             ((100,) * 4, (50, 100, 100, 100, 50)), ((5, 5), (5, 5)), ((3, 7, 5, 5), (10, 10))]
    for src, dst in cases:
        assert native.moved_fraction_axis(src, dst) == pytest.approx(
            python_only(_rechunk._axis_moved_fraction, src, dst), rel=1e-12)
    long = ((1,) * 300, (300,))  # > 256 blocks: the native path
    assert _rechunk._axis_moved_fraction(*long) == python_only(_rechunk._axis_moved_fraction, *long)
    import dask_array_tpu as jda
    import dask_array_tpu_torch as tda

    frac = _rechunk._moved_fraction(((1,) * 300, (4,)), ((300,), (2, 2)))
    got = tda.ones((300, 4), chunks=(1, 4)).rechunk((300, 2)).expr.transfer_bytes()
    assert got == (int(round(300 * 4 * 8 * frac)), 300 * 4 * 8)
    assert got == jda.ones((300, 4), chunks=(1, 4)).rechunk((300, 2)).expr.transfer_bytes()


@pytest.mark.parametrize("seed", range(25))
def test_coarse_axis_native_matches_python(seed):
    r = np.random.default_rng(100 + seed)
    n = int(r.integers(20, 300))
    a = _partition(r, n, int(r.integers(1, 25)))
    b = _partition(r, n, int(r.integers(1, 25)))
    inter = set(_chunks._boundaries(a)) & set(_chunks._boundaries(b))
    assert native.coarse_axis(a, b) == _chunks._from_boundaries(sorted(inter))


@pytest.mark.parametrize("seed", range(25))
def test_stage_degree_native_matches_python(seed, python_only):
    r = np.random.default_rng(200 + seed)
    n = int(r.integers(20, 300))
    a = _partition(r, n, int(r.integers(1, 25)))
    b = _partition(r, n, int(r.integers(1, 25)))
    mapping = _rechunk.old_to_new((a,), (b,))[0]
    assert native.stage_degree_axis(a, b) == max((len(p) for p in mapping), default=1)


@pytest.mark.parametrize("seed", range(6))
def test_stage_degree_and_unify_on_long_axes_match_python(seed, python_only):
    """Axes past the thresholds (> 256 blocks) take the native paths of
    ``_stage_degree`` and ``unify_blockdims``' coarsening."""
    r = np.random.default_rng(300 + seed)
    n = 5000
    a = _partition(r, n, 200)
    b = _partition(r, n, 150)
    got = _rechunk._stage_degree((a,), (b,))
    assert got == python_only(_rechunk._stage_degree, (a,), (b,)) == jrechunk._stage_degree((a,), (b,))
    cands = [(a, 8.0 * n), (b, 8.0 * n)]
    for policy in ("coarse", "auto", "refine"):
        got = _chunks.unify_blockdims(cands, policy=policy)
        assert got == python_only(_chunks.unify_blockdims, cands, policy)
        assert got == jchunks.unify_blockdims(cands, policy=policy)


def _py_encode(codes, strings):
    """The plan grammar of plankit.cpp, in Python (little-endian)."""
    out = bytearray([1]) + struct.pack("<I", len(strings))
    for s in strings:
        out += struct.pack("<I", len(s)) + s
    it = iter(codes)

    def op():
        tag = next(it)
        out.append(tag)
        if tag in (0, 3, 8, 9, 10):
            out.extend(struct.pack("<I", next(it)))
        elif tag in (1, 2):
            out.extend(struct.pack("<q", next(it)))
        elif tag == 4:
            out.append(next(it))
        elif tag == 6:
            mask = next(it)
            out.append(mask)
            for b in range(3):
                if mask & (1 << b):
                    out.extend(struct.pack("<q", next(it)))
        elif tag in (7, 11):
            cnt = next(it)
            out.extend(struct.pack("<H", cnt))
            for _ in range(cnt):
                op()

    n_nodes = next(it)
    out += struct.pack("<I", n_nodes)
    for _ in range(n_nodes):
        out += struct.pack("<I", next(it))
        ndim = next(it)
        out.append(ndim)
        for _ in range(ndim):
            nblk = next(it)
            out += struct.pack("<I", nblk)
            for _ in range(nblk):
                out += struct.pack("<q", next(it))
        n_ops = next(it)
        out += struct.pack("<H", n_ops)
        for _ in range(n_ops):
            op()
    return bytes(out)


def test_plan_encode_and_validate():
    strings = [b"FromArray", b"Elemwise", b"<f8", b"tok"]
    blob = b"".join(strings)
    offs = np.cumsum([0] + [len(s) for s in strings])
    codes = [
        2,
        # node 0: FromArray, chunks ((5, 5), (5, 5)); Leaf(0), Dtype("<f8"), None, Str("tok")
        0, 2, 2, 5, 5, 2, 5, 5, 4, 10, 0, 8, 2, 5, 3, 3,
        # node 1: Elemwise, chunks ((10,),); Expr(0), Slice(0, 10, -1), Tuple(Int 7, Float bits -3), List(Bool 1)
        1, 1, 1, 10, 4, 0, 0, 6, 7, 0, 10, -1, 7, 2, 1, 7, 2, -3, 11, 1, 4, 1,
    ]
    got = native.plan_encode(np.array(codes), blob, offs)
    assert got == _py_encode(codes, strings)
    info = native.plan_validate(got)
    assert info == {"version": 1, "n_strings": 4, "n_nodes": 2, "n_ops": 4 + 7}
    with pytest.raises(ValueError, match="malformed"):
        native.plan_encode(np.array(codes + [0]), blob, offs)  # trailing garbage
    with pytest.raises(ValueError, match="malformed"):
        native.plan_validate(got[:-3])
    with pytest.raises(ValueError, match="grammar version"):
        native.plan_validate(b"\x02" + got[1:])


def test_two_processes_that_build_at_once_both_load_a_whole_library(tmp_path):
    """Each process compiles into the same directory through its own
    temporary file; ``os.replace`` installs whole files, so both load."""
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))!r})
        from dask_array_tpu_torch import native
        native.BUILD_DIR = Path({str(tmp_path)!r})
        ok = native.available() and native._lib.plankit_generation() == native.PLANKIT_GENERATION
        print("loaded" if ok and native.hash_bytes(b"x") is not None else "failed")
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [o[0].strip() for o in outs] == ["loaded", "loaded"], outs
    libs = sorted(os.listdir(tmp_path))
    assert libs == [native.library_path().name]  # one whole library, no temporary file left
    assert os.path.getsize(tmp_path / libs[0]) == os.path.getsize(native.library_path())

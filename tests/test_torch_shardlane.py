"""The shard lane through the port on 8 CPU slots, beside the JAX package.

Every program below runs through both packages under a mesh (8 slots
``("d",)``, 2 x 4 ``("x", "y")`` and 2 x 2 x 2 ``("dcn", "x", "y")``; the
JAX package's 8 forced host devices, the port's 8 CPU slots) with the lane
forced (``tpu.execution-lane: shard-map``, mapped by
``config.from_reference``).  For each case the values must agree (float64
to rtol 1e-12, float32 to 1e-5, integers and booleans exactly) and
``ENGAGED`` must move in both packages or in neither: the decline matrix
(``docs/architecture.md``) row by row.  The port's ``COLLECTIVES`` record
must show the schedules the JAX tests pin from HLO: one combine per lane
reduction and no ``all_gather``, one ``all_gather`` a Blelloch scan, no
collective for a rows-lane matmul, one ``psum`` for a contraction-chunked
one, one ``ppermute`` each way for a stencil.

The JAX side of each (mesh, case) pair is computed once and memoized for
the module.
"""

import importlib

import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.parallel import Mesh as TMesh
from dask_array_tpu_torch.parallel import use_mesh as t_use_mesh
from dask_array_tpu_torch.parallel import shardlane as tlane
from dask_array_tpu_torch.parallel._sharded import COLLECTIVES

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


MESHES = {"d8": ((8,), ("d",)), "x2y4": ((2, 4), ("x", "y")), "dcn2x2y2": ((2, 2, 2), ("dcn", "x", "y"))}

# the JAX package's irregular grid (tests/test_shardlane.py): 11 row blocks
H = (23, 7, 15, 31, 9, 12, 4, 11, 8, 10, 7)
K = (2, 1, 3)  # an irregular column grid of 6
_rng = np.random.default_rng(5)
SRC = _rng.standard_normal((sum(H), 6))
SRC2 = _rng.standard_normal((sum(H), 6))
SRC3D = _rng.standard_normal((4, sum(H), 3))
COLS = _rng.standard_normal((6, sum(H)))
W = _rng.standard_normal((6, 4))
W2 = _rng.standard_normal((6, 4))
WK = _rng.standard_normal((sum(H), 3))
BIAS = _rng.standard_normal((4,))
ROWBIAS = _rng.standard_normal((sum(H), 4))
INTS = _rng.integers(-50, 50, size=(sum(H), 6)).astype(np.int32)
BOOLS = _rng.random((sum(H), 6)) > 0.3
NANS = SRC.copy()
NANS[np.random.default_rng(9).random(NANS.shape) < 0.2] = np.nan
NANS[23:30] = np.nan  # an all-NaN block
SRC32 = SRC.astype(np.float32)
G2 = _rng.standard_normal((sum(H), 6, 5))


class Pkg:
    def __init__(self, which):
        self.which = which
        root = "dask_array_tpu_torch" if which == "port" else "dask_array_tpu"
        self.da = importlib.import_module(root)
        self.lane = importlib.import_module(f"{root}.parallel.shardlane")
        if which == "port":
            self.roll, self.tanh = torch.roll, torch.tanh
        else:
            import jax.numpy as jnp

            self.roll, self.tanh = jnp.roll, jnp.tanh

    def mesh(self, name):
        shape, names = MESHES[name]
        if self.which == "port":
            return TMesh(np.array(["cpu"] * 8, dtype=object).reshape(shape), names)
        import jax
        from jax.sharding import Mesh

        return Mesh(np.asarray(jax.devices("cpu")[:8]).reshape(shape), names)

    def use_mesh(self, mesh):
        if self.which == "port":
            return t_use_mesh(mesh)
        return self.da.parallel.use_mesh(mesh)

    def config(self, values):
        if self.which == "port":
            return tconfig.set(tconfig.from_reference(values))
        return self.da.config.set(values)

    def arr(self, src, chunks):
        return self.da.from_array(src, chunks=chunks)

    def run(self, mesh_name, build, cfg):
        mesh = self.mesh(mesh_name)
        before = self.lane.ENGAGED["count"]
        with self.use_mesh(mesh), self.config(dict({"tpu.execution-lane": "shard-map"}, **cfg)):
            out = np.asarray(build(self).compute())
        return out, self.lane.ENGAGED["count"] - before


PORT = Pkg("port")


def _stencil(p, kind):
    roll, tanh = p.roll, p.tanh

    def lap(b):
        return roll(b, 1, 0) + roll(b, -1, 0) + roll(b, 1, 1) - 3 * b

    def tlap(b):
        return tanh(roll(b, 1, 0) + roll(b, -1, 0) - 2 * b)

    return {"lap": lap, "tlap": tlap}[kind]


def _block_id_func(p):
    def f(b, block_id=None):
        return b * 2

    return f


x = lambda p: p.arr(SRC, (H, 6))  # noqa: E731
y = lambda p: p.arr(SRC2, (H, 6))  # noqa: E731
xk = lambda p: p.arr(SRC, (H, K))  # noqa: E731
xc = lambda p: p.arr(COLS, (6, H))  # noqa: E731
xn = lambda p: p.arr(NANS, (H, 6))  # noqa: E731
x3 = lambda p: p.arr(SRC3D, (4, H, 3))  # noqa: E731
g3 = lambda p: p.arr(G2, (H, K, 5))  # noqa: E731
xmm_k = lambda p: p.arr(SRC.T.copy(), (6, H))  # noqa: E731

# (name, build, engages, collectives the port must record (None: not checked), config)
CASES = [
    # -- in-lane: elemwise / reductions / scans / argreduce, one chunked axis
    ("elemwise", lambda p: x(p) * 2 + 1, True, {"gather": 1}, {}),
    ("two_leaf_elemwise", lambda p: x(p) + y(p) * 3, True, {"gather": 1}, {}),
    ("sum_all", lambda p: (x(p) + 1).sum(), True, {"psum": 1}, {}),
    ("sum_axis0", lambda p: (x(p) + 1).sum(axis=0), True, {"psum": 1}, {}),
    ("mean_all", lambda p: (x(p) + 1).mean(), True, {"psum": 1}, {}),
    ("mean_axis0", lambda p: (x(p) + 1).mean(axis=0), True, {"psum": 1}, {}),
    ("max_all", lambda p: (x(p) + 1).max(), True, {"pmax": 1}, {}),
    ("max_axis0", lambda p: (x(p) + 1).max(axis=0), True, {"pmax": 1}, {}),
    ("min_all", lambda p: (x(p) + 1).min(), True, {"pmin": 1}, {}),
    ("sum_local_axis1", lambda p: x(p).sum(axis=1), True, {"gather": 1}, {}),
    ("prod_local_axis1", lambda p: x(p).prod(axis=1), True, {"gather": 1}, {}),
    ("local_3d", lambda p: x3(p).sum(axis=(0, 2)), True, None, {}),
    ("midaxis_3d_elemwise", lambda p: x3(p) * 2 - 1, True, None, {}),
    ("midaxis_3d_sum", lambda p: x3(p).sum(), True, {"psum": 1}, {}),
    ("var", lambda p: x(p).var(), True, {"psum": 2}, {}),
    ("std_axis0", lambda p: x(p).std(axis=0), True, None, {}),
    ("normalize", lambda p: (x(p) - x(p).mean()) / x(p).std(), True, None, {}),
    ("int_sum", lambda p: p.arr(INTS, (H, 6)).sum(axis=0), True, {"psum": 1}, {}),
    ("int_max", lambda p: p.arr(INTS, (H, 6)).max(), True, {"pmax": 1}, {}),
    ("int_min_axis0", lambda p: p.arr(INTS, (H, 6)).min(axis=0), True, {"pmin": 1}, {}),
    ("bool_any", lambda p: p.arr(BOOLS, (H, 6)).any(axis=0), True, {"pmax": 1}, {}),
    ("bool_all", lambda p: p.arr(BOOLS, (H, 6)).all(), True, {"pmin": 1}, {}),
    ("nansum", lambda p: p.da.nansum(xn(p), axis=0), True, {"psum": 1}, {}),
    ("nanmean", lambda p: p.da.nanmean(xn(p)), True, {"psum": 2}, {}),
    ("nanmax_axis0", lambda p: p.da.nanmax(xn(p), axis=0), True, {"pmax": 1}, {}),
    ("nanmin_all", lambda p: p.da.nanmin(xn(p)), True, {"pmin": 1}, {}),
    ("nanmax_local", lambda p: p.da.nanmax(xn(p), axis=1), True, {"gather": 1}, {}),
    ("float32_sum", lambda p: p.arr(SRC32, (H, 6)).sum(axis=0), True, {"psum": 1}, {}),
    ("cumsum_blelloch", lambda p: p.da.cumsum(x(p), axis=0), True, {"all_gather": 1, "gather": 1}, {}),
    ("cumprod_blelloch", lambda p: p.da.cumprod(x(p) * 0.1 + 1, axis=0), True, {"all_gather": 1, "gather": 1}, {}),
    ("cumsum_local", lambda p: p.da.cumsum(x(p), axis=1), True, {"gather": 1}, {}),
    ("int_cumsum", lambda p: p.da.cumsum(p.arr(INTS, (H, 6)), axis=0), True, {"all_gather": 1, "gather": 1}, {}),
    ("inner_scan_tree", lambda p: p.da.cumsum(x(p), axis=0) * 2 + 1, True, {"all_gather": 1, "gather": 1}, {}),
    ("inner_scan_reduce", lambda p: (x(p) - p.da.cumsum(x(p), axis=0)).sum(), True, {"all_gather": 1, "psum": 1}, {}),
    ("argmax_axis0", lambda p: x(p).argmax(axis=0), True, None, {}),
    ("argmin_all", lambda p: x(p).argmin(), True, None, {}),
    ("argmax_local", lambda p: x(p).argmax(axis=1), True, {"gather": 1}, {}),
    ("argmax_nan", lambda p: xn(p).argmax(axis=0), True, None, {}),
    ("argmin_int", lambda p: p.arr(INTS, (H, 6)).argmin(), True, None, {}),
    ("cols_elemwise", lambda p: xc(p) * 3, True, {"gather": 1}, {}),
    ("cols_sum_axis1", lambda p: xc(p).sum(axis=1), True, {"psum": 1}, {}),
    ("cols_cumsum", lambda p: p.da.cumsum(xc(p), axis=1), True, {"all_gather": 1, "gather": 1}, {}),
    # -- matmul terminals
    ("matmul_rows", lambda p: (x(p) * 2) @ W, True, {"gather": 1}, {}),
    ("matvec_rows", lambda p: x(p) @ W[:, 0], True, {"gather": 1}, {}),
    ("matmul_then_sum0", lambda p: (x(p) @ W).sum(axis=0), True, {"psum": 1}, {}),
    ("matmul_then_mean", lambda p: (x(p) @ W).mean(), True, {"psum": 1}, {}),
    ("matmul_then_max_axis1", lambda p: (x(p) @ W).max(axis=1), True, {"gather": 1}, {}),
    ("matmul_k", lambda p: xmm_k(p) @ WK, True, {"psum": 1}, {}),
    ("matmul_k_then_sum", lambda p: (xmm_k(p) @ WK).sum(axis=1), True, {"psum": 1}, {}),
    ("matmul_cols", lambda p: p.arr(SRC[:8], (8, 6)) @ p.arr(W, (6, (1, 2, 1))), True, {"gather": 1}, {}),
    ("tanh_of_matmul", lambda p: p.da.tanh(x(p) @ W), True, {"gather": 1}, {}),
    ("bias_add", lambda p: x(p) @ W + BIAS, True, {"gather": 1}, {}),
    # -- two-axis grids
    ("g2_elemwise", lambda p: xk(p) * 2 + 1, True, {"gather": 1}, {}),
    ("g2_sum_all", lambda p: xk(p).sum(), True, {"psum": 1}, {}),
    ("g2_mean_all", lambda p: xk(p).mean(), True, {"psum": 1}, {}),
    ("g2_max_all", lambda p: xk(p).max(), True, {"pmax": 1}, {}),
    ("g2_straddle_sum1", lambda p: xk(p).sum(axis=1), True, {"psum": 1}, {}),
    ("g2_straddle_min0", lambda p: xk(p).min(axis=0), True, {"pmin": 1}, {}),
    ("g2_straddle_mean0", lambda p: xk(p).mean(axis=0), True, {"psum": 1}, {}),
    ("g2_cumsum0", lambda p: p.da.cumsum(xk(p), axis=0), True, {"all_gather": 1, "gather": 1}, {}),
    ("g2_cumprod1", lambda p: p.da.cumprod(xk(p) * 0.1 + 1, axis=1), True, {"all_gather": 1, "gather": 1}, {}),
    ("g2_normalize", lambda p: (xk(p) - xk(p).mean()) / xk(p).std(), True, None, {}),
    ("g2_inner_scan", lambda p: p.da.cumsum(xk(p), axis=0) + 1, True, None, {}),
    ("g2_argmax_all", lambda p: xk(p).argmax(), True, None, {}),
    ("g2_argmax_axis0", lambda p: xk(p).argmax(axis=0), True, None, {}),
    ("g2_3d_local_sum", lambda p: g3(p).sum(axis=2), True, {"gather": 1}, {}),
    ("g2_3d_pair_sum", lambda p: g3(p).sum(axis=(0, 1)), True, {"psum": 1}, {}),
    ("g2_3d_local_cumsum", lambda p: p.da.cumsum(g3(p), axis=2), True, {"gather": 1}, {}),
    ("g2_3d_argmin_local", lambda p: g3(p).argmin(axis=2), True, {"gather": 1}, {}),
    # -- stencils (the per-block form: the band-stencil routing off in both)
    ("stencil_reflect", lambda p: x(p).map_overlap(_stencil(p, "lap"), depth=1, boundary="reflect"), True,
     {"ppermute": 2, "gather": 1}, {"tpu.stencil-kernel": "off"}),
    ("stencil_nearest", lambda p: x(p).map_overlap(_stencil(p, "lap"), depth=1, boundary="nearest"), True,
     {"ppermute": 2, "gather": 1}, {"tpu.stencil-kernel": "off"}),
    ("stencil_periodic", lambda p: x(p).map_overlap(_stencil(p, "tlap"), depth={0: 2, 1: 1}, boundary="periodic"),
     True, {"ppermute": 4, "gather": 1}, {"tpu.stencil-kernel": "off"}),
    # a halo deeper than the smallest block: map_overlap merges blocks first
    ("stencil_deep_halo", lambda p: x(p).map_overlap(_stencil(p, "tlap"), depth={0: 5, 1: 0}, boundary="reflect"),
     True, {"ppermute": 2, "gather": 1}, {"tpu.stencil-kernel": "off"}),
    ("stencil_constant", lambda p: x(p).map_overlap(_stencil(p, "tlap"), depth=1, boundary=0.5), True,
     {"ppermute": 2, "gather": 1}, {"tpu.stencil-kernel": "off"}),
    # -- declines (the default lanes answer, with the same values)
    ("decline_keepdims", lambda p: (x(p) * 2).sum(axis=0, keepdims=True), False, None, {}),
    ("decline_prod_sharded", lambda p: x(p).prod(axis=0), False, None, {}),
    ("decline_matmul_prod_rows", lambda p: (x(p) @ W).prod(axis=0), False, None, {}),
    ("decline_two_einsums", lambda p: (x(p) @ W) + (x(p) @ W2), False, None, {}),
    ("decline_rowbias", lambda p: x(p) @ W + ROWBIAS, False, None, {}),
    ("decline_cols_composed", lambda p: (p.arr(SRC[:8], (8, 6)) @ p.arr(W, (6, (1, 2, 1)))).sum(), False, None, {}),
    ("decline_matmul_k_both_chunked", lambda p: p.arr(SRC.T.copy(), ((2, 4), H)) @ WK, False, None, {}),
    ("decline_three_axes", lambda p: p.arr(G2, (H, K, (2, 3))) * 2, False, None, {}),
    ("decline_masked", lambda p: p.da.from_array(np.ma.masked_less(SRC, -1.0), chunks=(H, 6)).sum(axis=1), False,
     None, {}),
    ("decline_stencil_none", lambda p: x(p).map_overlap(_stencil(p, "lap"), depth=1, boundary="none"), False, None,
     {"tpu.stencil-kernel": "off"}),
    ("decline_stencil_2d_grid", lambda p: xk(p).map_overlap(_stencil(p, "lap"), depth=1, boundary="reflect"), False,
     None, {"tpu.stencil-kernel": "off"}),
    ("decline_stencil_block_id", lambda p: x(p).map_overlap(_block_id_func(p), depth=1, boundary="reflect"), False,
     None, {"tpu.stencil-kernel": "off"}),
    ("decline_tanh_matmul_sum", lambda p: p.da.tanh(x(p) @ W).sum(axis=0), False, None, {}),
    ("decline_unknown_chunks", lambda p: x(p)[x(p)[:, 0] > 0].sum(axis=0), False, None, {}),
]
CASE = {c[0]: c for c in CASES}
# every case on the 8-slot ring; these also on the 2-D and 3-D meshes
ON_ALL_MESHES = (
    "elemwise", "sum_axis0", "mean_all", "var", "normalize", "cumsum_blelloch", "argmax_axis0", "matmul_rows",
    "matmul_k", "matmul_then_sum0", "g2_straddle_sum1", "g2_argmax_axis0", "stencil_reflect",
    "stencil_periodic", "decline_keepdims", "decline_two_einsums",
)
ALL_PAIRS = [("d8", c[0]) for c in CASES] + [(m, n) for m in ("x2y4", "dcn2x2y2") for n in ON_ALL_MESHES]
# this file runs the one-axis grids; tests/test_torch_shardlane_grid2.py the
# two-axis grids, the stencils and the declines (the JAX side of each pair
# takes a compile, so the two files split the time)
SECOND_FILE = ("g2_", "stencil", "decline_")
PAIRS = [(m, c) for m, c in ALL_PAIRS if not c.startswith(SECOND_FILE)]

_JAX: dict = {}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's (value, ENGAGED delta) of each (mesh, case),
    computed once for the module."""
    pkg = Pkg("jax")

    def get(mesh_name, case):
        key = (mesh_name, case)
        if key not in _JAX:
            _, build, _, _, cfg = CASE[case]
            _JAX[key] = pkg.run(mesh_name, build, cfg)
        return _JAX[key]

    return get


def _assert_same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        return
    rtol = 1e-5 if want.dtype == np.float32 else 1e-12
    scale = float(np.nanmax(np.abs(want))) if want.size and not np.all(np.isnan(want)) else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale, 1.0))


def check_case(jax_side, mesh_name, case):
    """One (mesh, case) pair through both packages: the same values, the
    same engagement, and the port's collective schedule."""
    _, build, engages, schedule, cfg = CASE[case]
    want, jax_eng = jax_side(mesh_name, case)
    before = COLLECTIVES.snapshot()
    got, port_eng = PORT.run(mesh_name, build, cfg)
    moved = COLLECTIVES.delta(before)
    _assert_same(got, want)
    assert jax_eng == int(engages), f"the JAX package {'declined' if engages else 'engaged'}"
    assert port_eng == jax_eng
    if schedule is not None and engages:
        assert moved == schedule
    if engages:
        assert "all_gather" not in moved or case.startswith(("cumsum", "cumprod", "int_cumsum", "inner_scan",
                                                              "cols_cumsum", "g2_cumsum", "g2_cumprod",
                                                              "g2_inner_scan"))


@pytest.mark.parametrize("mesh_name,case", PAIRS, ids=[f"{m}-{c}" for m, c in PAIRS])
def test_lane_matches_the_jax_package(jax_side, mesh_name, case):
    check_case(jax_side, mesh_name, case)


def test_lane_reductions_combine_once_without_all_gather():
    """The JAX package pins "no all-gather, one all-reduce" from the
    compiled HLO of the lane's reduction; the port's record shows one
    combine a reduction and no all_gather on every mesh."""
    for mesh_name in MESHES:
        for build, kind in ((lambda p: x(p).sum(), "psum"), (lambda p: x(p).max(axis=0), "pmax"),
                            (lambda p: xk(p).min(), "pmin"), (lambda p: x(p).mean(axis=0), "psum")):
            before = COLLECTIVES.snapshot()
            PORT.run(mesh_name, build, {})
            assert COLLECTIVES.delta(before) == {kind: 1}


def test_lane_slots_hold_the_jax_block_assignment():
    """Slot ``s`` runs blocks ``[s*blk, (s+1)*blk)`` with ``blk = kpad /
    ndev`` (``dask_array_tpu/parallel/shardlane.py:879``): 11 blocks on 8
    slots give 2 a slot, slots 6 and 7 idle."""
    mesh = PORT.mesh("d8")
    lane = tlane._lane_1d(mesh, (H, (6,)), 0)
    assert [p.slot for p in lane.pieces] == [0, 1, 2, 3, 4, 5]
    off = np.concatenate([[0], np.cumsum(H)])
    assert [p.region[0] for p in lane.pieces] == [
        (int(off[2 * s]), int(off[min(2 * s + 2, 11)])) for s in range(6)
    ]
    g = tlane._lane_2d(mesh, (H, K), (0, 1))
    assert len(g.pieces) == 33 and [p.slot for p in g.pieces][:6] == [0, 0, 0, 0, 0, 1]


def test_auto_engages_regular_grids_in_the_port():
    """The port has no GSPMD partitioner: under "auto" a regular grid the
    planner matches runs in-lane (the JAX package keeps it on its GSPMD
    lane), and "gspmd" keeps every program on the walk."""
    mesh = PORT.mesh("d8")
    reg = PORT.arr(SRC[:136], (17, 6))
    before = tlane.ENGAGED["count"]
    with t_use_mesh(mesh):
        got = np.asarray(reg.sum(axis=0).compute())
    assert tlane.ENGAGED["count"] == before + 1
    np.testing.assert_allclose(got, SRC[:136].sum(axis=0), rtol=1e-12)
    with t_use_mesh(mesh), tconfig.set({"execution-lane": "gspmd"}):
        got = np.asarray(x(PORT).sum(axis=0).compute())
    assert tlane.ENGAGED["count"] == before + 1
    np.testing.assert_allclose(got, SRC.sum(axis=0), rtol=1e-12)


@pytest.mark.parametrize("lane", ["auto", "shard-map"])
def test_lane_errors_propagate(monkeypatch, lane):
    """A decline is decided in planning; an error while a lane program runs
    propagates under every setting (the JAX package falls back under
    "auto"; the port lets no fallback hide a failure on the card)."""

    def boom(*a, **k):
        raise RuntimeError("lane program failed")

    monkeypatch.setattr(tlane, "_execute_1d", boom)
    with t_use_mesh(PORT.mesh("d8")), tconfig.set({"execution-lane": lane}):
        with pytest.raises(RuntimeError, match="lane program failed"):
            x(PORT).sum().compute()


H9 = (23, 15, 31, 9, 12, 11, 10, 26)  # every block as deep as a 9-row halo


def _row9(b):
    return torch.roll(b, 9, 0) - 2 * b + torch.roll(b, -9, 0)


def _median3(b):
    """A 3x3 median filter (a stack and a median): a func the band-stencil
    gate declines."""
    return torch.stack([torch.roll(b, (dy, dx), (0, 1)) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]).median(0).values


def _explicit_stencil(src, chunks, func, depth, boundary):
    """overlap -> map_blocks -> trim_internal written out: the lane's
    stencil plan with the func the band-stencil gate takes."""
    from dask_array_tpu_torch.ops._overlap import overlap, trim_internal

    a = PORT.arr(src, chunks)
    return trim_internal(overlap(a, depth, boundary).map_blocks(func), depth, boundary)


# (name, build, config, band-stencil calls: one a slot, or none)
LANE_STENCILS = [
    ("taps_read", lambda: _explicit_stencil(SRC, (H, 6), _stencil(PORT, "lap"), {0: 1, 1: 1}, "reflect"),
     {}, "a slot"),
    ("nonlinear", lambda: _explicit_stencil(SRC, (H, 6), _stencil(PORT, "tlap"), {0: 1, 1: 1}, "reflect"),
     {}, "a slot"),
    ("declined", lambda: _explicit_stencil(SRC, (H, 6), _median3, {0: 1, 1: 1}, "reflect"), {}, 0),
    ("kernel_off", lambda: x(PORT).map_overlap(_stencil(PORT, "lap"), depth=1, boundary="reflect"),
     {"stencil-kernel": "off"}, 0),
    ("kernel_off_explicit", lambda: _explicit_stencil(SRC, (H, 6), _stencil(PORT, "lap"), {0: 1, 1: 1}, "reflect"),
     {"stencil-kernel": "off"}, 0),
    ("depth_9", lambda: PORT.arr(SRC, (H9, 6)).map_overlap(_row9, depth={0: 9, 1: 0}, boundary="reflect"),
     {}, 0),
]


@pytest.mark.parametrize("name,build,cfg,calls", LANE_STENCILS, ids=[c[0] for c in LANE_STENCILS])
def test_stencil_lane_takes_the_band_kernel_gate(monkeypatch, name, build, cfg, calls):
    """The lane's stencil plan reaches the band-stencil route (its plain
    version here) only where ``stencil_taps`` takes the func, the gate
    ``map_overlap`` takes: once a slot for a linear func or a program of
    pointwise ops, never for one the capture declines (a median), under
    ``stencil-kernel: off`` or past depth 8 (on the card the kernel refuses
    depth 9).  Each program runs in-lane and
    equals the walk."""
    from dask_array_tpu_torch.kernels import stencil

    seen = []
    real = stencil.band_stencil_call

    def counted(x, *args):
        seen.append(x.shape)
        return real(x, *args)

    monkeypatch.setattr(stencil, "band_stencil_call", counted)
    mesh = PORT.mesh("d8")
    with tconfig.set(cfg):
        e = build()
        want = np.asarray(e.compute())
        before = tlane.ENGAGED["count"]
        with t_use_mesh(mesh):
            got = np.asarray(e.compute())
    assert tlane.ENGAGED["count"] == before + 1
    slots = len(tlane._lane_1d(mesh, e.expr.optimize().chunks, 0).pieces)
    assert len(seen) == (slots if calls == "a slot" else calls)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

# (a terminal over inner reductions' results only, replicated on every
# slot; the JAX package's lane combines it once a slot, or fails)
REPLICATED_TERMINALS = [
    ("std_then_sum", lambda p, a: a.std(axis=0).T.sum(axis=0), lambda x: x.std(0).sum()),
    ("sum_then_argmax", lambda p, a: a[:3].sum(axis=-1).argmax(-1), lambda x: x[:3].sum(-1).argmax()),
    ("mean_then_cumsum", lambda p, a: p.da.cumsum(a.mean(axis=0), axis=0), lambda x: np.cumsum(x.mean(0))),
]


@pytest.mark.parametrize("lane", ["shard-map", "auto"])
@pytest.mark.parametrize("case", REPLICATED_TERMINALS, ids=[c[0] for c in REPLICATED_TERMINALS])
def test_lane_terminal_over_replicated_operand(case, lane):
    """A lane program whose terminal reads only inner reductions' results
    (the lane's chunked axis reduced away inside) runs the terminal once on
    the replicated value: numpy's answer, with no combine across slots."""
    _, build, want = case
    src = SRC[:, :5]
    mesh = PORT.mesh("d8")
    with t_use_mesh(mesh), tconfig.set({"execution-lane": lane}):
        got = np.asarray(build(PORT, PORT.arr(src, (H, 5))).compute())
    np.testing.assert_allclose(got, want(src), rtol=1e-12)


def test_lane_terminal_over_replicated_operand_is_a_reference_fault():
    """The JAX package's lane combines such a terminal once a slot (a sum
    counted once a device): the port's repair is real."""
    import dask_array_tpu as jda

    src = SRC[:, :5]
    jax_pkg = Pkg("jax")
    with jax_pkg.use_mesh(jax_pkg.mesh("d8")), jda.config.set({"tpu.execution-lane": "shard-map"}):
        got = float(jax_pkg.arr(src, (H, 5)).std(axis=0).T.sum(axis=0).compute())
    assert not np.isclose(got, src.std(0).sum(), rtol=1e-6)


# 2-byte floats: seeded normals through ``from_array`` on the irregular
# row grid; NaNs in a fifth of the nan-kind input, factors near 1 for
# ``cumprod``
_HALF_SRC = np.random.default_rng(21).standard_normal((sum(H), 6)) * 3
_HALF_NANS = _HALF_SRC.copy()
_HALF_NANS[np.random.default_rng(22).random(_HALF_NANS.shape) < 0.2] = np.nan
_HALF_FACTORS = 1 + _HALF_SRC * 0.01

# (name, build over (da, arrays of _HALF_SRC, _HALF_NANS, _HALF_FACTORS),
# engages on the row grid, engages on the row and column grid)
HALF_CASES = [
    ("sum_axis0", lambda da, a, n, f: a.sum(axis=0), True, True),
    ("sum_all", lambda da, a, n, f: a.sum(), True, True),
    ("mean_axis0", lambda da, a, n, f: a.mean(axis=0), True, True),
    ("mean_all", lambda da, a, n, f: a.mean(), True, True),
    ("nansum_axis0", lambda da, a, n, f: da.nansum(n, axis=0), True, True),
    ("nanmean_axis0", lambda da, a, n, f: da.nanmean(n, axis=0), True, True),
    ("normalize", lambda da, a, n, f: a - a.mean(), True, True),
    ("cumsum_axis0", lambda da, a, n, f: da.cumsum(a, axis=0), False, False),
    ("cumprod_axis0", lambda da, a, n, f: da.cumprod(f, axis=0), False, False),
    ("inner_scan_reduce", lambda da, a, n, f: (a - da.cumsum(a, axis=0)).sum(), False, False),
    ("cumsum_axis1", lambda da, a, n, f: da.cumsum(a, axis=1), True, False),
]


def _half_ulps(a, b):
    """The largest distance of two 2-byte float arrays in units in the last
    place (their bits as a signed-magnitude order; NaN to NaN is 0)."""
    ia, ib = (np.asarray(v).view(np.int16).astype(np.int64) for v in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFF), i) for i in (ia, ib))
    both_nan = np.isnan(np.asarray(a, np.float32)) & np.isnan(np.asarray(b, np.float32))
    return int(np.where(both_nan, 0, np.abs(ia - ib)).max(initial=0))


@pytest.mark.parametrize("grid", ["rows", "rows_cols"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("case", HALF_CASES, ids=[c[0] for c in HALF_CASES])
def test_lane_two_byte_float_rounds_once(case, dtype, grid):
    """Under ``"auto"`` on 8 slots a float16/bfloat16 sum or mean over the
    sharded axis equals the no-mesh walk: float32 partials through the
    slot combine and the ``all_reduce``, one rounding at the end.  A scan
    along the sharded axis declines the lane (the dense walk rounds at
    every step, which no per-piece carry reproduces) and so equals it too;
    on the row and column grid so does a scan along the chunked axis 1.

    Tolerance: one 2-byte ulp.  The lane adds its float32 partials in
    another order than the dense walk's one float32 sum, so the two
    float32 totals may differ in their last bits; that can move the one
    rounding to 2 bytes across a rounding boundary, by one ulp, never
    more.  The parent, which rounded each part to 2 bytes, was off by up
    to 54 ulps on these inputs."""
    import ml_dtypes

    import dask_array_tpu_torch as tda

    _, build, *engages = case
    dt = np.dtype(np.float16) if dtype == "float16" else np.dtype(ml_dtypes.bfloat16)
    chunks = (H, 6) if grid == "rows" else (H, K)

    def run():
        arrays = (tda.from_array(v.astype(dt), chunks=chunks) for v in (_HALF_SRC, _HALF_NANS, _HALF_FACTORS))
        return np.asarray(build(tda, *arrays).compute())

    want = run()
    before = tlane.ENGAGED["count"]
    with t_use_mesh(PORT.mesh("d8")):
        got = run()
    assert got.dtype == want.dtype == dt and got.shape == want.shape
    assert _half_ulps(got, want) <= 1
    assert tlane.ENGAGED["count"] - before == int(engages[grid == "rows_cols"])

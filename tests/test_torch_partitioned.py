"""The partitioned walk against the JAX package's mesh tests, on 8 CPU slots.

Every test of the JAX package's ``tests/test_mesh_battery.py``,
``tests/test_irregular_mesh.py`` and ``tests/test_parallel.py``, the
mesh test of ``tests/test_joint_compute.py`` and the two end-to-end tests
of ``tests/test_rechunk_collective.py``, each through both packages: the
JAX package under its 8-device CPU mesh (default lane; computed once for
the module), the port on ``Mesh`` objects of 8 ``cpu`` slots under
``"execution-lane"`` ``"gspmd"`` (the partitioned walk alone) and
``"auto"`` (the shard lane first), with numpy as the tie-breaker.

Each assertion the JAX package makes on compiled HLO has its counterpart
on the port's records: "all-reduce" is a ``psum`` in
``_sharded.COLLECTIVES``, "collective-permute" a ``ppermute``, "output
not fully replicated" the root's ``ShardedView`` spec from
``execute_views``, "the compiled path engaged" the node walked per slot
in ``partition.PARTITIONED`` with nothing gathered, and "no all-gather
beyond the scan's" the ``all_gather`` count of the scan alone.
"""

import importlib
from functools import partial

import numpy as np
import pytest
import torch

import dask_array_tpu.parallel  # noqa: F401  (the JAX side's mesh, as jda.parallel)
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.parallel import Mesh as TMesh
from dask_array_tpu_torch.parallel._sharded import COLLECTIVES, ShardedTensor, ShardedView
from dask_array_tpu_torch.parallel.partition import PARTITIONED

torch.set_num_threads(1)

MESHES = {"ring8": ((8,), ("r",)), "mesh2x4": ((2, 4), ("x", "y")), "dcn2x4": ((2, 4), ("dcn", "x")),
          "mesh2x2": ((2, 2), ("x", "y"))}
LANES = ["gspmd", "auto"]


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


class Pkg:
    def __init__(self, which):
        self.which = which
        root = "dask_array_tpu_torch" if which == "port" else "dask_array_tpu"
        self.da = importlib.import_module(root)
        self.xp = torch if which == "port" else importlib.import_module("jax.numpy")

    def mesh(self, name):
        shape, names = MESHES[name]
        n = int(np.prod(shape))
        if self.which == "port":
            return TMesh(np.array(["cpu"] * n, dtype=object).reshape(shape), names)
        import jax
        from jax.sharding import Mesh

        return Mesh(np.asarray(jax.devices("cpu")[:n]).reshape(shape), names)

    def use_mesh(self, mesh):
        return self.da.parallel.use_mesh(mesh)

    def lane(self, lane):
        if self.which == "port":
            return tconfig.set({"execution-lane": lane})
        return self.da.config.set({})

    def compute(self, *arrays):
        return [np.asarray(v) for v in self.da.compute(*arrays)]


JAX, PORT = Pkg("jax"), Pkg("port")
_JAX: dict = {}


def run(build, mesh_name, lane=None, which=None):
    """``build(pkg)`` (a list of collections) computed under ``mesh_name``:
    the JAX package's once for the module; the port's under ``lane``, with
    the records' deltas: (values, COLLECTIVES delta, their bytes,
    PARTITIONED delta)."""
    p = JAX if which == "jax" else PORT
    if which == "jax":
        key = (build.__qualname__, mesh_name)
        if key not in _JAX:
            with p.use_mesh(p.mesh(mesh_name)):
                _JAX[key] = p.compute(*build(p))
        return _JAX[key]
    arrays = build(p)
    with p.use_mesh(p.mesh(mesh_name)), p.lane(lane):
        coll, nb, parts = COLLECTIVES.snapshot(), dict(COLLECTIVES.nbytes), PARTITIONED.snapshot()
        got = p.compute(*arrays)
        moved = COLLECTIVES.delta(coll)
        nbytes = {k: COLLECTIVES.nbytes[k] - nb[k] for k in moved}
        parted = PARTITIONED.delta(parts)
    return got, moved, nbytes, parted


def check(build, mesh_name, lane, want_np, rtol=1e-10, atol=1e-10):
    """Both packages' values of ``build`` equal, and equal to numpy's; the
    port's records."""
    want = run(build, mesh_name, which="jax")
    got, moved, nbytes, parted = run(build, mesh_name, lane)
    for g, w, n in zip(got, want, want_np):
        assert g.shape == w.shape == np.shape(n)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
        np.testing.assert_allclose(g, n, rtol=rtol, atol=atol)
    return moved, nbytes, parted


def rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# tests/test_mesh_battery.py
# ---------------------------------------------------------------------------

X_ER = rng(61).standard_normal((64, 32))


def _elemwise_reduction(p):
    d = p.da.from_array(X_ER, chunks=(8, 32))
    return [((d * 2 + 1) ** 2).sum(axis=0)]


@pytest.mark.parametrize("lane", LANES)
def test_elemwise_reduction_on_mesh(lane):
    moved, _, parted = check(_elemwise_reduction, "ring8", lane, [((X_ER * 2 + 1) ** 2).sum(axis=0)])
    if lane == "gspmd":
        # the compiled path engaged: every node per slot, nothing gathered
        assert parted["slots"]["Reduction"] == 1 and "gathered" not in parted
        assert moved == {"psum": 1, "gather": 1}


X_MM, Y_MM = rng(62).standard_normal((64, 48)), rng(63).standard_normal((48, 32))


def _matmul_2d(p):
    return [p.da.from_array(X_MM, chunks=(16, 12)) @ p.da.from_array(Y_MM, chunks=(12, 8))]


@pytest.mark.parametrize("lane", LANES)
def test_matmul_on_mesh_2d(lane):
    moved, _, parted = check(_matmul_2d, "mesh2x4", lane, [X_MM @ Y_MM])
    if lane == "gspmd":
        assert parted["slots"]["Einsum"] == 1 and "gathered" not in parted


X_MK, Y_MK = rng(64).standard_normal((32, 64)), rng(65).standard_normal((64, 32))


def _matmul_k(p):
    return [p.da.from_array(X_MK, chunks=(32, 8)) @ p.da.from_array(Y_MK, chunks=(8, 32))]


@pytest.mark.parametrize("lane", LANES)
def test_matmul_contracted_axis_sharded_emits_allreduce(lane):
    moved, nbytes, parted = check(_matmul_k, "ring8", lane, [X_MK @ Y_MK])
    # "psum missing": the contraction axis is sharded on both operands
    assert moved.get("psum") == 1, moved
    if lane == "gspmd":
        assert "all_gather" not in moved and "all_to_all" not in moved


X_MO = rng(66).standard_normal((64, 16)).astype("f4")


def _map_overlap_roll(p):
    xp = p.xp
    d = p.da.from_array(X_MO, chunks=(8, 16))
    return [p.da.map_overlap(lambda b: xp.roll(b, 1, 0), d, depth={0: 1}, boundary="reflect", dtype="f4")]


@pytest.mark.parametrize("lane", LANES)
def test_map_overlap_on_mesh_emits_collective_permute(lane):
    pad = np.pad(X_MO, ((1, 1), (0, 0)), mode="symmetric")
    moved, _, _ = check(_map_overlap_roll, "ring8", lane, [np.roll(pad, 1, 0)[1:-1]], rtol=1e-6, atol=1e-6)
    assert moved.get("ppermute", 0) >= 1 or moved.get("all_gather", 0) >= 1


X_SH = rng(67).standard_normal((64, 8))
GROUPS = [[5, 1], [0, 2, 63], [40, 41, 42]]


def _shuffle(p):
    return [p.da.from_array(X_SH, chunks=(8, 8)).shuffle(GROUPS, axis=0)]


@pytest.mark.parametrize("lane", LANES)
def test_shuffle_on_mesh(lane):
    _, _, parted = check(_shuffle, "ring8", lane, [X_SH[[i for g in GROUPS for i in g]]])
    # the boundary gathers, permutes and shards under the new grid
    assert parted["gathered"] == {"Shuffle": 1}


X_TS = rng(68).standard_normal((256, 16))


@pytest.mark.parametrize("lane", LANES)
def test_tsqr_on_mesh(lane):
    def build(p):
        return list(p.da.linalg.tsqr(p.da.from_array(X_TS, chunks=(32, 16))))

    for qv, rv in (run(build, "ring8", which="jax"), run(build, "ring8", lane)[0]):
        np.testing.assert_allclose(qv @ rv, X_TS, atol=1e-8)
        np.testing.assert_allclose(qv.T @ qv, np.eye(16), atol=1e-8)
        np.testing.assert_allclose(np.tril(rv, -1), 0, atol=1e-10)


X_SVD = rng(69).standard_normal((128, 8))


@pytest.mark.parametrize("lane", LANES)
def test_tsqr_svd_on_mesh(lane):
    def build(p):
        return list(p.da.linalg.svd(p.da.from_array(X_SVD, chunks=(16, 8))))

    for uv, sv, vv in (run(build, "ring8", which="jax"), run(build, "ring8", lane)[0]):
        np.testing.assert_allclose((uv * sv) @ vv, X_SVD, atol=1e-7)
        np.testing.assert_allclose(sorted(sv), sorted(np.linalg.svd(X_SVD)[1]), atol=1e-7)


X_MS = rng(70).standard_normal((64, 64))


def _multi_stage(p):
    d = p.da.from_array(X_MS, chunks=(8, 64))
    return [(d.cumsum(axis=1).rechunk((64, 8)) * 2).sum(axis=0) + 1]


@pytest.mark.parametrize("lane", LANES)
def test_multi_stage_pipeline_on_mesh(lane):
    moved, _, parted = check(_multi_stage, "ring8", lane, [(np.cumsum(X_MS, axis=1) * 2).sum(axis=0) + 1])
    if lane == "gspmd":
        # the scan, the relayout, the scale and the reduction per slot: one
        # all_to_all moves the ring to the columns, so the sum over the rows
        # needs no psum; the output gathered
        assert "gathered" not in parted
        assert moved == {"all_to_all": 1, "gather": 1}


def _root_view(expr_or_array):
    """The root's value as the executor returns it (``execute_views``)."""
    from dask_array_tpu_torch._executor import execute_views
    from dask_array_tpu_torch._materialize import optimize_expr

    expr = getattr(expr_or_array, "expr", expr_or_array)
    return execute_views([optimize_expr(expr)])[0]


X_OS = rng(71).standard_normal((64, 16))


@pytest.mark.parametrize("lane", LANES)
def test_output_sharding_matches_chunk_layout(lane):
    import dask_array_tpu_torch as tda

    d = tda.from_array(X_OS, chunks=(8, 16))
    with PORT.use_mesh(PORT.mesh("ring8")), PORT.lane(lane):
        dev = (d * 2).compute_device()
        view = _root_view(d * 2)
    np.testing.assert_allclose(dev.numpy(), X_OS * 2)
    if lane == "gspmd":
        # not fully replicated: the root is held sharded along the rows
        assert isinstance(view, ShardedView) and view.sharded.spec == ("r", None)
        np.testing.assert_allclose(view.dense().numpy(), X_OS * 2)


X_PS = rng(72).standard_normal((64, 8))


@pytest.mark.parametrize("lane", LANES)
def test_persist_on_mesh_keeps_sharded_buffers(lane):
    import dask_array_tpu as jda

    import dask_array_tpu_torch as tda

    with JAX.use_mesh(JAX.mesh("ring8")):
        p = (jda.from_array(X_PS, chunks=(8, 8)) + 1).persist()
        want = np.asarray((p * 2).compute())
    d = tda.from_array(X_PS, chunks=(8, 8))
    with PORT.use_mesh(PORT.mesh("ring8")), PORT.lane(lane):
        p = (d + 1).persist()
        got = np.asarray((p * 2).compute())
        if lane == "gspmd":
            buf = p.expr.buffer
            assert isinstance(buf, ShardedTensor) and buf.spec == ("r", None)
            view = _root_view(p)
            # bound as it is: the same shard tensors, no copy
            assert view.sharded is buf
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, (X_PS + 1) * 2, rtol=1e-12)


@pytest.mark.parametrize("lane", LANES)
def test_random_on_mesh(lane):
    import dask_array_tpu_torch as tda

    with PORT.use_mesh(PORT.mesh("ring8")), PORT.lane(lane):
        r = tda.random.default_rng(0).standard_normal((64, 16), chunks=(8, 16))
        v = np.asarray(r.compute())
        again = np.asarray((r * 1).compute())
    assert v.shape == (64, 16)
    assert 0.5 < v.std() < 1.5
    np.testing.assert_array_equal(again, v)


X_GU = rng(73).standard_normal((64, 12))


def _gufunc(p):
    xp = p.xp
    d = p.da.from_array(X_GU, chunks=(8, 12))
    return [p.da.apply_gufunc(lambda a: xp.sum(a, axis=-1), "(i)->()", d, output_dtypes=["f8"])]


@pytest.mark.parametrize("lane", LANES)
def test_gufunc_on_mesh(lane):
    check(_gufunc, "ring8", lane, [X_GU.sum(axis=-1)])


X_HI = rng(74).standard_normal(4096)
EDGES = np.linspace(-3, 3, 33)


def _histogram(p):
    return [p.da.histogram(p.da.from_array(X_HI, chunks=512), bins=EDGES)[0]]


@pytest.mark.parametrize("lane", LANES)
def test_histogram_on_mesh(lane):
    moved, nbytes, parted = check(_histogram, "ring8", lane, [np.histogram(X_HI, bins=EDGES)[0]])
    # the counts once a slot, one psum of the 32 counts
    assert parted["slots"]["Histogram"] == 1
    assert moved.get("psum") == 1 and nbytes["psum"] == 32 * 8 * 8 * 7


X_QR = rng(75).standard_normal((128, 32))


@pytest.mark.parametrize("lane", LANES)
def test_blocked_qr_on_mesh_values(lane):
    def build(p):
        return list(p.da.linalg.qr(p.da.from_array(X_QR, chunks=(16, 16))))

    for qv, rv in (run(build, "ring8", which="jax"), run(build, "ring8", lane)[0]):
        np.testing.assert_allclose(qv @ rv, X_QR, atol=1e-8)


X_PR = rng(76).standard_normal((64, 8))


def test_explicit_psum_reduce_matches():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dask_array_tpu.parallel.collectives import psum_reduce as jpsum

    from dask_array_tpu_torch.parallel.collectives import psum_reduce

    jm = JAX.mesh("ring8")
    want = np.asarray(jpsum(jax.device_put(X_PR, NamedSharding(jm, P("r", None))), jm, "r", axis=0))
    before = COLLECTIVES.snapshot()
    got = psum_reduce(torch.from_numpy(X_PR), PORT.mesh("ring8"), "r", axis=0)
    assert COLLECTIVES.delta(before) == {"psum": 1}
    np.testing.assert_allclose(got.gather(record=False).numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(got.gather(record=False).numpy(), X_PR.sum(axis=0), rtol=1e-12)


def test_halo_exchange_matches_manual():
    from dask_array_tpu_torch.parallel.collectives import halo_exchange

    x = np.arange(64.0).reshape(64, 1)
    out = halo_exchange(torch.from_numpy(x), PORT.mesh("ring8"), "r", axis=0, depth=1).gather(record=False).numpy()
    # shard 1 received row 7 from the left and row 16 from the right
    shard1 = out[10:20]
    np.testing.assert_allclose(shard1[0], 7.0)
    np.testing.assert_allclose(shard1[-1], 16.0)


X_EF = rng(77).standard_normal((64,))


def _eager_fallback(p):
    from tests.test_reduction_framework import ref_arg_agg, ref_arg_chunk, ref_arg_combine

    d = p.da.from_array(X_EF, chunks=8)
    return [p.da.arg_reduction(d, partial(ref_arg_chunk, np.max, np.argmax), partial(ref_arg_combine, np.argmax),
                               partial(ref_arg_agg, np.argmax), axis=0)]


@pytest.mark.parametrize("lane", LANES)
def test_eager_fallback_on_mesh_still_right(lane):
    # the structured (host) arg-reduction gathers its operand and stays right
    check(_eager_fallback, "ring8", lane, [np.argmax(X_EF)])


DATA_SL = rng(78).standard_normal((12 * 96, 4))
DATA_SL[rng(79).random(DATA_SL.shape) < 0.2] = np.nan


def _sliding_nanvar(p):
    x = p.da.from_array(DATA_SL, chunks=(96, 2))
    return [p.da.nanvar(p.da.sliding_window_view(x, 480, axis=0), axis=-1)]


@pytest.mark.parametrize("lane", LANES)
def test_sliding_nan_moment_on_mesh(lane):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        exp = np.nanvar(np.lib.stride_tricks.sliding_window_view(DATA_SL, 480, axis=0), axis=-1)
    want = run(_sliding_nanvar, "mesh2x4", which="jax")[0]
    got = run(_sliding_nanvar, "mesh2x4", lane)[0][0]
    np.testing.assert_allclose(got, exp, rtol=1e-9, equal_nan=True)
    np.testing.assert_allclose(got, want, rtol=1e-9, equal_nan=True)


def _loader_stack(p):
    root = "dask_array_tpu_torch" if p.which == "port" else "dask_array_tpu"
    fm = importlib.import_module(f"{root}.io._from_map")

    def load(i):
        return np.full((8, 8), i, dtype=np.float64)

    parts = [fm.from_delayed(fm.delayed(load)(i), shape=(8, 8), dtype="f8") for i in range(16)]
    return [(p.da.stack(parts, axis=0) * 2 + 1).sum(axis=(1, 2))]


@pytest.mark.parametrize("lane", LANES)
def test_collapsed_loader_stack_on_mesh(lane):
    moved, _, parted = check(_loader_stack, "ring8", lane, [np.array([(i * 2 + 1) * 64 for i in range(16)], "f8")])
    if lane == "gspmd":
        # the loaders' stack is a leaf bound sharded; the sum per slot
        assert "gathered" not in parted and parted["slots"]["Reduction"] == 1


# ---------------------------------------------------------------------------
# tests/test_irregular_mesh.py
# ---------------------------------------------------------------------------

X_IR = rng(23).standard_normal((37, 23))


def _irregular_sum(p):
    d = p.da.from_array(X_IR, chunks=((20, 17), (23,)))
    return [(d * 2 + 1).sum(axis=1)]


@pytest.mark.parametrize("lane", LANES)
def test_irregular_grid_compute_is_sharded(lane):
    import dask_array_tpu_torch as tda

    moved, _, parted = check(_irregular_sum, "ring8", lane, [(X_IR * 2 + 1).sum(axis=1)])
    d = tda.from_array(X_IR, chunks=((20, 17), (23,)))
    with PORT.use_mesh(PORT.mesh("ring8")), PORT.lane(lane):
        view = _root_view(d * 2 + 1)
    if lane == "gspmd":
        # the JAX package's f64[5,23]: ceil(37 / 8) = 5 rows a slot, the
        # last two short
        assert [tuple(s.shape) for s in view.sharded.shards] == [(5, 23)] * 7 + [(2, 23)]
        assert "gathered" not in parted and moved == {"gather": 1}


X_IV = rng(24).standard_normal((41, 19))


def _irregular_values(p):
    d = p.da.from_array(X_IV, chunks=((13, 13, 15), (10, 9)))
    return [p.da.sin(d) @ p.da.cos(d).T]


@pytest.mark.parametrize("lane", LANES)
def test_irregular_grid_values_match(lane):
    check(_irregular_values, "ring8", lane, [np.sin(X_IV) @ np.cos(X_IV).T])


def test_divisible_axis_still_preferred():
    from dask_array_tpu.parallel.layout import plan_layout as jplan

    from dask_array_tpu_torch.parallel.layout import plan_layout

    args = ((37, 24), ((20, 17), (24,)))
    assert plan_layout(*args, PORT.mesh("ring8"), allow_uneven=True) == (None, "r")
    assert tuple(jplan(*args, JAX.mesh("ring8"), allow_uneven=True)) == (None, "r")


def test_uneven_only_constraint_layout():
    from dask_array_tpu_torch.parallel.layout import plan_layout, sharding_for

    assert plan_layout((37, 23), None, PORT.mesh("ring8"), allow_uneven=True) == ("r", None)
    assert sharding_for((37, 23), PORT.mesh("ring8")).spec == (None, None)
    # and the walk binds such a leaf under the constraint: uneven parts
    from dask_array_tpu_torch.parallel.partition import leaf_spec

    assert leaf_spec((37, 23), PORT.mesh("ring8")) == ("r", None)


X_EM = rng(25).standard_normal((64, 16))


def _eager_mask(p):
    d = p.da.from_array(X_EM, chunks=(8, 16))
    dm = p.da.from_array(X_EM[:, 0] > 0, chunks=8)
    return [d[dm] * 2.0]


@pytest.mark.parametrize("lane", LANES)
def test_eager_mode_mesh_aware(lane):
    # unknown chunks: the boolean take gathers, the rest follows dense
    check(_eager_mask, "ring8", lane, [X_EM[X_EM[:, 0] > 0] * 2.0])


X_TL = rng(26).standard_normal((3,))


def _tiny(p):
    return [p.da.from_array(X_TL, chunks=3) + 1]


@pytest.mark.parametrize("lane", LANES)
def test_tiny_leaf_not_broken_by_constraint(lane):
    moved, _, parted = check(_tiny, "ring8", lane, [X_TL + 1])
    # a leaf smaller than the mesh stays whole: nothing bound
    assert "bound" not in parted
    if lane == "gspmd":
        assert moved == {}


# ---------------------------------------------------------------------------
# tests/test_parallel.py (its mesh8 is 2 x 4)
# ---------------------------------------------------------------------------

X_P1, Y_P1 = rng(42).standard_normal((16, 32)).astype("f4"), rng(43).standard_normal((32, 8)).astype("f4")


def _mesh_elemwise_matmul(p):
    dx, dy = p.da.from_array(X_P1, chunks=(8, 8)), p.da.from_array(Y_P1, chunks=(8, 8))
    return [((dx + 1.0) @ dy).sum(axis=1)]


@pytest.mark.parametrize("lane", LANES)
def test_mesh_elemwise_matmul(lane):
    check(_mesh_elemwise_matmul, "mesh2x4", lane, [((X_P1 + 1.0) @ Y_P1).sum(axis=1)], rtol=1e-4, atol=1e-4)


X_P2 = rng(44).standard_normal((32, 16)).astype("f4")


def _mesh_rechunk_reduction(p):
    return [p.da.from_array(X_P2, chunks=(4, 4)).rechunk((16, 8)).mean(axis=0)]


@pytest.mark.parametrize("lane", LANES)
def test_mesh_rechunk_reduction(lane):
    check(_mesh_rechunk_reduction, "mesh2x4", lane, [X_P2.mean(axis=0)], rtol=1e-4, atol=1e-5)


X_P3 = rng(45).standard_normal((16, 16)).astype("f4")


@pytest.mark.parametrize("lane", LANES)
def test_mesh_output_sharded(lane):
    """The computed value is laid out across the mesh."""
    import dask_array_tpu_torch as tda

    d = tda.from_array(X_P3, chunks=(8, 8))
    with PORT.use_mesh(PORT.mesh("mesh2x4")), PORT.lane(lane):
        out = (d * 2).compute_device()
        view = _root_view(d * 2)
    np.testing.assert_allclose(out.numpy(), X_P3 * 2, rtol=1e-5)
    if lane == "gspmd":
        assert len({tuple(s.shape) for s in view.sharded.shards}) == 1
        assert sum(e is not None for e in view.sharded.spec) == 2


# ---------------------------------------------------------------------------
# tests/test_joint_compute.py and tests/test_rechunk_collective.py
# ---------------------------------------------------------------------------

X_JC = rng(46).standard_normal((8, 8)).astype("f4")


def _joint(p):
    d = p.da.from_array(X_JC, chunks=4)
    return [d.sum(axis=0), (d * 2).mean(axis=1)]


@pytest.mark.parametrize("lane", LANES)
def test_joint_compute_on_mesh(lane):
    check(_joint, "mesh2x2", lane, [X_JC.sum(axis=0), (X_JC * 2).mean(axis=1)], rtol=1e-5, atol=1e-6)


X_RC = rng(3).standard_normal((256, 256))


def _rechunk_pipeline(p):
    d = p.da.from_array(X_RC, chunks=(32, 256))
    return [d.cumsum(axis=1).rechunk((256, 32)).sum(axis=0)]


@pytest.mark.parametrize("lane", LANES)
def test_rechunk_collective_pipeline_end_to_end(lane):
    moved, _, _ = check(_rechunk_pipeline, "ring8", lane, [np.cumsum(X_RC, axis=1).sum(axis=0)])
    if lane == "gspmd":
        # the relayout moves the ring from the rows to the columns: one
        # all_to_all, and the sum over the rows' psum
        assert moved == {"all_to_all": 1, "gather": 1}


X_SQ = rng(5).standard_normal((64, 128))


def _square_swap(p):
    d = p.da.from_array(X_SQ, chunks=(32, (100, 28)))  # irregular cols
    return [d.cumsum(axis=1).freeze_chunks().rechunk(((50, 14), 64)) + 0.0]


def _square_base(p):
    return [p.da.from_array(X_SQ, chunks=(32, (100, 28))).cumsum(axis=1) + 0.0]


@pytest.mark.parametrize("lane", LANES)
def test_rechunk_square_mesh_swap_end_to_end(lane):
    moved, _, _ = check(_square_swap, "mesh2x2", lane, [np.cumsum(X_SQ, axis=1)])
    _, base, _, _ = run(_square_base, "mesh2x2", lane)
    # no all_gather beyond the scan-only baseline's; the scan's own
    # collective (XLA's permutes, the port's all_gather of totals) is there
    assert moved.get("all_gather", 0) == base.get("all_gather", 0)
    if lane == "gspmd":
        assert moved.get("all_gather", 0) == 1

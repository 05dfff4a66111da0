"""The explicit collectives, the rechunk relayout and ShardStencil through
the port on 8 CPU slots, beside the JAX package.

Each collective (``halo_exchange``, ``alltoall_reshard``, ``swap_reshard``,
``mesh_collective_relayout``, ``psum_reduce``) runs on the same numpy input
through both packages (the JAX package's 8 forced host devices, the port's
8 CPU slots) and must give the same values (float64 to rtol 1e-12, layouts
exactly), and the port's ``COLLECTIVES`` record must show the schedule the
JAX package's tests pin from the compiled HLO
(``tests/test_rechunk_collective.py``, ``tests/test_overlap_collective.py``):
one ``all_to_all`` a moving mesh axis and no all-gather, a single
``ppermute`` for a square swap, two permutes a sharded stencil axis, one
``psum`` a reduction.  Rechunk boundaries and ``map_overlap`` under
``tpu.overlap-method: shard`` run end to end through both packages.
"""

import importlib

import dask_array_tpu.parallel  # noqa: F401  (the JAX side's mesh, as jda.parallel)
import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.parallel import Mesh as TMesh
from dask_array_tpu_torch.parallel import collectives as tcoll
from dask_array_tpu_torch.parallel import use_mesh as t_use_mesh
from dask_array_tpu_torch.parallel._sharded import COLLECTIVES, ShardedTensor

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def tmesh(shape, names, n=8):
    return TMesh(np.array(["cpu"] * n, dtype=object).reshape(shape), names)


def jmesh(shape, names, n=8):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices("cpu")[:n]).reshape(shape), names)


def jput(a, mesh, spec):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.device_put(a, NamedSharding(mesh, PartitionSpec(*spec)))


def _dense(out):
    return out.gather(record=False).numpy() if isinstance(out, ShardedTensor) else np.asarray(out)


def _spy(fn):
    before = COLLECTIVES.snapshot()
    out = fn()
    return out, COLLECTIVES.delta(before)


RNG = np.random.default_rng(3)
A64 = RNG.standard_normal((64, 128))
A2D = RNG.standard_normal((64, 64))
Z3 = np.arange(4 * 8 * 8, dtype="f8").reshape(4, 8, 8)


# -- halo exchange -------------------------------------------------------------

HALO = [
    # (mesh shape, names, array axis, axis name, depth, wrap)
    ((8,), ("d",), 0, "d", 1, False),
    ((8,), ("d",), 0, "d", 2, True),
    ((2, 4), ("x", "y"), 0, "x", 1, False),
    ((2, 4), ("x", "y"), 1, "y", 3, True),
    ((2, 2, 2), ("dcn", "x", "y"), 0, ("dcn", "x"), 1, False),
    ((2, 2, 2), ("dcn", "x", "y"), 1, ("dcn", "x"), 2, True),
]


@pytest.mark.parametrize("case", HALO, ids=[f"{c[1]}-ax{c[2]}-d{c[4]}-wrap{c[5]}" for c in HALO])
def test_halo_exchange_matches(case):
    from dask_array_tpu.parallel.collectives import halo_exchange

    shape, names, axis, name, depth, wrap = case
    want = np.asarray(halo_exchange(A2D, jmesh(shape, names), name, axis, depth, wrap=wrap))
    got, moved = _spy(lambda: tcoll.halo_exchange(torch.from_numpy(A2D), tmesh(shape, names), name, axis, depth,
                                                  wrap=wrap))
    np.testing.assert_array_equal(_dense(got), want)
    assert moved == {"ppermute": 2}


# -- all-to-all reshard ----------------------------------------------------------


def test_alltoall_reshard_keeps_other_axes_sharded():
    from dask_array_tpu.parallel.collectives import alltoall_reshard

    jm = jmesh((2, 4), ("x", "y"))
    want = alltoall_reshard(jput(Z3, jm, ("x", "y", None)), jm, "y", from_axis=1, to_axis=2,
                            spec=["x", "y", None])
    got, moved = _spy(lambda: tcoll.alltoall_reshard(torch.from_numpy(Z3), tmesh((2, 4), ("x", "y")), "y", 1, 2,
                                                     spec=["x", "y", None]))
    np.testing.assert_array_equal(_dense(got), np.asarray(want))
    assert got.spec == tuple(want.sharding.spec) == ("x", None, "y")
    assert moved == {"all_to_all": 1}


def test_alltoall_reshard_ring():
    from dask_array_tpu.parallel.collectives import alltoall_reshard

    jm = jmesh((8,), ("r",))
    want = alltoall_reshard(jput(A64, jm, ("r", None)), jm, "r", from_axis=0, to_axis=1)
    got, moved = _spy(lambda: tcoll.alltoall_reshard(torch.from_numpy(A64), tmesh((8,), ("r",)), "r", 0, 1))
    np.testing.assert_array_equal(_dense(got), np.asarray(want))
    assert got.spec == tuple(want.sharding.spec)
    assert moved == {"all_to_all": 1}
    # each slot now holds all rows of its column part
    assert all(s.shape == (64, 16) for s in got.shards)


# -- axis swap -------------------------------------------------------------------


def test_swap_reshard_square_single_permute():
    from dask_array_tpu.parallel.collectives import swap_reshard

    jm = jmesh((2, 2), ("x", "y"), n=4)
    want = swap_reshard(jput(A64, jm, ("x", "y")), jm, "x", "y", 0, 1)
    got, moved = _spy(lambda: tcoll.swap_reshard(torch.from_numpy(A64), tmesh((2, 2), ("x", "y"), n=4), "x", "y",
                                                 0, 1))
    np.testing.assert_array_equal(_dense(got), np.asarray(want))
    assert got.spec == tuple(want.sharding.spec) == ("y", "x")
    assert moved == {"ppermute": 1}


@pytest.mark.parametrize("roles", [("x", "y", 0, 1), ("y", "x", 1, 0)])
def test_swap_reshard_nonsquare_no_all_gather(roles):
    from dask_array_tpu.parallel.collectives import swap_reshard

    jm = jmesh((2, 4), ("x", "y"))
    want = swap_reshard(jput(A64, jm, ("x", "y")), jm, *roles)
    got, moved = _spy(lambda: tcoll.swap_reshard(torch.from_numpy(A64), tmesh((2, 4), ("x", "y")), *roles))
    np.testing.assert_array_equal(_dense(got), np.asarray(want))
    assert got.spec == tuple(want.sharding.spec) == ("y", "x")
    assert moved == {"all_to_all": 2, "ppermute": 1}


def test_swap_reshard_indivisible_declines():
    from dask_array_tpu.parallel.collectives import swap_reshard

    a = RNG.standard_normal((8, 12))
    jm = jmesh((2, 4), ("x", "y"))
    assert swap_reshard(jput(a, jm, ("x", "y")), jm, "x", "y", 0, 1) is None
    assert tcoll.swap_reshard(torch.from_numpy(a), tmesh((2, 4), ("x", "y")), "x", "y", 0, 1) is None


# -- psum reduce -----------------------------------------------------------------


@pytest.mark.parametrize("case", [((8,), ("d",), "d", 0), ((2, 4), ("x", "y"), "y", 1), ((2, 4), ("x", "y"), "x", 0)])
def test_psum_reduce_matches(case):
    from dask_array_tpu.parallel.collectives import psum_reduce

    shape, names, name, axis = case
    want = np.asarray(psum_reduce(A64, jmesh(shape, names), name, axis))
    got, moved = _spy(lambda: tcoll.psum_reduce(torch.from_numpy(A64), tmesh(shape, names), name, axis))
    np.testing.assert_allclose(_dense(got), want, rtol=1e-12, atol=1e-12)
    assert moved == {"psum": 1}


# -- the rechunk relayout ------------------------------------------------------------


def _relayout_cases():
    """(name, mesh shape, names, source, chunks, target, expected schedule)."""
    x1 = RNG.standard_normal((256, 256))
    x3 = RNG.standard_normal((4, 64, 64))
    x2 = RNG.standard_normal((64, 128))
    xs = RNG.standard_normal((64, 128))
    return [
        # (the partitioned walk binds the leaf under the constraint layout; a
        # scan along an axis it shards adds one all_gather of its totals, and
        # the root comes back by one gather)
        ("axis_move_ring", (8,), ("r",), x1, (32, 256), (256, 32), {"all_to_all": 1, "gather": 1}),
        ("no_move_ring", (8,), ("r",), x1, (16, 256), (32, 256), {"gather": 1}),
        # the layout solver puts y on axis 1 and x on axis 2, then y on axis 2
        # and x on axis 1: a cycle, the non-square swap's three stages
        ("chain_move_2x4", (2, 4), ("x", "y"), x3, (2, 16, 64), (2, 64, 16),
         {"all_gather": 1, "all_to_all": 2, "ppermute": 1, "gather": 1}),
        ("swap_2x4", (2, 4), ("x", "y"), x2, (32, 32), (16, 64),
         {"all_gather": 1, "all_to_all": 2, "ppermute": 1, "gather": 1}),
        # the leaf's constraint layout is already the new grid's: nothing moves
        ("swap_square_2x2", (2, 2), ("x", "y"), xs, (32, (100, 28)), ((50, 14), 64), {"all_gather": 1, "gather": 1}),
        ("multislice_move", (2, 2, 2), ("dcn", "x", "y"), x1, (32, 256), (256, 32), None),
    ]


RELAYOUT = _relayout_cases()


@pytest.mark.parametrize("case", RELAYOUT, ids=[c[0] for c in RELAYOUT])
def test_rechunk_relayout_matches(case):
    import dask_array_tpu as jda

    import dask_array_tpu_torch as tda

    name, shape, names, src, chunks, target, schedule = case
    n = int(np.prod(shape))
    axis = 2 if src.ndim == 3 else 1
    with jda.parallel.use_mesh(jmesh(shape, names, n)):
        want = np.asarray(jda.from_array(src, chunks=chunks).cumsum(axis=axis).freeze_chunks().rechunk(target)
                          .compute())
    scan = tda.from_array(src, chunks=chunks).cumsum(axis=axis)
    r = scan.freeze_chunks().rechunk(target)
    with t_use_mesh(tmesh(shape, names, n)):
        got, moved = _spy(lambda: np.asarray(r.compute()))
        with tconfig.set({"execution-lane": "gspmd"}):
            _, base = _spy(lambda: scan.compute())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, np.cumsum(src, axis=axis), rtol=1e-12, atol=1e-12)
    if schedule is not None:
        assert moved == schedule
    # the relayout adds no all_gather to the scan's own (the JAX package's
    # test_rechunk_square_mesh_swap_end_to_end criterion)
    assert moved.get("all_gather", 0) == base.get("all_gather", 0)


def test_rechunk_tasks_method_moves_nothing():
    import dask_array_tpu_torch as tda

    src = RNG.standard_normal((256, 256))
    r = tda.from_array(src, chunks=(32, 256)).cumsum(axis=1).rechunk((256, 32))
    with t_use_mesh(tmesh((8,), ("r",))), tconfig.set(tconfig.from_reference({"array.rechunk.method": "tasks"})):
        got, moved = _spy(lambda: np.asarray(r.compute()))
    np.testing.assert_allclose(got, np.cumsum(src, axis=1), rtol=1e-12)
    assert moved == {"gather": 1}  # the rechunk moves nothing; the root comes back


@pytest.mark.parametrize("case", RELAYOUT, ids=[c[0] for c in RELAYOUT])
def test_mesh_collective_relayout_direct(case):
    from dask_array_tpu.parallel.collectives import mesh_collective_relayout as jrelayout
    from dask_array_tpu.parallel.layout import plan_layout as jplan

    from dask_array_tpu_torch._chunks import normalize_chunks

    name, shape, names, src, chunks, target, _ = case
    n = int(np.prod(shape))
    old = normalize_chunks(chunks, src.shape)
    new = normalize_chunks(target, src.shape)
    jm = jmesh(shape, names, n)
    want = jrelayout(jput(src, jm, jplan(src.shape, old, jm)), old, new, jm)
    got = tcoll.mesh_collective_relayout(torch.from_numpy(src), old, new, tmesh(shape, names, n))
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(_dense(got), np.asarray(want))
        assert got.spec == tuple(want.sharding.spec) + (None,) * (src.ndim - len(want.sharding.spec))


# -- ShardStencil ----------------------------------------------------------------------


def _funcs(which):
    if which == "port":
        roll, tanh = torch.roll, torch.tanh
    else:
        import jax.numpy as jnp

        roll, tanh = jnp.roll, jnp.tanh

    def mean3(b):
        return (roll(b, 1, 0) + b + roll(b, -1, 0)) / 3.0

    def tlap(b):
        return tanh(roll(b, 1, 0) + roll(b, -1, 0) + roll(b, 1, 1) + roll(b, -1, 1) - 4 * b)

    return {"mean3": mean3, "tlap": tlap}


STENCILS = [
    # (mesh shape, names, func, depth, boundary, chunks, sharded halo axes)
    ((8,), ("r",), "mean3", {0: 1}, "reflect", (8, 32), 1),
    ((8,), ("r",), "mean3", {0: 1}, "nearest", (8, 32), 1),
    ((8,), ("r",), "mean3", {0: 1}, "periodic", (8, 32), 1),
    ((8,), ("r",), "mean3", {0: 1}, 0.0, (8, 32), 1),
    ((2, 4), ("x", "y"), "tlap", 1, "reflect", (32, 8), 2),
    ((2, 4), ("x", "y"), "tlap", 2, "periodic", (32, 8), 2),
    ((2, 2, 2), ("dcn", "x", "y"), "mean3", {0: 1}, "reflect", (8, 32), 1),
    ((2, 2, 2), ("dcn", "x", "y"), "tlap", 1, "nearest", (8, 16), 2),
]


def _run_stencil(which, case, src):
    shape, names, fname, depth, boundary, chunks, _ = case
    da = importlib.import_module("dask_array_tpu_torch" if which == "port" else "dask_array_tpu")
    func = _funcs(which)[fname]
    cfg = {"tpu.overlap-method": "shard", "tpu.stencil-kernel": "off"}
    if which == "port":
        mesh, um, conf = tmesh(shape, names), t_use_mesh, tconfig.set(tconfig.from_reference(cfg))
    else:
        mesh, um, conf = jmesh(shape, names), da.parallel.use_mesh, da.config.set(cfg)
    with um(mesh), conf:
        e = da.map_overlap(func, da.from_array(src, chunks=chunks), depth=depth, boundary=boundary,
                           dtype=src.dtype)
        assert type(e.expr).__name__ == "ShardStencil"
        return np.asarray(e.compute())


@pytest.mark.parametrize("case", STENCILS, ids=[f"{c[1]}-{c[2]}-{c[4]}" for c in STENCILS])
def test_shard_stencil_matches(case):
    src = RNG.standard_normal((64, 64))
    want = _run_stencil("jax", case, src)
    got, moved = _spy(lambda: _run_stencil("port", case, src))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert moved == {"ppermute": 2 * case[-1], "gather": 1}


def test_shard_stencil_deep_halo_and_no_mesh_run_whole():
    import dask_array_tpu_torch as tda

    src = RNG.standard_normal((64, 16))
    f = _funcs("port")["mean3"]
    with tconfig.set({"overlap-method": "shard", "stencil-kernel": "off"}):
        e = tda.map_overlap(f, tda.from_array(src, chunks=(8, 16)), depth={0: 9}, boundary="reflect")
        flat = np.asarray(e.compute())
        with t_use_mesh(tmesh((8,), ("r",))):
            got, moved = _spy(lambda: np.asarray(e.compute()))
    pad = np.pad(src, ((1, 1), (0, 0)), mode="symmetric")
    np.testing.assert_allclose(flat, (pad[:-2] + pad[1:-1] + pad[2:]) / 3.0, rtol=1e-12)
    np.testing.assert_allclose(got, flat, rtol=1e-12)
    assert moved == {}  # a shard of 8 rows cannot donate a 9-row halo


def test_band_stencil_under_a_mesh_takes_the_shard_body():
    """A stencil the band-stencil kernel takes stays a ``BandStencil``; under
    a mesh it runs the ShardStencil body (the kernel once a slot; its plain
    version here), equal to the JAX package's ShardStencil."""
    import dask_array_tpu as jda

    import dask_array_tpu_torch as tda

    src = RNG.standard_normal((64, 64)).astype(np.float32)
    with jda.parallel.use_mesh(jmesh((2, 2), ("x", "y"), n=4)), jda.config.set({"tpu.overlap-method": "shard"}):
        want = np.asarray(jda.map_overlap(_lap("jax"), jda.from_array(src, chunks=(32, 32)), depth=1,
                                          boundary="reflect", dtype="float32").compute())
    e = tda.map_overlap(_lap("port"), tda.from_array(src, chunks=(32, 32)), depth=1, boundary="reflect")
    assert type(e.expr).__name__ == "BandStencil"
    with t_use_mesh(tmesh((2, 2), ("x", "y"), n=4)):
        got, moved = _spy(lambda: np.asarray(e.compute()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert moved == {"ppermute": 4, "gather": 1}


def _lap(which):
    if which == "port":
        roll = torch.roll
    else:
        import jax.numpy as jnp

        roll = jnp.roll

    def laplace(b):
        return roll(b, 1, 0) + roll(b, -1, 0) + roll(b, 1, 1) + roll(b, -1, 1) - 4 * b

    return laplace


def test_shard_stencil_transfer_bytes_match():
    import dask_array_tpu as jda

    import dask_array_tpu_torch as tda

    src = RNG.standard_normal((64, 48))
    got = {}
    for name, da, conf in (("jax", jda, jda.config.set), ("port", tda,
                                                           lambda v: tconfig.set(tconfig.from_reference(v)))):
        with conf({"tpu.overlap-method": "shard", "tpu.stencil-kernel": "off"}):
            e = da.map_overlap(_funcs(name)["tlap"], da.from_array(src, chunks=(8, 48)), depth={0: 2, 1: 1},
                               boundary="reflect", dtype=src.dtype)
        assert type(e.expr).__name__ == "ShardStencil"
        got[name] = e.expr.transfer_bytes()
    assert got["port"] == got["jax"]

"""The port's mesh, layout solver and mesh hooks on 8 CPU slots, beside the
JAX package.

* ``Mesh``, ``use_mesh``/``set_mesh``/``current_mesh``, ``dcn_axis_names``,
  ``auto_mesh`` and ``multislice_mesh`` against the JAX package's (shapes,
  axis names, the near-square factorisation, the contiguous slice split);
  ``auto_mesh`` without a card raises.
* ``plan_layout`` equal to the JAX package's over a grid of shapes, chunk
  grids and meshes, with and without ``allow_uneven``; ``sharding_for*``
  and ``constrain_to_mesh`` give the JAX package's specs, and a sharded
  tensor gathers back to itself (uneven dims: the last part short).
* The streaming lane's mesh test: under a mesh ``_pin_resident`` leaves
  the expression untouched, in both packages (without a mesh it pins).
* ``config.from_reference`` maps the four mesh keys.
* The JAX package's multichip dry run (``__graft_entry__._dryrun_body``)
  at n = 8, stage by stage, and its multislice stage: the same values in
  both packages, the same shard-lane engagements.

The JAX side of each dry-run stage is computed once for the module.
"""

import importlib

import dask_array_tpu.parallel  # noqa: F401  (the JAX side's mesh, as jda.parallel)
import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.parallel import Mesh as TMesh
from dask_array_tpu_torch.parallel import (
    auto_mesh,
    constrain_to_mesh,
    current_mesh,
    dcn_axis_names,
    multislice_mesh,
    sharding_for,
    sharding_for_chunks,
    use_mesh,
)
from dask_array_tpu_torch.parallel._sharded import COLLECTIVES, shard
from dask_array_tpu_torch.parallel.layout import plan_layout
from dask_array_tpu_torch.parallel.mesh import set_mesh

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


MESHES = [((8,), ("d",)), ((2, 4), ("x", "y")), ((4, 2), ("x", "y")), ((2, 2, 2), ("dcn", "x", "y")),
          ((2, 4), ("slice", "x"))]


# -- the mesh ------------------------------------------------------------------


def test_mesh_attributes_match_jax():
    for shape, names in MESHES:
        t, j = tmesh(shape, names), jmesh(shape, names)
        assert dict(t.shape) == dict(j.shape)
        assert list(t.shape) == list(j.shape)  # ordered as the JAX mesh
        assert t.axis_names == tuple(j.axis_names)
        assert t.size == j.size == 8
        assert t.devices.shape == j.devices.shape
    m = TMesh([["cpu", "cpu"], ["cpu", "cpu"]], ("a", "b"))
    assert m.shape == {"a": 2, "b": 2} and all(d == torch.device("cpu") for d in m.slots)
    assert m == tmesh((2, 2), ("a", "b"), 4) and hash(m) == hash(tmesh((2, 2), ("a", "b"), 4))
    assert m != tmesh((4,), ("a",), 4)


@pytest.mark.parametrize("devices,names", [
    (["cpu"] * 4, ("a", "b")),                                  # names for 2 dims, devices in 1
    (np.array(["cpu"] * 4, dtype=object).reshape(2, 2), ("a", "a")),  # a repeated name
    ([], ("a",)),                                               # no device
    (["cpu", "meta"], ("a",)),                                  # two device types
])
def test_mesh_refuses_bad_layouts(devices, names):
    with pytest.raises(ValueError):
        TMesh(devices, names)


def test_mesh_stack():
    a, b = tmesh((8,), ("d",)), tmesh((2, 4), ("x", "y"))
    assert current_mesh() is None
    with use_mesh(a):
        assert current_mesh() is a
        with use_mesh(b):
            assert current_mesh() is b
        assert current_mesh() is a
    assert current_mesh() is None
    set_mesh(b)
    try:
        assert current_mesh() is b
    finally:
        set_mesh(None)
    assert current_mesh() is None


@pytest.mark.parametrize("pinned", [None, ("x",), ("dcn", "slice"), ()])
def test_dcn_axis_names_match(pinned):
    import dask_array_tpu as jda
    from dask_array_tpu.parallel import dcn_axis_names as jdcn

    for shape, names in MESHES:
        with jda.config.set({"tpu.dcn-axes": pinned}), tconfig.set(tconfig.from_reference({"tpu.dcn-axes": pinned})):
            assert dcn_axis_names(tmesh(shape, names)) == jdcn(jmesh(shape, names))


def test_auto_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        auto_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multislice_mesh(2)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_auto_mesh_factorisation_matches(n):
    import jax

    from dask_array_tpu.parallel import auto_mesh as jauto

    t = auto_mesh(devices=["cpu"] * 8, n_devices=n)
    j = jauto(n_devices=n, devices=jax.devices("cpu")[:8])
    assert dict(t.shape) == dict(j.shape) and t.axis_names == tuple(j.axis_names)


@pytest.mark.parametrize("n_slices,names", [(2, ("x", "y")), (2, ("x",)), (4, ("x", "y")), (1, ("x", "y"))])
def test_multislice_mesh_matches(n_slices, names):
    import jax

    from dask_array_tpu.parallel import multislice_mesh as jms

    t = multislice_mesh(n_slices, names, devices=["cpu"] * 8)
    j = jms(n_slices, names, devices=jax.devices("cpu")[:8])
    assert dict(t.shape) == dict(j.shape) and t.axis_names == tuple(j.axis_names)
    with pytest.raises(ValueError):
        multislice_mesh(3, names, devices=["cpu"] * 8)


# -- the layout solver -------------------------------------------------------------

GRIDS = [
    ((64, 64), (8, 8)), ((64, 64), (32, 64)), ((64, 64), (64, 8)), ((256, 256), (32, 256)),
    ((256, 256), (256, 32)), ((4, 64, 64), (2, 16, 64)), ((4, 64, 64), (2, 64, 16)), ((137, 6), (23, 6)),
    ((137, 6), ((23, 7, 15, 31, 9, 12, 4, 11, 8, 10, 7), 6)), ((10, 12), (5, 3)), ((9, 7), (9, 7)),
    ((64, 128), (32, (100, 28))), ((64, 128), ((50, 14), 64)), ((8, 12), (4, 3)), ((16,), (2,)), ((3, 5, 7), (1, 5, 7)),
    ((1024, 8), (128, 8)), ((6, 40), (6, 5)), ((0, 8), (0, 8)),
]


def _chunks(shape, chunks):
    from dask_array_tpu_torch._chunks import normalize_chunks

    return normalize_chunks(chunks, shape)


@pytest.mark.parametrize("uneven", [False, True])
@pytest.mark.parametrize("mesh", MESHES, ids=["-".join(m[1]) + "-" + "x".join(map(str, m[0])) for m in MESHES])
def test_plan_layout_matches(mesh, uneven):
    from dask_array_tpu.parallel.layout import plan_layout as jplan

    shape_, names = mesh
    t, j = tmesh(shape_, names), jmesh(shape_, names)
    for shape, chunks in GRIDS:
        c = _chunks(shape, chunks)
        assert plan_layout(shape, c, t, allow_uneven=uneven) == jplan(shape, c, j, allow_uneven=uneven), (shape, c)
        assert plan_layout(shape, None, t, allow_uneven=uneven) == jplan(shape, None, j, allow_uneven=uneven)


@pytest.mark.parametrize("mesh", MESHES[:4], ids=["-".join(m[1]) for m in MESHES[:4]])
def test_shardings_match(mesh):
    from dask_array_tpu.parallel.layout import sharding_for as jfor
    from dask_array_tpu.parallel.layout import sharding_for_chunks as jforc

    shape_, names = mesh
    t, j = tmesh(shape_, names), jmesh(shape_, names)

    def spec(js, nd):
        s = tuple(js.spec)
        return s + (None,) * (nd - len(s))

    for shape, chunks in GRIDS:
        c = _chunks(shape, chunks)
        assert sharding_for(shape, t).spec == spec(jfor(shape, j), len(shape))
        assert sharding_for_chunks(shape, c, t, allow_uneven=True).spec == spec(
            jforc(shape, c, j, allow_uneven=True), len(shape))
    assert sharding_for((4, 4), None) is None


def test_constrain_to_mesh_and_uneven_parts():
    src = torch.arange(10 * 6, dtype=torch.float64).reshape(10, 6)
    st = constrain_to_mesh(src, _chunks((10, 6), (3, 6)), tmesh((4,), ("r",), 4))
    assert st.spec == ("r", None)
    # ceil(10 / 4) = 3 rows a part, the last part short
    assert [tuple(s.shape) for s in st.shards] == [(3, 6), (3, 6), (3, 6), (1, 6)]
    assert torch.equal(st.gather(record=False), src)
    assert constrain_to_mesh(src, None, None) is src
    st = shard(src, tmesh((2, 4), ("x", "y")), (("x", "y"), None))
    assert [s.shape[0] for s in st.shards] == [2, 2, 2, 2, 2, 0, 0, 0]
    assert torch.equal(st.gather(record=False), src)
    before = COLLECTIVES["gather"]
    shard(src, tmesh((8,), ("d",)), (None, "d")).gather()
    assert COLLECTIVES["gather"] == before + 1


# -- config ---------------------------------------------------------------------------


def test_from_reference_maps_the_mesh_keys():
    got = tconfig.from_reference({
        "tpu.execution-lane": "shard-map",
        "tpu.overlap-method": "shard",
        "tpu.dcn-axes": ("x",),
        "array.rechunk.method": "tasks",
        "tpu.jit": False,
    })
    assert got == {"execution-lane": "shard-map", "overlap-method": "shard", "dcn-axes": ("x",),
                   "array.rechunk.method": "tasks"}
    for key in ("execution-lane", "overlap-method", "dcn-axes", "array.rechunk.method"):
        assert key in tconfig._global
    assert tconfig.get("execution-lane") == "auto" and tconfig.get("overlap-method") == "auto"


def test_a_mesh_of_another_device_type_raises():
    import dask_array_tpu_torch as tda

    with use_mesh(TMesh(["meta"] * 2, ("d",))):
        with pytest.raises(RuntimeError, match="mesh's devices"):
            tda.ones((4, 4), chunks=2).sum().compute()


# -- the streaming lane's mesh test ------------------------------------------------------


def _panel_sweep(da, force_cfg):
    rng = np.random.default_rng(1)
    a_np = rng.standard_normal((96, 24)).astype(np.float32)
    b_np = rng.standard_normal((24, 5)).astype(np.float32)
    return da.from_array(a_np, chunks=(8, 24)) @ b_np, a_np @ b_np


def test_pin_resident_leaves_the_expression_under_a_mesh():
    import dask_array_tpu as jda
    from dask_array_tpu._streaming import _pin_resident as jpin

    import dask_array_tpu_torch as tda
    from dask_array_tpu_torch._streaming import STREAMED, _pin_resident

    t_expr, _ = _panel_sweep(tda, None)
    j_expr, _ = _panel_sweep(jda, None)
    t_opt, j_opt = t_expr.expr.optimize(), j_expr.expr.optimize()
    # without a mesh the weights pin (the expression changes) ...
    before = STREAMED["pinned"]
    assert _pin_resident(t_opt, t_opt, 1 << 30) is not t_opt
    pinned = STREAMED["pinned"]
    assert pinned > before
    # ... under a mesh both packages leave it as it is
    with use_mesh(tmesh((8,), ("d",))):
        assert _pin_resident(t_opt, t_opt, 1 << 30) is t_opt
    with jda.parallel.use_mesh(jmesh((8,), ("d",))):
        assert jpin(j_opt, j_opt, 1 << 30) is j_opt
    assert STREAMED["pinned"] == pinned


def test_streamed_panel_sweep_under_a_mesh_pins_nothing():
    import dask_array_tpu as jda
    from dask_array_tpu._streaming import STREAMED as JS

    import dask_array_tpu_torch as tda
    from dask_array_tpu_torch._streaming import STREAMED as TS

    out = {}
    for name, da, st, um, mesh, conf in (
        ("jax", jda, JS, jda.parallel.use_mesh, jmesh((8,), ("d",)), jda.config.set),
        ("port", tda, TS, use_mesh, tmesh((8,), ("d",)), lambda v: tconfig.set(tconfig.from_reference(v))),
    ):
        e, want = _panel_sweep(da, None)
        before = {k: st[k] for k in ("count", "panels", "pinned")}
        with um(mesh), conf({"tpu.out-of-core": "force"}):
            got = np.asarray(e.compute())
        out[name] = (got, {k: st[k] - before[k] for k in before})
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1]["pinned"] == 0 and out["port"][1]["count"] == 1
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-5, atol=1e-5)


# -- the multichip dry run, stage by stage ---------------------------------------------------

N = 8
A_AX, B_AX = 4, 2  # _dryrun_body's near-square split of 8
M = K = 8 * A_AX * B_AX
_rng = np.random.default_rng(1)
A_NP = _rng.standard_normal((M, K)).astype(np.float32)
B_NP = _rng.standard_normal((M // 2, K)).astype(np.float32)
W_NP = _rng.standard_normal((K, 4)).astype(np.float32)


class Pkg:
    def __init__(self, which):
        self.which = which
        root = "dask_array_tpu_torch" if which == "port" else "dask_array_tpu"
        self.da = importlib.import_module(root)
        self.lane = importlib.import_module(f"{root}.parallel.shardlane")
        self.xp = torch if which == "port" else importlib.import_module("jax.numpy")

    def mesh(self):
        if self.which == "port":
            return tmesh((A_AX, B_AX), ("x", "y"))
        return jmesh((A_AX, B_AX), ("x", "y"))

    def multislice(self):
        if self.which == "port":
            return multislice_mesh(2, devices=["cpu"] * N)
        import jax

        return self.da.parallel.multislice_mesh(2, devices=jax.devices("cpu")[:N])

    def use_mesh(self, mesh):
        return use_mesh(mesh) if self.which == "port" else self.da.parallel.use_mesh(mesh)

    def config(self, values):
        if self.which == "port":
            return tconfig.set(tconfig.from_reference(values))
        return self.da.config.set(values)


def _pipeline(a, b):
    centered = a - a.mean(axis=0)
    scaled = centered / (a.std(axis=0) + 1e-6)
    y = scaled @ b.T
    return (y * y).sum(axis=1)


def _rechunked_b(p, b):
    return b.rechunk((M // 2 // A_AX if (M // 2) % A_AX == 0 else M // 2, K))


def stage_pipeline(p, multislice=False):
    a = p.da.from_array(A_NP, chunks=(M // A_AX, K // B_AX))
    b = p.da.from_array(B_NP, chunks=(M // 2, K // B_AX))
    with p.use_mesh(p.multislice() if multislice else p.mesh()):
        return [np.asarray(_pipeline(a, _rechunked_b(p, b)).compute())]


def stage_stencil(p):
    roll = p.xp.roll

    def laplace(blk):
        return roll(blk, 1, 0) + roll(blk, -1, 0) + roll(blk, 1, 1) + roll(blk, -1, 1) - 4 * blk

    a = p.da.from_array(A_NP, chunks=(M // A_AX, K // B_AX))
    with p.use_mesh(p.mesh()):
        return [np.asarray(p.da.map_overlap(laplace, a, depth=1, boundary="reflect", dtype="float32").compute())]


def stage_relayout(p):
    a = p.da.from_array(A_NP, chunks=(M // A_AX, K // B_AX))
    with p.use_mesh(p.mesh()):
        return [np.asarray(a.cumsum(axis=1).rechunk((M, M // A_AX)).sum(axis=0).compute())]


def stage_quantile(p):
    a = p.da.from_array(A_NP, chunks=(M // A_AX, K // B_AX))
    with p.use_mesh(p.mesh()):
        return [np.asarray(p.da.nanquantile(a, 0.75, axis=1, method="weibull").compute())]


def stage_svd(p):
    ts = p.da.from_array(A_NP, chunks=(M // A_AX, K))
    with p.use_mesh(p.mesh()):
        u, s, vh = (np.asarray(v) for v in p.da.compute(*p.da.linalg.svd(ts)))
    return [s, (u * s) @ vh]


def stage_lane(p):
    """The shard-lane stage: seven programs on irregular grids, each one
    lane program under the default lane."""
    heights = (M // 2 + 1, M // 4, M - (M // 2 + 1) - M // 4)
    kheights = (K // 2, K // 4, K - K // 2 - K // 4)
    da = p.da
    xi = da.from_array(A_NP, chunks=(heights, K))
    xk = da.from_array(A_NP, chunks=(M, kheights))
    xg = da.from_array(A_NP, chunks=(heights, kheights))
    wc = da.from_array(W_NP, chunks=(K, (1, 2, 1)))
    before = p.lane.ENGAGED["count"]
    with p.use_mesh(p.mesh()):
        outs = [
            np.asarray(((xi * 2.0) @ W_NP).compute()),
            np.asarray((xi + 1.0).sum(axis=0).compute()),
            np.asarray(da.cumsum(xi, axis=0).compute()),
            np.asarray((xk @ W_NP).compute()),
            np.asarray(((xg - xg.mean()) / xg.std()).compute()),
            np.asarray((da.from_array(A_NP) @ wc).compute()),
            np.asarray(xg.sum(axis=1).compute()),
        ]
    return outs + [np.asarray(p.lane.ENGAGED["count"] - before)]


def stage_multislice_pipeline(p):
    return stage_pipeline(p, multislice=True)


def stage_multislice_sliding(p):
    a = p.da.from_array(A_NP, chunks=(M // A_AX, K // B_AX))
    with p.use_mesh(p.multislice()):
        return [np.asarray(p.da.sliding_window_view(a, 4, axis=0).mean(axis=-1).compute())]


def stage_multislice_shard_stencil(p):
    roll = p.xp.roll

    def edge3(blk):
        return roll(blk, 1, 0) + blk + roll(blk, -1, 0)

    a = p.da.from_array(A_NP, chunks=(M // A_AX, K // B_AX))
    with p.use_mesh(p.multislice()), p.config({"tpu.overlap-method": "shard", "tpu.stencil-kernel": "off"}):
        e = p.da.map_overlap(edge3, a, depth={0: 1}, boundary={0: "reflect"}, dtype="float32")
        assert type(e.expr).__name__ == "ShardStencil"
        return [np.asarray(e.compute())]


STAGES = {f.__name__[6:]: f for f in (
    stage_pipeline, stage_stencil, stage_relayout, stage_quantile, stage_svd, stage_lane,
    stage_multislice_pipeline, stage_multislice_sliding, stage_multislice_shard_stencil,
)}
_JAX: dict = {}


@pytest.fixture(scope="module")
def jax_stage():
    pkg = Pkg("jax")

    def get(name):
        if name not in _JAX:
            _JAX[name] = STAGES[name](pkg)
        return _JAX[name]

    return get


@pytest.mark.parametrize("name", list(STAGES))
def test_dryrun_stage_matches(jax_stage, name):
    want = jax_stage(name)
    before = COLLECTIVES.snapshot()
    got = STAGES[name](Pkg("port"))
    moved = COLLECTIVES.delta(before)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)
    if name == "lane":
        assert int(got[-1]) == int(want[-1]) == 7
    if name == "multislice_shard_stencil":
        # one halo exchange along the nested ("dcn", x) rows: two ppermutes
        assert moved == {"ppermute": 2, "gather": 1}
    if name in ("relayout", "pipeline"):
        # no all_gather beyond the scan's own totals (the relayout's
        # cumsum runs along the axis the leaf's layout shards)
        assert moved.get("all_gather", 0) == (1 if name == "relayout" else 0)


def test_structural_key_keys_on_the_mesh():
    """A program keys apart on each mesh (the JAX package's ``_mesh_key``),
    and back to its plain key without one."""
    import dask_array_tpu_torch as tda
    from dask_array_tpu_torch._executor import structural_key

    opt = (tda.from_array(np.ones((8, 8)), chunks=4) * 2).sum().expr.optimize()
    plain = structural_key(opt)
    with use_mesh(tmesh((8,), ("d",))):
        ring = structural_key(opt)
    with use_mesh(tmesh((2, 4), ("x", "y"))):
        grid = structural_key(opt)
    assert len({plain, ring, grid}) == 3 and ring.startswith(plain)
    assert structural_key(opt) == plain
    with use_mesh(tmesh((8,), ("d",))):
        assert structural_key(opt) == ring


@pytest.mark.parametrize("indexer", [[[1, 3], [0, 2, 9]], [[9, 8, 7, 6, 5, 4, 3, 2, 1, 0]], [[0], [5], [5]]])
def test_shuffle_transfer_bytes_match(indexer):
    import dask_array_tpu as jda

    import dask_array_tpu_torch as tda

    got = tda.shuffle(tda.from_array(np.ones((10, 4)), chunks=5), indexer, axis=0).expr.transfer_bytes()
    want = jda.shuffle(jda.from_array(np.ones((10, 4)), chunks=5), indexer, axis=0).expr.transfer_bytes()
    assert got == want

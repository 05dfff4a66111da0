"""Pickle round trips of the port's lazy collections on the CPU.

Every case of the JAX package's ``tests/test_pickle.py``, against the
port: an expression pickles as its class and operands
(``ArrayExpr.__reduce__``), its name survives, its caches are rebuilt on
load, a shared subtree stays shared, and torch callables in operands
travel by attribute path (``dask_array_tpu_torch/utils/_pickle.py``).  A
persisted leaf travels in host memory and loads on the configured device.
Each case runs through ``pickle`` and ``cloudpickle``; each round-tripped
expression computes the original's values and numpy's (and, where the JAX
package round-trips the same program, its values too).

Tolerance: exact where the round trip recomputes the same plan (the
original and the loaded expression); numpy's float64 results to rtol 1e-12.
"""

import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import cloudpickle
import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch._collection import Persisted

torch.set_num_threads(1)

SERIALIZERS = {"pickle": pickle.dumps, "cloudpickle": cloudpickle.dumps}


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


@pytest.fixture(params=sorted(SERIALIZERS))
def rt(request):
    dumps = SERIALIZERS[request.param]
    return lambda a: pickle.loads(dumps(a))


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def same(loaded, original, want, rtol=1e-12):
    """The loaded expression computes the original's values exactly and
    numpy's to ``rtol``."""
    got = np.asarray(loaded.compute())
    np.testing.assert_array_equal(got, np.asarray(original.compute()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    return got


def _double(block):
    return block * 2


def test_elemwise_pickle(rt, rng):
    x = rng.standard_normal((6, 8))
    d = tda.from_array(x, chunks=(3, 4))
    same(rt(d + 1), d + 1, x + 1)
    same(rt(tda.sqrt(d * d)), tda.sqrt(d * d), np.sqrt(x * x))


def test_reduction_of_an_elemwise_pickles(rt, rng):
    """``(from_array(x) + 1).sum(0)`` raised ``TypeError: Reduction missing
    operand 'array'`` before expressions had ``__reduce__``; the JAX package
    round-trips it to the same values."""
    x = rng.standard_normal((6, 8))
    y = (tda.from_array(x, chunks=(3, 4)) + 1).sum(0)
    got = same(rt(y), y, (x + 1).sum(0))
    ref = pickle.loads(pickle.dumps((jda.from_array(x, chunks=(3, 4)) + 1).sum(0)))
    np.testing.assert_allclose(got, np.asarray(ref.compute()), rtol=1e-12, atol=0)


def test_pickle_preserves_name(rt, rng):
    x = rng.standard_normal((6, 8))
    d = tda.from_array(x, chunks=(3, 4))
    y = d + 1
    assert rt(y).name == y.name
    assert rt(y).chunks == y.chunks
    assert type(rt(y).expr) is type(y.expr)


def test_pickle_drops_caches(rt, rng):
    x = rng.standard_normal((6, 8))
    d = tda.from_array(x, chunks=(3, 4))
    y = (d + 1).sum(axis=0)
    _ = y.optimize()  # fill the lowering caches
    y2 = rt(y)
    assert "_meta" not in y2.expr.__dict__ or y2.expr._meta.dtype == y.dtype
    same(y2, y, (x + 1).sum(axis=0))


@pytest.mark.parametrize("serializer", sorted(SERIALIZERS))
def test_pickle_loads_without_caches_in_a_new_process(serializer, rng, tmp_path):
    """Loaded where no node of the tree exists yet, every node is built
    from its operands alone: no cached metadata or lowering, the same
    names, the same values."""
    x = rng.standard_normal((6, 8))
    d = tda.from_array(x, chunks=(3, 4))
    y = (d + 1).sum(axis=0) * tda.maximum(d, 0).mean()
    _ = y.optimize()
    path = tmp_path / "expr.pkl"
    path.write_bytes(SERIALIZERS[serializer](y))
    script = textwrap.dedent(f"""
        import json, pickle, sys
        import numpy as np
        from dask_array_tpu_torch import config
        config.set_global({{"device": "cpu"}})
        y = pickle.loads(open({str(path)!r}, "rb").read())
        cached = sorted({{k for node in y.expr.walk() for k in node.__dict__
                          if k in ("_meta", "chunks", "shape", "numblocks", "_opt_memo", "_leaf_key")}})
        print(json.dumps({{"name": y.name, "cached": cached, "value": np.asarray(y.compute()).tolist()}}))
    """)
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, cwd=root, timeout=300,
                          env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["name"] == y.name
    assert out["cached"] == []
    np.testing.assert_array_equal(np.asarray(out["value"]), np.asarray(y.compute()))


def test_pickle_shared_subtree(rt, rng):
    x = rng.standard_normal((6, 8))
    d = tda.from_array(x, chunks=(3, 4))
    z = (d + 1) * (d + 1).sum()
    z2 = rt(z)
    assert z2.optimize().name == z.optimize().name
    ids = {}
    stack = [z2.expr]
    while stack:  # every node reachable through operands, repeats included
        node = stack.pop()
        ids.setdefault(node._name, set()).add(id(node))
        stack.extend(node.dependencies())
    assert (d + 1).expr._name in ids
    assert all(len(v) == 1 for v in ids.values())  # one object a name: d + 1 is one node, not two equal ones
    same(z2, z, (x + 1) * (x + 1).sum())


def _families(d, di, x, xi):
    """(name, port expression, numpy result): one case of each op family."""
    u = xi.astype(np.uint32)
    du = tda.from_array(u, chunks=(3, 4))
    return [
        ("matmul", d @ d.T, x @ x.T),
        ("sum", d.sum(axis=0), x.sum(axis=0)),
        ("slice", (d * 3)[1:4, ::2], (x * 3)[1:4, ::2]),
        ("take", d[np.array([0, 2, 4])], x[[0, 2, 4]]),
        ("map_overlap", tda.map_overlap(_double, d, depth=1), x * 2),
        ("rechunk", d.rechunk((2, 8)), x),
        ("concatenate", tda.concatenate([d, d], axis=0), np.concatenate([x, x], axis=0)),
        ("reshape_transpose", d.T.reshape(48), x.T.reshape(48)),
        ("var_cumsum", d.var(axis=1) + d.cumsum(axis=1)[:, -1], x.var(axis=1) + x.cumsum(axis=1)[:, -1]),
        ("ufunc_table", tda.clip(tda.floor_divide(di, 2), 0, 3) + tda.maximum(di, 4) + tda.cbrt(d),
         np.clip(np.floor_divide(xi, 2), 0, 3) + np.maximum(xi, 4) + np.cbrt(x)),
        ("unsigned", du // 3 + (du < 4), u // 3 + (u < 4)),
        ("where_mask", tda.where(d > 0, d, 0.5), np.where(x > 0, x, 0.5)),
        ("boolean_index", d[d > 0], x[x > 0]),
        ("histogram", tda.histogram(d, bins=5, range=(-2, 2))[0], np.histogram(x, bins=5, range=(-2, 2))[0]),
        ("bincount", tda.bincount(di.ravel()), np.bincount(xi.ravel())),
        ("pad", tda.pad(d, 1, mode="reflect"), np.pad(x, 1, mode="reflect")),
        ("fft", tda.fft.fft(d.rechunk((3, 8)), axis=1), np.fft.fft(x, axis=1)),
        ("qr_r", abs(tda.linalg.qr(d.rechunk((6, 8)))[1]), abs(np.linalg.qr(x)[1])),
        ("median", tda.median(d, axis=0), np.median(x, axis=0)),
    ]


FAMILIES = ["matmul", "sum", "slice", "take", "map_overlap", "rechunk", "concatenate", "reshape_transpose",
            "var_cumsum", "ufunc_table", "unsigned", "where_mask", "boolean_index", "histogram", "bincount", "pad",
            "fft", "qr_r", "median"]


@pytest.mark.parametrize("family", FAMILIES)
def test_pickle_across_families(rt, rng, family):
    x = rng.standard_normal((6, 8))
    xi = rng.integers(0, 9, (6, 8))
    d, di = tda.from_array(x, chunks=(3, 4)), tda.from_array(xi, chunks=(3, 4))
    _, e, want = next(c for c in _families(d, di, x, xi) if c[0] == family)
    same(rt(e), e, want, rtol=1e-10 if family == "qr_r" else 1e-12)


def test_pickle_random(rt):
    a = tda.random.default_rng(5).standard_normal((4, 6), chunks=2)
    a2 = rt(a)
    assert a2.name == a.name
    np.testing.assert_array_equal(np.asarray(a2.compute()), np.asarray(a.compute()))


def test_persisted_pickle(rt, rng):
    x = rng.standard_normal((6, 8))
    d = tda.from_array(x, chunks=(3, 4)).persist()
    same(rt(d * 2), d * 2, x * 2)
    assert rt(d).name == d.name  # the persisted name pin survives


def test_persisted_leaf_travels_in_host_memory(rng):
    """The leaf pickles its tensor from host memory and loads it on the
    configured device (the CPU here); loaded where no leaf of that name
    exists, it holds the pickled values."""
    x = rng.standard_normal((6, 8))
    d = tda.from_array(x, chunks=(3, 4)).persist()
    fn, args = d.expr.__reduce__()
    assert args[0].device.type == "cpu" and torch.equal(args[0], d.expr.buffer)
    fresh = fn(args[0].clone(), args[1], "persisted-elsewhere")
    assert type(fresh) is Persisted and fresh.buffer.device == torch.device("cpu")
    np.testing.assert_array_equal(np.asarray(tda.Array(fresh).compute()), x)


def test_astype_unsigned_numpy_parity(rt, rng):
    x = rng.standard_normal((6, 8)) * 10
    d = tda.from_array(x, chunks=(3, 4))
    for dt in ("uint8", "uint16", "uint32", "uint64", "int8", "int32"):
        got = np.asarray(rt(d.astype(dt)).compute())
        want = x.astype(dt)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want), dt


def test_field_access_expr_pickles():
    pytest.skip("field access of structured arrays is S9's host lane, which the port does not have yet "
                "(ROADMAP Queue 1 item 5)")


def test_lambda_still_rejected(rng):
    """Stock pickle refuses a lambda, as dask without cloudpickle does."""
    x = rng.standard_normal((4, 4))
    y = tda.from_array(x, chunks=2).map_blocks(lambda b: b + 1)
    with pytest.raises(Exception):
        pickle.dumps(y)


def test_map_blocks_with_a_torch_function_through_cloudpickle(rng):
    """A map_blocks of a torch function, and of a lambda that calls one,
    round-trips through cloudpickle."""
    x = rng.standard_normal((6, 8))
    d = tda.from_array(x, chunks=(3, 4))
    y = d.map_blocks(torch.sin) + d.map_blocks(lambda b: torch.special.expit(b) * 2)
    y2 = pickle.loads(cloudpickle.dumps(y))
    assert y2.name == y.name
    same(y2, y, np.sin(x) + 2 / (1 + np.exp(-x)))
    assert pickle.loads(pickle.dumps(d.map_blocks(torch.sin))).name == d.map_blocks(torch.sin).name

"""Plan records through the port on the CPU, beside the JAX package.

Every case of the JAX package's ``tests/test_planrec.py`` runs through the
port's ``_planrec`` (the same grammar, version 1): the native (plankit) and
Python encoders give equal bytes for every pipeline, the decoders reject
malformed and mis-versioned blobs, and the fingerprint tells structure
apart, ignores leaf contents and is stable across processes.  Then the
differential checks: a tape encodes to the same bytes and decodes to the
same table through both packages' Python code, and ``structural_key``
takes the plan fingerprint first and the tokenize walk where the grammar
declines.

Tolerance: exact everywhere (bytes, hex digests, node tables).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dask_array_tpu_torch as da
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch import native
from dask_array_tpu_torch._planrec import (
    GRAMMAR_VERSION,
    decode_plan,
    encode_py,
    flatten_plan,
    plan_fingerprint,
    plan_records,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def test_plankit_is_built():
    # the native half of every parity test below: a skip would hide it
    assert native.available()


def _fp(x):
    out = plan_fingerprint(x.expr.optimize())
    assert out is not None
    return out[0]


def _pipelines():
    x = da.ones((60, 60), chunks=(20, 20))
    y = da.from_array(np.arange(144.0).reshape(12, 12), chunks=4)
    return {
        "readme": (x + x.T)[:30, :30],
        "reduce": x.sum(axis=0),
        "matmul": y @ y.T,
        "slice_step": x[::2, 1:50:3],
        "rechunk": x.rechunk((30, 30)) * 2,
        "stack": da.stack([y, y + 1], axis=0),
        "overlap": da.map_overlap(lambda b: b, y, depth=1, boundary="reflect"),
        "random": da.random.default_rng(7).normal(size=(40, 40), chunks=20) + 1,
    }


def _offsets(strings):
    offs = [0]
    for s in strings:
        offs.append(offs[-1] + len(s.encode("utf-8")))
    return offs


@pytest.mark.parametrize("name", sorted(_pipelines()))
def test_native_python_encoder_byte_parity(name):
    expr = _pipelines()[name].expr.optimize()
    flat = flatten_plan(expr)
    assert flat is not None
    codes, strings, _stable = flat
    blob_py = encode_py(codes, strings)
    blob_nat = native.plan_encode(codes, "".join(strings).encode("utf-8"), _offsets(strings))
    assert blob_nat == blob_py


@pytest.mark.parametrize("name", sorted(_pipelines()))
def test_roundtrip_decode(name):
    expr = _pipelines()[name].expr.optimize()
    rec = plan_records(expr)
    assert rec is not None
    blob, _stable = rec
    d = decode_plan(blob)
    assert d["version"] == GRAMMAR_VERSION
    assert len(d["nodes"]) >= 1
    for node in d["nodes"]:
        assert node["type"]
    info = native.plan_validate(blob)
    assert info["n_nodes"] == len(d["nodes"]) and info["version"] == GRAMMAR_VERSION


@pytest.mark.parametrize("name", sorted(_pipelines()))
def test_tape_encodes_and_decodes_the_same_through_the_jax_package(name):
    from dask_array_tpu import _planrec as jplanrec

    codes, strings, _ = flatten_plan(_pipelines()[name].expr.optimize())
    blob = encode_py(codes, strings)
    assert jplanrec.encode_py(codes, strings) == blob
    assert jplanrec.decode_plan(blob) == decode_plan(blob)


def test_grammar_version_rejected_by_both_decoders():
    blob, _ = plan_records(_pipelines()["readme"].expr.optimize())
    bad = bytes([blob[0] + 1]) + blob[1:]
    with pytest.raises(ValueError, match="version"):
        decode_plan(bad)
    with pytest.raises(ValueError, match="version"):
        native.plan_validate(bad)


@pytest.mark.parametrize("cut", [1, 5, -3, -1])
def test_truncated_blob_rejected(cut):
    blob, _ = plan_records(_pipelines()["reduce"].expr.optimize())
    bad = blob[:cut]
    with pytest.raises(ValueError):
        decode_plan(bad)
    with pytest.raises(ValueError, match="malformed"):
        native.plan_validate(bad)


def test_trailing_bytes_rejected():
    blob, _ = plan_records(_pipelines()["reduce"].expr.optimize())
    with pytest.raises(ValueError):
        decode_plan(blob + b"\x00")
    with pytest.raises(ValueError, match="malformed"):
        native.plan_validate(blob + b"\x00")


def test_fingerprint_distinguishes_scalars():
    x = da.ones((40, 40), chunks=20)
    assert _fp(x + 1) != _fp(x + 2)
    assert _fp(x + 1) != _fp(x + 1.0)  # int vs float literal
    assert _fp(x + 1.0) != _fp(x + 1.5)


def test_fingerprint_distinguishes_sharing_patterns():
    a = da.ones((30, 30), chunks=10)
    b = da.from_array(np.ones((30, 30)), chunks=10)
    c = da.from_array(np.ones((30, 30)), chunks=10)
    assert _fp(a * a) != _fp(b * c)


def test_fingerprint_distinguishes_chunk_grids():
    assert _fp(da.ones((40, 40), chunks=20) + 0) != _fp(da.ones((40, 40), chunks=10) + 0)


def test_fingerprint_distinguishes_slices():
    x = da.ones((40, 40), chunks=20)
    assert _fp(x[::2]) != _fp(x[::4])
    assert _fp(x[1:]) != _fp(x[2:])
    assert _fp(x[:, 1:]) != _fp(x[1:, :])


def test_fingerprint_equal_for_equal_programs():
    def build():
        x = da.ones((40, 40), chunks=20)
        return (x + x.T)[:10].sum(axis=1)

    assert _fp(build()) == _fp(build())


def test_same_shape_different_data_share_fingerprint():
    a = da.from_array(np.arange(16.0).reshape(4, 4), chunks=2)
    b = da.from_array(np.ones((4, 4)), chunks=2)
    assert _fp(a + 1) == _fp(b + 1)
    c = da.from_array(np.ones((4, 4), dtype=np.float32), chunks=2)
    assert _fp(a + 1) != _fp(c + 1)


def test_unstable_flag_for_identity_tokenized_operands():
    class Opaque:
        __slots__ = ("__weakref__",)

        def __reduce__(self):
            raise TypeError("unpicklable")

    x = da.ones((8,), chunks=4)
    y = da.map_blocks(lambda b, extra=None: b, x, extra=Opaque(), dtype=x.dtype)
    out = plan_fingerprint(y.expr.optimize())
    if out is not None:
        assert out[1] is False


def test_stable_flag_for_plain_pipelines():
    out = plan_fingerprint(_pipelines()["readme"].expr.optimize())
    assert out is not None and out[1] is True


def test_cross_process_fingerprint_stability():
    code = (
        "import dask_array_tpu_torch as da\n"
        "from dask_array_tpu_torch._planrec import plan_fingerprint\n"
        "x = da.ones((60, 60), chunks=(20, 20))\n"
        "e = (x + x.T)[:30, :30].sum(axis=0).expr.optimize()\n"
        "print(plan_fingerprint(e)[0])\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root)
    assert out.returncode == 0, out.stderr[-500:]
    x = da.ones((60, 60), chunks=(20, 20))
    e = (x + x.T)[:30, :30].sum(axis=0).expr.optimize()
    assert out.stdout.strip() == plan_fingerprint(e)[0]


def test_structural_key_uses_plan_fingerprint():
    from dask_array_tpu_torch._executor import structural_key

    x = da.ones((20, 20), chunks=10)
    assert structural_key((x + 1).expr.optimize()).startswith("plan:")


def test_structural_key_equal_across_rebuilds_of_new_data():
    # the key the streaming lane's single-plan rule reads: structurally
    # equal programs over fresh leaf data share it (the JAX package's
    # executor-cache case; the port compiles nothing)
    from dask_array_tpu_torch._executor import structural_key

    def run(data):
        arr = da.from_array(data, chunks=2)
        y = arr * 2 + 1
        return structural_key(y.expr.optimize()), y.sum().compute()

    k1, r1 = run(np.arange(16.0).reshape(4, 4))
    k2, r2 = run(np.ones((4, 4)))
    assert k1 == k2
    assert float(r1) == np.arange(16.0).sum() * 2 + 16 and float(r2) == 16 * 2 + 16


def test_structural_key_falls_back_to_the_tokenize_walk(monkeypatch):
    from dask_array_tpu_torch import _executor, _planrec

    monkeypatch.setattr(_planrec, "flatten_plan", lambda root: None)
    x = da.ones((20, 20), chunks=10)
    k1 = _executor.structural_key((x + 1).expr.optimize())
    k2 = _executor.structural_key((x + 1).expr.optimize())
    k3 = _executor.structural_key((x + 2).expr.optimize())
    assert k1.startswith("walk:") and k1 == k2 and k1 != k3
    a = da.from_array(np.arange(16.0).reshape(4, 4), chunks=2)
    b = da.from_array(np.ones((4, 4)), chunks=2)
    assert _executor.structural_key((a + 1).expr.optimize()) == _executor.structural_key((b + 1).expr.optimize())


def test_tuple_list_operands_do_not_alias():
    t = encode_py([1, 0, 0, 1, 7, 2, 1, 1, 1, 2], ["X"])
    lst = encode_py([1, 0, 0, 1, 11, 2, 1, 1, 1, 2], ["X"])
    assert t != lst


def test_decode_rejects_forward_expr_reference():
    blob = encode_py([1, 0, 0, 1, 0, 0], ["X"])
    with pytest.raises(ValueError, match="forward"):
        decode_plan(blob)
    with pytest.raises(ValueError, match="malformed"):
        native.plan_validate(blob)


def test_native_encoder_rejects_malformed_tape():
    with pytest.raises(ValueError, match="malformed plan tape"):
        native.plan_encode([1, 5, 0, 0], b"", [0])
    with pytest.raises(ValueError, match="malformed plan tape"):
        native.plan_encode([1, 0, 0, 1, 99], b"X", [0, 1])
    with pytest.raises(ValueError, match="malformed plan tape"):
        native.plan_encode([2, 0, 0], b"X", [0, 1])


def test_plan_table_matches_expression_types():
    x = da.ones((40, 40), chunks=20)
    expr = (x @ x).expr.optimize()
    blob, _ = plan_records(expr)
    types = {n["type"] for n in decode_plan(blob)["nodes"]}
    assert types == {type(n).__qualname__ for n in expr.walk()}


@pytest.mark.parametrize("leaf", ["from_array", "persist", "from_map", "barrier"])
def test_leaves_enter_the_plan_by_their_spec(leaf):
    """Leaves are cut points keyed by dtype and chunks, not contents: the
    four leaf kinds the JAX package keys so (FromArray, Persisted, FromMap,
    Barrier)."""

    def make(v):
        base = da.from_array(np.full((8, 8), v), chunks=4)
        if leaf == "persist":
            return base.persist()
        if leaf == "from_map":
            return da.from_map(lambda i: np.full((4, 8), v), [0, 1], chunks=((4, 4), (8,)), dtype="f8")
        if leaf == "barrier":
            return da.barrier(base)
        return base

    a, b = make(1.0), make(2.0)
    assert _fp(a + 1) == _fp(b + 1)
    d = decode_plan(plan_records((a + 1).expr.optimize())[0])
    assert any(op == ("leaf", 0) for n in d["nodes"] for op in n["ops"])

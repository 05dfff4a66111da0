"""The port's BASELINE pipelines take the JAX package's arguments.

Each of the seven functions of ``dask_array_tpu_torch/models/pipelines.py``
has the reference's positional parameters, with their names and defaults,
in its order; the port's extra inputs (``x_np``, ``a_np``, ``b_np``) are
keyword-only.  ``blocked_matmul(n, chunk, dtype, seed)`` draws the
reference's operands from the same numpy seed, so its product equals the
JAX package's: float32 to rtol 1e-5 with an atol of 2^-20 times the sum of
|products| (64-term sums in another order), bfloat16 to one step of the
type (2^-7 relative, both round a float32 sum once) with an atol of 2^-16
times the sum of |products|.
"""

import inspect

import numpy as np
import pytest
import torch

from dask_array_tpu.models import pipelines as jpipes
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.models import pipelines as tpipes

torch.set_num_threads(1)

PIPELINES = ("readme_example", "normalize_contract", "reduction_tree", "blocked_matmul", "stencil2d",
             "tall_skinny_svd", "rechunk_relayout")
EXTRAS = {"reduction_tree": ("x_np",), "blocked_matmul": ("a_np", "b_np"), "stencil2d": ("x_np",),
          "tall_skinny_svd": ("x_np",), "rechunk_relayout": ("x_np",)}


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def _f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("name", PIPELINES)
def test_positional_parameters_match_the_reference(name):
    ref = list(inspect.signature(getattr(jpipes, name)).parameters.values())
    got = list(inspect.signature(getattr(tpipes, name)).parameters.values())
    positional = [p for p in got if p.kind is not inspect.Parameter.KEYWORD_ONLY]
    assert [(p.name, p.kind, p.default) for p in positional] == [(p.name, p.kind, p.default) for p in ref]
    extras = [p for p in got if p.kind is inspect.Parameter.KEYWORD_ONLY]
    assert tuple(p.name for p in extras) == EXTRAS.get(name, ())
    assert all(p.default is None for p in extras)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_matmul_draws_the_reference_operands(dtype):
    got = tpipes.blocked_matmul(n=64, chunk=16, dtype=dtype, seed=0)
    ref = jpipes.blocked_matmul(n=64, chunk=16, dtype=dtype, seed=0)
    assert got.chunks == ref.chunks == ((16,) * 4, (8,) * 8)
    assert np.dtype(got.dtype) == np.dtype(ref.dtype)
    g, r = got.compute(), np.asarray(ref.compute())
    assert g.dtype == r.dtype and g.shape == r.shape == (64, 64)
    rng = np.random.default_rng(0)
    a, b = np.abs(rng.standard_normal((64, 64))), np.abs(rng.standard_normal((64, 64)))
    mag = float((a @ b).max())
    if dtype == "float32":
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=2.0**-20 * mag)
    else:
        np.testing.assert_allclose(_f32(g), _f32(r), rtol=2.0**-7, atol=2.0**-16 * mag)


def test_blocked_matmul_takes_both_operands_or_neither():
    a = np.ones((8, 8), np.float32)
    with pytest.raises(ValueError, match="both"):
        tpipes.blocked_matmul(8, 4, a_np=a)
    np.testing.assert_array_equal(tpipes.blocked_matmul(8, 4, a_np=a, b_np=a).compute(), a @ a)


def test_stencil2d_persist_runs_and_equals_the_lazy_input():
    held = tpipes.stencil2d(64, 16, persist=True)
    lazy = tpipes.stencil2d(64, 16)
    assert held.shape == lazy.shape == (64, 64) and held.chunks == lazy.chunks
    assert held.compute().tobytes() == lazy.compute().tobytes()


def test_positional_calls_take_the_reference_order():
    """A call written for the JAX package runs on the port as it reads:
    ``stencil2d(64, 16)`` is n=64 and chunk=16, ``rechunk_relayout(32, 8)``
    n=32 and chunk=8, ``tall_skinny_svd(400, 8, 100)`` rows, cols and
    chunk_rows, ``reduction_tree(40, 10, 2)`` n, chunk and split_every."""
    assert tpipes.stencil2d(64, 16).chunks == ((16,) * 4,) * 2
    assert tpipes.rechunk_relayout(32, 8).chunks == ((8,) * 4, (32,))
    u, s, vh = tpipes.tall_skinny_svd(400, 8, 100)
    assert u.shape == (400, 8) and u.chunks[0] == (100,) * 4 and s.shape == (8,)
    total, means, sd = tpipes.reduction_tree(40, 10, 2)
    assert total.shape == means.shape == (40,) and sd.shape == ()

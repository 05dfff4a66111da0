"""The plain references against numpy at a small size, dask's "reflect"
edge (numpy's symmetric pad) included."""

import numpy as np
import pytest
import torch

from portbench import core

STENCIL = core.load_module(core.PORTBENCH / "reference" / "stencil2d.py", "reference")
REDUCTION = core.load_module(core.PORTBENCH / "reference" / "reduction_tree.py", "reference")
CFG = {"depth": 1, "boundary": "reflect"}


def numpy_laplace(a):
    p = np.pad(a, 1, mode="symmetric")
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]


@pytest.mark.parametrize("func", ["laplace_roll", "laplace_slices"])
@pytest.mark.parametrize("shape", [(7, 5), (33, 64)])
def test_stencil_reference_is_numpys_symmetric_laplace(func, shape):
    a = np.random.default_rng(1).standard_normal(shape)
    field = torch.from_numpy(a)
    rows = torch.arange(shape[0])
    got = STENCIL.rows(field, CFG, {"func": func}, rows, torch.float64).numpy()
    np.testing.assert_allclose(got, numpy_laplace(a), rtol=0, atol=1e-12)
    some = torch.tensor([0, 3, shape[0] - 1])
    np.testing.assert_allclose(STENCIL.rows(field, CFG, {"func": func}, some, torch.float64).numpy(),
                               numpy_laplace(a)[[0, 3, shape[0] - 1]], rtol=0, atol=1e-12)


def test_reflect_repeats_the_edge_element():
    a = np.arange(12.0).reshape(3, 4)
    got = STENCIL.rows(torch.from_numpy(a), CFG, {"func": "laplace_roll"}, torch.tensor([0]), torch.float64)
    # row 0, column 0: up is row 0 itself, left is column 0 itself
    assert got[0, 0].item() == a[0, 0] + a[1, 0] + a[0, 0] + a[0, 1] - 4 * a[0, 0]


def test_stencil_reference_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError):
        STENCIL.rows(torch.zeros(4, 4), {"depth": 2, "boundary": "reflect"}, {"func": "laplace_roll"},
                     torch.arange(4), torch.float64)


@pytest.mark.parametrize("how", ["sum", "mean", "var", "std"])
@pytest.mark.parametrize("axis", [0, 1, None])
def test_reduction_reference_against_numpy(how, axis, monkeypatch):
    monkeypatch.setattr(REDUCTION, "BLOCK_ELEMENTS", 3 * 90)  # several blocks of rows
    a = np.random.default_rng(2).standard_normal((120, 90)) + 3.0
    got = REDUCTION.full(torch.from_numpy(a), {}, {"how": how, "axis": axis}, torch.float64).numpy()
    np.testing.assert_allclose(got, getattr(np, how)(a, axis=axis), rtol=1e-12, atol=1e-12)


def test_control_precision_is_coarser():
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(3))
    exact = REDUCTION.full(a, {}, {"how": "std", "axis": None}, torch.float64)
    low = REDUCTION.full(a, {}, {"how": "std", "axis": None}, torch.bfloat16)
    assert low.dtype == torch.bfloat16 and 1e-5 < abs(low.double().item() - exact.item()) < 1e-1

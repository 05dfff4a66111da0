"""The PyTorch port stands alone: importing it loads neither jax nor the
JAX package, and its device is explicit."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield

PKG = pathlib.Path(__file__).resolve().parents[1] / "dask_array_tpu_torch"


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import dask_array_tpu_torch\n"
        "from dask_array_tpu_torch.models import pipelines\n"
        "from dask_array_tpu_torch.kernels import _build, halo, mstat, scale, stencil, transpose\n"
        "from dask_array_tpu_torch.ops import _blocks, _overlap, _reshape, _sliding, creation, manipulation, stacking\n"
        "from dask_array_tpu_torch.ops import linalg_decomp\n"
        "from dask_array_tpu_torch import linalg, _materialize\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dask_array_tpu' or m.startswith('dask_array_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import dask_array_tpu\b|from dask_array_tpu[ .])", re.M)
    offenders = [p.name for p in PKG.rglob("*.py") if pattern.search(p.read_text())]
    assert offenders == []


def _fresh_python(code):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=120
    )


def test_device_defaults_to_cpu():
    """The package's default device is the card ("cuda"); only these tests'
    fixture asks for the CPU."""
    out = _fresh_python("import dask_array_tpu_torch as da; print(da.config.get('device'))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "cuda"


def test_default_device_without_card_raises():
    # under the default device, a machine with no card refuses to compute
    # instead of running on the CPU
    code = (
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "import dask_array_tpu_torch as da\n"
        "try:\n"
        "    da.ones((4, 4), chunks=2).compute()\n"
        "except RuntimeError as e:\n"
        "    print('raised', 'no CUDA device' in str(e))\n"
    )
    out = _fresh_python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised True"


def test_cpu_device_is_asked_for():
    import dask_array_tpu_torch as da

    assert da.config.get("device") == "cpu"
    out = da.ones((4, 4), chunks=2).compute_device()
    assert out.device.type == "cpu"


def test_cuda_device_without_card_raises(monkeypatch):
    import dask_array_tpu_torch as da

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = da.from_array(np.ones((4, 4)), chunks=2)
    with da.config.set({"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            x.compute()


def test_public_names_are_the_references():
    import json

    import dask_array_tpu_torch as da

    reference = set(json.loads((PKG.parent / "tests" / "reference_namespace.json").read_text()))
    port_only = {"config", "new_collection", "trim_internal", "wrap_numpy_ufunc"}
    assert set(da.__all__) - port_only <= reference
    for name in ("sum", "mean", "std", "var", "argmax", "cumsum", "reduction", "arg_reduction",
                 "cumreduction", "moment", "trace", "einsum", "tensordot", "dot", "matmul",
                 "blockwise", "compute"):
        assert name in da.__all__ and name in reference
    assert da.linalg.matmul is da.matmul and da.reductions.sum is da.sum


def test_shape_and_layout_names_are_exported():
    import json

    import dask_array_tpu_torch as da

    reference = set(json.loads((PKG.parent / "tests" / "reference_namespace.json").read_text()))
    names = ("atleast_1d atleast_2d atleast_3d broadcast_to expand_dims flip fliplr flipud moveaxis roll "
             "rollaxis rot90 squeeze swapaxes transpose block concatenate dstack hstack stack vstack "
             "ravel reshape reshape_blockwise vdot outer conj conjugate").split()
    for name in names:
        assert name in da.__all__ and name in reference and callable(getattr(da, name)), name
    assert da.linalg.vdot is da.vdot and da.linalg.outer is da.outer


def test_halo_path_and_creation_names_are_exported():
    import json

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch.ops import _sliding

    reference = set(json.loads((PKG.parent / "tests" / "reference_namespace.json").read_text()))
    names = ("pad tile repeat sliding_window_view push trim_overlap ones_like zeros_like empty_like full_like "
             "linspace eye diag diagonal tri meshgrid indices fromfunction").split()
    for name in names:
        assert name in da.__all__ and name in reference and callable(getattr(da, name)), name
    # the move_* reductions stay in ops._sliding, as in the JAX package
    for name in ("move_sum", "move_mean", "move_max", "move_min", "move_var", "move_std"):
        assert callable(getattr(_sliding, name)) and name not in da.__all__


def test_chip_smoke_imports_no_jax():
    source = (PKG.parent / "chip_smoke.py").read_text()
    pattern = re.compile(r"^\s*(import jax|from jax|import dask_array_tpu\b|from dask_array_tpu[ .])", re.M)
    assert not pattern.search(source)


def test_decomposition_names_are_exported():
    import dask_array_tpu_torch as da

    names = "cholesky inv lstsq lu norm qr sfqr solve solve_triangular svd tsqr".split()
    for name in names:
        assert getattr(da, name) is getattr(da.linalg, name), name
    # linalg's names, as in dask; the top-level list stays the reference's
    assert not set(names) & set(da.__all__)
    assert callable(da.linalg.svd_flip)
    # svd_compressed is also a top-level attribute, as in the JAX package
    assert da.svd_compressed is da.linalg.svd_compressed and "svd_compressed" not in da.__all__

"""The PyTorch port stands alone: importing it loads neither jax nor the
JAX package, and its device is explicit."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parents[1] / "dask_array_tpu_torch"


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import dask_array_tpu_torch\n"
        "from dask_array_tpu_torch.models import pipelines\n"
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


def test_device_defaults_to_cpu():
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

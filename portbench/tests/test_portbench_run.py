"""Whole runs of each cell on the CPU at a small size, past the harness's
look for a card: sound runs come out correct, and the control and each
fault the cell can have, planted underneath the timed path, come out not
correct.  On the card (``gpu`` marker) each cell runs at its own size."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import core, readings

sys.path.insert(0, str(Path(__file__).parent))
from _small import SMALL  # noqa: E402

BENCH = core.load_json(core.CHECKOUT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 12345


def small(cell):
    return SMALL[core.Cell(cell).entry["config"]]


def run_small(cell, seed=SEED):
    return core.run_cell(cell, seed, 0.2, False, device="cpu", cfg_override=small(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = run_small(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert {"eff_gbps", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_run_reads_the_host_spans(cell):
    result = core.run_cell(cell, SEED, 0.2, True, device="cpu", cfg_override=small(cell))
    assert result["correct"]
    assert {"build_ms", "walk_ms"} <= set(result["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = core.Cell(cell)
    numbers = readings.control_numbers(c, SEED, device="cpu", cfg_override=small(cell))
    assert any(numbers[name] > limit for name, limit in c.limits.items()), numbers


@pytest.mark.parametrize("cell", [c for c in CELLS if core.Cell(c).entry["config"] == "reduction_tree"])
def test_the_half_field_reading_fails_every_statistic(cell):
    c = core.Cell(cell)
    numbers = readings.half_field_numbers(c, SEED, device="cpu", cfg_override=small(cell))
    assert set(numbers) == set(c.limits)
    assert all(numbers[name] > limit for name, limit in c.limits.items()), numbers


# -- faults planted underneath the timed path: the executor's answers ---------


def _stencil_unchanged(field, t):
    return field.clone()


def _stencil_no_exchange(field, t):
    """Each block's Laplace from the block alone: the halo between blocks
    left out (every block reflects at its own edges)."""
    ref = core.load_module(core.PORTBENCH / "reference" / "stencil2d.py", "reference")
    out = torch.empty_like(t)
    n0, n1 = field.shape
    c0, c1 = n0 // 4, n1 // 4
    for i in range(0, n0, c0):
        for j in range(0, n1, c1):
            block = field[i:i + c0, j:j + c1].contiguous()
            out[i:i + c0, j:j + c1] = ref.laplace_rows(block, torch.arange(block.shape[0]), t.dtype)
    return out


def _altered(field, t):
    t = t.clone()
    t.view(-1)[t.numel() // 2] += 1.0
    return t


def _half(field, t):
    """The statistic over half of the field, the mean over the rest."""
    n0, n1 = field.shape
    if t.shape == (n1,):
        return field[: n0 // 2].sum(0)
    if t.shape == (n0,):
        return field[:, : n1 // 2].mean(1)
    if t.dim() == 0:
        return field[: n0 // 2].std(unbiased=False)
    return t


def _half_std(field, t):
    """Only the standard deviation over half of the field: in
    ``reduction_tree.single`` the lone std is P4's one launch."""
    if t.dim() == 0:
        return field[: field.shape[0] // 2].std(unbiased=False)
    return t


FAULTS = {
    "stencil2d": {"unchanged": _stencil_unchanged, "no_exchange": _stencil_no_exchange, "altered": _altered},
    "reduction_tree": {"half": _half, "half_std": _half_std, "altered": _altered},
}


class _FaultyView:
    def __init__(self, view, fault):
        self._view, self._fault = view, fault

    def dense(self):
        return self._fault(self._view.dense())

    def __getattr__(self, name):
        return getattr(self._view, name)


def plant(monkeypatch, fault):
    """Arm ``fault`` once the field is held: every answer the executor
    gives (``execute_views`` and ``execute_many`` as ``_materialize``
    calls them) goes through it."""
    from dask_array_tpu_torch import _materialize

    state = {"field": None}
    hold = core.hold

    def holding(da, field, cfg):
        x = hold(da, field, cfg)
        state["field"] = field.clone()
        return x

    def views(exprs, *a, **k):
        out = real_views(exprs, *a, **k)
        if state["field"] is None:
            return out
        return [_FaultyView(v, lambda t: fault(state["field"], t)) for v in out]

    def many(exprs, *a, **k):
        out = real_many(exprs, *a, **k)
        if state["field"] is None:
            return out
        return [fault(state["field"], t) for t in out]

    real_views, real_many = _materialize.execute_views, _materialize.execute_many
    monkeypatch.setattr(core, "hold", holding)
    monkeypatch.setattr(_materialize, "execute_views", views)
    monkeypatch.setattr(_materialize, "execute_many", many)


CASES = [(cell, name) for cell in CELLS
         for name in FAULTS[core.Cell(cell).cfg.get("reference", core.Cell(cell).entry["config"])]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    family = core.Cell(cell).cfg.get("reference", core.Cell(cell).entry["config"])
    plant(monkeypatch, FAULTS[family][fault])
    result = run_small(cell)
    assert not result["correct"], result["checks"]


def test_it_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=core.CHECKOUT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_it_gives_no_result_with_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copy(core.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.PORTBENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(SEED),
                           "--seconds", "2", "--trace", "0"], cwd=core.CHECKOUT, capture_output=True,
                          text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"

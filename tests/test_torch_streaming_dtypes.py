"""The out-of-core lane for bfloat16, float16, float8, narrow-integer and
datetime programs, through the port on the CPU beside the JAX package.

The JAX package's ``_scan`` declines only host-only dtypes (records,
strings, objects), and so does the port's lane now.  Each program runs
under ``"force"`` with a small budget in both packages: the port's
``STREAMED`` counts a run and its panels, exactly as the JAX package's
do; the port's streamed result equals its in-core walk bit for bit; and it
equals the JAX package's streamed result bit for bit, except in
``KNOWN_REFERENCE_FAULTS`` (checked to differ below).  Then a streamed
bfloat16 and float16 stencil runs the band stencil once a panel, and the
pinned rings' dtype maps take the 1-byte, 2-byte and tick data.
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu import _streaming as jstreaming
from dask_array_tpu_torch import _streaming
from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

BF16 = np.dtype(ml_dtypes.bfloat16)
FORCE = {"tpu.out-of-core": "force", "tpu.memory-budget": "200 kB"}
KEYS = ("count", "panels")


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def _data():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((400, 64)).astype(np.float32)
    ticks = np.datetime64("2020-01-01", "ns") + rng.integers(0, 10**15, (400, 64)).astype("m8[ns]")
    ticks[5, 3] = np.datetime64("NaT")
    small = np.clip(np.round(f * 3), -8, 7).astype(np.int8)
    return f, ticks, small


F32, TICKS, SMALL = _data()
EPOCH = np.datetime64("2020-01-01", "ns")


def _x(da, a):
    return da.from_array(a, chunks=(25, 64))


PROGRAMS = {
    "bfloat16_sum": lambda da: _x(da, F32.astype(BF16)).sum(axis=0),
    "bfloat16_mean": lambda da: _x(da, F32.astype(BF16)).mean(axis=0),
    "bfloat16_map_overlap": lambda da: da.map_overlap(lambda b: b * 2 + 1, _x(da, F32.astype(BF16)), depth=1,
                                                      boundary="nearest"),
    "float16_add": lambda da: _x(da, F32.astype(np.float16)) + 1,
    "float8_e4m3fn_add": lambda da: _x(da, F32.astype(ml_dtypes.float8_e4m3fn)) * 2,
    "float8_e4m3fn_sum": lambda da: _x(da, F32.astype(ml_dtypes.float8_e4m3fn)).sum(axis=0),
    "float8_e4m3_add": lambda da: _x(da, F32.astype(ml_dtypes.float8_e4m3)) + _x(da, F32.astype(ml_dtypes.float8_e4m3)),
    "float8_e4m3_sum": lambda da: _x(da, F32.astype(ml_dtypes.float8_e4m3)).sum(axis=0),
    "int4_mul": lambda da: _x(da, SMALL.astype(ml_dtypes.int4)) * 3,
    "int4_sum": lambda da: _x(da, SMALL.astype(ml_dtypes.int4)).sum(axis=0),
    "datetime_min": lambda da: _x(da, TICKS).min(axis=0),
    "datetime_max": lambda da: _x(da, TICKS).max(axis=0),
    "datetime_subtract": lambda da: _x(da, TICKS) - EPOCH,
}

KNOWN_REFERENCE_FAULTS = {
    # the JAX package rounds each panel's partial sum to bfloat16 (float8)
    # and combines in that type; the port's partials stay float32 across
    # panels, as its in-core sum accumulates, and round once
    "bfloat16_sum", "bfloat16_mean", "float8_e4m3fn_sum", "float8_e4m3_sum",
    # the JAX package's streamed datetime max and subtraction treat NaT as
    # its int64 ticks (the least value): the max skips it, the difference
    # is a number; numpy, and the port, keep NaT
    "datetime_max", "datetime_subtract",
}


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape, b.dtype, b.shape)
    if a.dtype.kind == "V":
        return np.array_equal(a.view(np.uint8), b.view(np.uint8))
    return np.array_equal(a, b, equal_nan=a.dtype.kind in "fcmM")


def _port_streamed(name):
    before = {k: _streaming.STREAMED[k] for k in KEYS}
    with tconfig.set(tconfig.from_reference(FORCE)):
        out = PROGRAMS[name](tda).compute()
    return out, {k: _streaming.STREAMED[k] - before[k] for k in KEYS}


def _jax_streamed(name):
    before = {k: jstreaming.STREAMED[k] for k in KEYS}
    with jda.config.set(FORCE):
        out = np.asarray(PROGRAMS[name](jda).compute())
    return out, {k: jstreaming.STREAMED[k] - before[k] for k in KEYS}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_streams_and_equals_in_core(name):
    got, delta = _port_streamed(name)
    assert delta["count"] == 1 and delta["panels"] >= 2
    assert same(got, PROGRAMS[name](tda).compute())
    ref, jdelta = _jax_streamed(name)
    assert delta == jdelta  # the same plan: one run, the same panels
    if name not in KNOWN_REFERENCE_FAULTS:
        assert same(got, ref)


@pytest.mark.parametrize("name", sorted(KNOWN_REFERENCE_FAULTS))
def test_known_reference_faults_are_real(name):
    got, _ = _port_streamed(name)
    ref, _ = _jax_streamed(name)
    assert not same(got, ref)


def test_records_still_decline():
    """Records still decline the lane (the host lane computes them)."""
    rec = np.zeros((400, 4), dtype=[("a", "f4"), ("b", "i4")])
    before = _streaming.STREAMED["count"]
    with tconfig.set(tconfig.from_reference(FORCE)):
        out = tda.from_array(rec, chunks=(25, 4))[::2].compute()
    assert _streaming.STREAMED["count"] == before and np.array_equal(out, rec[::2])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_streamed_two_byte_stencil_runs_the_band_stencil_once_a_panel(dtype, monkeypatch):
    """stencil2d's roll form on 2-byte data, streamed: the band stencil's
    wrapper (K1; its 2-byte build on the card) once a panel, the result the
    in-core one bit for bit."""
    from dask_array_tpu_torch.models.pipelines import stencil2d
    from dask_array_tpu_torch.ops import _overlap

    calls = []
    real = _overlap.band_stencil_call

    def spy(x, *args, **kwargs):
        calls.append(x.dtype)
        return real(x, *args, **kwargs)

    monkeypatch.setattr(_overlap, "band_stencil_call", spy)
    dt = BF16 if dtype == "bfloat16" else np.dtype(np.float16)
    src = np.random.default_rng(1).standard_normal((256, 64)).astype(dt)
    in_core = stencil2d(chunk=32, x_np=src).compute()
    assert len(calls) == 1
    before = {k: _streaming.STREAMED[k] for k in KEYS}
    with tconfig.set(tconfig.from_reference({"tpu.out-of-core": "force", "tpu.memory-budget": "60 kB"})):
        out = stencil2d(chunk=32, x_np=src).compute()
    panels = _streaming.STREAMED["panels"] - before["panels"]
    assert _streaming.STREAMED["count"] - before["count"] == 1 and panels >= 2
    assert len(calls) == 1 + panels and set(calls) == {getattr(torch, dtype)}
    assert out.dtype == dt and np.array_equal(out.view(np.uint16), in_core.view(np.uint16))


@pytest.mark.parametrize("dtype, held", [("int4", torch.uint8), ("float8_e4m3", torch.uint8),
                                         ("float8_e4m3fn", torch.float8_e4m3fn), ("bfloat16", torch.bfloat16),
                                         ("datetime64[ns]", torch.int64)])
def test_pinned_rings_carry_the_held_words(dtype, held):
    """The rings move a panel as the tensor ``_chunks.tensor_of`` holds it:
    a narrow type as its uint8 carrier, bfloat16 and float8 as torch's,
    datetime as int64 ticks; the pieces of a strided panel cover its bytes
    once."""
    from dask_array_tpu_torch._hostcopy import _pieces, _torch_dtype_of

    dt = np.dtype(getattr(ml_dtypes, dtype, None) or dtype)
    assert _torch_dtype_of(dt) == held
    raw = np.random.default_rng(2).integers(0, 256, (64, 48 * dt.itemsize), dtype=np.uint8)
    arr = raw.view(dt)[:, 5:40]
    assert sum(nb for _, nb, _ in _pieces(arr, 256)) == arr.nbytes

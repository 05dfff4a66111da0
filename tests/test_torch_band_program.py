"""The band stencil's programs (kernels/stencil.py: capture_program,
program_plain, emit_program; BandStencil with a program spec).

The Pallas band kernel inlines any shape-preserving jnp func; the port
reads a non-linear func into a straight-line program of pointwise ops over
shifted windows and generates a CUDA kernel from it.  Here, on the CPU:

- the capture reproduces each accepted op, in its function and its method
  form, byte for byte (``program_plain`` against the func itself, float32
  and float64), and declines what the kernel cannot take;
- the port's ``map_overlap`` of six non-linear funcs (the four of
  chip_smoke's phase 35, a clip and a second kwarg func) takes
  ``BandStencil`` with a program and matches the JAX package's Pallas
  kernel in interpret mode (called directly and through its own
  ``map_overlap``) under five boundaries and depths (1, 1), (2, 0), (8, 8).
  Tolerance: atol 1e-5 in float32 and 1e-12 in float64 (the two compute
  the same ops in the same order; XLA's and torch's transcendental
  functions differ in the last place).  bfloat16 and float16: the JAX
  kernel rounds every op to the 2-byte type, the port computes in float32
  and rounds once, so they differ by the JAX side's accumulated rounding:
  atol 2**-5 (bfloat16) and 2**-8 (float16) of max(1, max|result|);
- the sliced route (``_accept_slice``), a run on 8 CPU slots (the
  partitioned walk and the shard lane) against the walk without a mesh,
  a pickle round trip and equal tokens for equal funcs;
- the generated source is deterministic and, compiled with g++ as host
  code through a small shim, evaluates a tile as ``program_plain`` does:
  equal bytes for the exact ops, within 4 ulps (glibc's transcendental
  functions and square root against torch's CPU ones, which need not round
  correctly) otherwise.

The kernels themselves run in tests/test_torch_gpu.py, on a card.
"""

import ctypes
import functools
import pickle
import shutil
import subprocess

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu import config as jconfig
from dask_array_tpu.kernels.stencil import band_stencil_call as jax_band_stencil_call
from dask_array_tpu.ops._overlap import BandStencil as JaxBandStencil
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.kernels import stencil
from dask_array_tpu_torch.models import pipelines
from dask_array_tpu_torch.ops import _overlap
from dask_array_tpu_torch.ops._overlap import BandStencil

torch.set_num_threads(1)

MODES = ["reflect", "nearest", "periodic", 0.0, 2.5]
DEPTHS = [(1, 1), (2, 0), (8, 8)]


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def r(b, dy, dx):
    return torch.roll(b, (dy, dx), (0, 1))


# ---------------------------------------------------------------------------
# the capture, op by op: function form and method form
# ---------------------------------------------------------------------------

# name -> (function form, method form); each is non-linear where it can be,
# and every tap lies within depth (1, 1)
OPS = {
    "add": (lambda b: b * b + r(b, 1, 0), lambda b: b.mul(b).add(r(b, 1, 0))),
    "sub": (lambda b: torch.sub(r(b, 0, 1), b * b), lambda b: r(b, 0, 1).sub(b.mul(b))),
    "mul": (lambda b: torch.mul(b, r(b, -1, 1)), lambda b: b.mul(r(b, -1, 1))),
    "div": (lambda b: b / (r(b, 1, 1).abs() + 0.5), lambda b: b.div(r(b, 1, 1).abs().add(0.5))),
    "div_scalar": (lambda b: b * b / 3.0, lambda b: b.mul(b).div(3.0)),
    "rdiv_scalar": (lambda b: 2.0 / (b.abs() + 1), lambda b: b.abs().add(1).reciprocal().mul(2.0)),
    "neg": (lambda b: -(b * r(b, 1, 0)), lambda b: b.mul(r(b, 1, 0)).neg()),
    "pow": (lambda b: (b.abs() + 0.5) ** 1.5, lambda b: b.abs().add(0.5).pow(1.5)),
    "pow_int": (lambda b: torch.pow(b - r(b, 0, 1), 2), lambda b: b.sub(r(b, 0, 1)).pow(3)),
    **{name: (lambda b, n=name: getattr(torch, n)(arg(b)), lambda b, n=name: getattr(arg(b), n)())
       for name, arg in [
           ("abs", lambda b: b - r(b, 1, 0)), ("sqrt", lambda b: b.abs() + r(b, 0, 1).abs()),
           ("rsqrt", lambda b: b * b + 0.5), ("exp", lambda b: b - r(b, 1, 1)), ("expm1", lambda b: b * r(b, 0, -1)),
           ("log", lambda b: b.abs() + 0.1), ("log1p", lambda b: b.abs() * 2), ("tanh", pipelines.laplace_roll),
           ("sigmoid", lambda b: b + r(b, -1, 0)), ("sin", lambda b: 3 * b - r(b, 0, 1)),
           ("cos", lambda b: b * r(b, 1, 1)), ("floor", lambda b: 4 * b + r(b, 0, 1)),
           ("ceil", lambda b: 4 * b - r(b, 1, 0)), ("sign", lambda b: b - r(b, 1, 0)),
           ("square", lambda b: b - r(b, 0, 1)), ("reciprocal", lambda b: b.abs() + 0.5),
       ]},
    "builtin_abs": (lambda b: abs(b * r(b, 1, 0)), lambda b: b.mul(r(b, 1, 0)).absolute()),
    "maximum": (lambda b: torch.maximum(b, r(b, 1, 1)), lambda b: b.maximum(r(b, 1, 1))),
    "minimum": (lambda b: torch.minimum(r(b, -1, -1), b), lambda b: r(b, -1, -1).minimum(b)),
    "clamp": (lambda b: torch.clamp(b * b, -0.5, 0.75), lambda b: b.mul(b).clamp(min=-0.5, max=0.75)),
    "clip": (lambda b: torch.clip(b * r(b, 1, 0), max=0.3), lambda b: b.mul(r(b, 1, 0)).clip(0.1)),
    **{f"where_{op}": (lambda b, op=op: torch.where(getattr(torch, op)(b, r(b, 1, 0)), b, 0.5 * r(b, -1, 0)),
                       lambda b, op=op: b.where(getattr(b, op)(0.25), -r(b, 0, 1)))
       for op in ("gt", "ge", "lt", "le", "eq", "ne")},
    "where_operators": (lambda b: torch.where(b > r(b, 1, 0), 1.5, b) + torch.where(b <= 0, b, -1.0),
                        lambda b: torch.where(b != r(b, 0, 1), b, 2.0) * torch.where(b == 0.5, b, r(b, 1, 1))),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("form", ["function", "method"])
@pytest.mark.parametrize("op", list(OPS))
def test_capture_reproduces_each_op(op, form, dtype):
    func = OPS[op][form == "method"]
    program = stencil.capture_program(func, (1, 1))
    assert program is not None and stencil.is_program(program)
    padded = torch.from_numpy(np.random.default_rng(41).standard_normal((19, 23))).to(dtype)
    # equal inputs in a few places, so the comparisons take both branches
    padded[3, 4:8] = 0.25
    padded[5, :] = 0.5
    want = func(padded)
    got = stencil.program_plain(program, padded)
    assert got.dtype == want.dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_capture_program_nodes():
    """The program's form: rolls become taps, scalars constants, equal
    nodes are shared, the result is last."""
    program = stencil.capture_program(pipelines.tanh_laplace, (1, 1))
    assert program == (("tap", -1, 0), ("tap", 1, 0), ("add", 0, 1), ("tap", 0, -1), ("add", 2, 3), ("tap", 0, 1),
                       ("add", 4, 5), ("const", 4), ("tap", 0, 0), ("mul", 7, 8), ("sub", 6, 9), ("tanh", 10))
    # a roll of a roll moves the offset twice; a roll of a non-linear value
    # moves its taps
    assert stencil.capture_program(lambda b: torch.tanh(torch.roll(torch.roll(b * b, 1, 0), 1, 1)), (1, 1)) == (
        ("tap", -1, -1), ("mul", 0, 0), ("tanh", 1))
    assert stencil.capture_program(lambda b: torch.roll(torch.tanh(b), -2, 0), (2, 0)) == (("tap", 2, 0), ("tanh", 0))
    # -0.0 and 0.0, and 2 and 2.0, stay apart
    p = stencil.capture_program(lambda b: torch.where(b > 0.0, b * 2, b * 2.0) - torch.where(b > -0.0, b, 1.0), (0, 0))
    assert ("const", 0.0) in p and ("const", -0.0) in p and ("const", 2) in p and ("const", 2.0) in p
    assert repr(p).count("'const', 0.0") == 1 and repr(p).count("'const', -0.0") == 1


def _too_long(b):
    out = b
    for _ in range(stencil.MAX_NODES):
        out = torch.tanh(out) + 1.0
    return out


@pytest.mark.parametrize(
    "func, depth",
    [
        (lambda b: torch.tanh(torch.roll(b, 2, 0)), (1, 1)),                      # a roll past the depth
        (lambda b: torch.tanh(torch.roll(torch.roll(b, 1, 0), 1, 0)), (1, 1)),    # rolls carried past it
        (lambda b: torch.tanh(torch.roll(b, 1, 1)), (1, 0)),
        (lambda b: torch.stack([b, torch.tanh(b)]).amax(0), (1, 1)),              # stack
        (lambda b: torch.cat([b[:1], torch.tanh(b[1:])]), (1, 1)),                # cat, slices
        (lambda b: torch.tanh(b[1:]), (1, 1)),                                    # a slice
        (lambda b: b * torch.ones(1), (1, 1)),                                    # a tensor constant
        (lambda b: torch.tanh(b).double(), (1, 1)),                               # a cast
        (lambda b: torch.tanh(b.to(torch.float16)), (1, 1)),
        (lambda b: torch.tanh(b) if b.sum() > 0 else b, (1, 1)),                  # control flow on values
        (lambda b: torch.tanh(b) * b.sum(), (1, 1)),                              # a reduction
        (lambda b: (b > 0) * b, (1, 1)),                                          # a comparison as a number
        (lambda b: torch.where(b > 0, 1.0, 0.0), (1, 1)),                         # no tensor branch
        (lambda b: torch.where(b, b, b), (1, 1)),                                 # a value as a condition
        (lambda b: torch.add(b, torch.tanh(b), alpha=2), (1, 1)),                 # a keyword
        (lambda b: torch.clamp(b * b), (1, 1)),                                   # clamp without bounds
        (lambda b: torch.clamp(b * b, min=b), (1, 1)),                            # a tensor bound
        (lambda b: torch.maximum(b * b, 0.5), (1, 1)),                            # maximum of a scalar
        (lambda b: 2.0 ** b, (1, 1)),                                             # a tensor exponent
        (lambda b: b ** b, (1, 1)),
        (lambda b: torch.tanh(b) + True, (1, 1)),                                 # a bool scalar
        (lambda b: torch.tanh(b) + 2**60, (1, 1)),                                # an int no float holds
        (lambda b: torch.tanh(b) * np.float32(2), (1, 1)),                        # a numpy scalar
        (lambda b: torch.erf(b), (1, 1)),                                         # an op it lacks
        (lambda b: torch.tanh(torch.roll(b, 1)), (1, 1)),                         # a flat roll
        (lambda b, c: b * c, (1, 1)),                                             # two inputs
        (_too_long, (1, 1)),                                                      # past MAX_NODES
    ],
)
def test_capture_program_declines(func, depth):
    assert stencil.capture_program(func, depth) is None


def test_program_within_the_cap_is_taken():
    def long(b):
        out = b
        for _ in range((stencil.MAX_NODES - 2) // 2):
            out = torch.tanh(out) + 1.0  # a shared constant, a tanh and an add a step
        return out

    program = stencil.capture_program(long, (0, 0))
    assert program is not None and len(program) <= stencil.MAX_NODES
    x = torch.randn(5, 6)
    assert torch.equal(stencil.program_plain(program, x), long(x))


def test_stencil_spec_prefers_taps():
    """A linear func keeps its tap list (and the window and tap-list
    kernels); a non-linear one takes a program."""
    assert stencil.stencil_spec(pipelines.laplace_roll, (1, 1)) == stencil.capture_taps(pipelines.laplace_roll, (1, 1))
    assert not stencil.is_program(stencil.stencil_spec(pipelines.laplace_roll, (1, 1)))
    assert stencil.is_program(stencil.stencil_spec(pipelines.max_filter3, (1, 1)))
    assert stencil.stencil_spec(lambda b: torch.stack([b]).sum(0), (1, 1)) is None


@pytest.mark.parametrize("kwargs, takes", [({"rate": 0.3}, True), ({"rate": 0.3, "limit": 0.01}, True),
                                           ({"bogus": 1}, False), ({}, True)])
def test_gate_binds_scalar_kwargs(kwargs, takes):
    spec = stencil.stencil_taps(2, "float32", ((1, 1), (1, 1)), ("reflect", "reflect"),
                                pipelines.limited_diffusion, kwargs)
    assert (spec is not None) == takes
    if takes:
        assert spec == stencil.capture_program(functools.partial(pipelines.limited_diffusion, **kwargs), (1, 1))


# ---------------------------------------------------------------------------
# against the JAX package: the port's map_overlap and the Pallas kernel
# ---------------------------------------------------------------------------


class _Torch:
    roll = staticmethod(lambda b, s, a: torch.roll(b, s, a))
    tanh, sqrt, maximum, where, abs, sign = torch.tanh, torch.sqrt, torch.maximum, torch.where, torch.abs, torch.sign
    minimum = torch.minimum
    clip = staticmethod(lambda v, lo, hi: torch.clip(v, lo, hi))
    relu = staticmethod(lambda v: torch.clamp(v, min=0.0))


class _Jax:
    roll = staticmethod(lambda b, s, a: jnp.roll(b, s, a))
    tanh, sqrt, maximum, where, abs, sign = jnp.tanh, jnp.sqrt, jnp.maximum, jnp.where, jnp.abs, jnp.sign
    minimum = jnp.minimum
    clip = staticmethod(lambda v, lo, hi: jnp.clip(v, lo, hi))
    relu = staticmethod(lambda v: jnp.clip(v, 0.0, None))


def make_func(xp, kind, s0, s1):
    """The non-linear funcs, written once for both packages, their rolls
    reaching (s0, s1); at (1, 1) the torch ones are
    ``models/pipelines.py``'s own programs."""
    roll = xp.roll

    def lap(b):
        return roll(b, s0, 0) + roll(b, -s0, 0) + roll(b, s1, 1) + roll(b, -s1, 1) - 4 * b

    def tanh_laplace(b):
        return xp.tanh(lap(b))

    def sobel(b):
        up, down = roll(b, s0, 0), roll(b, -s0, 0)
        gx = (roll(up, -s1, 1) + 2 * roll(b, -s1, 1) + roll(down, -s1, 1)
              - roll(up, s1, 1) - 2 * roll(b, s1, 1) - roll(down, s1, 1))
        gy = (roll(down, s1, 1) + 2 * down + roll(down, -s1, 1)
              - roll(up, s1, 1) - 2 * up - roll(up, -s1, 1))
        return xp.sqrt(gx * gx + gy * gy)

    def max_filter(b):
        out = b
        for dy in (-s0, 0, s0):
            for dx in (-s1, 0, s1):
                if dy or dx:
                    out = xp.maximum(out, roll(roll(b, dy, 0), dx, 1))
        return out

    def diffusion(b, rate=0.2, limit=0.05):
        d = rate * lap(b)
        return b + xp.where(xp.abs(d) > limit, xp.sign(d) * limit, d)

    def clipped(b):
        return xp.clip(lap(b), -1.0, 1.5)

    def shrink(b, t=0.1):
        v = lap(b)
        return xp.sign(v) * xp.relu(xp.abs(v) - t)

    return {"tanh_laplace": (tanh_laplace, {}), "sobel": (sobel, {}), "max_filter": (max_filter, {}),
            "diffusion": (diffusion, {"rate": 0.3, "limit": 0.1}), "clip": (clipped, {}),
            "shrink": (shrink, {"t": 0.25})}[kind]


KINDS = ["tanh_laplace", "sobel", "max_filter", "diffusion", "clip", "shrink"]
_NP = {"float32": np.float32, "float64": np.float64, "bfloat16": ml_dtypes.bfloat16, "float16": np.float16}


def _against_jax(kind, depth, boundary, dtype):
    x = np.random.default_rng(43).standard_normal((64, 96)).astype(_NP[dtype])
    tfunc, kw = make_func(_Torch, kind, *depth)
    jfunc, _ = make_func(_Jax, kind, *depth)
    got = tda.map_overlap(tfunc, tda.from_array(x, chunks=(16, 48)), depth={0: depth[0], 1: depth[1]},
                          boundary=boundary, **kw)
    assert isinstance(got.expr, BandStencil) and stencil.is_program(got.expr.taps)
    got = got.compute()
    with jconfig.set({"tpu.stencil-kernel": "interpret"}):
        ref = jda.map_overlap(jfunc, jda.from_array(x, chunks=(16, 48)), depth={0: depth[0], 1: depth[1]},
                              boundary=boundary, **kw)
        # the JAX package's gate takes float kinds: bfloat16 (ml_dtypes,
        # kind "V") keeps its Overlap route, which also rounds every op
        assert isinstance(ref.expr, JaxBandStencil) or dtype == "bfloat16"
        via_map_overlap = np.asarray(ref.compute())
    direct = np.asarray(jax_band_stencil_call(jnp.asarray(x), functools.partial(jfunc, **kw), depth,
                                              (boundary, boundary), band=16, interpret=True))
    assert got.dtype == via_map_overlap.dtype == direct.dtype == x.dtype
    return got, via_map_overlap, direct


@pytest.mark.parametrize("boundary", MODES, ids=str)
@pytest.mark.parametrize("depth", DEPTHS, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_map_overlap_matches_the_pallas_kernel_float32(kind, depth, boundary):
    got, via, direct = _against_jax(kind, depth, boundary, "float32")
    np.testing.assert_allclose(got, via, atol=1e-5)
    np.testing.assert_allclose(got, direct, atol=1e-5)


@pytest.mark.parametrize("depth", DEPTHS, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_map_overlap_matches_the_pallas_kernel_float64(kind, depth):
    boundary = MODES[(KINDS.index(kind) + DEPTHS.index(depth)) % len(MODES)]
    got, via, direct = _against_jax(kind, depth, boundary, "float64")
    np.testing.assert_allclose(got, via, atol=1e-12)
    np.testing.assert_allclose(got, direct, atol=1e-12)


@pytest.mark.parametrize("dtype, frac", [("bfloat16", 2.0**-5), ("float16", 2.0**-8)])
@pytest.mark.parametrize("kind", KINDS)
def test_map_overlap_matches_the_pallas_kernel_two_byte(kind, dtype, frac):
    boundary = MODES[KINDS.index(kind) % len(MODES)]
    got, via, direct = _against_jax(kind, (1, 1), boundary, dtype)
    f = [np.asarray(a, dtype=np.float64) for a in (got, via, direct)]
    atol = frac * max(1.0, float(np.abs(f[1]).max()))
    np.testing.assert_allclose(f[0], f[1], atol=atol)
    np.testing.assert_allclose(f[0], f[2], atol=atol)
    # the port rounds once: it is the float32 result rounded
    x = np.random.default_rng(43).standard_normal((64, 96)).astype(_NP[dtype])
    tfunc, kw = make_func(_Torch, kind, 1, 1)
    want = tda.map_overlap(tfunc, tda.from_array(x.astype(np.float32), chunks=(16, 48)), depth=1,
                           boundary=boundary, **kw).compute().astype(_NP[dtype])
    assert np.array_equal(got.view(np.uint16), want.view(np.uint16))


def test_pipeline_funcs_are_the_tested_programs():
    for kind, func in (("tanh_laplace", pipelines.tanh_laplace), ("sobel", pipelines.sobel_magnitude),
                       ("max_filter", pipelines.max_filter3)):
        made, _ = make_func(_Torch, kind, 1, 1)
        x = torch.randn(20, 30, dtype=torch.float64)
        assert torch.equal(made(x), func(x))
        assert stencil.capture_program(func, (1, 1)) is not None


# ---------------------------------------------------------------------------
# the routes: slices, a mesh, pickling, tokens
# ---------------------------------------------------------------------------


def _diffusion(x, **kw):
    return tda.map_overlap(pipelines.limited_diffusion, tda.from_array(x, chunks=(16, 24)), depth=1,
                           boundary="reflect", rate=0.3, limit=0.1, **kw)


@pytest.mark.parametrize("index", [np.s_[16:48, :], np.s_[:, 24:72], np.s_[16:32, 24:48], np.s_[:16, 70:]])
def test_slice_pushes_below_the_program(index):
    x = np.random.default_rng(44).standard_normal((64, 96)).astype(np.float32)
    arr = _diffusion(x)
    sliced = arr[index]
    plan = sliced.expr.simplify()
    (node,) = list(plan.find(BandStencil))
    assert stencil.is_program(node.taps) and node.array.shape != (64, 96)
    np.testing.assert_allclose(sliced.compute(), arr.compute()[index], rtol=1e-6, atol=1e-7)


def test_mesh_of_eight_cpu_slots_matches_the_walk(monkeypatch):
    from dask_array_tpu_torch.ops._overlap import overlap, trim_internal
    from dask_array_tpu_torch.parallel import Mesh, use_mesh

    calls = []
    real = stencil.band_stencil_call

    def counted(x, func, depth, boundary, spec):
        calls.append(stencil.is_program(spec))
        return real(x, func, depth, boundary, spec)

    monkeypatch.setattr(stencil, "band_stencil_call", counted)
    monkeypatch.setattr(_overlap, "band_stencil_call", counted)
    x = np.random.default_rng(45).standard_normal((64, 96)).astype(np.float32)
    mesh = Mesh(np.array(["cpu"] * 8, dtype=object), ("d",))
    arr = _diffusion(x)
    want = arr.compute()
    for lane in ("gspmd", "shard-map"):
        calls.clear()
        with use_mesh(mesh), tconfig.set({"execution-lane": lane}):
            got = arr.compute()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert calls and all(calls)
    # the shard lane's own stencil plan: overlap -> map_blocks -> trim
    # written out, the kernel (its plain version here) once a slot
    func = functools.partial(pipelines.limited_diffusion, rate=0.3, limit=0.1)
    e = trim_internal(overlap(tda.from_array(x, chunks=(8, 96)), 1, "nearest").map_blocks(func), 1, "nearest")
    want = e.compute()
    calls.clear()
    with use_mesh(mesh):
        got = e.compute()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert calls == [True] * 8


def test_program_expressions_pickle_and_tokenize():
    x = np.random.default_rng(46).standard_normal((64, 96)).astype(np.float32)
    arr = _diffusion(x)
    back = pickle.loads(pickle.dumps(arr))
    assert back.name == arr.name and back.expr.taps == arr.expr.taps
    np.testing.assert_array_equal(back.compute(), arr.compute())
    assert _diffusion(x).name == arr.name
    other = tda.map_overlap(pipelines.limited_diffusion, tda.from_array(x, chunks=(16, 24)), depth=1,
                            boundary="reflect", rate=0.3, limit=0.2)
    assert other.name != arr.name and other.expr.taps != arr.expr.taps
    tl = tda.map_overlap(pipelines.tanh_laplace, tda.from_array(x, chunks=(16, 24)), depth=1, boundary="reflect")
    assert tl.name == tda.map_overlap(pipelines.tanh_laplace, tda.from_array(x, chunks=(16, 24)), depth=1,
                                      boundary="reflect").name


def test_output_is_cast_to_the_meta_dtype():
    x = np.random.default_rng(47).standard_normal((32, 48)).astype(np.float32)
    got = tda.map_overlap(pipelines.tanh_laplace, tda.from_array(x, chunks=16), depth=1, boundary="reflect",
                          dtype="float64")
    assert isinstance(got.expr, BandStencil) and got.dtype == np.float64
    out = got.compute()
    assert out.dtype == np.float64
    want = tda.map_overlap(pipelines.tanh_laplace, tda.from_array(x, chunks=16), depth=1,
                           boundary="reflect").compute()
    np.testing.assert_array_equal(out, want.astype(np.float64))


# ---------------------------------------------------------------------------
# the emitter: deterministic text, and g++ evaluates it as program_plain
# ---------------------------------------------------------------------------


def test_emitted_source_is_deterministic():
    a = stencil.program_source(stencil.capture_program(pipelines.sobel_magnitude, (1, 1)), (1, 1), torch.bfloat16)
    b = stencil.program_source(stencil.capture_program(pipelines.sobel_magnitude, (1, 1)), (1, 1), torch.bfloat16)
    assert a == b and '#include "band_program.cuh"' in a and "using T = __nv_bfloat16;" in a
    assert "constexpr int D0 = 1, D1 = 1;" in a and "band_program_launch" in a
    c = stencil.program_source(stencil.capture_program(pipelines.sobel_magnitude, (1, 1)), (2, 1), torch.bfloat16)
    assert c != a and "constexpr int D0 = 2, D1 = 1;" in c


def test_emitter_takes_torch_cuda_arithmetic():
    """What the emitter writes for the ops whose CUDA form torch fixes:
    IEEE intrinsics, division by a scalar as a product with its float32
    inverse, NaN-propagating maximum, and exact scalars, which go by value
    in the parameter block (``program_scalars``)."""
    program = stencil.capture_program(
        lambda b: torch.maximum(b * b / 3.0, b) + torch.where(b > 0.1, 2.0 / (b * b), float("nan")), (0, 0))
    src, slots = stencil._emit(program, torch.float32)
    assert src == stencil.emit_program(program, torch.float32)
    assert "kSlots = 4;" in src and "__fmul_rn(v1, c[0])" in src
    assert "A v4 = max_any_nan(v3, v0);" in src and "const A s4 = max_first_nan(v3, v0);" in src
    assert "__fmul_rn(__fdiv_rn(1.0f, v1), c[2])" in src and "v6 ? v8 : c[3]" in src
    scalars = np.frombuffer(stencil.program_scalars(program, slots, torch.float32), np.float32)
    assert scalars[0] == np.float32(1) / np.float32(3) and scalars[1] == np.float32(0.1) and scalars[2] == 2.0
    assert scalars[3:].view(np.int32).tolist() == [2143289344]  # the NaN's float32 bits
    dprog = stencil.capture_program(lambda b: torch.tanh(b * b) / 3.0, (0, 0))
    dsrc, dslots = stencil._emit(dprog, torch.float64)
    assert "__dmul_rn(v2, c[0])" in dsrc and "tanh(v1)" in dsrc
    assert np.frombuffer(stencil.program_scalars(dprog, dslots, torch.float64), np.float64).tolist() == [1 / 3.0]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64], ids=str)
def test_programs_that_differ_in_scalars_share_a_source(dtype):
    """A func's scalars and keyword values are parameters, not code: one
    source (so one build) for every rate and limit of the diffusion step,
    each launch with its own scalars; a pow exponent is code."""
    def program(**kw):
        return stencil.capture_program(stencil.bind_kwargs(pipelines.limited_diffusion, kw), (1, 1))

    a, b = program(rate=0.2, limit=0.05), program(rate=0.3, limit=-0.0)
    assert a != b and stencil.program_source(a, (1, 1), dtype) == stencil.program_source(b, (1, 1), dtype)
    slots = stencil._emit(a, dtype)[1]
    assert slots == stencil._emit(b, dtype)[1] and len(slots) == 3
    sa, sb = (stencil.program_scalars(p, slots, dtype) for p in (a, b))
    assert sa != sb and len(sa) == len(sb) == 3 * (8 if dtype == torch.float64 else 4)
    pw = [stencil.capture_program(lambda b, e=e: b.abs() ** e, (0, 0)) for e in (1.5, 2.5)]
    assert stencil.program_source(pw[0], (0, 0), dtype) != stencil.program_source(pw[1], (0, 0), dtype)


_SHIM = r"""
#include <cmath>
#include <cstring>
#define __device__
#define __forceinline__ inline
#define __restrict__
template <typename T> struct Acc { using type = T; static T load(T v) { return v; } };
template <typename T> constexpr int kStride = STRIDE;
// the kernel's taps of one output, read from the padded block
struct Taps {
  const TYPE* p;
  template <int DY, int DX> TYPE at() const { return p[DY * STRIDE + DX]; }
};
// max.NaN / min.NaN: the canonical NaN where an operand is NaN
template <typename A> A max_any_nan(A a, A b) { return (a != a || b != b) ? A(NAN) : std::fmax(a, b); }
template <typename A> A min_any_nan(A a, A b) { return (a != a || b != b) ? A(NAN) : std::fmin(a, b); }
template <typename A> A max_first_nan(A a, A b) { return (a != a) ? a : ((b != b) ? b : std::fmax(a, b)); }
template <typename A> A min_first_nan(A a, A b) { return (a != a) ? a : ((b != b) ? b : std::fmin(a, b)); }
template <typename A> bool nan_or_zero(A v) { return !(std::fabs(v) > 0); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
inline double rsqrt(double a) { return 1.0 / std::sqrt(a); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline double __longlong_as_double(long long i) { double f; std::memcpy(&f, &i, 8); return f; }
using T = TYPE;
"""

_EVAL = r"""
extern "C" void eval_tile(const T* padded, T* out, int rows, int cols, int d0, int d1, const T* c) {
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < cols; ++j) out[i * cols + j] = Program::eval(Taps{padded + (i + d0) * STRIDE + (j + d1)}, c);
}
"""


def _host_eval(program, padded, depth, tmp_path):
    """The emitted functor compiled with g++ and run over the interior of
    ``padded``, with the program's scalars."""
    ctype = {torch.float32: "float", torch.float64: "double"}[padded.dtype]
    src = (_SHIM.replace("STRIDE", str(padded.shape[1])).replace("TYPE", ctype)
           + stencil.emit_program(program, padded.dtype) + _EVAL.replace("STRIDE", str(padded.shape[1])))
    (tmp_path / "prog.cpp").write_text(src)
    lib = tmp_path / "libprog.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(lib),
                    str(tmp_path / "prog.cpp")], check=True, capture_output=True)
    d0, d1 = depth
    rows, cols = padded.shape[0] - 2 * d0, padded.shape[1] - 2 * d1
    out = torch.empty((rows, cols), dtype=padded.dtype)
    p = padded.contiguous()
    scalars = stencil.program_scalars(program, stencil._emit(program, padded.dtype)[1], padded.dtype)
    ctypes.CDLL(str(lib)).eval_tile(ctypes.c_void_p(p.data_ptr()), ctypes.c_void_p(out.data_ptr()), rows, cols, d0, d1,
                                    ctypes.c_char_p(scalars))
    return out


def _exact(b):
    a, c = r(b, 2, 0), r(b, 0, -1)
    w = torch.where(a > b, torch.maximum(b, c), torch.minimum(a, c)) * 0.5
    return (w - torch.clamp(r(b, -2, 1), -0.5, 1.0) / 4.0 + torch.abs(b).floor() - torch.ceil(a) * torch.sign(c)
            + (-b) / (torch.abs(c) + 1) + torch.square(a - c) + (a - b) ** 3
            + torch.where(b <= c, b, -0.25))


def _transcendental(b):
    a, c = r(b, -2, 0), r(b, 0, 1)
    return (torch.tanh(a - c) + torch.exp(-b * b) + torch.log1p(c.abs()) + torch.sigmoid(a) + torch.cos(b)
            + torch.sin(c) + torch.log(a.abs() + 1) + torch.expm1(b * 0.25) + (b.abs() + 0.5) ** 1.3
            + torch.rsqrt(c * c + 1) + torch.sqrt(b * b + 1))


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ to build the host shim")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("which", ["exact", "transcendental"])
def test_emitted_program_evaluates_as_program_plain(tmp_path, which, dtype):
    func = _exact if which == "exact" else _transcendental
    depth = (2, 1)
    program = stencil.capture_program(func, depth)
    assert program is not None
    padded = torch.from_numpy(np.random.default_rng(48).standard_normal((21, 27))).to(dtype)
    got = _host_eval(program, padded, depth, tmp_path)
    want = stencil.program_plain(program, padded)[2:-2, 1:-1]
    if which == "exact":
        assert torch.equal(got, want)
    else:
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}[dtype]
        assert int((got.view(bits).long() - want.view(bits).long()).abs().max()) <= 4


# ---------------------------------------------------------------------------
# maximum/minimum chains: NaN, signed zeros and infinities
# ---------------------------------------------------------------------------


class _Np:
    roll = staticmethod(lambda b, s, a: np.roll(b, s, a))
    maximum, minimum = np.maximum, np.minimum


def extremum_filter(xp, which):
    """The 3x3 max (min) filter, a chain of eight ``maximum``
    (``minimum``) calls in ``max_filter3``'s order."""
    ext = xp.maximum if which == "max" else xp.minimum

    def f(b):
        out = b
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    out = ext(out, xp.roll(xp.roll(b, dy, 0), dx, 1))
        return out

    return f


_NP_PAD = {"reflect": {"mode": "symmetric"}, "nearest": {"mode": "edge"}, "periodic": {"mode": "wrap"},
           2.5: {"mode": "constant", "constant_values": 2.5}}


def special_values(shape, seed):
    """Normals with NaN, +0, -0, +inf and -inf each in a few percent of the
    places, and a block of NaN and one of -0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    pick = rng.random(shape)
    for i, v in enumerate((np.nan, 0.0, -0.0, np.inf, -np.inf)):
        x[(pick >= 0.04 * i) & (pick < 0.04 * i + 0.03)] = v
    x[10:13, 20:23] = np.nan
    x[30:33, 40:43] = -0.0
    return x


@pytest.mark.parametrize("boundary", ["reflect", "nearest", "periodic", 2.5], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "bfloat16"])
@pytest.mark.parametrize("which", ["max", "min"])
def test_extremum_filters_with_nan_zeros_and_inf(which, dtype, boundary):
    """The max and min filters of an input with NaN, ±0 and ±inf through
    the port's ``map_overlap`` (a program: its plain version here) equal
    the JAX package's ``map_overlap`` (the Pallas kernel in interpret mode;
    bfloat16 keeps the JAX package's Overlap route) and numpy's chain of
    ``maximum`` (``minimum``) on the padded array.  Tolerance 0: a maximum
    returns one of its operands; NaN in the same places (numpy's
    ``assert_array_equal`` takes -0 equal to +0)."""
    x = special_values((48, 64), 61).astype(_NP[dtype])
    got = tda.map_overlap(extremum_filter(_Torch, which), tda.from_array(x, chunks=(16, 32)), depth=1,
                          boundary=boundary)
    assert isinstance(got.expr, BandStencil) and stencil.is_program(got.expr.taps)
    got = got.compute()
    with jconfig.set({"tpu.stencil-kernel": "interpret"}):
        ref = np.asarray(jda.map_overlap(extremum_filter(_Jax, which), jda.from_array(x, chunks=(16, 32)), depth=1,
                                         boundary=boundary).compute())
    with np.errstate(invalid="ignore"):
        want = extremum_filter(_Np, which)(np.pad(x, 1, **_NP_PAD[boundary]))[1:-1, 1:-1]
    assert got.dtype == ref.dtype == want.dtype == x.dtype
    assert np.isnan(want.astype(np.float32)).any() and np.isinf(want.astype(np.float32)).any()
    np.testing.assert_array_equal(got.astype(np.float64), want.astype(np.float64))
    np.testing.assert_array_equal(ref.astype(np.float64), want.astype(np.float64))


def test_an_extremum_chain_is_one_fast_pass_and_one_nan_path():
    """A chain of ``maximum`` (``minimum``) nodes is emitted as one pass of
    the one-instruction NaN-propagating form, one test of its result (NaN
    or a zero), and the chain again in the plain order inside it; a value
    used outside the chain ends it (its own test)."""
    for which in ("max", "min"):
        program = stencil.capture_program(extremum_filter(_Torch, which), (1, 1))
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            src = stencil.emit_program(program, dtype)
            assert src.count(f"{which}_any_nan(") == 8 and src.count(f"{which}_first_nan(") == 8
            assert src.count("if (") == 1 and "    A v16 = " in src and "if (nan_or_zero(v16)) {" in src
    shared = stencil.capture_program(lambda b: torch.maximum(b, r(b, 1, 0)) * torch.minimum(
        torch.maximum(b, r(b, 1, 0)), r(b, 0, 1)), (1, 1))
    src = stencil.emit_program(shared, torch.float32)
    assert src.count("if (") == 2 and src.count("_any_nan(") == 2 and src.count("_first_nan(") == 2


# the functor lines of programs with no maximum or minimum, as the emitter
# wrote them before chains had a fast pass: the ops are unchanged, only the
# taps read from the thread's window
_NON_EXTREMUM_LINES = {
    "tanh_laplace": ["const A v2 = __fadd_rn(v0, v1);", "const A v4 = __fadd_rn(v2, v3);",
                     "const A v6 = __fadd_rn(v4, v5);", "const A v9 = __fmul_rn(c[0], v8);",
                     "const A v10 = __fsub_rn(v6, v9);", "const A v11 = tanhf(v10);"],
    "limited_diffusion": ["const A v4 = __fadd_rn(v2, v3);", "const A v6 = __fadd_rn(v4, v5);",
                          "const A v8 = __fadd_rn(v6, v7);", "const A v10 = __fmul_rn(c[0], v0);",
                          "const A v11 = __fsub_rn(v8, v10);", "const A v12 = __fmul_rn(c[1], v11);",
                          "const A v13 = fabsf(v12);", "const bool v15 = (v13 > c[2]);",
                          "const A v16 = static_cast<A>(static_cast<int>(A(0) < v12) - static_cast<int>(v12 < A(0)));",
                          "const A v17 = __fmul_rn(v16, c[2]);", "const A v18 = v15 ? v17 : v12;",
                          "const A v19 = __fadd_rn(v0, v18);"],
}


@pytest.mark.parametrize("name", list(_NON_EXTREMUM_LINES))
def test_a_program_without_extrema_keeps_its_ops(name):
    func = stencil.bind_kwargs(getattr(pipelines, name), {"rate": 0.2, "limit": 0.05} if "diffusion" in name else {})
    program = stencil.capture_program(func, (1, 1))
    lines = [ln.strip() for ln in stencil.emit_program(program, torch.float32).splitlines()]
    values = [ln for ln in lines if ln.startswith("const ") and "w.template at<" not in ln]
    taps = [ln for ln in lines if "w.template at<" in ln]
    assert values == _NON_EXTREMUM_LINES[name]
    assert len(taps) == sum(node[0] == "tap" for node in program)
    assert "_any_nan" not in "".join(lines) and "if (" not in "".join(lines)


def _first_nan_reference(which, padded):
    """The 3x3 filter of ``padded`` as torch's CUDA kernels compute a
    maximum (minimum): a NaN operand returned as it is, the first where
    both are NaN, by ``torch.where`` (which copies bits)."""
    ext = torch.maximum if which == "max" else torch.minimum

    def op(a, b):
        return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, ext(a, b)))

    out = padded
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = op(out, r(padded, dy, dx))
    return out[1:-1, 1:-1]


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ to build the host shim")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("which", ["max", "min"])
def test_emitted_chain_returns_the_first_nan_bits(tmp_path, which, dtype):
    """The emitted chain, compiled as host code (its fast pass giving the
    canonical NaN, as max.NaN does): where an operand is NaN the plain
    order runs and returns the first NaN operand's own bits, whatever its
    payload and sign; every other value, ±inf among them, is the chain's.
    (The sign of a zero is held to torch's CUDA kernels on the card,
    tests/test_torch_gpu.py: the host's fmax need not order ±0 as they
    do.)"""
    bits = {torch.float32: (torch.int32, np.int32, [0x7FC00001, -0x003FFFFE, 0x7FA00003, 0x7F800F00]),
            torch.float64: (torch.int64, np.int64, [0x7FF8000000000001, -0x0007FFFFFFFFFFFE, 0x7FF4000000000003,
                                                    0x7FF00000000F0000])}[dtype]
    padded = torch.from_numpy(special_values((26, 31), 62)).to(dtype)
    flat = padded.view(bits[0]).reshape(-1)
    nan_at = torch.nonzero(torch.isnan(padded).reshape(-1)).reshape(-1)
    flat[nan_at] = torch.from_numpy(np.array(bits[2], dtype=bits[1]))[torch.arange(len(nan_at)) % 4]
    program = stencil.capture_program(extremum_filter(_Torch, which), (1, 1))
    got = _host_eval(program, padded, (1, 1), tmp_path)
    want = _first_nan_reference(which, padded)
    nan = torch.isnan(want)
    assert nan.sum() > 9 and torch.isinf(want).any()
    assert torch.equal(torch.isnan(got), nan) and torch.equal(got.view(bits[0])[nan], want.view(bits[0])[nan])
    assert torch.equal(got[~nan], want[~nan])

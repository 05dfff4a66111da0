"""The port's ``random`` module and the random-input pipelines on the CPU.

A random leaf's values cannot be compared across packages: the JAX
package draws from JAX's counter-based PRNG, the port from torch's CPU (or
CUDA) generator.  So the port is held to the JAX package on everything
else, for every ``Generator`` method, every ``RandomState`` method and
every module-level function: shape, dtype, chunks, the ``seed`` operand
of the random leaf (the same sequence of draws from one seed), and the
errors for bad parameters.  Its values are held to the laws themselves:

- determinism: one seed, the same bytes; grid independence: chunks 7 and
  50 give the same bytes, and a rechunk is absorbed into the leaf;
- successive draws of one Generator differ;
- bounds of ``integers``: ``endpoint``, ``high = 2**63``, the unsigned
  dtypes up to 2**64;
- moments at a fixed seed: 2e5 draws, the sample mean within 6 standard
  errors of ``scipy.stats``' mean (SE = sqrt(var / n)) and the sample
  variance within 6 standard errors of its variance (SE = sqrt((kurtosis
  + 2) * var**2 / n), kurtosis the excess); parameters are chosen so the
  fourth moment is finite.  Continuous laws also pass a Kolmogorov-Smirnov
  test against the scipy CDF with p > 1e-4.

The JAX package runs through the same moment checks as a tie-breaker;
where it differs from numpy, ``KNOWN_REFERENCE_FAULTS`` lists the case and
``test_known_reference_faults_are_real`` shows the difference.  The
pipelines' random-input forms equal their numpy forms fed with the same
input's values, byte for byte.
"""

import re

import numpy as np
import pytest
import torch
from scipy import stats

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.models import pipelines as tpipes
from dask_array_tpu_torch.ops import _fancy_indexing
from dask_array_tpu_torch.ops.random import Random

torch.set_num_threads(1)

N = 200_000


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def leaf_seeds(x):
    """The ``seed`` operands of the random leaves under ``x``."""
    return [n.operand("seed") for n in x.expr.walk() if type(n).__name__ == "Random"]


def public_names(module, defined_in):
    return {n for n in dir(module) if not n.startswith("_")
            and getattr(getattr(module, n), "__module__", None) == defined_in}


def test_every_public_random_name_is_ported():
    want = public_names(jda.random, "dask_array_tpu.ops.random")
    assert len(want) == 46
    assert want - set(dir(tda.random)) == set()


# -- the port against the JAX package: everything but the values ---------------

# name -> call(generator, package): every Generator method at a small size
GENERATOR_CASES = {
    "random": lambda r, m: r.random(size=(5, 3), chunks=2),
    "random_float32": lambda r, m: r.random(size=(5, 3), dtype="float32", chunks=2),
    "uniform": lambda r, m: r.uniform(-1, 3, size=(5, 3), chunks=2),
    "normal": lambda r, m: r.normal(1, 2, size=(5, 3), chunks=2),
    "standard_normal": lambda r, m: r.standard_normal((5, 3), chunks=(2, 3)),
    "standard_normal_float32": lambda r, m: r.standard_normal((5, 3), dtype="float32", chunks=2),
    "integers": lambda r, m: r.integers(10, size=(5, 3), chunks=2),
    "integers_low_high": lambda r, m: r.integers(-5, 5, size=7, chunks=3),
    "integers_int8_endpoint": lambda r, m: r.integers(0, 9, size=(5, 3), dtype=np.int8, endpoint=True, chunks=2),
    "integers_uint32": lambda r, m: r.integers(0, 2**32 - 1, size=(5,), dtype=np.uint32),
    "beta": lambda r, m: r.beta(2, 3, size=(5, 3), chunks=2),
    "binomial": lambda r, m: r.binomial(10, 0.3, size=(5, 3), chunks=2),
    "chisquare": lambda r, m: r.chisquare(3, size=(5, 3), chunks=2),
    "exponential": lambda r, m: r.exponential(2, size=(5, 3), chunks=2),
    "standard_exponential": lambda r, m: r.standard_exponential((5, 3), chunks=2),
    "standard_exponential_float32": lambda r, m: r.standard_exponential((5, 3), dtype="float32"),
    "f": lambda r, m: r.f(5, 20, size=(5, 3), chunks=2),
    "gamma": lambda r, m: r.gamma(2.5, 1.5, size=(5, 3), chunks=2),
    "standard_gamma": lambda r, m: r.standard_gamma(2.5, size=(5, 3), chunks=2),
    "standard_gamma_float32": lambda r, m: r.standard_gamma(2.5, size=(5, 3), dtype="float32"),
    "geometric": lambda r, m: r.geometric(0.3, size=(5, 3), chunks=2),
    "gumbel": lambda r, m: r.gumbel(1, 2, size=(5, 3), chunks=2),
    "laplace": lambda r, m: r.laplace(1, 2, size=(5, 3), chunks=2),
    "logistic": lambda r, m: r.logistic(1, 2, size=(5, 3), chunks=2),
    "lognormal": lambda r, m: r.lognormal(0, 0.5, size=(5, 3), chunks=2),
    "negative_binomial": lambda r, m: r.negative_binomial(5, 0.4, size=(5, 3), chunks=2),
    "pareto": lambda r, m: r.pareto(5, size=(5, 3), chunks=2),
    "poisson": lambda r, m: r.poisson(4, size=(5, 3), chunks=2),
    "power": lambda r, m: r.power(3, size=(5, 3), chunks=2),
    "rayleigh": lambda r, m: r.rayleigh(2, size=(5, 3), chunks=2),
    "standard_cauchy": lambda r, m: r.standard_cauchy(size=(5, 3), chunks=2),
    "standard_t": lambda r, m: r.standard_t(8, size=(5, 3), chunks=2),
    "triangular": lambda r, m: r.triangular(0, 1, 3, size=(5, 3), chunks=2),
    "vonmises": lambda r, m: r.vonmises(0.5, 2, size=(5, 3), chunks=2),
    "wald": lambda r, m: r.wald(2, 3, size=(5, 3), chunks=2),
    "weibull": lambda r, m: r.weibull(2, size=(5, 3), chunks=2),
    "hypergeometric": lambda r, m: r.hypergeometric(20, 30, 10, size=(5, 3), chunks=2),
    "hypergeometric_complement": lambda r, m: r.hypergeometric(20, 30, 40, size=(5, 3), chunks=2),
    "logseries": lambda r, m: r.logseries(0.6, size=(5, 3), chunks=2),
    "multinomial": lambda r, m: r.multinomial(10, [0.2, 0.3, 0.5], size=(5, 2)),
    "multinomial_chunks": lambda r, m: r.multinomial(10, [0.2, 0.8], size=7, chunks=(3, 2)),
    "noncentral_chisquare": lambda r, m: r.noncentral_chisquare(3, 2, size=(5, 3), chunks=2),
    "noncentral_f": lambda r, m: r.noncentral_f(5, 20, 2, size=(5, 3), chunks=2),
    "zipf": lambda r, m: r.zipf(3, size=(5, 3), chunks=2),
    "multivariate_hypergeometric": lambda r, m: r.multivariate_hypergeometric([5, 10, 3], 6, size=4),
    "multivariate_normal": lambda r, m: r.multivariate_normal([0, 1], [[2, 0.5], [0.5, 1]], size=(4, 3), chunks=2),
    "permutation": lambda r, m: r.permutation(12, chunks=5),
    "permutation_array": lambda r, m: r.permutation(m.from_array(np.arange(24.0).reshape(8, 3), chunks=3)),
    "choice_int": lambda r, m: r.choice(10, size=6, chunks=4),
    "choice_no_replace": lambda r, m: r.choice(10, size=6, replace=False, chunks=4),
    "choice_p": lambda r, m: r.choice(5, size=(3, 2), p=[0.1, 0.2, 0.3, 0.2, 0.2]),
    "choice_array": lambda r, m: r.choice(m.from_array(np.arange(9.0) * 2, chunks=4), size=5),
}

# RandomState's methods (legacy numpy names) and its pass-through to Generator
STATE_CASES = {
    "random_sample": lambda s: s.random_sample((4, 3), chunks=2),
    "random": lambda s: s.random((4, 3)),
    "rand": lambda s: s.rand(4, 3, chunks=2),
    "randn": lambda s: s.randn(4, 3),
    "randint": lambda s: s.randint(0, 10, size=(4, 3), chunks=2),
    "randint_high_only": lambda s: s.randint(7, size=5),
    "random_integers": lambda s: s.random_integers(1, 6, size=(4, 3)),
    "normal": lambda s: s.normal(1, 2, size=5, chunks=2),
    "poisson": lambda s: s.poisson(3, size=5),
}

MODULE_FUNCTIONS = [
    "random_sample", "random", "uniform", "normal", "standard_normal", "integers", "beta", "binomial",
    "chisquare", "exponential", "standard_exponential", "f", "gamma", "standard_gamma", "geometric", "gumbel",
    "laplace", "logistic", "lognormal", "negative_binomial", "pareto", "poisson", "power", "rayleigh",
    "standard_cauchy", "standard_t", "triangular", "wald", "weibull", "permutation", "multivariate_normal",
    "vonmises", "hypergeometric", "logseries", "multinomial", "noncentral_chisquare", "noncentral_f", "zipf",
    "randint", "random_integers",
]

# the positional arguments of each module-level function at a small size
MODULE_ARGS = {
    "integers": (5, None, 4), "randint": (5, None, 4), "random_integers": (1, 5, 4), "beta": (2, 3, 4),
    "binomial": (10, 0.3, 4), "chisquare": (3, 4), "f": (5, 20, 4), "gamma": (2.0, 1.0, 4),
    "standard_gamma": (2.0, 4), "geometric": (0.3, 4), "negative_binomial": (5, 0.4, 4), "pareto": (5, 4),
    "power": (3, 4), "standard_t": (8, 4), "triangular": (0, 1, 3, 4), "wald": (2, 3, 4), "weibull": (2, 4),
    "permutation": (6,), "multivariate_normal": ([0, 1], [[1, 0], [0, 1]], 4), "vonmises": (0.5, 2, 4),
    "hypergeometric": (20, 30, 10, 4), "logseries": (0.6, 4), "multinomial": (10, [0.2, 0.8], 4),
    "noncentral_chisquare": (3, 2, 4), "noncentral_f": (5, 20, 2, 4), "zipf": (3, 4),
    "random_sample": (4,), "random": (4,), "standard_normal": (4,), "standard_exponential": (4,),
    "standard_cauchy": (4,),
}


def same_metadata(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype and got.chunks == want.chunks, (
        got.shape, want.shape, got.dtype, want.dtype, got.chunks, want.chunks)
    assert leaf_seeds(got) == leaf_seeds(want)
    value = got.compute()
    assert value.shape == got.shape and value.dtype == got.dtype


@pytest.mark.parametrize("name", sorted(GENERATOR_CASES))
def test_generator_method_matches_the_reference_but_for_values(name):
    call = GENERATOR_CASES[name]
    same_metadata(call(tda.random.default_rng(7), tda), call(jda.random.default_rng(7), jda))


@pytest.mark.parametrize("name", sorted(STATE_CASES))
def test_random_state_method_matches_the_reference_but_for_values(name):
    call = STATE_CASES[name]
    port, ref = tda.random.RandomState(5), jda.random.RandomState(5)
    same_metadata(call(port), call(ref))
    port.seed(9), ref.seed(9)
    same_metadata(call(port), call(ref))


@pytest.mark.parametrize("name", MODULE_FUNCTIONS)
def test_module_function_matches_the_reference_but_for_values(name):
    tda.random.seed(11), jda.random.seed(11)
    args = MODULE_ARGS.get(name, ())
    got, want = getattr(tda.random, name), getattr(jda.random, name)
    same_metadata(got(*args), want(*args))
    same_metadata(got(*args), want(*args))  # the second draw: the next seed


def test_one_generator_draws_the_reference_seed_sequence():
    port, ref = tda.random.default_rng(123), jda.random.default_rng(123)
    got = [leaf_seeds(port.normal(size=3)) for _ in range(4)] + [leaf_seeds(port.integers(5, size=2))]
    want = [leaf_seeds(ref.normal(size=3)) for _ in range(4)] + [leaf_seeds(ref.integers(5, size=2))]
    assert got == want and len({s[0] for s in got}) == 5
    assert tda.random.default_rng(port) is port
    # numpy's "auto" chunking through normalize_chunks
    assert port.random((3000, 3000)).chunks == ref.random((3000, 3000)).chunks


# the JAX package's checks on parameters: the same error type and message
ERROR_CASES = {
    "hypergeometric_nsample": lambda r, m: r.hypergeometric(5, 5, 11),
    "hypergeometric_array_nsample": lambda r, m: r.hypergeometric(5, 5, np.array([3])),
    "logseries_p": lambda r, m: r.logseries(1.0),
    "multinomial_pvals": lambda r, m: r.multinomial(5, [0.7, 0.7, 0.1]),
    "noncentral_chisquare_df": lambda r, m: r.noncentral_chisquare(0, 1),
    "noncentral_f_nonc": lambda r, m: r.noncentral_f(1, 2, -1),
    "zipf_a": lambda r, m: r.zipf(1.0),
    "mvhg_method": lambda r, m: r.multivariate_hypergeometric([2, 3], 2, method="x"),
    "mvhg_colors": lambda r, m: r.multivariate_hypergeometric([-1, 3], 2),
    "mvhg_array_nsample": lambda r, m: r.multivariate_hypergeometric([2, 3], np.array([2])),
    "mvhg_nsample": lambda r, m: r.multivariate_hypergeometric([2, 3], 6),
    "shuffle": lambda r, m: r.shuffle(m.ones(3, chunks=1)),
}


@pytest.mark.parametrize("name", sorted(ERROR_CASES))
def test_bad_parameters_raise_the_reference_errors(name):
    call = ERROR_CASES[name]
    with pytest.raises(Exception) as ref:
        call(jda.random.default_rng(0), jda)
    with pytest.raises(type(ref.value), match=re.escape(str(ref.value))):
        call(tda.random.default_rng(0), tda)


# numpy's checks that the JAX package lacks: the port raises numpy's error
NUMPY_ERROR_CASES = {
    "integers_low_ge_high": (lambda r: r.integers(5, 5, size=3), {}),
    "integers_endpoint_low_gt_high": (lambda r: r.integers(5, 4, size=3, endpoint=True), {}),
    "integers_high_out_of_bounds": (lambda r: r.integers(0, 300, size=3, dtype=np.uint8), {}),
    "integers_low_out_of_bounds": (lambda r: r.integers(-1, 5, size=3, dtype=np.uint8), {}),
    "integers_float_dtype": (lambda r: r.integers(0, 5, size=3, dtype=np.float64), {}),
    "multivariate_normal_shapes": (lambda r: r.multivariate_normal([0.0, 1.0], [[1.0]], size=3), {}),
}


@pytest.mark.parametrize("name", sorted(NUMPY_ERROR_CASES))
def test_bad_parameters_raise_numpys_errors(name):
    call, _ = NUMPY_ERROR_CASES[name]
    with pytest.raises(Exception) as want:
        call(np.random.default_rng(0))
    with pytest.raises(type(want.value), match=re.escape(str(want.value))):
        call(tda.random.default_rng(0))


# -- the values: determinism, grid independence, bounds -----------------------------


@pytest.mark.parametrize("name", sorted(GENERATOR_CASES))
def test_one_seed_gives_the_same_bytes(name):
    call = GENERATOR_CASES[name]
    a = call(tda.random.default_rng(42), tda).compute()
    b = call(tda.random.default_rng(42), tda).compute()
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["random", "normal", "integers", "gamma", "binomial", "vonmises", "zipf",
                                  "hypergeometric", "multinomial", "multivariate_normal"])
def test_values_do_not_depend_on_the_chunk_grid(name):
    def draw(chunks):
        r = tda.random.default_rng(3)
        args = {"integers": (0, 1000), "gamma": (2.0,), "binomial": (10, 0.3), "vonmises": (0.5, 2.0),
                "zipf": (3.0,), "hypergeometric": (20, 30, 10), "multinomial": (10, [0.2, 0.3, 0.5]),
                "multivariate_normal": ([0.0, 1.0], [[2.0, 0.5], [0.5, 1.0]])}.get(name, ())
        if name in ("multinomial", "multivariate_normal"):
            return getattr(r, name)(*args, size=100, chunks=(chunks, -1))
        return getattr(r, name)(*args, size=(100, 60), chunks=chunks)

    x7, x50 = draw(7), draw(50)
    assert x7.chunks != x50.chunks
    assert x7.compute().tobytes() == x50.compute().tobytes()
    # a rechunk keeps every value and is absorbed into the leaf
    y = x7.rechunk(13)
    assert isinstance(y.optimize().expr, Random) or any(isinstance(n, Random) for n in y.optimize().expr.walk())
    assert y.compute().tobytes() == x7.compute().tobytes()


def test_a_rechunk_becomes_the_leaf():
    x = tda.random.default_rng(1).standard_normal((40, 40), chunks=10)
    y = x.rechunk((8, 20)).optimize().expr
    assert isinstance(y, Random) and y.chunks == ((8,) * 5, (20, 20))


@pytest.mark.parametrize("name", ["random", "standard_normal", "integers", "poisson", "permutation"])
def test_successive_draws_differ(name):
    r = tda.random.default_rng(0)
    args = {"integers": (2**40, None, 1000), "poisson": (5.0, 1000), "permutation": (1000,)}.get(name, (1000,))
    a, b = getattr(r, name)(*args).compute(), getattr(r, name)(*args).compute()
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_a_large_draw_is_in_the_requested_dtype():
    """float32 draws are made in float32 (no float64 pass), float64 in
    float64: the fine bits below float32's resolution are there."""
    x = tda.random.default_rng(2).random(10_000).compute()
    assert x.dtype == np.float64 and np.any(x.astype(np.float32).astype(np.float64) != x)
    y = tda.random.default_rng(2).random(10_000, dtype="float32").compute()
    assert y.dtype == np.float32 and 0.0 <= y.min() and y.max() < 1.0


@pytest.mark.parametrize("low, high, dtype, endpoint", [
    (0, 4, np.int64, True),
    (-3, 3, np.int8, False),
    (0, 2**63, np.int64, False),
    (-(2**63), 2**63, np.int64, False),
    (0, 255, np.uint8, True),
    (0, 2**16, np.uint16, False),
    (2**31, 2**32, np.uint32, False),
    (0, 2**64, np.uint64, False),
    (2**63, 2**64 - 1, np.uint64, True),
    (0, 2**63 + 2**61, np.uint64, False),
    (0, 2, np.bool_, False),
])
def test_integers_stay_in_bounds(low, high, dtype, endpoint):
    _fancy_indexing.SYNCS = 0
    x = tda.random.default_rng(4).integers(low, high, size=20_000, dtype=dtype, endpoint=endpoint, chunks=5000)
    got = x.compute()
    assert got.dtype == np.dtype(dtype) and got.shape == (20_000,)
    top = high if endpoint else high - 1
    values = got.astype(object) if np.dtype(dtype).itemsize == 8 else got.astype(np.int64)
    assert min(values) >= low and max(values) <= top
    span = top - low + 1
    if span <= 16:
        assert len(set(values.tolist())) == span  # every value, the endpoint included, appears
    else:
        # the draws spread over the range: each quarter holds about a quarter
        quarters = np.bincount([min(int((v - low) * 4 // span), 3) for v in values], minlength=4)
        assert quarters.min() > 20_000 // 4 * 0.9
    # only a range wider than 2**63 - 1 and narrower than 2**64 rejects
    assert (_fancy_indexing.SYNCS > 0) == (2**63 <= span < 2**64)


# -- moments and the KS test -----------------------------------------------------------

# name -> (call of (generator, size), the scipy law, continuous)
LAWS = {
    "random": (lambda r, n: r.random(n), stats.uniform(), True),
    "random_float32": (lambda r, n: r.random(n, dtype="float32"), stats.uniform(), True),
    "uniform": (lambda r, n: r.uniform(-1, 3, n), stats.uniform(-1, 4), True),
    "normal": (lambda r, n: r.normal(1, 2, n), stats.norm(1, 2), True),
    "standard_normal": (lambda r, n: r.standard_normal(n), stats.norm(), True),
    "standard_normal_float32": (lambda r, n: r.standard_normal(n, dtype="float32"), stats.norm(), True),
    "integers": (lambda r, n: r.integers(-5, 12, n), stats.randint(-5, 12), False),
    "beta": (lambda r, n: r.beta(2, 3, n), stats.beta(2, 3), True),
    "binomial": (lambda r, n: r.binomial(10, 0.3, n), stats.binom(10, 0.3), False),
    "chisquare": (lambda r, n: r.chisquare(3, n), stats.chi2(3), True),
    "exponential": (lambda r, n: r.exponential(2, n), stats.expon(scale=2), True),
    "standard_exponential": (lambda r, n: r.standard_exponential(n), stats.expon(), True),
    "f": (lambda r, n: r.f(5, 20, n), stats.f(5, 20), True),
    "gamma": (lambda r, n: r.gamma(2.5, 1.5, n), stats.gamma(2.5, scale=1.5), True),
    "standard_gamma": (lambda r, n: r.standard_gamma(0.5, n), stats.gamma(0.5), True),
    "geometric": (lambda r, n: r.geometric(0.3, n), stats.geom(0.3), False),
    "gumbel": (lambda r, n: r.gumbel(1, 2, n), stats.gumbel_r(1, 2), True),
    "laplace": (lambda r, n: r.laplace(1, 2, n), stats.laplace(1, 2), True),
    "logistic": (lambda r, n: r.logistic(1, 2, n), stats.logistic(1, 2), True),
    "lognormal": (lambda r, n: r.lognormal(0.5, 0.25, n), stats.lognorm(0.25, scale=np.exp(0.5)), True),
    "negative_binomial": (lambda r, n: r.negative_binomial(5, 0.4, n), stats.nbinom(5, 0.4), False),
    "pareto": (lambda r, n: r.pareto(10, n), stats.lomax(10), True),
    "poisson": (lambda r, n: r.poisson(4, n), stats.poisson(4), False),
    "poisson_large": (lambda r, n: r.poisson(300, n), stats.poisson(300), False),
    "power": (lambda r, n: r.power(3, n), stats.powerlaw(3), True),
    "rayleigh": (lambda r, n: r.rayleigh(2, n), stats.rayleigh(scale=2), True),
    "standard_cauchy": (lambda r, n: r.standard_cauchy(n), stats.cauchy(), True),
    "standard_t": (lambda r, n: r.standard_t(10, n), stats.t(10), True),
    "triangular": (lambda r, n: r.triangular(0, 1, 3, n), stats.triang(1 / 3, 0, 3), True),
    "vonmises": (lambda r, n: r.vonmises(0.0, 2, n), stats.vonmises(2), True),
    "vonmises_small_kappa": (lambda r, n: r.vonmises(0.0, 1e-3, n), stats.vonmises(1e-3), True),
    "wald": (lambda r, n: r.wald(2, 3, n), stats.invgauss(2 / 3, scale=3), True),
    "weibull": (lambda r, n: r.weibull(2, n), stats.weibull_min(2), True),
    "hypergeometric": (lambda r, n: r.hypergeometric(20, 30, 10, n), stats.hypergeom(50, 20, 10), False),
    "hypergeometric_complement": (lambda r, n: r.hypergeometric(20, 30, 40, n), stats.hypergeom(50, 20, 40), False),
    "logseries": (lambda r, n: r.logseries(0.6, n), stats.logser(0.6), False),
    "noncentral_chisquare": (lambda r, n: r.noncentral_chisquare(3, 2, n), stats.ncx2(3, 2), True),
    "noncentral_f": (lambda r, n: r.noncentral_f(5, 20, 2, n), stats.ncf(5, 20, 2), True),
    "zipf": (lambda r, n: r.zipf(6, n), stats.zipf(6), False),
    "multinomial_0": (lambda r, n: r.multinomial(20, [0.2, 0.3, 0.5], n)[:, 0], stats.binom(20, 0.2), False),
    "multinomial_2": (lambda r, n: r.multinomial(20, [0.2, 0.3, 0.5], n)[:, 2], stats.binom(20, 0.5), False),
    "mvhg_0": (lambda r, n: r.multivariate_hypergeometric([5, 10, 15], 12, n)[:, 0],
               stats.hypergeom(30, 5, 12), False),
    "mvhg_2": (lambda r, n: r.multivariate_hypergeometric([5, 10, 15], 12, n)[:, 2],
               stats.hypergeom(30, 15, 12), False),
    "mvn_0": (lambda r, n: r.multivariate_normal([1.0, -2.0], [[2.0, 0.5], [0.5, 1.0]], n)[:, 0],
              stats.norm(1, np.sqrt(2)), True),
    "mvn_1": (lambda r, n: r.multivariate_normal([1.0, -2.0], [[2.0, 0.5], [0.5, 1.0]], n)[:, 1],
              stats.norm(-2, 1), True),
}

# the JAX package as tie-breaker: its draws that fail the same checks
KNOWN_REFERENCE_FAULTS = {
    # numpy's integers accepts these; the JAX package raises on compute
    "integers_2**63": "OverflowError",
    "integers_uint64_2**64": "OverflowError",
    # numpy refuses these; the JAX package draws without a check
    "integers_low_ge_high": "no error",
    "integers_high_out_of_bounds": "no error",
    "integers_low_out_of_bounds": "no error",
    # numpy samples a singular (positive semi-definite) cov by its SVD;
    # the JAX package's Cholesky factor gives NaN
    "multivariate_normal_singular": "NaN",
}


def check_law(sample, law, continuous):
    """Mean and variance within 6 standard errors of the law's; a KS test
    with p > 1e-4 for a continuous law (the Cauchy law: the KS test and
    its median only)."""
    sample = np.asarray(sample, dtype=np.float64)
    n = sample.size
    assert np.isfinite(sample).all()
    mean, var, kurt = (float(v) for v in law.stats(moments="mvk"))
    if np.isfinite(mean):
        assert abs(sample.mean() - mean) <= 6 * np.sqrt(var / n), (sample.mean(), mean)
        se_var = np.sqrt((kurt + 2) * var**2 / n)
        assert abs(sample.var() - var) <= 6 * se_var, (sample.var(), var)
    else:
        assert abs(np.median(sample)) <= 6 * np.pi / 2 / np.sqrt(n)
    if continuous:
        assert stats.kstest(sample, law.cdf).pvalue > 1e-4


@pytest.mark.parametrize("name", sorted(LAWS))
def test_port_draws_follow_the_law(name):
    call, law, continuous = LAWS[name]
    check_law(call(tda.random.default_rng(20240), N).compute(), law, continuous)


@pytest.mark.parametrize("name", sorted(LAWS))
def test_reference_draws_follow_the_law(name):
    """The tie-breaker: the JAX package passes the same checks."""
    call, law, continuous = LAWS[name]
    check_law(call(jda.random.default_rng(20240), N).compute(), law, continuous)


def test_multivariate_normal_covariance_and_a_singular_cov():
    cov = np.array([[2.0, 0.5], [0.5, 1.0]])
    x = tda.random.default_rng(8).multivariate_normal([1.0, -2.0], cov, N).compute()
    # the correlation's standard error is (1 - rho^2) / sqrt(n)
    rho, rho_hat = 0.5 / np.sqrt(2), np.corrcoef(x.T)[0, 1]
    assert abs(rho_hat - rho) <= 6 * (1 - rho**2) / np.sqrt(N)
    # a singular cov: numpy samples the line x1 = x0 + 1, off it by the
    # square root of a rounding-sized singular value (about 1e-8, numpy too)
    y = tda.random.default_rng(8).multivariate_normal([0.0, 1.0], [[1.0, 1.0], [1.0, 1.0]], 1000).compute()
    assert np.isfinite(y).all() and np.allclose(y[:, 1], y[:, 0] + 1, rtol=0, atol=1e-6)
    assert 0.8 < y[:, 0].std() < 1.2


def test_permutations_and_choices_are_what_they_say():
    r = tda.random.default_rng(5)
    assert sorted(r.permutation(50, chunks=7).compute().tolist()) == list(range(50))
    a = np.arange(40.0).reshape(10, 4)
    p = r.permutation(tda.from_array(a, chunks=3)).compute()
    assert sorted(p[:, 0].tolist()) == a[:, 0].tolist() and np.array_equal(p[:, 1], p[:, 0] + 1)
    c = r.choice(20, size=15, replace=False).compute()
    assert len(set(c.tolist())) == 15 and c.min() >= 0 and c.max() < 20
    assert set(r.choice(5, size=500, p=[0.5, 0, 0, 0, 0.5]).compute().tolist()) == {0, 4}
    assert set(r.choice(tda.from_array(np.array([3.0, 7.0]), chunks=1), size=50).compute().tolist()) <= {3.0, 7.0}


def test_rejection_samplers_count_their_host_syncs():
    _fancy_indexing.SYNCS = 0
    tda.random.default_rng(6).vonmises(0.5, 2, 5000).compute()
    rounds = _fancy_indexing.SYNCS
    assert 1 <= rounds <= 200
    _fancy_indexing.SYNCS = 0
    tda.random.default_rng(6).hypergeometric(20, 30, 10, 5000).compute()
    tda.random.default_rng(6).normal(size=5000).compute()
    assert _fancy_indexing.SYNCS == 0  # the urn and the plain laws never sync


def reference_fault(name):
    """Runs the JAX package's side of a fault; returns what it did."""
    r = jda.random.default_rng(0)
    if name == "integers_2**63":
        r.integers(0, 2**63, size=4).compute()
    elif name == "integers_uint64_2**64":
        r.integers(0, 2**64, size=4, dtype=np.uint64).compute()
    elif name == "integers_low_ge_high":
        r.integers(5, 5, size=4).compute()
    elif name == "integers_high_out_of_bounds":
        r.integers(0, 300, size=4, dtype=np.uint8).compute()
    elif name == "integers_low_out_of_bounds":
        r.integers(-1, 5, size=4, dtype=np.uint8).compute()
    elif name == "multivariate_normal_singular":
        return r.multivariate_normal([0.0, 1.0], [[1.0, 1.0], [1.0, 1.0]], 4).compute()
    return "no error"


@pytest.mark.parametrize("name", sorted(KNOWN_REFERENCE_FAULTS))
def test_known_reference_faults_are_real(name):
    """Each listed case does differ from numpy in the JAX package, and the
    port does what numpy does."""
    what = KNOWN_REFERENCE_FAULTS[name]
    if what == "OverflowError":
        with pytest.raises(OverflowError):
            reference_fault(name)
    elif what == "NaN":
        assert np.isnan(reference_fault(name)).all()
        assert np.isfinite(tda.random.default_rng(0).multivariate_normal(
            [0.0, 1.0], [[1.0, 1.0], [1.0, 1.0]], 4).compute()).all()
    else:
        assert reference_fault(name) == "no error"
        with pytest.raises(ValueError):
            NUMPY_ERROR_CASES[name][0](tda.random.default_rng(0))


# -- the pipelines: the random-input form against the numpy form ------------------


def _input(n0, n1, chunks, seed=0):
    return tda.random.default_rng(seed).standard_normal((n0, n1), dtype="float32", chunks=chunks).compute()


def test_reduction_tree_random_input_equals_the_numpy_form():
    got = tda.compute(*tpipes.reduction_tree(chunk=10, n=100))
    want = tda.compute(*tpipes.reduction_tree(chunk=10, x_np=_input(100, 100, 10)))
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("form", ["roll", "slices"])
def test_stencil2d_random_input_equals_the_numpy_form(form):
    got = tpipes.stencil2d(chunk=16, form=form, n=64, seed=3).compute()
    want = tpipes.stencil2d(chunk=16, form=form, x_np=_input(64, 64, 16, seed=3)).compute()
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("persist", [False, True])
def test_rechunk_relayout_random_input_equals_the_numpy_form(persist):
    got = tpipes.rechunk_relayout(chunk=16, persist=persist, n=64, seed=1)
    want = tpipes.rechunk_relayout(chunk=16, x_np=_input(64, 64, (16, 64), seed=1))
    assert got.chunks == want.chunks and got.compute().tobytes() == want.compute().tobytes()


def test_tall_skinny_svd_random_input_equals_the_numpy_form():
    got = tda.compute(*tpipes.tall_skinny_svd(chunk_rows=250, rows=2000, cols=16, seed=2))
    want = tda.compute(*tpipes.tall_skinny_svd(chunk_rows=250, x_np=_input(2000, 16, (250, 16), seed=2)))
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.tobytes() == w.tobytes()


def test_pipelines_draw_the_reference_inputs():
    """Without numpy input the port's pipelines draw what the JAX
    package's draw: the same shape, dtype, chunks and seed."""
    from dask_array_tpu.models import pipelines as jpipes

    pairs = [
        (tpipes.reduction_tree(chunk=10, n=100)[0], jpipes.reduction_tree(n=100, chunk=10)[0]),
        (tpipes.stencil2d(chunk=16, form="slices", n=64), jpipes.stencil2d(n=64, chunk=16, form="slices")),
        (tpipes.rechunk_relayout(chunk=16, n=64), jpipes.rechunk_relayout(n=64, chunk=16)),
        (tpipes.tall_skinny_svd(chunk_rows=250, rows=2000, cols=16)[1],
         jpipes.tall_skinny_svd(rows=2000, cols=16, chunk_rows=250)[1]),
    ]
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == want.dtype and got.chunks == want.chunks
        leaves = {(n.operand("seed"), n.chunks, str(n.dtype)) for n in got.expr.walk() if isinstance(n, Random)}
        ref = {(n.operand("seed"), n.chunks, str(n.dtype)) for n in want.expr.walk()
               if type(n).__name__ == "Random"}
        assert leaves == ref and len(leaves) == 1

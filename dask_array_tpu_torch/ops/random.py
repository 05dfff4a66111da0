"""Random number generation: Generator / default_rng / RandomState / choice.

Port of ``dask_array_tpu/ops/random.py``.  A ``Random`` leaf draws the
whole array in one call on the execution device, from an explicit
``torch.Generator`` of that device seeded with the leaf's ``seed``: values
depend only on ``(seed, shape, dtype, params)`` and the device, never on
the chunk grid, so a rechunk of a random array keeps its values and is
absorbed into the leaf.  The global RNG is never used.

One Generator's n-th draw has the same ``seed`` operand as the JAX
package's (``Generator._next_seed``), but the values differ: the CPU and
CUDA generators give different streams for one seed, and neither is JAX's.
The draw is in the requested dtype (Hopper has native float64; the JAX
package's float32 draws for float64 are a TPU setting).

The rejection samplers (vonmises, logseries, zipf, and ``integers`` over a
range wider than 2**63 - 1) resample only their rejected lanes and stop
when every lane is done, at most 200 rounds; each round reads ``done`` on
the host once (counted in ``ops._fancy_indexing.SYNCS``).  The urn samplers
(hypergeometric, multivariate_hypergeometric) take ``nsample`` rounds
without a sync.
"""

from __future__ import annotations

import functools
import math
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._chunks import cast, normalize_chunks
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr

_MAX_ROUNDS = 200  # a rejection loop's bound, as in the JAX package
_F64 = torch.float64


class Random(ArrayExpr):
    """A lazy random leaf: the whole array from one seeded generator."""

    _parameters = ("dist", "seed", "chunks_", "_dtype", "params")
    _defaults = {"params": ()}

    _fusable_leaf = True

    def _name_prefix(self):
        return f"random-{self.dist}"

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks_), dtype=self._dtype)

    def _build(self, ctx):
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(self.seed)
        dtype = np.dtype(self._dtype)
        draw = _Draw(gen, tuple(int(s) for s in self.shape), ctx.device)
        dense = _SAMPLERS[self.dist](draw, dtype, dict(self.params or ()))
        return BlockView(self.chunks_, dense=cast(dense, dtype))

    def _accept_rechunk(self, target_chunks):
        # values are chunk-grid-independent: absorb rechunks outright
        return type(self)(self.dist, self.seed, tuple(target_chunks), self._dtype, self.params)


class _Draw:
    """The generator, shape and device of one leaf's draws."""

    def __init__(self, gen, shape, device):
        self.gen, self.shape, self.device = gen, shape, device

    def empty(self, dtype=_F64, shape=None):
        return torch.empty(self.shape if shape is None else shape, dtype=dtype, device=self.device)

    def full(self, value, dtype=_F64, shape=None):
        return torch.full(self.shape if shape is None else shape, value, dtype=dtype, device=self.device)

    def uniform(self, dtype=_F64, shape=None):
        """[0, 1)."""
        return torch.rand(self.shape if shape is None else shape, generator=self.gen, dtype=dtype,
                          device=self.device)

    def open_uniform(self, dtype=_F64, floor=None):
        """(0, 1): a 0 becomes ``floor`` (the smallest normal number)."""
        return self.uniform(dtype).clamp_min_(torch.finfo(dtype).tiny if floor is None else floor)

    def normal(self, dtype=_F64, shape=None):
        return torch.randn(self.shape if shape is None else shape, generator=self.gen, dtype=dtype,
                           device=self.device)

    def exponential(self, dtype=_F64):
        return self.empty(dtype).exponential_(generator=self.gen)

    def gamma(self, alpha, dtype=_F64):
        """Standard gamma of shape ``alpha`` (a number or a tensor)."""
        if not isinstance(alpha, torch.Tensor):
            alpha = self.full(float(alpha), dtype)
        return torch._standard_gamma(alpha.to(dtype), generator=self.gen)

    def chisquare(self, df, dtype=_F64):
        return 2.0 * self.gamma(df / 2.0, dtype)

    def poisson(self, lam):
        if not isinstance(lam, torch.Tensor):
            lam = self.full(float(lam))
        return torch.poisson(lam.to(_F64), generator=self.gen)

    def binomial(self, n, p, shape=None):
        n = n if isinstance(n, torch.Tensor) else self.full(float(n), shape=shape)
        p = p if isinstance(p, torch.Tensor) else self.full(float(p), shape=shape)
        return torch.binomial(n.to(_F64), p.to(_F64), generator=self.gen)

    def rejection(self, body, init):
        """Lane-wise rejection: ``body()`` gives (value, accepted); a lane
        keeps its first accepted value.  One host read of ``done`` a
        round, at most ``_MAX_ROUNDS`` rounds."""
        from dask_array_tpu_torch.ops._fancy_indexing import count_sync

        out = init
        done = torch.zeros(self.shape, dtype=torch.bool, device=self.device)
        for _ in range(_MAX_ROUNDS):
            val, acc = body()
            out = torch.where(~done & acc, val, out)
            done |= acc
            count_sync()
            if bool(done.all()):
                break
        return out


def _t(dtype):
    """The torch dtype a float distribution is drawn in: the requested
    float dtype, float64 for an integer one."""
    from dask_array_tpu_torch._chunks import torch_dtype

    return torch_dtype(dtype) if dtype.kind == "f" else _F64


def _integer_offsets(d, span):
    """Uniform int64 bits of [0, span) read as unsigned, span <= 2**64."""
    if span <= 2**63 - 1:
        return torch.randint(0, span, d.shape, generator=d.gen, dtype=torch.int64, device=d.device)
    bits = lambda: d.empty(torch.int64).random_(-(2**63), None, generator=d.gen)  # noqa: E731 (all 64 bits)
    if span == 2**64:
        return bits()
    # 2**63 <= span < 2**64: accept bits below span (unsigned), at least
    # half of them each round; unsigned order is signed order of x ^ 2**63
    limit = span - 2**63

    def body():
        b = bits()
        return b, (b ^ torch.iinfo(torch.int64).min) < limit

    return d.rejection(body, d.full(0, torch.int64))


def _integers(d, dtype, p):
    low, high = p["low"], p["high"]
    offsets = _integer_offsets(d, high - low)
    start = (low + 2**63) % 2**64 - 2**63  # low's two's-complement bits
    return offsets + start  # wraps modulo 2**64: the bits of low + offset


def _vonmises(d, dtype, p):
    # Best & Fisher (1979), numpy's algorithm, in the JAX package's stable
    # form: rho = (tau - sqrt(2 tau)) / (2 k) cancels for small k
    t = _t(dtype)
    kappa = d.full(p["kappa"], t)
    safe_k = kappa.clamp_min(1e-7)
    s = torch.sqrt(1.0 + 4.0 * safe_k * safe_k)
    tau = 1.0 + s
    rho = 2.0 * safe_k * tau / ((s + 1.0) * (tau + torch.sqrt(2.0 * tau)))
    r = (1.0 + rho * rho) / (2.0 * rho)

    def body():
        u1 = d.uniform(t)
        u2 = d.open_uniform(t, floor=1e-12)
        z = torch.cos(math.pi * u1)
        fc = (1.0 + r * z) / (r + z)
        c = safe_k * (r - fc)
        return fc, (c * (2.0 - c) - u2 > 0.0) | (torch.log(c / u2) + 1.0 - c >= 0.0)

    f = d.rejection(body, d.full(0.0, t))
    u3 = d.uniform(t)
    mu = p["mu"]
    theta = mu + torch.sign(u3 - 0.5) * torch.arccos(f.clamp(-1.0, 1.0))
    # kappa ~ 0 degenerates to the uniform circle
    theta = torch.where(kappa < 1e-6, (2.0 * u3 - 1.0) * math.pi + mu, theta)
    # numpy returns samples wrapped onto [-pi, pi]
    return torch.remainder(theta + math.pi, 2.0 * math.pi) - math.pi


def _hypergeometric(d, dtype, p):
    # exact sequential urn draws, one Bernoulli(good / total) a round
    good = d.full(float(p["ngood"]))
    total = good + float(p["nbad"])
    cnt = d.full(0.0)
    for _ in range(int(p["nsample"])):
        take = (d.uniform() * total < good).to(_F64)
        good, total, cnt = good - take, total - 1.0, cnt + take
    return cnt


def _logseries(d, dtype, p):
    # numpy's rk_logseries rejection, lane-wise
    pp = p["p"]
    r = math.log1p(-pp)

    def body():
        v = d.open_uniform(floor=1e-300)
        u = d.open_uniform(floor=1e-300)
        q = -torch.expm1(r * u)
        in_q2 = v <= q * q
        res_q2 = torch.floor(1.0 + torch.log(v) / torch.log(q))
        bad = in_q2 & (res_q2 < 1.0)
        val = torch.where(in_q2, res_q2, torch.where(v >= q, 1.0, 2.0))
        val = torch.where(v >= pp, 1.0, val)
        return val, (v >= pp) | ~bad

    return d.rejection(body, d.full(1.0))


def _multinomial(d, dtype, p):
    # the conditional-binomial chain over the categories (the last axis)
    pvals = p["pvals"]
    base = d.shape[:-1]
    remaining = d.full(float(p["n"]), shape=base)
    rem_p = 1.0
    outs = []
    for pi in pvals[:-1]:
        cond_p = min(max(pi / max(rem_p, 1e-300), 0.0), 1.0)
        x = d.binomial(remaining, cond_p, shape=base)
        outs.append(x)
        remaining = remaining - x
        rem_p = rem_p - pi
    outs.append(remaining)
    return torch.stack(outs, dim=-1)


def _noncentral_chisquare(d, dtype, df, nonc):
    # Poisson mixture: ncx2(df, nonc) == chisq(df + 2 * Poisson(nonc / 2))
    i = d.poisson(nonc / 2.0)
    return 2.0 * d.gamma(df / 2.0 + i)


def _multivariate_hypergeometric(d, dtype, p):
    # an exact k-colour urn: nsample draws, each taking the colour whose
    # interval of the cumulative remaining counts holds u * total.  The
    # cumulative counts are one small product with an upper-triangular
    # matrix of ones (exact: integer counts), not a scan along the short
    # last axis, which the card runs one row at a time
    k = int(p["k"])
    base = d.shape[:-1]
    rem = torch.tensor(p["colors"], dtype=_F64, device=d.device).expand(base + (k,)).clone()
    cnt = torch.zeros(base + (k,), dtype=_F64, device=d.device)
    upper = torch.triu(torch.ones((k, k), dtype=_F64, device=d.device))
    for _ in range(int(p["nsample"])):
        cum = rem @ upper
        x = d.uniform(shape=base)[..., None] * cum[..., -1:]
        pick = ((cum - rem <= x) & (x < cum)).to(_F64)
        rem, cnt = rem - pick, cnt + pick
    return cnt


def _zipf(d, dtype, p):
    # Devroye's rejection (numpy's rk_zipf), lane-wise
    am1 = p["a"] - 1.0
    b = 2.0**am1

    def body():
        u = 1.0 - d.uniform()
        v = d.uniform()
        x = torch.floor(u ** (-1.0 / am1))
        in_range = (x >= 1.0) & (x < 2.0**62)
        t = (1.0 + 1.0 / x) ** am1
        return x, in_range & (v * x * (t - 1.0) / (b - 1.0) <= t / b)

    return d.rejection(body, d.full(1.0))


def _multivariate_normal(d, dtype, p):
    # numpy's factor: x = z @ (sqrt(s)[:, None] * v) + mean, (u, s, v) the
    # SVD of cov, so a singular (positive semi-definite) cov is sampled
    mean = torch.tensor(p["mean"], dtype=_F64, device=d.device)
    cov = torch.tensor(p["cov"], dtype=_F64, device=d.device)
    _, s, vh = torch.linalg.svd(cov)
    z = d.normal()
    return z @ (torch.sqrt(s)[:, None] * vh) + mean


def _wald(d, dtype, p):
    # numpy's rk_wald: IG(mean, scale)
    mu, lam = p["mean"], p["scale"]
    y = mu * d.normal() ** 2
    x = mu + mu / (2.0 * lam) * (y - torch.sqrt(4.0 * lam * y + y * y))
    u = d.uniform()
    return torch.where(u <= mu / (mu + x), x, mu * mu / x)


def _triangular(d, dtype, p):
    left, mode, right = p["left"], p["mode"], p["right"]
    base, left_base, right_base = right - left, mode - left, right - mode
    u = d.uniform()
    lo = left + torch.sqrt(u * base * left_base)
    hi = right - torch.sqrt((1.0 - u) * base * right_base)
    return torch.where(u <= left_base / base, lo, hi)


_SAMPLERS = {
    "random": lambda d, dt, p: d.uniform(_t(dt)),
    "uniform": lambda d, dt, p: d.empty(_t(dt)).uniform_(p.get("low", 0.0), p.get("high", 1.0), generator=d.gen),
    "normal": lambda d, dt, p: p.get("loc", 0.0) + p.get("scale", 1.0) * d.normal(_t(dt)),
    "standard_normal": lambda d, dt, p: d.normal(_t(dt)),
    "integers": _integers,
    "beta": lambda d, dt, p: (lambda x, y: x / (x + y))(d.gamma(p["a"], _t(dt)), d.gamma(p["b"], _t(dt))),
    "binomial": lambda d, dt, p: d.binomial(p["n"], p["p"]),
    "chisquare": lambda d, dt, p: d.chisquare(p["df"], _t(dt)),
    "exponential": lambda d, dt, p: p.get("scale", 1.0) * d.exponential(_t(dt)),
    "standard_exponential": lambda d, dt, p: d.exponential(_t(dt)),
    "f": lambda d, dt, p: (d.chisquare(p["dfnum"], _t(dt)) / p["dfnum"]) / (d.chisquare(p["dfden"], _t(dt)) / p["dfden"]),
    "gamma": lambda d, dt, p: p.get("scale", 1.0) * d.gamma(p["shape"], _t(dt)),
    "standard_gamma": lambda d, dt, p: d.gamma(p["shape"], _t(dt)),
    "geometric": lambda d, dt, p: d.empty().geometric_(p["p"], generator=d.gen),
    "gumbel": lambda d, dt, p: p.get("loc", 0.0) - p.get("scale", 1.0) * torch.log(
        d.exponential(_t(dt)).clamp_min_(torch.finfo(_t(dt)).tiny)),
    "laplace": lambda d, dt, p: p.get("loc", 0.0) + p.get("scale", 1.0) * (
        d.exponential(_t(dt)) - d.exponential(_t(dt))),
    "logistic": lambda d, dt, p: p.get("loc", 0.0) + p.get("scale", 1.0) * (
        lambda u: torch.log(u) - torch.log1p(-u))(d.open_uniform(_t(dt))),
    "lognormal": lambda d, dt, p: d.empty(_t(dt)).log_normal_(p.get("mean", 0.0), p.get("sigma", 1.0), generator=d.gen),
    "pareto": lambda d, dt, p: torch.expm1(d.exponential(_t(dt)) / p["a"]),
    "poisson": lambda d, dt, p: d.poisson(p.get("lam", 1.0)),
    "power": lambda d, dt, p: d.uniform(_t(dt)) ** (1.0 / p["a"]),
    "rayleigh": lambda d, dt, p: p.get("scale", 1.0) * torch.sqrt(2.0 * d.exponential(_t(dt))),
    "standard_cauchy": lambda d, dt, p: d.empty(_t(dt)).cauchy_(generator=d.gen),
    "standard_t": lambda d, dt, p: d.normal(_t(dt)) / torch.sqrt(d.chisquare(p["df"], _t(dt)) / p["df"]),
    "triangular": _triangular,
    "wald": _wald,
    "weibull": lambda d, dt, p: d.exponential(_t(dt)) ** (1.0 / p["a"]),
    "vonmises": _vonmises,
    "negative_binomial": lambda d, dt, p: d.poisson(d.gamma(p["n"]) * (1.0 - p["p"]) / p["p"]),
    "multivariate_normal": _multivariate_normal,
    "permutation_kernel": lambda d, dt, p: torch.randperm(p["n"], generator=d.gen, device=d.device),
    "hypergeometric": _hypergeometric,
    "logseries": _logseries,
    "multinomial": _multinomial,
    "noncentral_chisquare": lambda d, dt, p: _noncentral_chisquare(d, dt, p["df"], p["nonc"]),
    "noncentral_f": lambda d, dt, p: (_noncentral_chisquare(d, dt, p["dfnum"], p["nonc"]) / p["dfnum"])
    / (d.chisquare(p["dfden"]) / p["dfden"]),
    "multivariate_hypergeometric": _multivariate_hypergeometric,
    "zipf": _zipf,
}


def _size_tuple(size):
    if size is None:
        return ()
    if isinstance(size, Integral):
        return (int(size),)
    return tuple(int(s) for s in size)


class Generator:
    """numpy.random.Generator-style API over device-drawn random leaves."""

    def __init__(self, seed=None):
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2**63))
        self._seed = int(seed) % (2**63)
        self._counter = 0

    def _next_seed(self):
        # each draw gets a distinct stream (like advancing a bit-generator)
        s = (self._seed * 1000003 + self._counter) % (2**63)
        self._counter += 1
        return s

    def _draw(self, dist, size, dtype, chunks="auto", **params):
        from dask_array_tpu_torch._collection import new_collection

        size = _size_tuple(size)
        dtype = np.dtype(dtype)
        ch = normalize_chunks(chunks, size, dtype=dtype)
        norm = tuple(sorted(
            (k, tuple(np.asarray(v).ravel().tolist()) if isinstance(v, (list, np.ndarray)) else v)
            for k, v in params.items()
        ))
        return new_collection(Random(dist, self._next_seed(), ch, dtype, norm))

    # -- distributions ------------------------------------------------------

    def random(self, size=None, dtype=float, chunks="auto", **kw):
        return self._draw("random", size, dtype, chunks)

    def uniform(self, low=0.0, high=1.0, size=None, chunks="auto", **kw):
        return self._draw("uniform", size, float, chunks, low=float(low), high=float(high))

    def normal(self, loc=0.0, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("normal", size, float, chunks, loc=float(loc), scale=float(scale))

    def standard_normal(self, size=None, dtype=float, chunks="auto", **kw):
        return self._draw("standard_normal", size, dtype, chunks)

    def integers(self, low, high=None, size=None, dtype=np.int64, endpoint=False, chunks="auto", **kw):
        if high is None:
            low, high = 0, low
        low, high = int(low), int(high)
        if endpoint:
            high = high + 1
        # numpy's checks (the JAX package clamps instead)
        dt = np.dtype(dtype)
        info = np.iinfo(dt) if dt.kind in "iu" else np.iinfo(np.uint8) if dt.kind == "b" else None
        if info is None:
            raise TypeError(f"Unsupported dtype {dt!r} for integers")
        top = 1 if dt.kind == "b" else int(info.max)
        if low < int(info.min):
            raise ValueError("low is out of bounds for " + dt.name)
        if high - 1 > top:
            raise ValueError("high is out of bounds for " + dt.name)
        if low >= high:
            raise ValueError("low >= high" if not endpoint else "low > high")
        return self._draw("integers", size, dtype, chunks, low=low, high=high)

    def beta(self, a, b, size=None, chunks="auto", **kw):
        return self._draw("beta", size, float, chunks, a=float(a), b=float(b))

    def binomial(self, n, p, size=None, chunks="auto", **kw):
        return self._draw("binomial", size, np.int64, chunks, n=float(n), p=float(p))

    def chisquare(self, df, size=None, chunks="auto", **kw):
        return self._draw("chisquare", size, float, chunks, df=float(df))

    def exponential(self, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("exponential", size, float, chunks, scale=float(scale))

    def standard_exponential(self, size=None, dtype=float, chunks="auto", **kw):
        return self._draw("standard_exponential", size, dtype, chunks)

    def f(self, dfnum, dfden, size=None, chunks="auto", **kw):
        return self._draw("f", size, float, chunks, dfnum=float(dfnum), dfden=float(dfden))

    def gamma(self, shape, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("gamma", size, float, chunks, shape=float(shape), scale=float(scale))

    def standard_gamma(self, shape, size=None, dtype=float, chunks="auto", **kw):
        return self._draw("standard_gamma", size, dtype, chunks, shape=float(shape))

    def geometric(self, p, size=None, chunks="auto", **kw):
        return self._draw("geometric", size, np.int64, chunks, p=float(p))

    def gumbel(self, loc=0.0, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("gumbel", size, float, chunks, loc=float(loc), scale=float(scale))

    def laplace(self, loc=0.0, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("laplace", size, float, chunks, loc=float(loc), scale=float(scale))

    def logistic(self, loc=0.0, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("logistic", size, float, chunks, loc=float(loc), scale=float(scale))

    def lognormal(self, mean=0.0, sigma=1.0, size=None, chunks="auto", **kw):
        return self._draw("lognormal", size, float, chunks, mean=float(mean), sigma=float(sigma))

    def negative_binomial(self, n, p, size=None, chunks="auto", **kw):
        return self._draw("negative_binomial", size, np.int64, chunks, n=float(n), p=float(p))

    def pareto(self, a, size=None, chunks="auto", **kw):
        return self._draw("pareto", size, float, chunks, a=float(a))

    def poisson(self, lam=1.0, size=None, chunks="auto", **kw):
        return self._draw("poisson", size, np.int64, chunks, lam=float(lam))

    def power(self, a, size=None, chunks="auto", **kw):
        return self._draw("power", size, float, chunks, a=float(a))

    def rayleigh(self, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("rayleigh", size, float, chunks, scale=float(scale))

    def standard_cauchy(self, size=None, chunks="auto", **kw):
        return self._draw("standard_cauchy", size, float, chunks)

    def standard_t(self, df, size=None, chunks="auto", **kw):
        return self._draw("standard_t", size, float, chunks, df=float(df))

    def triangular(self, left, mode, right, size=None, chunks="auto", **kw):
        return self._draw("triangular", size, float, chunks, left=float(left), mode=float(mode), right=float(right))

    def vonmises(self, mu, kappa, size=None, chunks="auto", **kw):
        return self._draw("vonmises", size, float, chunks, mu=float(mu), kappa=float(kappa))

    def wald(self, mean, scale, size=None, chunks="auto", **kw):
        return self._draw("wald", size, float, chunks, mean=float(mean), scale=float(scale))

    def weibull(self, a, size=None, chunks="auto", **kw):
        return self._draw("weibull", size, float, chunks, a=float(a))

    def hypergeometric(self, ngood, nbad, nsample, size=None, chunks="auto", **kw):
        if not isinstance(nsample, Integral):
            raise NotImplementedError("array-valued nsample is not supported")
        ngood, nbad, nsample = int(ngood), int(nbad), int(nsample)
        total = ngood + nbad
        if nsample > total:
            raise ValueError("ngood + nbad < nsample")
        if nsample > total // 2:
            # the urn takes nsample rounds: sample the COMPLEMENT (the same
            # distribution, good_in_sample = ngood - good_in_rest)
            rest = self._draw(
                "hypergeometric", size, np.int64, chunks,
                ngood=ngood, nbad=nbad, nsample=total - nsample,
            )
            return ngood - rest
        return self._draw(
            "hypergeometric", size, np.int64, chunks,
            ngood=ngood, nbad=nbad, nsample=nsample,
        )

    def logseries(self, p, size=None, chunks="auto", **kw):
        if not 0.0 < float(p) < 1.0:
            raise ValueError("p must be in (0, 1)")
        return self._draw("logseries", size, np.int64, chunks, p=float(p))

    def multinomial(self, n, pvals, size=None, chunks="auto", **kw):
        pvals = tuple(float(v) for v in np.asarray(pvals).ravel())
        if np.sum(pvals[:-1]) > 1.0 + 1e-12:
            raise ValueError("sum(pvals[:-1]) > 1.0")
        k = len(pvals)
        size = _size_tuple(size)
        if chunks == "auto":
            chunks = ("auto",) * len(size) + (k,)  # categories stay one block
        return self._draw("multinomial", size + (k,), np.int64, chunks, n=int(n), pvals=pvals, k=k)

    def noncentral_chisquare(self, df, nonc, size=None, chunks="auto", **kw):
        if float(df) <= 0 or float(nonc) < 0:
            raise ValueError("df must be > 0, nonc >= 0")
        return self._draw("noncentral_chisquare", size, float, chunks, df=float(df), nonc=float(nonc))

    def noncentral_f(self, dfnum, dfden, nonc, size=None, chunks="auto", **kw):
        if float(dfnum) <= 0 or float(dfden) <= 0 or float(nonc) < 0:
            raise ValueError("dfnum/dfden must be > 0, nonc >= 0")
        return self._draw(
            "noncentral_f", size, float, chunks,
            dfnum=float(dfnum), dfden=float(dfden), nonc=float(nonc),
        )

    def zipf(self, a, size=None, chunks="auto", **kw):
        if float(a) <= 1.0:
            raise ValueError("a must be > 1")
        return self._draw("zipf", size, np.int64, chunks, a=float(a))

    def multivariate_hypergeometric(self, colors, nsample, size=None, method="marginals", chunks="auto", **kw):
        if method not in ("marginals", "count"):
            raise ValueError(f"method must be 'marginals' or 'count', got {method!r}")
        colors = tuple(int(c) for c in np.asarray(colors).ravel())
        if any(c < 0 for c in colors):
            raise ValueError("colors must be non-negative")
        if not isinstance(nsample, Integral):
            raise NotImplementedError("array-valued nsample is not supported")
        if int(nsample) > sum(colors):
            raise ValueError("nsample > sum(colors)")
        k = len(colors)
        size = _size_tuple(size)
        if chunks == "auto":
            chunks = ("auto",) * len(size) + (k,)
        return self._draw(
            "multivariate_hypergeometric", size + (k,), np.int64, chunks,
            colors=colors, nsample=int(nsample), k=k,
        )

    def multivariate_normal(self, mean, cov, size=None, chunks="auto", **kw):
        from dask_array_tpu_torch._collection import new_collection

        mean = np.asarray(mean, dtype="f8")
        cov = np.asarray(cov, dtype="f8")
        # numpy's shape checks
        if mean.ndim != 1:
            raise ValueError("mean must be 1 dimensional")
        if cov.ndim != 2 or cov.shape[0] != cov.shape[1]:
            raise ValueError("cov must be 2 dimensional and square")
        if mean.shape[0] != cov.shape[0]:
            raise ValueError("mean and cov must have same length")
        full = _size_tuple(size) + (mean.shape[0],)
        ch = normalize_chunks(chunks, full, dtype=np.dtype("f8"))
        params = (("cov", tuple(map(tuple, cov.tolist()))), ("mean", tuple(mean.tolist())))
        return new_collection(Random("multivariate_normal", self._next_seed(), ch, np.dtype("f8"), params))

    def permutation(self, x, chunks="auto"):
        from dask_array_tpu_torch._collection import new_collection
        from dask_array_tpu_torch.ops._fancy_indexing import take

        if isinstance(x, Integral):
            n = int(x)
            ch = normalize_chunks(chunks, (n,), dtype=np.dtype(np.int64))
            return new_collection(Random("permutation_kernel", self._next_seed(), ch, np.dtype(np.int64), (("n", n),)))
        idx = self.permutation(x.shape[0] if hasattr(x, "shape") else len(x))
        return take(x, np.asarray(idx.compute()), axis=0)

    def choice(self, a, size=None, replace=True, p=None, chunks="auto"):
        return choice(a, size=size, replace=replace, p=p, chunks=chunks, rng=self)

    def shuffle(self, x):
        raise NotImplementedError("in-place shuffle is not supported; use permutation()")


def default_rng(seed=None):
    if isinstance(seed, Generator):
        return seed
    return Generator(seed)


def choice(a, size=None, replace=True, p=None, chunks="auto", rng=None):
    from dask_array_tpu_torch.ops._fancy_indexing import take
    from dask_array_tpu_torch.ops._from_array import asarray, from_array

    rng = rng or Generator()
    if isinstance(a, Integral):
        n = int(a)
        if replace and p is None:
            return rng.integers(0, n, size=size, chunks=chunks)
        idx_np = np.random.default_rng(rng._next_seed()).choice(n, size=size, replace=replace, p=p)
        return from_array(idx_np, chunks=chunks)
    a = asarray(a)
    idx = choice(a.shape[0], size=size, replace=replace, p=p, chunks=chunks, rng=rng)
    return take(a, np.asarray(idx.compute()).ravel(), axis=0)


class RandomState:
    """Legacy numpy.random.RandomState-style API."""

    def __init__(self, seed=None):
        self._g = Generator(seed)

    def seed(self, seed=None):
        self._g = Generator(seed)

    def random_sample(self, size=None, chunks="auto"):
        return self._g.random(size=size, chunks=chunks)

    random = random_sample

    def rand(self, *size, chunks="auto"):
        return self._g.random(size=size or None, chunks=chunks)

    def randn(self, *size, chunks="auto"):
        return self._g.standard_normal(size=size or None, chunks=chunks)

    def randint(self, low, high=None, size=None, dtype=int, chunks="auto"):
        return self._g.integers(low, high, size=size, dtype=dtype, chunks=chunks)

    def random_integers(self, low, high=None, size=None, chunks="auto"):
        return self._g.integers(low, high, size=size, endpoint=True, chunks=chunks)

    def __getattr__(self, name):
        g = object.__getattribute__(self, "_g")
        attr = getattr(g, name, None)
        if attr is None:
            raise AttributeError(name)
        return attr


_default = None


def _module_rng():
    global _default
    if _default is None:
        _default = Generator(0xDA5C)
    return _default


# module-level convenience functions (numpy.random's namespace)
def _module_fn(name):
    def fn(*args, **kwargs):
        return getattr(_module_rng(), name)(*args, **kwargs)

    fn.__name__ = name
    return fn


random_sample = _module_fn("random")
random = _module_fn("random")
uniform = _module_fn("uniform")
normal = _module_fn("normal")
standard_normal = _module_fn("standard_normal")
integers = _module_fn("integers")
beta = _module_fn("beta")
binomial = _module_fn("binomial")
chisquare = _module_fn("chisquare")
exponential = _module_fn("exponential")
standard_exponential = _module_fn("standard_exponential")
f = _module_fn("f")
gamma = _module_fn("gamma")
standard_gamma = _module_fn("standard_gamma")
geometric = _module_fn("geometric")
gumbel = _module_fn("gumbel")
laplace = _module_fn("laplace")
logistic = _module_fn("logistic")
lognormal = _module_fn("lognormal")
negative_binomial = _module_fn("negative_binomial")
pareto = _module_fn("pareto")
poisson = _module_fn("poisson")
power = _module_fn("power")
rayleigh = _module_fn("rayleigh")
standard_cauchy = _module_fn("standard_cauchy")
standard_t = _module_fn("standard_t")
triangular = _module_fn("triangular")
wald = _module_fn("wald")
weibull = _module_fn("weibull")
permutation = _module_fn("permutation")
multivariate_normal = _module_fn("multivariate_normal")
vonmises = _module_fn("vonmises")
hypergeometric = _module_fn("hypergeometric")
logseries = _module_fn("logseries")
multinomial = _module_fn("multinomial")
noncentral_chisquare = _module_fn("noncentral_chisquare")
noncentral_f = _module_fn("noncentral_f")
zipf = _module_fn("zipf")


def randint(low, high=None, size=None, dtype=int, chunks="auto"):
    """Legacy exclusive-endpoint randint."""
    return _module_rng().integers(low, high, size=size, dtype=dtype, chunks=chunks)


def random_integers(low, high=None, size=None, chunks="auto"):
    """Legacy inclusive-endpoint randint."""
    return _module_rng().integers(low, high, size=size, endpoint=True, chunks=chunks)


def seed(seed=None):
    """Re-seed the module-level generator (legacy np.random.seed)."""
    global _default
    _default = Generator(seed)

"""Port parity: ``mx.np.linalg`` and ``mx.np.random``, JAX package ->
PyTorch port.

``np.linalg``: the cases of ``tests/test_linalg.py`` through both packages
(on the CPU): results of the same structure (the reference's
NamedTuples, field for field), shapes and dtypes exactly; values within
rtol 1e-4 + atol 1e-5 (float32; LAPACK and XLA factor in another order),
factorizations whose signs or phases are conventions compared by their
invariants (``q r`` and ``|r|``, ``u s vh``, sorted eigenvalues), the rank
exactly; gradients of ``det``, ``slogdet``, ``inv``, ``solve``, ``norm``
and ``cholesky`` against the JAX package's ``autograd`` at rtol 1e-4 +
atol 1e-5, and against central differences (``check_numeric_gradient``,
float64). ``eig`` / ``eigvals`` run on the host and come back on the
input's device.

``np.random``: the streams cannot match (threefry against Philox / MT), so
each sampler is held by its surface, shape and dtype equal to the
reference's for the same call, seed reproducibility, an explicit
``torch.Generator``, and its distribution: moments within 5 standard
errors at 20000 draws and, for uniform, normal, exponential and randint,
the chi-square test of ``verify_generator`` (5 repeats of 4000 draws, 8
buckets).
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch.test_utils import (assert_almost_equal,
                                        check_numeric_gradient,
                                        gen_buckets_probs_with_ppf,
                                        verify_generator)

from test_op_coverage import REF_RANDOM

torch.set_num_threads(2)

RNG = onp.random.RandomState(7)
A = (RNG.randn(4, 4) + 2 * onp.eye(4)).astype(onp.float32)
_B = RNG.randn(4, 4).astype(onp.float32)
SPD = (_B @ _B.T + 4 * onp.eye(4)).astype(onp.float32)
RECT = RNG.randn(5, 3).astype(onp.float32)
T3 = (RNG.randn(2, 3, 6) + 1.0).astype(onp.float32)
TS = (RNG.randn(6, 2, 3) + onp.eye(6).reshape(6, 2, 3)).astype(onp.float32)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _match(got, want, name, rtol=1e-4, atol=1e-5):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), name
        assert getattr(got, "_fields", None) == getattr(want, "_fields",
                                                        None), name
        for i, (g, w) in enumerate(zip(got, want)):
            _match(g, w, f"{name}[{i}]", rtol, atol)
        return
    w = want.asnumpy()
    tol = (rtol, atol) if w.dtype.kind in "fc" else (0, 0)
    assert_almost_equal(got, w, rtol=tol[0], atol=tol[1], names=(name, "jax"),
                        check_dtype=True)


def _both(fn):
    want = fn(mx.np)
    got = fn(tnp)
    return got, want


# -- values ----------------------------------------------------------------------

UNIQUE = {
    "det": lambda np: np.linalg.det(np.array(A)),
    "inv": lambda np: np.linalg.inv(np.array(A)),
    "solve": lambda np: np.linalg.solve(np.array(A), np.array(RECT[:4])),
    "solve_vector": lambda np: np.linalg.solve(np.array(A),
                                               np.array(RECT[:4, 0])),
    "cholesky": lambda np: np.linalg.cholesky(np.array(SPD)),
    "slogdet": lambda np: np.linalg.slogdet(np.array(A)),
    "eigvalsh": lambda np: np.linalg.eigvalsh(np.array(SPD)),
    "svd_values": lambda np: np.linalg.svd(np.array(RECT), compute_uv=False),
    "pinv": lambda np: np.linalg.pinv(np.array(RECT)),
    "lstsq": lambda np: np.linalg.lstsq(np.array(RECT),
                                        np.array(RECT[:, 0] + 1), rcond=None),
    "lstsq_matrix": lambda np: np.linalg.lstsq(np.array(RECT),
                                               np.array(RECT[:, :2] * 2),
                                               rcond=None),
    "matrix_power": lambda np: np.linalg.matrix_power(np.array(A), 3),
    "matrix_power_neg": lambda np: np.linalg.matrix_power(np.array(A), -2),
    "matrix_power_int": lambda np: np.linalg.matrix_power(
        np.array([[1, 2], [3, 4]]), 2),
    "matrix_rank": lambda np: np.linalg.matrix_rank(np.array(
        onp.outer(onp.arange(4.0), onp.arange(4.0)).astype(onp.float32))),
    "matrix_rank_full": lambda np: np.linalg.matrix_rank(np.array(A)),
    "multi_dot": lambda np: np.linalg.multi_dot(
        [np.array(RECT), np.array(RECT.T), np.array(RECT)]),
    "tensorinv": lambda np: np.linalg.tensorinv(np.array(T3), ind=2),
    "tensorsolve": lambda np: np.linalg.tensorsolve(np.array(TS),
                                                    np.array(RECT[:, 0].tolist()
                                                             + [1.0])),
    "det_int": lambda np: np.linalg.det(np.array([[1, 2], [3, 4]])),
    "inv_int": lambda np: np.linalg.inv(np.array([[1, 2], [3, 4]])),
    "norm_vector_axis": lambda np: np.linalg.norm(np.array(RECT), axis=1),
    "norm_keepdims": lambda np: np.linalg.norm(np.array(RECT), axis=0,
                                               keepdims=True),
    "norm_int": lambda np: np.linalg.norm(np.array([3, 4])),
}


@pytest.mark.parametrize("name", sorted(UNIQUE))
def test_linalg_values_match_jax(name):
    got, want = _both(UNIQUE[name])
    _match(got, want, name)


@pytest.mark.parametrize("ord_", [None, 1, 2, -2, onp.inf, -onp.inf, "fro",
                                  "nuc"])
def test_norm_orders_match_jax(ord_):
    got, want = _both(lambda np: np.linalg.norm(np.array(A), ord=ord_))
    _match(got, want, f"norm {ord_}")


def test_qr_matches_jax_up_to_signs():
    for mode in ("reduced", "complete"):
        got, want = _both(lambda np: np.linalg.qr(np.array(RECT), mode=mode))
        assert got._fields == want._fields == ("Q", "R")
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
        q, r = (x.asnumpy() for x in got)
        onp.testing.assert_allclose(q @ r, RECT, atol=1e-5)
        onp.testing.assert_allclose(onp.abs(r), onp.abs(want.R.asnumpy()),
                                    rtol=1e-4, atol=1e-5)


def test_svd_matches_jax_up_to_signs():
    for full in (True, False):
        got, want = _both(lambda np: np.linalg.svd(np.array(RECT),
                                                   full_matrices=full))
        assert got._fields == want._fields == ("U", "S", "Vh")
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
        u, s, vh = (x.asnumpy() for x in got)
        onp.testing.assert_allclose(s, want.S.asnumpy(), rtol=1e-5)
        k = s.shape[0]
        onp.testing.assert_allclose(u[:, :k] * s @ vh[:k], RECT, atol=1e-5)


def test_eigh_matches_jax():
    got, want = _both(lambda np: np.linalg.eigh(np.array(SPD)))
    assert got._fields == want._fields
    _match(got.eigenvalues, want.eigenvalues, "eigh values")
    w, v = got.eigenvalues.asnumpy(), got.eigenvectors.asnumpy()
    onp.testing.assert_allclose(SPD @ v, v * w, atol=1e-4)


def test_eig_runs_on_the_host_and_matches_jax():
    """General eig / eigvals: complex64 results, on the input's device, the
    eigenvalues equal to the reference's as a sorted set."""
    got, want = _both(lambda np: np.linalg.eig(np.array(A)))
    assert got._fields == want._fields == ("eigenvalues", "eigenvectors")
    assert str(got[0].dtype) == str(want[0].dtype) == "complex64"
    assert got[0].ctx == tmx.cpu()
    gv, wv = (onp.sort_complex(x.eigenvalues.asnumpy()) for x in (got, want))
    onp.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5)
    w, v = got.eigenvalues.asnumpy(), got.eigenvectors.asnumpy()
    onp.testing.assert_allclose(A @ v, v * w, atol=1e-4)
    ev, ewant = _both(lambda np: np.linalg.eigvals(np.array(A)))
    onp.testing.assert_allclose(onp.sort_complex(ev.asnumpy()),
                                onp.sort_complex(ewant.asnumpy()),
                                rtol=1e-4, atol=1e-5)


# -- gradients ---------------------------------------------------------------------

GRADS = {
    "det": (lambda np, xs: np.linalg.det(xs[0]), A[:3, :3]),
    "slogdet": (lambda np, xs: np.linalg.slogdet(xs[0])[1], SPD[:3, :3]),
    "inv": (lambda np, xs: np.linalg.inv(xs[0]).sum(), A[:3, :3]),
    "solve": (lambda np, xs: np.linalg.solve(xs[0], np.array(
        RECT[:3, 0])).sum(), A[:3, :3]),
    "norm": (lambda np, xs: np.linalg.norm(xs[0]), A[:3, :3]),
    "cholesky": (lambda np, xs: np.linalg.cholesky(
        xs[0] @ xs[0].T + 3 * np.eye(3)).sum(), RECT[:3]),
}


@pytest.mark.parametrize("name", sorted(GRADS))
def test_linalg_gradients_match_jax(name):
    f, x0 = GRADS[name]
    grads = []
    for m in (mx, tmx):
        x = m.np.array(x0)
        x.attach_grad()
        with m.autograd.record():
            y = f(m.np, [x])
        y.backward()
        grads.append(x.grad)
    _match(grads[1], grads[0], f"d{name}")
    check_numeric_gradient(lambda xs: f(tnp, xs), [tnp.array(x0)],
                           eps=1e-4, rtol=1e-3, atol=1e-4)


# -- random ------------------------------------------------------------------------

CALLS = {
    "uniform": lambda r: r.uniform(size=(2, 3)),
    "uniform_scalar": lambda r: r.uniform(),
    "normal": lambda r: r.normal(size=4),
    "normal_f16": lambda r: r.normal(size=4, dtype="float16"),
    "randn": lambda r: r.randn(2, 3),
    "rand": lambda r: r.rand(2, 3),
    "randint": lambda r: r.randint(0, 10, size=(5,)),
    "randint_high": lambda r: r.randint(5, size=(5,)),
    "randint_scalar": lambda r: r.randint(5),
    "choice_int": lambda r: r.choice(5, size=(3,)),
    "choice_array": lambda r: r.choice(r.uniform(size=(3,)), size=(2,)),
    "choice_p": lambda r: r.choice(5, size=(3,), p=onp.full(5, 0.2)),
    "choice_no_replace": lambda r: r.choice(5, size=(3,), replace=False),
    "choice_scalar": lambda r: r.choice(5),
    "permutation_int": lambda r: r.permutation(5),
    "multinomial": lambda r: r.multinomial(10, [0.2, 0.8]),
    "multinomial_size": lambda r: r.multinomial(10, [0.2, 0.3, 0.5],
                                                size=(4,)),
    "bernoulli": lambda r: r.bernoulli(0.3, size=(3,)),
    "gamma": lambda r: r.gamma(2.0, 1.0, size=(3,)),
    "gamma_scalar": lambda r: r.gamma(2.0),
    "beta": lambda r: r.beta(2.0, 3.0, size=(3,)),
    "beta_scalar": lambda r: r.beta(2.0, 3.0),
    "exponential": lambda r: r.exponential(2.0, size=(3,)),
    "poisson": lambda r: r.poisson(3.0, size=(3,)),
    "poisson_scalar": lambda r: r.poisson(3.0),
    "laplace": lambda r: r.laplace(size=(3,)),
    "gumbel": lambda r: r.gumbel(size=(3,)),
    "lognormal": lambda r: r.lognormal(size=(3,)),
    "chisquare": lambda r: r.chisquare(3.0, size=(3,)),
    "chisquare_scalar": lambda r: r.chisquare(3.0),
    "rayleigh": lambda r: r.rayleigh(size=(3,)),
    "weibull": lambda r: r.weibull(2.0, size=(3,)),
    "pareto": lambda r: r.pareto(2.0, size=(3,)),
    "pareto_scalar": lambda r: r.pareto(2.0),
    "power": lambda r: r.power(2.0, size=(3,)),
    "logistic": lambda r: r.logistic(size=(3,)),
    "f": lambda r: r.f(2.0, 3.0, size=(3,)),
    "f_scalar": lambda r: r.f(2.0, 3.0),
    "multivariate_normal": lambda r: r.multivariate_normal(
        onp.zeros(2), onp.eye(2), size=(5,)),
    "multivariate_normal_one": lambda r: r.multivariate_normal(
        onp.zeros(2), onp.eye(2)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_sampler_shape_and_dtype_match_jax(name):
    want = CALLS[name](mx.np.random)
    got = CALLS[name](tnp.random)
    assert got.shape == want.shape, name
    assert str(got.dtype) == str(want.dtype), name


def test_every_reference_sampler_is_exercised():
    called = {n for n in REF_RANDOM if any(c == n or c.startswith(n + "_")
                                           for c in CALLS)}
    assert set(REF_RANDOM) - {"shuffle"} == called


def test_seed_reproducibility_and_explicit_generators():
    for name in ("uniform", "normal", "gamma", "poisson", "choice_p",
                 "multinomial", "permutation_int", "laplace"):
        tmx.random.seed(3)
        a = CALLS[name](tnp.random).asnumpy()
        tnp.random.seed(3)
        b = CALLS[name](tnp.random).asnumpy()
        onp.testing.assert_array_equal(a, b, err_msg=name)
    g1, g2 = tmx.random.generator(5), tmx.random.generator(5)
    a = tnp.random.normal(size=(8,), generator=g1).asnumpy()
    b = tnp.random.normal(size=(8,), generator=g2).asnumpy()
    onp.testing.assert_array_equal(a, b)


def test_shuffle_rebinds_and_permutes():
    for m in (mx, tmx):
        x = m.np.arange(12).reshape(6, 2)
        v = x.version
        m.np.random.shuffle(x)
        assert x.version == v + 1 and x.dtype == onp.int32
        rows = sorted(map(tuple, x.asnumpy().tolist()))
        assert rows == [(2 * i, 2 * i + 1) for i in range(6)]


N = 20000

# (draw of N samples, mean, variance) of each continuous sampler
MOMENTS = {
    "uniform": (lambda r: r.uniform(-1.0, 3.0, size=N), 1.0, 16 / 12),
    "normal": (lambda r: r.normal(1.0, 2.0, size=N), 1.0, 4.0),
    "gamma": (lambda r: r.gamma(2.0, 1.5, size=N), 3.0, 4.5),
    "beta": (lambda r: r.beta(2.0, 3.0, size=N), 0.4, 0.04),
    "exponential": (lambda r: r.exponential(2.0, size=N), 2.0, 4.0),
    "poisson": (lambda r: r.poisson(3.0, size=N), 3.0, 3.0),
    "laplace": (lambda r: r.laplace(1.0, 2.0, size=N), 1.0, 8.0),
    "gumbel": (lambda r: r.gumbel(0.0, 1.0, size=N), 0.5772156649,
               math.pi ** 2 / 6),
    "lognormal": (lambda r: r.lognormal(0.0, 0.5, size=N),
                  math.exp(0.125), (math.exp(0.25) - 1) * math.exp(0.25)),
    "chisquare": (lambda r: r.chisquare(3.0, size=N), 3.0, 6.0),
    "rayleigh": (lambda r: r.rayleigh(2.0, size=N), 2.0 * math.sqrt(
        math.pi / 2), (4 - math.pi) / 2 * 4.0),
    "weibull": (lambda r: r.weibull(2.0, size=N), math.gamma(1.5),
                math.gamma(2.0) - math.gamma(1.5) ** 2),
    "pareto": (lambda r: r.pareto(5.0, size=N), 0.25, 5 / (16 * 3)),
    "power": (lambda r: r.power(2.0, size=N), 2 / 3, 2 / 4 - 4 / 9),
    "logistic": (lambda r: r.logistic(1.0, 2.0, size=N), 1.0,
                 4 * math.pi ** 2 / 3),
    "f": (lambda r: r.f(5.0, 10.0, size=N), 10 / 8,
          2 * 100 * 13 / (5 * 64 * 6)),
    "bernoulli": (lambda r: r.bernoulli(0.3, size=N), 0.3, 0.21),
    "randint": (lambda r: r.randint(0, 10, size=N), 4.5, 99 / 12),
    "choice_p": (lambda r: r.choice(4, size=N, p=[0.1, 0.2, 0.3, 0.4]),
                 2.0, 1.0),
}


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_sampler_moments(name):
    draw, mean, var = MOMENTS[name]
    tmx.random.seed(11)
    x = draw(tnp.random).asnumpy().astype(onp.float64)
    se = math.sqrt(var / x.size)
    assert abs(x.mean() - mean) < 5 * se, (x.mean(), mean)
    assert abs(x.var() - var) < 0.1 * var, (x.var(), var)


def test_multinomial_and_mvn_moments():
    tmx.random.seed(12)
    c = tnp.random.multinomial(20, [0.1, 0.3, 0.6], size=(N,)).asnumpy()
    assert (c.sum(1) == 20).all()
    onp.testing.assert_allclose(c.mean(0), [2.0, 6.0, 12.0], rtol=0.02)
    cov = onp.array([[2.0, 0.6], [0.6, 1.0]])
    z = tnp.random.multivariate_normal(onp.array([1.0, -1.0]), cov,
                                       size=(N,)).asnumpy()
    onp.testing.assert_allclose(z.mean(0), [1.0, -1.0], atol=0.05)
    onp.testing.assert_allclose(onp.cov(z.T), cov, atol=0.06)


def _ppf_normal(q):
    from statistics import NormalDist
    q = min(max(q, 1e-12), 1 - 1e-12)
    return NormalDist().inv_cdf(q)


@pytest.mark.parametrize("name", ["uniform", "normal", "exponential",
                                  "randint"])
def test_verify_generator(name):
    tmx.random.seed(13)
    if name == "uniform":
        buckets, probs = gen_buckets_probs_with_ppf(lambda q: q, 8)
        gen = lambda n: tnp.random.uniform(size=n)  # noqa: E731
    elif name == "normal":
        buckets, probs = gen_buckets_probs_with_ppf(_ppf_normal, 8)
        gen = lambda n: tnp.random.normal(size=n)  # noqa: E731
    elif name == "exponential":
        buckets, probs = gen_buckets_probs_with_ppf(
            lambda q: -math.log(1 - q) if q < 1 else math.inf, 8)
        gen = lambda n: tnp.random.exponential(1.0, size=n)  # noqa: E731
    else:
        buckets, probs = list(range(8)), [1 / 8] * 8
        gen = lambda n: tnp.random.randint(0, 8, size=n)  # noqa: E731
    verify_generator(gen, buckets, probs, nsamples=4000, nrepeat=5)

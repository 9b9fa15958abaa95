"""`mx.np.random` in the port: each of the reference's 32 names, held to
its distribution (its draws come from the port's generator, not the
reference's JAX random bits: a kept deviation, ROADMAP Queue C), its
shapes and types, and repeated under `np.random.seed` / `npx.seed` /
`mx.random.seed`.
"""
import math

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

np = mx.np
N = 20000


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _mv(x):
    x = x.asnumpy().astype("float64")
    return x.mean(), x.var()


# name -> (draw, expected mean, expected variance, tolerance in standard
# errors of each)
MOMENTS = {
    "uniform": (lambda: np.random.uniform(-1.0, 3.0, size=(N,)), 1.0,
                16 / 12),
    "normal": (lambda: np.random.normal(2.0, 0.5, size=(N,)), 2.0, 0.25),
    "randn": (lambda: np.random.randn(N), 0.0, 1.0),
    "rand": (lambda: np.random.rand(N), 0.5, 1 / 12),
    "randint": (lambda: np.random.randint(0, 10, size=(N,)), 4.5, 8.25),
    "exponential": (lambda: np.random.exponential(2.0, size=(N,)), 2.0,
                    4.0),
    "gamma": (lambda: np.random.gamma(3.0, 2.0, size=(N,)), 6.0, 12.0),
    "beta": (lambda: np.random.beta(2.0, 3.0, size=(N,)), 0.4,
             6 / (25 * 6)),
    "poisson": (lambda: np.random.poisson(4.0, size=(N,)), 4.0, 4.0),
    "negative_binomial": (lambda: np.random.negative_binomial(
        5, 0.5, size=(N,)), 5.0, 10.0),
    "standard_normal": (lambda: np.random.standard_normal(size=(N,)), 0.0,
                        1.0),
    "standard_exponential": (lambda: np.random.standard_exponential(
        size=(N,)), 1.0, 1.0),
    "standard_gamma": (lambda: np.random.standard_gamma(2.0, size=(N,)),
                       2.0, 2.0),
    "lognormal": (lambda: np.random.lognormal(0.0, 0.25, size=(N,)),
                  math.exp(0.25 ** 2 / 2),
                  (math.exp(0.25 ** 2) - 1) * math.exp(0.25 ** 2)),
    "laplace": (lambda: np.random.laplace(1.0, 2.0, size=(N,)), 1.0, 8.0),
    "logistic": (lambda: np.random.logistic(1.0, 0.5, size=(N,)), 1.0,
                 0.25 * math.pi ** 2 / 3),
    "gumbel": (lambda: np.random.gumbel(0.0, 1.0, size=(N,)), 0.5772157,
               math.pi ** 2 / 6),
    "pareto": (lambda: np.random.pareto(5.0, size=(N,)), 0.25,
               5 / (16 * 3)),
    "power": (lambda: np.random.power(3.0, size=(N,)), 0.75, 3 / 80),
    "rayleigh": (lambda: np.random.rayleigh(2.0, size=(N,)),
                 2.0 * math.sqrt(math.pi / 2), (4 - math.pi) / 2 * 4),
    "weibull": (lambda: np.random.weibull(2.0, size=(N,)),
                math.gamma(1.5), math.gamma(2.0) - math.gamma(1.5) ** 2),
    "chisquare": (lambda: np.random.chisquare(4.0, size=(N,)), 4.0, 8.0),
    "f": (lambda: np.random.f(5.0, 10.0, size=(N,)), 10 / 8,
          2 * 100 * 13 / (5 * 64 * 6)),
    "bernoulli": (lambda: np.random.bernoulli(0.3, size=(N,)), 0.3, 0.21),
    "binomial": (lambda: np.random.binomial(10, 0.5, size=(N // 4,)), 5.0,
                 2.5),
}


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_moments(name):
    mx.np.random.seed(11)
    draw, mean, var = MOMENTS[name]
    x = draw()
    assert type(x) is mx.np.ndarray
    n = x.size
    m, v = _mv(x)
    assert abs(m - mean) < 5 * math.sqrt(var / n) + 1e-6, (m, mean)
    # the variance's standard error from the sample's fourth moment
    xs = x.asnumpy().astype("float64")
    se_v = math.sqrt(max(((xs - m) ** 4).mean() - v * v, 1e-12) / n)
    assert abs(v - var) < 6 * se_v + 1e-6, (v, var)


def test_standard_cauchy_quartiles():
    mx.np.random.seed(12)
    x = np.random.standard_cauchy(size=(N,)).asnumpy()
    q = onp.percentile(x, [25, 50, 75])
    onp.testing.assert_allclose(q, [-1.0, 0.0, 1.0], atol=0.06)


def test_multivariate_normal():
    mx.np.random.seed(13)
    cov = onp.array([[1.0, 0.3], [0.3, 0.5]])
    x = np.random.multivariate_normal(np.array([1.0, -1.0]), np.array(cov),
                                      size=N).asnumpy().astype("float64")
    assert x.shape == (N, 2)
    onp.testing.assert_allclose(x.mean(0), [1.0, -1.0], atol=0.05)
    onp.testing.assert_allclose(onp.cov(x.T), cov, atol=0.05)


def test_choice_permutation_shuffle_multinomial():
    mx.np.random.seed(14)
    draws = np.random.choice(3, size=(6000,), p=[0.6, 0.3, 0.1]).asnumpy()
    freq = onp.bincount(draws.astype("int64"), minlength=3) / 6000.0
    onp.testing.assert_allclose(freq, [0.6, 0.3, 0.1], atol=0.04)
    u = np.random.choice(5, size=(6000,)).asnumpy()
    onp.testing.assert_allclose(onp.bincount(u, minlength=5) / 6000.0,
                                [0.2] * 5, atol=0.04)
    c = np.random.choice(10, size=(6,), replace=False).asnumpy()
    assert len(set(c.tolist())) == 6
    w = np.random.choice(5, size=(3,), replace=False,
                         p=[0.1, 0.2, 0.3, 0.2, 0.2]).asnumpy()
    assert len(set(w.tolist())) == 3
    vals = np.random.choice(np.array([10.0, 20.0, 30.0]), size=(4,))
    assert set(vals.asnumpy().tolist()) <= {10.0, 20.0, 30.0}
    pm = np.random.permutation(10).asnumpy()
    assert sorted(pm.tolist()) == list(range(10))
    a = np.array(onp.arange(8.0))
    np.random.shuffle(a)
    assert sorted(a.asnumpy().tolist()) == list(range(8))
    p2 = np.random.permutation(np.array(onp.arange(5.0))).asnumpy()
    assert sorted(p2.tolist()) == list(range(5))
    m = np.random.multinomial(50, [0.5, 0.5], size=2).asnumpy()
    assert m.shape == (2, 2) and (m.sum(axis=1) == 50).all()
    m1 = np.random.multinomial(4000, [0.25, 0.25, 0.5]).asnumpy()
    onp.testing.assert_allclose(m1 / 4000.0, [0.25, 0.25, 0.5], atol=0.04)


SEEDERS = [("np.random.seed", lambda s: mx.np.random.seed(s)),
           ("npx.seed", lambda s: mx.npx.seed(s)),
           ("random.seed", lambda s: mx.random.seed(s))]


@pytest.mark.parametrize("how,seed", SEEDERS, ids=[s[0] for s in SEEDERS])
def test_draws_repeat_under_seed(how, seed):
    def draws():
        return [np.random.uniform(size=(5,)).asnumpy(),
                np.random.normal(size=(3,)).asnumpy(),
                np.random.permutation(16).asnumpy(),
                np.random.choice(10, size=(6,), replace=False).asnumpy(),
                np.random.choice(5, size=(8,),
                                 p=[0.1, 0.2, 0.3, 0.2, 0.2]).asnumpy(),
                np.random.multinomial(20, [0.25, 0.25, 0.5]).asnumpy(),
                np.random.gamma(2.0, size=(4,)).asnumpy()]
    seed(42)
    a = draws()
    seed(42)
    b = draws()
    for x, y in zip(a, b):
        onp.testing.assert_array_equal(x, y)
    seed(43)
    assert not onp.array_equal(draws()[0], a[0])


def test_every_reference_name_is_drawn_here():
    names = set(jmx.np.random.__all__)
    held = set(MOMENTS) | {"standard_cauchy", "multivariate_normal",
                           "choice", "permutation", "shuffle",
                           "multinomial", "seed"}
    assert len(names) == 32 and names == held == set(mx.np.random.__all__)


def test_shapes_and_types():
    assert np.random.uniform(size=(2, 3)).shape == (2, 3)
    assert np.random.uniform().shape == ()
    assert np.random.randint(5, size=(4,)).dtype == onp.int32
    assert np.random.normal(size=(2,), dtype="float16").dtype == onp.float16
    assert np.random.binomial(3, 0.5, size=4).shape == (4,)

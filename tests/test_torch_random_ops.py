"""The random ops (`ops/random_ops.py`), `mx.random`'s draws and
`nd.random`.

The port draws from its own `torch.Generator` per context, not the
reference's threefry stream (a kept deviation), so each op is held:
- to the reference's output shape and dtype on the same arguments
  (``jax.eval_shape`` of the reference's op);
- to its distribution, on 20,000 seeded draws: a Kolmogorov-Smirnov test
  against the exact distribution (scipy.stats) for the continuous ones,
  p > 1e-3, and for the counts the mean and variance within five
  standard errors of the exact ones, or a chi-square test of the category
  frequencies, p > 1e-3;
- to `mx.random.seed`: the same seed gives the same draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as ref_registry
from mxnet_tpu_torch.ops import registry as port_registry

DRAWS = 20000
P_MIN = 1e-3


def _draw(pkg, op, args=(), shape=None, seed=0, **kw):
    with pkg.cpu():
        pkg.random.seed(seed)
        vals = [pkg.nd.array(a) for a in args]
        if shape is not None:
            kw["shape"] = shape
        out = pkg.nd.invoke(op, *vals, **kw)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o.asnumpy() for o in outs]


def _reference_form(op, args, kw):
    """The reference op's output shapes and dtypes on these arguments,
    from ``jax.eval_shape`` (no draw is compiled or made)."""
    fn = ref_registry.get(op).fn
    key = jax.random.key(0)
    arrays = [jnp.asarray(a) for a in args]
    out = jax.eval_shape(lambda *a: fn(*a, key=key, **kw), *arrays)
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [(tuple(o.shape), np.dtype(o.dtype)) for o in outs]


def _same_form(op, args=(), **kw):
    """Shape and dtype of each output equal the reference's."""
    got = _draw(mx, op, args, **kw)
    assert [(g.shape, g.dtype) for g in got] == \
        _reference_form(op, args, kw), op
    return got


def _moments_ok(x, mean, var):
    n = x.size
    assert abs(x.mean() - mean) <= 5 * np.sqrt(var / n), (x.mean(), mean)
    # the sample variance's standard error, from the fourth moment
    m4 = ((x - x.mean()) ** 4).mean()
    assert abs(x.var() - var) <= 5 * np.sqrt(max(m4 - var ** 2, 1e-12) / n), \
        (x.var(), var)


@pytest.mark.parametrize("op,kw,dist", [
    ("_random_uniform", {"low": -2.0, "high": 3.0},
     stats.uniform(-2.0, 5.0)),
    ("_random_normal", {"loc": 1.5, "scale": 2.0}, stats.norm(1.5, 2.0)),
    ("_random_gamma", {"alpha": 2.5, "beta": 0.5}, stats.gamma(2.5,
                                                               scale=0.5)),
    ("_random_gamma", {"alpha": 0.3, "beta": 2.0}, stats.gamma(0.3,
                                                               scale=2.0)),
    ("_random_exponential", {"lam": 4.0}, stats.expon(scale=0.25)),
])
def test_continuous_draws_follow_their_distribution(op, kw, dist):
    _same_form(op, shape=(2, 3), **kw)
    x = _draw(mx, op, shape=(DRAWS,), seed=1, **kw)[0].astype(np.float64)
    assert stats.kstest(x, dist.cdf).pvalue > P_MIN


@pytest.mark.parametrize("op,kw,mean,var", [
    ("_random_poisson", {"lam": 3.5}, 3.5, 3.5),
    ("_random_negative_binomial", {"k": 3, "p": 0.4}, 3 * .6 / .4,
     3 * .6 / .4 ** 2),
    ("_random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
     2.0, 2.0 + 0.5 * 4.0),
    ("_random_randint", {"low": -3, "high": 7}, 1.5, (10 ** 2 - 1) / 12.0),
])
def test_count_draws_have_their_moments(op, kw, mean, var):
    _same_form(op, shape=(4,), **kw)
    x = _draw(mx, op, shape=(DRAWS,), seed=2, **kw)[0].astype(np.float64)
    assert np.all(x == np.round(x))
    _moments_ok(x, mean, var)
    if op == "_random_randint":
        assert x.min() == -3 and x.max() == 6


def test_aliases_are_the_same_ops():
    pairs = [("uniform", "_random_uniform"),
             ("random_uniform", "_random_uniform"),
             ("normal", "_random_normal"), ("random_normal", "_random_normal"),
             ("randn", "_random_normal"), ("randint", "_random_randint"),
             ("random_randint", "_random_randint"),
             ("random_gamma", "_random_gamma"),
             ("random_exponential", "_random_exponential"),
             ("random_poisson", "_random_poisson"),
             ("random_negative_binomial", "_random_negative_binomial"),
             ("random_generalized_negative_binomial",
              "_random_generalized_negative_binomial"),
             ("sample_multinomial", "_sample_multinomial"),
             ("shuffle", "_shuffle")]
    for alias, name in pairs:
        assert port_registry.get(alias) is port_registry.get(name), alias


def test_sample_ops_draw_per_element():
    low, high = np.array([0., -1., 5.], np.float32), np.array(
        [1., 1., 9.], np.float32)
    u = _same_form("_sample_uniform", (low, high), shape=(DRAWS,))[0]
    mu, sigma = np.array([0., 3.], np.float32), np.array([1., .5],
                                                         np.float32)
    z = _same_form("_sample_normal", (mu, sigma), shape=(DRAWS,))[0]
    alpha, beta = np.array([.5, 4.], np.float32), np.array([2., .25],
                                                           np.float32)
    g = _same_form("_sample_gamma", (alpha, beta), shape=(DRAWS,))[0]
    for i in range(3):
        assert stats.kstest(u[i], stats.uniform(low[i], high[i] - low[i])
                            .cdf).pvalue > P_MIN
    for i in range(2):
        assert stats.kstest(z[i], stats.norm(mu[i], sigma[i]).cdf
                            ).pvalue > P_MIN
        assert stats.kstest(g[i], stats.gamma(alpha[i], scale=beta[i]).cdf
                            ).pvalue > P_MIN
    _same_form("_sample_uniform", (low, high))


def test_multinomial_frequencies_and_log_probabilities():
    p = np.array([[.1, .2, .7], [.5, .25, .25]], np.float32)
    draws, logp = _same_form("_sample_multinomial", (p,), shape=(DRAWS,),
                             get_prob=True)
    for row, probs in zip(draws, p):
        counts = np.bincount(row, minlength=3)
        assert stats.chisquare(counts, probs * DRAWS).pvalue > P_MIN
    np.testing.assert_allclose(logp, np.log(np.take_along_axis(
        p, draws, axis=1)), rtol=1e-6)
    one = _same_form("_sample_multinomial", (p[0],))[0]
    assert one.shape == () and 0 <= int(one) < 3


def test_unique_zipfian_is_log_uniform():
    r = 1000
    s = _same_form("_sample_unique_zipfian", shape=(DRAWS,), range_max=r)[0]
    assert s.min() >= 0 and s.max() < r
    for k in (0, 3, 30, 300):
        want = np.log(k + 2) / np.log(r)
        got = (s <= k).mean()
        assert abs(got - want) <= 5 * np.sqrt(want * (1 - want) / DRAWS)


def test_shuffle_permutes_rows():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    got = _same_form("_shuffle", (x,))[0]
    np.testing.assert_array_equal(np.sort(got[:, 0]), x[:, 0])
    np.testing.assert_array_equal(got[:, 1:] - got[:, :1],
                                  x[:, 1:] - x[:, :1])
    first = [int(_draw(mx, "_shuffle", (x,), seed=s)[0][0, 0]) // 4
             for s in range(400)]
    counts = np.bincount(first, minlength=10)
    assert stats.chisquare(counts).pvalue > P_MIN


def test_bernoulli_rate():
    p = np.full((DRAWS,), 0.3, np.float32)
    x = _same_form("bernoulli", (p,))[0]
    assert set(np.unique(x)) <= {0.0, 1.0}
    _moments_ok(x.astype(np.float64), 0.3, 0.21)


def test_seed_repeats_the_draws_and_namespaces_draw():
    a = _draw(mx, "_random_normal", shape=(5,), seed=7)[0]
    b = _draw(mx, "_random_normal", shape=(5,), seed=7)[0]
    c = _draw(mx, "_random_normal", shape=(5,), seed=8)[0]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with mx.cpu():
        mx.random.seed(3)
        for fn, kw in [(mx.nd.random.uniform, {}), (mx.nd.random.randn, {}),
                       (mx.nd.random.exponential, {"lam": 2.0}),
                       (mx.nd.random.poisson, {"lam": 2.0}),
                       (mx.nd.random.gamma, {"alpha": 2.0}),
                       (mx.random.negative_binomial, {"k": 2, "p": .5}),
                       (mx.random.generalized_negative_binomial, {}),
                       (mx.random.randint, {"low": 0, "high": 4}),
                       (mx.random.randn, {}), (mx.random.gamma, {}),
                       (mx.random.exponential, {}), (mx.random.poisson, {})]:
            assert fn(shape=(2, 3), **kw).shape == (2, 3)
        assert mx.random.multinomial(mx.nd.array([.5, .5]),
                                     shape=(4,)).shape == (4,)
        assert mx.random.shuffle(mx.nd.arange(6)).shape == (6,)


def test_negative_scale_raises_in_both():
    for pkg in (jmx, mx):
        with pkg.cpu(), pytest.raises(Exception):
            pkg.nd.random.normal(0, -1.0, shape=(2,)).asnumpy()


def test_random_ops_draw_on_the_symbolic_route():
    """sym.random draws through the op-by-op executor route."""
    with mx.cpu():
        mx.random.seed(5)
        s = mx.sym.random.uniform(low=0.0, high=2.0, shape=(3, 4)) \
            + mx.sym.var("x")
        ex = s.bind(mx.cpu(), {"x": mx.nd.zeros((3, 4))})
        out = ex.forward()[0].asnumpy()
    assert out.shape == (3, 4) and 0 <= out.min() and out.max() < 2.0


@pytest.mark.parametrize("op,kw,shape", [
    ("_random_uniform", dict(shape=(3, 4)), (3, 4)),
    ("_random_normal", dict(shape=(3, 4)), (3, 4)),
    ("_random_randint", dict(low=0, high=5, shape=(3, 4)), (3, 4)),
    ("_random_gamma", dict(shape=(3, 4)), (3, 4)),
    ("_random_exponential", dict(shape=(3, 4)), (3, 4)),
    ("_random_poisson", dict(shape=(3, 4)), (3, 4)),
    ("_random_negative_binomial", dict(shape=(3, 4)), (3, 4)),
    ("_random_generalized_negative_binomial", dict(shape=(3, 4)), (3, 4)),
    ("_sample_unique_zipfian", dict(range_max=100, shape=(3, 4)), (3, 4)),
    ("eye", dict(N=3, M=4), (3, 4)),
    ("linspace", dict(start=0, stop=1, num=5), (5,)),
])
def test_creation_ops_infer_shapes_without_drawing(op, kw, shape):
    """A creation op's symbol has no arguments, and its shape is inferred
    on `meta`: nothing is drawn from mx.random's CPU stream."""
    from mxnet_tpu_torch.symbol.symbol import _make_op
    s = _make_op(op)(**kw)
    mx.random.seed(11)
    want = mx.random.uniform(shape=(4,), ctx=mx.cpu()).asnumpy()
    mx.random.seed(11)
    assert s.list_arguments() == []
    assert s.infer_shape()[1] == [shape]
    np.testing.assert_array_equal(
        mx.random.uniform(shape=(4,), ctx=mx.cpu()).asnumpy(), want)

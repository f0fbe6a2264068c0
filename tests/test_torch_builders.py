"""The array builders of ``core/arrivals.py`` and ``core/rentcosts.py``
against the reference's, bit for bit (``np.array_equal``), in both
threefry layouts, at T = 300: each materialises a B = 1 stream (here on
the CPU) and returns one row of the same dtype.  On one row XLA orders
the ARMA scan's dots as FMA chains (``hosting._xla_dot``)."""
import jax
import numpy as np
import pytest

from repro.core import arrivals as ja
from repro.core import rentcosts as jr
from repro_torch.convert import tree_from_numpy
from repro_torch.core import arrivals as pa
from repro_torch.core import rentcosts as pr
from repro_torch.kernels.hosting import threefry_partitionable

T = 300
LAYOUTS = [True, False]
CPU = "cpu"


def _pk(key):
    return tree_from_numpy(np.asarray(key), CPU)


def _same(got, want):
    want = np.asarray(want)
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape == (T,)
    assert np.array_equal(got, want)


def _cases(key):
    """(name, reference thunk, port thunk) for every builder."""
    k = _pk(key)
    ge = dict(p_hl=0.3, p_lh=0.2, rate_h=12.0, rate_l=0.5)
    proc = dict(mean=0.4, ar=(0.5, 0.2), ma=(0.3, 0.1), sigma=0.07,
                c_min=0.1, c_max=1.2)
    # one row: XLA's dots in the scan are FMA chains (three terms and up)
    long = dict(mean=0.5, ar=(0.3, 0.2, 0.1, 0.05, 0.02, 0.01),
                ma=(0.4, 0.2, 0.1), sigma=0.08, c_min=0.1, c_max=2.0)
    return [
        ("bernoulli", lambda: ja.bernoulli(key, 0.35, T),
         lambda: pa.bernoulli(k, 0.35, T, device=CPU)),
        ("poisson below 10", lambda: ja.poisson(key, 3.5, T),
         lambda: pa.poisson(k, 3.5, T, device=CPU)),
        ("poisson above 10", lambda: ja.poisson(key, 37.0, T),
         lambda: pa.poisson(k, 37.0, T, device=CPU)),
        ("GE Poisson", lambda: ja.GilbertElliot(**ge).sample(key, T),
         lambda: pa.GilbertElliot(**ge).sample(k, T, device=CPU)),
        ("cluster_trace_like", lambda: ja.cluster_trace_like(key, T),
         lambda: pa.cluster_trace_like(k, T, device=CPU)),
        ("iid_uniform", lambda: jr.iid_uniform(key, 0.35, 0.3, T),
         lambda: pr.iid_uniform(k, 0.35, 0.3, T, device=CPU)),
        ("negatively_associated",
         lambda: jr.negatively_associated(key, 0.35, 0.2, T),
         lambda: pr.negatively_associated(k, 0.35, 0.2, T, device=CPU)),
        ("ARMAProcess", lambda: jr.ARMAProcess(**proc).sample(key, T),
         lambda: pr.ARMAProcess(**proc).sample(k, T, device=CPU)),
        ("ARMAProcess default", lambda: jr.ARMAProcess(0.55).sample(key, T),
         lambda: pr.ARMAProcess(0.55).sample(k, T, device=CPU)),
        ("ARMAProcess p6 q3", lambda: jr.ARMAProcess(**long).sample(key, T),
         lambda: pr.ARMAProcess(**long).sample(k, T, device=CPU)),
        ("aws_spot_like", lambda: jr.aws_spot_like(key, 0.55, T),
         lambda: pr.aws_spot_like(k, 0.55, T, device=CPU)),
        ("aws_spot_like rails",
         lambda: jr.aws_spot_like(key, 2.0, T, rel_sigma=0.4, c_min=1.5),
         lambda: pr.aws_spot_like(k, 2.0, T, rel_sigma=0.4, c_min=1.5,
                                  device=CPU)),
    ]


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_builders_match_the_reference(partitionable):
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        for name, ref, got in _cases(jax.random.PRNGKey(7)):
            _same(got(), ref())
        ge = dict(p_hl=0.25, p_lh=0.15, rate_h=0.9, rate_l=0.1,
                  emission="bernoulli")
        key = jax.random.PRNGKey(8)
        xw, sw = ja.GilbertElliot(**ge).sample(key, T, return_states=True)
        xg, sg = pa.GilbertElliot(**ge).sample(_pk(key), T,
                                               return_states=True,
                                               device=CPU)
        _same(xg, xw)
        _same(sg, sw)


def test_constant_and_the_spot_stream():
    _same(pr.constant(0.35, T), jr.constant(0.35, T))
    # aws_spot_like is the spot_rents stream's first row under the same key
    from repro_torch.core import scenarios as ps
    k = _pk(jax.random.PRNGKey(3))
    row = ps.materialize_stream(ps.spot_rents(k, 0.55, 1, device=CPU), T)[0]
    _same(pr.aws_spot_like(k, 0.55, T, device=CPU), row)


def test_fit_arma_matches_the_reference():
    rng = np.random.default_rng(5)
    series = 0.5 + np.cumsum(rng.normal(0.0, 0.02, 800)) * 0.1 \
        + rng.normal(0.0, 0.03, 800)
    for p, q in ((4, 2), (2, 1)):
        want, got = jr.fit_arma(series, p, q), pr.fit_arma(series, p, q)
        for f in ("mean", "ar", "ma", "sigma", "c_min", "c_max"):
            assert getattr(got, f) == getattr(want, f), f


def test_cluster_trace_like_refuses_a_diurnal_period():
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        pa.cluster_trace_like(_pk(jax.random.PRNGKey(0)), T,
                              diurnal_period=24, device=CPU)

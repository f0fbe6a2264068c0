"""The ARMA / spot rent streams against the reference's
``materialize_stream``, bit for bit (``np.array_equal``), in both
threefry layouts: any chunking, per-instance coefficients, the seed axis,
and the clip rails of ``spot_bounds``."""
import numpy as np
import jax
import pytest
import torch

from repro.core import scenarios as js
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.core.rentcosts import DEFAULT_AR, DEFAULT_MA
from repro_torch.kernels.hosting import threefry_partitionable

B, T = 6, 300
LAYOUTS = [True, False]
CHUNKS = [None, 64, 97]                 # 97 does not divide T
CPU = "cpu"


def _pk(key):
    return tree_from_numpy(np.asarray(key), CPU)


def _streams(key):
    """(name, reference stream, port stream): the default ARMA(4, 2),
    per-instance [B, p] / [B, q] coefficients at other orders (p = 1 puts
    the product into the add; q = 3 and p = 6 are left-to-right sums), and
    spot rents at a scalar and a per-instance mean."""
    rng = np.random.default_rng(3)
    per = lambda n, s: (rng.random((B, n)) * s).astype(np.float32)  # noqa
    means = rng.uniform(0.2, 0.6, B)
    out = [("arma-default", js.arma_rents(key, 0.35, B),
            ps.arma_rents(_pk(key), 0.35, B, device=CPU))]
    for ar, ma in ((per(2, 0.4), per(2, 0.3)), (per(1, 0.6), per(3, 0.2)),
                   (per(6, 0.15), per(2, 0.3))):
        out.append((f"arma-p{ar.shape[1]}q{ma.shape[1]}",
                    js.arma_rents(key, means.astype(np.float32), B, ar=ar,
                                  ma=ma, sigma=0.08, c_min=0.1, c_max=0.9),
                    ps.arma_rents(_pk(key), means.astype(np.float32), B,
                                  ar=ar, ma=ma, sigma=0.08, c_min=0.1,
                                  c_max=0.9, device=CPU)))
    out.append(("spot", js.spot_rents(key, 0.35, B),
                ps.spot_rents(_pk(key), 0.35, B, device=CPU)))
    out.append(("spot-per-instance", js.spot_rents(key, means, B,
                                                   rel_sigma=0.3),
                ps.spot_rents(_pk(key), means, B, rel_sigma=0.3,
                              device=CPU)))
    return out


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_arma_and_spot_rents_materialize_bitwise(partitionable):
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        for name, ref, got in _streams(jax.random.PRNGKey(21)):
            want = np.asarray(js.materialize_stream(ref, T, 64))
            for chunk in CHUNKS:
                c = ps.materialize_stream(got, T, chunk)
                assert np.array_equal(c, want), (name, chunk)
            lo, hi = (np.asarray(got.params[k]) for k in ("c_min", "c_max"))
            assert ((c >= lo[:, None]) & (c <= hi[:, None])).all(), name


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_spot_rents_seed_axis_matches_replicate_seeds(partitionable):
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        key = jax.random.PRNGKey(4)
        ref = js.replicate_seeds(js.spot_rents(key, 0.5, 3), 4)
        got = ps.replicate_seeds(ps.spot_rents(_pk(key), 0.5, 3,
                                               device=CPU), 4)
        want = np.asarray(js.materialize_stream(ref, 200, 50))
        assert np.array_equal(ps.materialize_stream(got, 200, 64), want)
        one = ps.with_seed(ps.spot_rents(_pk(key), 0.5, 3, device=CPU), 2)
        assert np.array_equal(ps.materialize_stream(one, 200, None),
                              want[2::4])


def test_spot_bounds_and_default_coefficients_match():
    from repro.core.rentcosts import DEFAULT_AR as JAR, DEFAULT_MA as JMA
    assert (DEFAULT_AR, DEFAULT_MA) == (JAR, JMA)
    for c in (0.0001, 0.35, 0.5, 1.7):
        assert ps.spot_bounds(c) == js.spot_bounds(c)


def test_arma_orders_outside_the_pinned_ones_raise():
    """q = 0 is refused (the reference fails there; MA(1) is pinned since
    and held in tests/test_torch_streams_rest.py); the state has the
    orders' shapes, the default ARMA(4, 2) and an ARMA(1, 1)."""
    key = ps.prng_key(0, CPU)
    with pytest.raises(ValueError, match="q >= 1"):
        ps.arma_rents(key, 0.35, 2, ar=(0.5,), ma=(), device=CPU)
    for kw, p, q in (({}, 4, 2), (dict(ar=(0.5,), ma=(0.3,)), 1, 1)):
        s = ps.arma_rents(key, 0.35, 2, device=CPU, **kw)
        st = s.init_fn(s.params)
        assert st["hist"].shape == (2, p) and st["eps"].shape == (2, q)
        assert torch.equal(st["hist"], torch.zeros((2, p)))

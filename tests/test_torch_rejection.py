"""``jax.random.poisson``'s rejection branch (Hormann, rates of 10 and
above) on the port against the JAX package, bit for bit
(``np.array_equal``), in both threefry layouts: the draws on slot keys at
rates in [10, 1e5] and at rates that mix both branches, XLA's ``lgamma``
(``_xla_lgamma``) on 1 .. 2**16 and on non-integers, the three-way key
split, and the Poisson, GE-Poisson (10 / 200) and bursty (2 / 20) streams
materialized at chunkings 1, 37 and T."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import scenarios as js
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.kernels import hosting as H
from repro_torch.kernels.hosting import threefry_partitionable

LAYOUTS = [True, False]
CPU = "cpu"
B, T = 4, 240


def _pk(key):
    return tree_from_numpy(np.asarray(key), CPU)


@jax.jit
def _ref_poisson(keys, lam):
    """The reference's draw: ``jax.random.poisson`` on each key."""
    return jax.vmap(lambda k, r: jax.random.poisson(
        jax.random.wrap_key_data(k), r, ()))(keys, lam)


def _slot_keys(keys, tids):
    """[R, chunk, 2] key words ``fold_in(keys[i], tids[j])`` (jax)."""
    return jax.vmap(lambda k: jax.vmap(
        lambda t: jax.random.key_data(jax.random.fold_in(
            jax.random.wrap_key_data(k), t)))(jnp.asarray(tids)))(
        jnp.asarray(keys.astype(np.uint32)))


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("rates", ["rejection", "mixed"])
def test_poisson_draws_match_jax(partitionable, rates):
    """20,000 slot-keyed draws a case: rates log-uniform in [10, 1e5] with
    the figures' 10, 20 and 200 and the top 1e5 (``rejection``), or rows
    whose rates straddle 10 (``mixed``: 0, 9.99, 10, 10.5 and draws from
    both branches), through ``poisson_chunk_plain`` == the reference."""
    rng = np.random.default_rng(11 if rates == "rejection" else 12)
    R, n = 40, 500
    if rates == "rejection":
        lam = np.exp(rng.uniform(np.log(10.0), np.log(1e5), R))
        lam[:5] = (10.0, 20.0, 200.0, 1e5, 37.0)
    else:
        lam = rng.uniform(0.0, 30.0, R)
        lam[:5] = (0.0, 9.99, 10.0, 10.5, 2.0)
    lam = lam.astype(np.float32)
    keys = rng.integers(0, 2 ** 32, (R, 2), dtype=np.uint64)
    tids = np.arange(3, 3 + n, dtype=np.int32)
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        want = np.asarray(_ref_poisson(
            _slot_keys(keys, tids).reshape(-1, 2),
            jnp.repeat(jnp.asarray(lam), n)))
        got = H.poisson_chunk_plain(
            torch.tensor(keys.astype(np.int64)), torch.tensor(tids),
            torch.tensor(lam)).numpy()
    assert np.array_equal(got.reshape(-1), want)
    assert abs(got[2].mean() - 200.0) < 5.0 if rates == "rejection" else \
        (got[0] == 0).all()


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_rejection_plain_and_split3_match_jax(partitionable):
    """``poisson_rejection_plain`` on raw keys (a lane frozen at its first
    acceptance whatever its neighbours do) and ``_split3`` ==
    ``jax.random.split(key, 3)``."""
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 2 ** 32, (4000, 2), dtype=np.uint64)
    lam = rng.choice(np.float32([10.0, 12.5, 200.0, 4321.0]), 4000)
    k0, k1 = (torch.tensor(keys[:, i].astype(np.int64)) for i in (0, 1))
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        jk = jnp.asarray(keys.astype(np.uint32))
        want = np.asarray(_ref_poisson(jk, jnp.asarray(lam)))
        got = H.poisson_rejection_plain(k0, k1, torch.tensor(lam)).numpy()
        assert np.array_equal(got, want)
        split = np.asarray(jax.vmap(lambda k: jax.random.key_data(
            jax.random.split(jax.random.wrap_key_data(k), 3)))(jk))
        mine = H._split3(k0, k1, partitionable)
        for i, (a, b) in enumerate(mine):
            assert np.array_equal(a.numpy(), split[:, i, 0].astype(np.int64))
            assert np.array_equal(b.numpy(), split[:, i, 1].astype(np.int64))


@pytest.mark.parametrize("inputs", ["integers", "non-integers"])
def test_xla_lgamma_matches_jax(inputs):
    """``_xla_lgamma`` == the jitted ``jax.lax.lgamma`` (XLA's Lanczos
    sum, log1p and log, its one contracted FMA) on every integer 1 ..
    2**16 or on 200,000 non-integers in [0.5, 1e5]; ``torch.lgamma``
    differs from it."""
    rng = np.random.default_rng(14)
    x = (np.arange(1, 2 ** 16 + 1, dtype=np.float32) if inputs == "integers"
         else np.exp(rng.uniform(np.log(0.5), np.log(1e5), 200_000))
         .astype(np.float32))
    want = np.asarray(jax.jit(jax.lax.lgamma)(jnp.asarray(x)))
    got = H._xla_lgamma(torch.tensor(x)).numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(torch.lgamma(torch.tensor(x)).numpy(), want)


def _streams(key):
    """(name, reference stream, port stream): per-row rates at and above
    10, fig17_22's GE-Poisson (10 / 200) and the bursty default (2 /
    20: one row mixes both branches)."""
    lam = np.asarray([10.0, 15.0, 200.0, 9.5], np.float32)
    return [
        ("poisson", js.poisson_arrivals(key, lam, B),
         ps.poisson_arrivals(_pk(key), lam, B, device=CPU)),
        ("ge-poisson", js.ge_arrivals(key, 0.4, 0.4, 200.0, 10.0, B),
         ps.ge_arrivals(_pk(key), 0.4, 0.4, 200.0, 10.0, B, device=CPU)),
        ("bursty", js.bursty_arrivals(js.shared_keys(key, B), B),
         ps.bursty_arrivals(ps.shared_keys(_pk(key), B), B, device=CPU)),
    ]


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("name", ["poisson", "ge-poisson", "bursty"])
def test_rejection_streams_match_the_reference(name, partitionable):
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        _, ref, got = next(s for s in _streams(jax.random.PRNGKey(21))
                           if s[0] == name)
        want = js.materialize_stream(ref, T)
        for chunk in (1, 37, T):
            # one-slot chunks over a prefix: the streams are counter keyed
            n = 40 if chunk == 1 else T
            out = ps.materialize_stream(got, n, chunk)
            for w, o in zip(want, out):
                assert np.array_equal(o, np.asarray(w)[:, :n]), chunk

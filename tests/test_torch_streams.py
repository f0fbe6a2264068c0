"""Every ported stream, ``combine`` and the seed axis against the JAX
package's ``materialize`` (exact equality), under both threefry layouts."""
import numpy as np
import jax
import pytest
import torch

from repro.core import scenarios as js
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.kernels.hosting import threefry_partitionable

B, T = 4, 300
LAYOUTS = [True, False]
CPU = "cpu"


def _key(seed):
    return jax.random.PRNGKey(seed)


def _pk(key):
    return tree_from_numpy(np.asarray(key), CPU)


def _streams(k):
    """(name, reference stream, port stream) of every ported stream;
    single keys, so the per-instance split is exercised too."""
    rng = np.random.default_rng(0)
    xtr = rng.integers(0, 3, (B, 250)).astype(np.int32)
    side = rng.integers(0, 2, (B, 250)).astype(np.int32)
    ctr = rng.random(250).astype(np.float32)
    p = np.array([0.1, 0.35, 0.5, 0.9], np.float32)
    return [
        ("bernoulli", js.bernoulli_arrivals(k, p, B),
         ps.bernoulli_arrivals(_pk(k), p, B, device=CPU)),
        ("ge-bernoulli",
         js.ge_arrivals(k, 0.3, 0.2, 0.9, 0.2, B, emission="bernoulli"),
         ps.ge_arrivals(_pk(k), 0.3, 0.2, 0.9, 0.2, B, emission="bernoulli",
                        device=CPU)),
        ("uniform", js.uniform_rents(k, 0.35, 0.2, B),
         ps.uniform_rents(_pk(k), 0.35, 0.2, B, device=CPU)),
        ("uniform-clamped", js.uniform_rents(k, 0.1, 0.3, B, c_min=0.05),
         ps.uniform_rents(_pk(k), 0.1, 0.3, B, c_min=0.05, device=CPU)),
        ("na", js.na_rents(k, 0.35, 0.2, B),
         ps.na_rents(_pk(k), 0.35, 0.2, B, device=CPU)),
        ("constant", js.constant_rents(0.4, B),
         ps.constant_rents(0.4, B, device=CPU)),
        ("trace-arrivals", js.trace_arrivals(xtr),
         ps.trace_arrivals(xtr, device=CPU)),
        ("trace-arrivals-side", js.trace_arrivals(xtr, side=side),
         ps.trace_arrivals(xtr, side=side, device=CPU)),
        ("trace-rents", js.trace_rents(ctr, B),
         ps.trace_rents(ctr, B, device=CPU)),
    ]


def _assert_tree_equal(ref, got):
    if isinstance(ref, tuple):
        for r, g in zip(ref, got):
            _assert_tree_equal(r, g)
    else:
        np.testing.assert_array_equal(np.asarray(ref), got)


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_every_stream_materializes_bitwise(partitionable):
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        for name, ref, got in _streams(_key(11)):
            _assert_tree_equal(js.materialize_stream(ref, T, 64),
                               ps.materialize_stream(got, T, 64))


def _scenarios(k1, k2):
    return [
        (js.combine(js.bernoulli_arrivals(k1, 0.35, B),
                    js.uniform_rents(k2, 0.35, 0.2, B)),
         ps.combine(ps.bernoulli_arrivals(_pk(k1), 0.35, B, device=CPU),
                    ps.uniform_rents(_pk(k2), 0.35, 0.2, B, device=CPU))),
        (js.combine(js.ge_arrivals(k1, 0.3, 0.2, 0.9, 0.2, B,
                                   emission="bernoulli"),
                    js.na_rents(k2, 0.35, 0.2, B)),
         ps.combine(ps.ge_arrivals(_pk(k1), 0.3, 0.2, 0.9, 0.2, B,
                                   emission="bernoulli", device=CPU),
                    ps.na_rents(_pk(k2), 0.35, 0.2, B, device=CPU))),
    ]


def _assert_obs_equal(ref, got):
    for r, g in zip(ref, got):
        assert (r is None) == (g is None)
        if r is not None:
            np.testing.assert_array_equal(r, g)


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_combine_and_seed_axis_bitwise(partitionable):
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        for ref, got in _scenarios(_key(3), _key(4)):
            _assert_obs_equal(js.materialize(ref, T, 100),
                              ps.materialize(got, T, 100))
            _assert_obs_equal(js.materialize(js.with_seed(ref, 5), T),
                              ps.materialize(ps.with_seed(got, 5), T))
            for anti in (False, True):
                _assert_obs_equal(
                    js.materialize(js.replicate_seeds(ref, 4, anti), T, 128),
                    ps.materialize(ps.replicate_seeds(got, 4, anti), T, 128))


def test_chunk_invariance_and_replica_rows():
    _, got = _scenarios(_key(5), _key(6))[1]
    whole = ps.materialize(got, T)
    for chunk in (1, 37, 128, 1000):
        _assert_obs_equal(whole, ps.materialize(got, T, chunk))
    rep = ps.materialize(ps.replicate_seeds(got, 3), T, 50)
    for s in range(3):
        one = ps.materialize(ps.with_seed(got, s), T, 50)
        for r, o in zip(rep, one):
            if r is not None:
                np.testing.assert_array_equal(r[s::3], o)


def test_unported_samplers_raise():
    # Poisson emissions at a rate of 10 or more take jax's rejection
    # branch, ported since the Figs 17-22 slice: the GE stream that was
    # refused here is now held bit for bit (both layouts)
    for part in LAYOUTS:
        with jax.threefry_partitionable(part), threefry_partitionable(part):
            want = js.materialize_stream(
                js.ge_arrivals(_key(0), 0.3, 0.2, 12.0, 0.5, B), 120)
            got = ps.materialize_stream(
                ps.ge_arrivals(_pk(_key(0)), 0.3, 0.2, 12.0, 0.5, B,
                               device=CPU), 120, 50)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError):
        ps.replicate_seeds(_scenarios(_key(0), _key(1))[0][1], 3,
                           antithetic=True)
    assert torch.equal(ps.split_keys(_pk(_key(2)), 3),
                       ps.as_keys(_pk(_key(2)), 3, CPU))


# ----------------------------------------------------------------------
# Kernel P's stream variants through the streams: flips set per row, NA
# pairs and the GE chain cut by chunks of odd length that do not divide T
# (so chunks start on odd slots and the chain crosses every cut), and the
# antithetic seed axis.
# ----------------------------------------------------------------------

FLIP = np.array([True, False, False, True])


def _with_flip(stream, flip):
    return stream._replace(params=dict(stream.params, flip=flip))


def _variant_streams(k):
    p = np.array([0.1, 0.35, 0.5, 0.9], np.float32)
    return {
        "bernoulli-flip": (
            _with_flip(js.bernoulli_arrivals(k, p, B), FLIP),
            _with_flip(ps.bernoulli_arrivals(_pk(k), p, B, device=CPU),
                       torch.from_numpy(FLIP))),
        "uniform-flip": (
            _with_flip(js.uniform_rents(k, 0.35, 0.2, B), FLIP),
            _with_flip(ps.uniform_rents(_pk(k), 0.35, 0.2, B, device=CPU),
                       torch.from_numpy(FLIP))),
        "na": (js.na_rents(k, 0.3, 0.25, B),
               ps.na_rents(_pk(k), 0.3, 0.25, B, device=CPU)),
        "ge-bernoulli": (
            js.ge_arrivals(k, 0.3, 0.2, 0.9, 0.2, B, emission="bernoulli"),
            ps.ge_arrivals(_pk(k), 0.3, 0.2, 0.9, 0.2, B,
                           emission="bernoulli", device=CPU)),
    }


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("chunk", [37, 1, 301])
@pytest.mark.parametrize("name", ["bernoulli-flip", "uniform-flip", "na",
                                  "ge-bernoulli"])
def test_stream_variants_bitwise_across_odd_chunks(name, chunk,
                                                   partitionable):
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        ref, got = _variant_streams(_key(21))[name]
        want = js.materialize_stream(ref, T + 1, None)
        _assert_tree_equal(want, ps.materialize_stream(got, T + 1, chunk))
    if name == "ge-bernoulli":                    # side = the chain state
        x, side = want
        assert (np.asarray(side) != np.asarray(side)[:, :1]).any()


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_antithetic_seed_axis_across_odd_chunks(partitionable):
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        for ref, got in _scenarios(_key(7), _key(8)):
            r = js.replicate_seeds(ref, 4, True)
            g = ps.replicate_seeds(got, 4, True)
            _assert_obs_equal(js.materialize(r, T + 1, 37),
                              ps.materialize(g, T + 1, 37))

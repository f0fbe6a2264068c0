"""The port's counter PRNG against jax's, under both threefry layouts.

Exact equality throughout: threefry is integer arithmetic and the
bits -> float mapping is exact, so the port must give jax's bits."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.scenarios import base as jbase
from repro.kernels import hosting as jhost
from repro_torch.convert import tree_from_numpy
from repro_torch.core.scenarios import base as pbase
from repro_torch.kernels import hosting as phost

LAYOUTS = [True, False]


def _words(rng, *shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    return tree_from_numpy(np.asarray(a), "cpu")


def test_threefry2x32_matches_reference_hash():
    rng = np.random.default_rng(0)
    k0, k1, x0, x1 = (_words(rng, 257) for _ in range(4))
    ref = jhost.threefry2x32(*(jnp.asarray(a) for a in (k0, k1, x0, x1)))
    got = phost.threefry2x32(*(_t(a) for a in (k0, k1, x0, x1)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy())


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_fold_and_split_match_jax(partitionable):
    rng = np.random.default_rng(1)
    keys = _words(rng, 9, 2)
    data = np.array([0, 1, 7, 2 ** 31 - 1, 12345, 3, 99, 2 ** 20, 5],
                    np.int32)
    with jax.threefry_partitionable(partitionable), \
            phost.threefry_partitionable(partitionable):
        ref = jax.vmap(jax.random.fold_in)(jnp.asarray(keys),
                                           jnp.asarray(data))
        got = pbase.fold_keys(_t(keys), torch.from_numpy(data))
        np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                      got.numpy())
        for B in (1, 2, 5, 8):
            ref = jax.random.split(jnp.asarray(keys[0]), B)
            got = pbase.split_keys(_t(keys[0]), B)
            np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                          got.numpy())


def test_prng_key_matches_jax():
    for seed in (0, 1, 42, 2 ** 31 - 1):
        ref = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
        np.testing.assert_array_equal(ref, pbase.prng_key(seed, "cpu").numpy())


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("salt", [None, 0, 1])
def test_slot_uniform_matches_reference(partitionable, salt):
    rng = np.random.default_rng(2)
    keys = _words(rng, 5, 2)
    tids = np.concatenate([np.arange(40), [2 ** 31 - 1, 2 ** 31 - 2, 65535,
                                           1 << 24, 0x7FFFFFFE]]).astype(
        np.int32)
    with jax.threefry_partitionable(partitionable), \
            phost.threefry_partitionable(partitionable):
        ref = jax.vmap(lambda k: jbase.slot_uniform(k, jnp.asarray(tids),
                                                    salt))(jnp.asarray(keys))
        got = pbase.slot_uniform(_t(keys), torch.from_numpy(tids), salt)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    # the explicit layout argument agrees with the context
    expl = phost.slot_uniform_plain(_t(keys), torch.from_numpy(tids), salt,
                                    partitionable)
    assert torch.equal(expl, got)


def test_layouts_differ_and_cpu_wrapper_launches_nothing():
    rng = np.random.default_rng(3)
    keys, tids = _t(_words(rng, 3, 2)), torch.arange(16, dtype=torch.int32)
    before = phost.slot_uniform.launches
    a = phost.slot_uniform(keys, tids, None, True)
    b = phost.slot_uniform(keys, tids, None, False)
    assert not torch.equal(a, b)
    assert phost.slot_uniform.launches == before
    assert a.dtype == torch.float32 and a.shape == (3, 16)
    assert bool(((a >= 0) & (a < 1)).all())


def test_fma32_is_one_rounding():
    # a * b + c rounded once: compare with exact rational arithmetic
    from fractions import Fraction
    rng = np.random.default_rng(4)
    n = 3000
    a = rng.random(n).astype(np.float32)
    b = rng.random(n).astype(np.float32)
    c = (rng.standard_normal(n) * np.where(rng.random(n) < 0.5, 1e-9, 1.0)
         ).astype(np.float32)
    got = phost.fma32(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        f = np.float32(float(exact))
        cands = [np.nextafter(f, np.float32(-np.inf)), f,
                 np.nextafter(f, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert got[i] == best, i
    inf = torch.tensor([float("inf")])
    assert phost.fma32(torch.tensor([2.0]), torch.tensor([3.0]), inf) == inf


# ----------------------------------------------------------------------
# Kernel P's stream variants: each plain version against the reference's
# chunk function, jitted and vmapped over rows as its ``materialize`` runs
# it (inside jit XLA:CPU fuses the rents' lo + u * (hi - lo) into one FMA).
# ----------------------------------------------------------------------

from repro.core.scenarios import streams as jstreams  # noqa: E402

# counters that start on an odd slot and run an odd length (NA pairs cut
# at both ends), and scattered ones (NA pairs apart, the top of the range)
STREAM_TIDS = {
    "odd-start": np.arange(7, 7 + 37, dtype=np.int32),
    "scattered": np.array([5, 4, 9, 100, 101, 2 ** 31 - 1, 2 ** 31 - 2, 0,
                           3, 65536, 65537], np.int32),
}
VARIANTS = ["bernoulli", "uniform_rents", "na_rents", "ge_bernoulli"]


def _variant_case(variant, rows=6, seed=5):
    """(reference chunk fn, its params and state, port call) of a variant."""
    rng = np.random.default_rng(seed)
    keys = _words(rng, rows, 2)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    flip = np.array([False, True] * (rows // 2))
    lo = f32(rng.random(rows) * 0.3)
    hi = f32(lo + rng.random(rows) * 0.5)
    if variant == "bernoulli":
        p = f32(rng.random(rows))
        return (jstreams._bernoulli_chunk,
                {"key": keys, "p": p, "flip": flip}, (),
                lambda t: phost.bernoulli_arrivals_chunk(
                    _t(keys), t, _t(p), _t(flip)))
    if variant == "uniform_rents":
        return (jstreams._uniform_rents_chunk,
                {"key": keys, "lo": lo, "hi": hi, "flip": flip}, (),
                lambda t: phost.uniform_rents_chunk(
                    _t(keys), t, _t(lo), _t(hi), _t(flip)))
    if variant == "na_rents":
        return (jstreams._na_rents_chunk, {"key": keys, "lo": lo, "hi": hi},
                (), lambda t: phost.na_rents_chunk(_t(keys), t, _t(lo),
                                                   _t(hi)))
    ge = {k: f32(rng.random(rows)) for k in ("p_hl", "p_lh", "rate_h",
                                             "rate_l")}
    s = rng.integers(0, 2, rows).astype(np.int32)
    rest = [_t(ge[k]) for k in ("p_hl", "p_lh", "rate_h", "rate_l")]
    port = lambda t, s0=_t(s): phost.ge_bernoulli_chunk(  # noqa: E731
        _t(keys), t, s0, *rest)
    return (jstreams._ge_chunk_bernoulli, dict(key=keys, **ge), {"s": s},
            port)


def _flat(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _flat(v)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("tids_case", sorted(STREAM_TIDS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_stream_variant_plain_matches_reference_chunk(variant, tids_case,
                                                      partitionable):
    tids = STREAM_TIDS[tids_case]
    fn, params, state, port = _variant_case(variant)
    with jax.threefry_partitionable(partitionable), \
            phost.threefry_partitionable(partitionable):
        ref_state, ref_vals = jax.jit(jax.vmap(fn, in_axes=(0, 0, None)))(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(tids))
        before = [k.launches for k in (phost.bernoulli_arrivals_chunk,
                                       phost.uniform_rents_chunk,
                                       phost.na_rents_chunk,
                                       phost.ge_bernoulli_chunk)]
        got = port(torch.from_numpy(tids))
        after = [k.launches for k in (phost.bernoulli_arrivals_chunk,
                                      phost.uniform_rents_chunk,
                                      phost.na_rents_chunk,
                                      phost.ge_bernoulli_chunk)]
    assert before == after                     # the CPU takes the plain way
    if variant == "ge_bernoulli":
        # (s', states, x) against the reference's ({"s": s'}, (x, states))
        want = [ref_state["s"], ref_vals[1], ref_vals[0]]
    elif variant == "bernoulli":
        want = [ref_vals[0]]
        got = [got]
    else:
        want = [ref_vals]
        got = [got]
    assert len(_flat(want)) == len(got)
    for w, g in zip(_flat(want), got):
        assert np.array_equal(w, g.numpy()), (variant, tids_case)


def test_ge_chunk_carries_the_chain_across_calls():
    # one call over 40 slots == calls of 17 and 23 slots, the second from
    # the first's state; the states really switch
    port = _variant_case("ge_bernoulli")[3]
    whole = port(torch.arange(3, 43, dtype=torch.int32))
    s1, st1, x1 = port(torch.arange(3, 20, dtype=torch.int32))
    s2, st2, x2 = port(torch.arange(20, 43, dtype=torch.int32), s1)
    assert torch.equal(whole[0], s2)
    assert torch.equal(whole[1], torch.cat([st1, st2], 1))
    assert torch.equal(whole[2], torch.cat([x1, x2], 1))
    assert bool((whole[1] != whole[1][:, :1]).any())


def test_fma32_counts_only_calls_on_the_card():
    before = phost.fma32.card_calls
    phost.fma32(torch.ones(3), torch.ones(3), torch.ones(3))
    assert phost.fma32.card_calls == before

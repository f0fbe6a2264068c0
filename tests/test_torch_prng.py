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

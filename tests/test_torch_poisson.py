"""Knuth's Poisson draws and the streams built on them against the JAX
package, bit for bit (``np.array_equal``), in both threefry layouts:
``jax.random.poisson`` on slot keys at rates in [0, 10), the Poisson,
GE-Poisson and bursty streams materialized at any chunking, the seed
axis, the same streams at rates that reach 10 (Hormann's branch, held in
full by ``test_torch_rejection.py``), and the refusal of the part that is
not ported (the diurnal remodulation)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import scenarios as js
from repro.core.scenarios.streams import BURSTY_EXIT_P as J_EXIT_P
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.kernels import hosting as H
from repro_torch.kernels.hosting import threefry_partitionable

B, T = 4, 301
LAYOUTS = [True, False]
CHUNKS = [1, 37, 301]
CPU = "cpu"
LAMS = (0.0, 0.15, 1.2, 2.0, 4.0, 8.0, 9.99)


def _pk(key):
    return tree_from_numpy(np.asarray(key), CPU)


@jax.jit
def _ref_poisson(keys, lam):
    """The reference's draw: ``jax.random.poisson`` on each key."""
    return jax.vmap(lambda k, r: jax.random.poisson(
        jax.random.wrap_key_data(k), r, ()))(keys, lam)


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_knuth_draws_match_jax_poisson(partitionable):
    """Slot keys ``fold_in(key, t)`` at every rate of the figures and the
    ends of Knuth's branch: ``poisson_chunk_plain`` == the reference."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 2 ** 32, (len(LAMS), 2), dtype=np.uint64)
    lam = np.asarray(LAMS, np.float32)
    tids = np.arange(5, 5 + 400, dtype=np.int32)
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        slot = jax.vmap(lambda k: jax.vmap(
            lambda t: jax.random.key_data(jax.random.fold_in(
                jax.random.wrap_key_data(k), t)))(jnp.asarray(tids)))(
            jnp.asarray(keys.astype(np.uint32)))            # [R, chunk, 2]
        want = np.asarray(_ref_poisson(
            slot.reshape(-1, 2), jnp.repeat(jnp.asarray(lam), len(tids))))
        got = H.poisson_chunk_plain(
            torch.tensor(keys.astype(np.int64)), torch.tensor(tids),
            torch.tensor(lam)).numpy()
    assert np.array_equal(got.reshape(-1), want)
    assert (got[0] == 0).all() and got[-1].mean() > 8


def _arrivals(key):
    """(name, reference stream, port stream) of the Poisson-drawing
    arrival streams: per-instance rates, GE-Poisson with the bursty
    figure's rates, and bursty itself (shared keys)."""
    lam = np.asarray([0.15, 2.0, 4.0, 9.99], np.float32)
    kw = dict(device=CPU)
    return [
        ("poisson", js.poisson_arrivals(key, lam, B),
         ps.poisson_arrivals(_pk(key), lam, B, **kw)),
        ("ge-poisson", js.ge_arrivals(key, 0.3, 0.2, 1.2, 0.15, B),
         ps.ge_arrivals(_pk(key), 0.3, 0.2, 1.2, 0.15, B, **kw)),
        ("bursty", js.bursty_arrivals(js.shared_keys(key, B), B,
                                      base_rate=0.15, burst_rate=1.2,
                                      burst_p=0.08),
         ps.bursty_arrivals(ps.shared_keys(_pk(key), B), B, base_rate=0.15,
                            burst_rate=1.2, burst_p=0.08, **kw)),
    ]


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_poisson_streams_match_the_reference(partitionable):
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        for name, ref, got in _arrivals(jax.random.PRNGKey(3)):
            want = js.materialize_stream(ref, T)
            for chunk in CHUNKS:
                # one-slot chunks over a prefix: the streams are counter
                # keyed, so a prefix is the same draws (and 301 launches
                # of plain-torch rounds would dominate the file's time)
                n = 60 if chunk == 1 else T
                out = ps.materialize_stream(got, n, chunk)
                for w, o in zip(want, out):
                    assert np.array_equal(o, np.asarray(w)[:, :n]), (name,
                                                                      chunk)


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_poisson_seed_replicas_match_the_reference(partitionable):
    """``replicate_seeds`` of a Poisson scenario: row b * S + s is the
    reference's, and ``with_seed(., s)``'s row b."""
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        key = jax.random.PRNGKey(8)
        (_, jp, pp), (_, jg, pg) = _arrivals(key)[:2]
        ref = js.combine(jp, js.constant_rents(0.4, B))
        got = ps.combine(pp, ps.constant_rents(0.4, B, device=CPU))
        ref2 = js.combine(jg, js.constant_rents(0.4, B))
        got2 = ps.combine(pg, ps.constant_rents(0.4, B, device=CPU))
        for r, g in ((ref, got), (ref2, got2)):
            want = js.materialize(js.replicate_seeds(r, 3), 120, 50)
            out = ps.materialize(ps.replicate_seeds(g, 3), 120, 50)
            for w, o in zip(want, out):
                if w is not None:
                    assert np.array_equal(o, np.asarray(w))
            one = ps.materialize(ps.with_seed(g, 2), 120, 50)
            assert np.array_equal(out[0][2::3], one[0])


def test_unported_poisson_parts_raise():
    """Rates of 10 and above (jax's rejection branch), refused before the
    Figs 17-22 slice, now equal the reference bit for bit in both layouts
    at the same rates; the diurnal remodulation still raises, naming its
    ROADMAP item; the bursty constants are the reference's."""
    key = jax.random.PRNGKey(0)
    k = _pk(key)
    lam = np.asarray([2.0, 10.0, 1.0, 1.0], np.float32)
    for part in LAYOUTS:
        with jax.threefry_partitionable(part), \
                threefry_partitionable(part):
            for ref, got in (
                    (js.poisson_arrivals(key, lam, B),
                     ps.poisson_arrivals(k, lam, B, device=CPU)),
                    (js.ge_arrivals(key, 0.3, 0.2, 10.0, 0.5, B),
                     ps.ge_arrivals(k, 0.3, 0.2, 10.0, 0.5, B, device=CPU)),
                    (js.bursty_arrivals(key, B),             # rate 20
                     ps.bursty_arrivals(k, B, device=CPU))):
                want = js.materialize_stream(ref, 90)
                out = ps.materialize_stream(got, 90, 40)
                for w, o in zip(want, out):
                    assert np.array_equal(o, np.asarray(w)), (part, ref.name)
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        ps.bursty_arrivals(k, B, base_rate=0.5, burst_rate=2.0,
                           diurnal_period=24, device=CPU)
    assert ps.BURSTY_EXIT_P == J_EXIT_P
    # Bernoulli emissions still take any rate up to 1
    ps.ge_arrivals(k, 0.3, 0.2, 0.9, 0.2, B, emission="bernoulli",
                   device=CPU)

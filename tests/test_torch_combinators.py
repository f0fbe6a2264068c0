"""The port's scenario combinators against the JAX package's, bit for bit
(``np.array_equal``), in both threefry layouts: ``mixture`` (GE chains
and ARMA rents among its components), ``mixture_from_weights``
(``jax.random.choice``), ``regime_switch``, ``antithetic_pairing``,
``tile_services``, ``trace_scenario``, and the fleet drivers on a composed
scenario and under ``prng_backend=``.  The laws are the reference's own
(``tests/test_scenarios.py``): a mixture's rows are its components' rows,
a regime's slots its component's slots, antithetic pairs sum to lo + hi,
a trace replays the fused run."""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.core import scenarios as js
from repro.core.costs import HostingCosts as JCosts, HostingGrid as JGrid
from repro.core.fleet import FleetBatch as JFleet
from repro.core.fleet import evaluate_schedule_fleet as jeval_fleet
from repro.core.fleet import offline_opt_fleet as jopt_fleet
from repro.core.fleet import run_fleet as jrun_fleet
from repro.core.policies import AlphaRR as JAlphaRR
from repro.core.policies import RetroRenting as JRR
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.fleet import (FleetBatch, evaluate_schedule_fleet,
                                    offline_opt_fleet, run_fleet)
from repro_torch.core.policies import AlphaRR, RetroRenting
from repro_torch.kernels.hosting import threefry_partitionable

LAYOUTS = [True, False]
CPU = "cpu"
B, T = 6, 300
CHUNKS = [None, 64, 97]


def _pk(key):
    return tree_from_numpy(np.asarray(key), CPU)


def _both(part):
    stack = contextlib.ExitStack()
    stack.enter_context(jax.threefry_partitionable(part))
    stack.enter_context(threefry_partitionable(part))
    return stack


def _equal(ref, got):
    if isinstance(ref, tuple):
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            _equal(r, g)
    elif ref is None:
        assert got is None
    else:
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def _keys(n, seed=21):
    return list(jax.random.split(jax.random.PRNGKey(seed), n))


def _arrivals(ks, n=B):
    """Arrival components, reference and port: Bernoulli, GE-Bernoulli,
    Poisson, GE-Poisson."""
    k = ks
    ref = [js.bernoulli_arrivals(k[0], 0.35, n),
           js.ge_arrivals(k[1], 0.2, 0.3, 0.9, 0.2, n, emission="bernoulli"),
           js.poisson_arrivals(k[2], 2.0, n),
           js.ge_arrivals(k[3], 0.2, 0.3, 6.0, 1.0, n)]
    got = [ps.bernoulli_arrivals(_pk(k[0]), 0.35, n, device=CPU),
           ps.ge_arrivals(_pk(k[1]), 0.2, 0.3, 0.9, 0.2, n,
                          emission="bernoulli", device=CPU),
           ps.poisson_arrivals(_pk(k[2]), 2.0, n, device=CPU),
           ps.ge_arrivals(_pk(k[3]), 0.2, 0.3, 6.0, 1.0, n, device=CPU)]
    return ref, got


def _rents(ks, n=B):
    """Rent components: uniform, ARMA(2, 1), spot (ARMA(4, 2)), NA."""
    k = ks
    ref = [js.uniform_rents(k[0], 0.35, 0.2, n),
           js.arma_rents(k[1], 0.35, n, ar=(0.55, 0.2), ma=(0.4,)),
           js.spot_rents(k[2], 0.35, n),
           js.na_rents(k[3], 0.35, 0.2, n)]
    got = [ps.uniform_rents(_pk(k[0]), 0.35, 0.2, n, device=CPU),
           ps.arma_rents(_pk(k[1]), 0.35, n, ar=(0.55, 0.2), ma=(0.4,),
                         device=CPU),
           ps.spot_rents(_pk(k[2]), 0.35, n, device=CPU),
           ps.na_rents(_pk(k[3]), 0.35, 0.2, n, device=CPU)]
    return ref, got


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("channel", ["arrivals", "rents"])
def test_mixture_matches_and_selects_components(channel, partitionable):
    """Every component stateful or not (the GE chains, the ARMA
    recursions) advances on every row; row b is bitwise its component's
    own row."""
    assign = [0, 1, 2, 3, 1, 0]
    with _both(partitionable):
        ref, got = (_arrivals if channel == "arrivals" else _rents)(_keys(4))
        want = js.materialize_stream(js.mixture(ref, assign), T, 64)
        mixed = ps.mixture(got, assign)
        assert mixed.has_side == (channel == "arrivals")
        for chunk in CHUNKS:
            _equal(want, ps.materialize_stream(mixed, T, chunk))
        own = [ps.materialize_stream(s, T, 64) for s in got]
        out = ps.materialize_stream(mixed, T, 64)
        for b, i in enumerate(assign):
            if channel == "arrivals":
                for a, o in zip(out, own[i]):
                    np.testing.assert_array_equal(a[b], o[b])
            else:
                np.testing.assert_array_equal(out[b], own[i][b])
    with pytest.raises(ValueError, match="component indices"):
        ps.mixture(got, [0, 4, 0, 0, 0, 0])
    with pytest.raises(ValueError, match="cannot mix"):
        ps.mixture([_arrivals(_keys(4))[1][0], _rents(_keys(4))[1][0]],
                   [0] * B)


# (weights, instances): 2 to 8 components; shares whose float32 cumulative
# sum rounds (thirds, sevenths, zero weights, and two whose left-to-right
# sum ends off 1.0, at 1 + 2**-23 and 1 - 2**-24, where a pairwise sum
# would end at 1.0)
WEIGHTS = [([0.3, 0.7], 1000), ([1, 1, 1], 999), ([0.5, 0.3, 0.2], 64),
           ([1, 0, 2, 0, 3], 500), ([1] * 7, 777),
           ([0.1, 0.11, 0.12, 0.13, 0.14, 0.15, 0.16, 0.09], 1024),
           ([3.3, 1e-3, 5.7, 2.2], 257),
           ([2.4, 8.8, 0.6, 3.4, 1.5, 4.5, 8.0, 2.3], 2000),
           ([4.4, 9.5, 5.0, 4.3, 6.2, 10.0, 9.5], 1500)]


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_mixture_from_weights_is_jax_random_choice(partitionable):
    """The assignment is ``jax.random.choice(key, n, (B,), p=w / w.sum())``
    exactly (float32 shares, their left-to-right float32 cumulative sum,
    ``cumsum[-1] * (1 - u)`` and the left insertion point): a mixture of
    constant rents whose value names the component, row for row."""
    rounds = False
    cumsum = jax.jit(jnp.cumsum)
    with _both(partitionable):
        key = jax.random.PRNGKey(0)
        for w, n_inst in WEIGHTS:
            w = np.asarray(w, np.float64)
            p32 = (w / w.sum()).astype(np.float32)
            seq = p32.copy()
            for i in range(1, len(seq)):
                seq[i] = seq[i - 1] + p32[i]
            np.testing.assert_array_equal(np.asarray(cumsum(p32)), seq)
            rounds |= seq[-1] != 1.0
            want = np.asarray(jax.random.choice(
                key, len(w), (n_inst,), p=jnp.asarray(w / w.sum())))
            comps_j = [js.constant_rents(float(i + 1), n_inst)
                       for i in range(len(w))]
            comps_p = [ps.constant_rents(float(i + 1), n_inst, device=CPU)
                       for i in range(len(w))]
            got = ps.materialize_stream(ps.mixture_from_weights(
                comps_p, w, _pk(key), n_inst), 3)
            np.testing.assert_array_equal(got[:, 0] - 1, want)
            np.testing.assert_array_equal(got, np.asarray(
                js.materialize_stream(js.mixture_from_weights(
                    comps_j, w, key, n_inst), 3)))
    assert rounds


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_regime_switch_matches_and_plays_each_regime(partitionable):
    """Boundaries mid-chunk (20, 150) and on a chunk edge (64) at chunks
    of 64; each regime's slots are bitwise its component's slots (the
    stateful ones kept advancing through foreign regimes)."""
    with _both(partitionable):
        ref_a, got_a = _arrivals(_keys(4))
        ref_r, got_r = _rents(_keys(4, seed=5))
        for ref, got, bounds in ((ref_a[:3], got_a[:3], [20, 64]),
                                 (ref_r[:2], got_r[:2], [150]),
                                 (ref_r[1:], got_r[1:], [64, 150])):
            want = js.materialize_stream(js.regime_switch(ref, bounds), T,
                                         64)
            sw = ps.regime_switch(got, bounds)
            for chunk in CHUNKS:
                _equal(want, ps.materialize_stream(sw, T, chunk))
            edges = [0] + bounds + [T]
            out = ps.materialize_stream(sw, T, 64)
            for i, s in enumerate(got):
                own = ps.materialize_stream(s, T, 64)
                sl = slice(edges[i], edges[i + 1])
                if s.kind == "arrivals":
                    np.testing.assert_array_equal(out[0][:, sl], own[0][:, sl])
                else:
                    np.testing.assert_array_equal(out[:, sl], own[:, sl])
    with pytest.raises(ValueError, match="boundaries"):
        ps.regime_switch(got_r[:3], [10, 10])
    with pytest.raises(ValueError, match="len"):
        ps.regime_switch(got_r[:3], [10])


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_antithetic_pairing_matches(partitionable):
    """Pairs (2m, 2m + 1) share key 2m, the odd member flipped: pair sums
    of uniform rents are lo + hi; a stream without a flip is refused."""
    with _both(partitionable):
        k = jax.random.PRNGKey(13)
        for ref, got in (
                (js.uniform_rents(k, 0.5, 0.2, B),
                 ps.uniform_rents(_pk(k), 0.5, 0.2, B, device=CPU)),
                (js.bernoulli_arrivals(k, 0.4, B),
                 ps.bernoulli_arrivals(_pk(k), 0.4, B, device=CPU))):
            want = js.materialize_stream(js.antithetic_pairing(ref), T, 64)
            pair = ps.antithetic_pairing(got)
            for chunk in CHUNKS:
                _equal(want, ps.materialize_stream(pair, T, chunk))
        c = ps.materialize_stream(ps.antithetic_pairing(
            ps.uniform_rents(_pk(k), 0.5, 0.2, B, device=CPU)), T)
        assert np.allclose(c[0::2] + c[1::2], 1.0, atol=1e-6)
        assert np.std(c[0]) > 0.01
    with pytest.raises(ValueError, match="antithetic"):
        ps.antithetic_pairing(ps.poisson_arrivals(ps.prng_key(0, CPU), 2.0,
                                                  2, device=CPU))


def _svc_scenario(mod, k, n, device):
    kw = {} if mod is js else dict(device=device)
    pk = (lambda a: a) if mod is js else _pk
    g = np.array([1.0, 0.6, 0.2, 0.0], np.float32)
    return mod.combine(mod.bernoulli_arrivals(pk(k[0]), 0.5, n, **kw),
                       mod.uniform_rents(pk(k[1]), 0.35, 0.2, n, **kw),
                       mod.model2_service(pk(k[2]), g, n, 4, **kw))


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_tile_services_matches(partitionable):
    """N = 1 returns the object itself; N = 3 salts every key per service
    except in the shared groups (the default shares the rents; none; the
    arrivals and rents), on a scenario with Model-2 service and on a bare
    stream (whose own entries are the groups, so its key is replicated, as
    in the reference)."""
    with _both(partitionable):
        k = _keys(3, seed=8)
        jsc, psc = _svc_scenario(js, k, 2, CPU), _svc_scenario(ps, k, 2, CPU)
        assert ps.tile_services(psc, 1) is psc
        for shared in (("rent",), (), ("arr", "rent")):
            want = js.materialize(js.tile_services(jsc, 3, shared), T, 64)
            got = ps.tile_services(psc, 3, shared)
            assert got.B == 6
            for chunk in (64, 97):
                _equal(want, ps.materialize(got, T, chunk))
        ref_s = js.bernoulli_arrivals(k[0], 0.5, 2)
        got_s = ps.bernoulli_arrivals(_pk(k[0]), 0.5, 2, device=CPU)
        _equal(js.materialize_stream(js.tile_services(ref_s, 3), T),
               ps.materialize_stream(ps.tile_services(got_s, 3), T))
    with pytest.raises(ValueError, match="n_services"):
        ps.tile_services(psc, 0)


class _Obj(tuple):
    """A params holder with the ``_replace`` / ``name`` of a Scenario."""

    def __new__(cls, params, name="obj"):
        return super().__new__(cls, (params, name))

    params = property(lambda self: self[0])
    name = property(lambda self: self[1])

    def _replace(self, params, name):
        return _Obj(params, name)


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_stacked_key_leaves_fold_per_row(partitionable):
    """``[B, N, 2]`` key leaves (a joint multi-service scenario's stacked
    sub-stream keys): the service, seed and antithetic folds broadcast each
    row's salt over the stacked axis, bitwise the reference's
    ``_fold_stacked``."""
    with _both(partitionable):
        kk = jax.random.split(jax.random.PRNGKey(2), 3 * 4).reshape(3, 4, 2)
        flat = jax.random.split(jax.random.PRNGKey(3), 3)
        params = {"arr": {"key": kk, "flip": jnp.zeros((3,), bool),
                          "p": jnp.full((3,), 0.5, jnp.float32)},
                  "rent": {"key": flat, "lo": jnp.zeros((3,), jnp.float32)}}
        pparams = tree_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  CPU)
        for jf, pf in (
                (lambda o: js.tile_services(o, 3),
                 lambda o: ps.tile_services(o, 3)),
                (lambda o: js.tile_services(o, 2, shared=()),
                 lambda o: ps.tile_services(o, 2, shared=())),
                (lambda o: js.with_seed(o, 7), lambda o: ps.with_seed(o, 7)),
                (lambda o: js.replicate_seeds(o, 2, antithetic=True),
                 lambda o: ps.replicate_seeds(o, 2, antithetic=True))):
            want = jf(_Obj(params)).params
            got = pf(_Obj(pparams)).params
            for path in (("arr", "key"), ("arr", "flip"), ("arr", "p"),
                         ("rent", "key"), ("rent", "lo")):
                a, b = want, got
                for p in path:
                    a, b = a[p], b[p]
                np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_trace_scenario_matches_past_the_trace(partitionable):
    """[B, T] arrivals and rents with a side channel, the svc trace [B, T,
    K] and a broadcast [T, K] one; materialised past the trace's end (the
    clipped gather repeats its last slot), and a [T] trace broadcast over
    B rows.  ``test_drivers_on_a_composed_scenario_match`` replays one
    through the drivers."""
    rng = np.random.default_rng(7)
    n, L, K = 4, 250, 3
    x = rng.integers(0, 4, (n, L)).astype(np.int32)
    c = rng.uniform(0.1, 0.6, (n, L)).astype(np.float32)
    side = rng.integers(0, 2, (n, L)).astype(np.int32)
    svc3 = rng.integers(0, 4, (n, L, K)).astype(np.float32)
    svc2 = rng.integers(0, 4, (L, K)).astype(np.float32)
    with _both(partitionable):
        for kw in (dict(svc=svc3, side=side), dict(svc=svc2), {}):
            want = js.materialize(js.trace_scenario(x, c, **kw), T, 64)
            got = ps.trace_scenario(x, c, device=CPU, **kw)
            for chunk in (None, 64, 97):
                _equal(want, ps.materialize(got, T, chunk))
        one = ps.materialize(ps.trace_scenario(x[0], c[0], B=2, device=CPU),
                             L)
        np.testing.assert_array_equal(one[0], np.stack([x[0]] * 2))


def _grids(n):
    spec = [(2.5, (0.0, 0.3, 1.0), (1.0, 0.6, 0.0)),
            (8.0, (0.0, 0.45, 1.0), (1.0, 0.5, 0.0)),
            (15.0, (0.0, 0.55, 1.0), (1.0, 0.35, 0.0))]
    spec = [spec[i % 3] for i in range(n)]
    jg = JGrid.from_costs([JCosts(M=m, levels=lv, g=g) for m, lv, g in spec])
    pg = HostingGrid.from_costs([HostingCosts(M=m, levels=lv, g=g)
                                 for m, lv, g in spec], device=CPU)
    return jg, pg


def _composed(mod, n, key_seed=4):
    """The composed leg of ``chip_smoke.py`` at a small size: arrivals a
    weighted mixture of Bernoulli, Poisson and GE-Bernoulli; rents a regime
    switch from uniform rents to ARMA(2, 1) mid-chunk."""
    k = _keys(6, key_seed)
    kw = {} if mod is js else dict(device=CPU)
    pk = (lambda a: a) if mod is js else _pk
    arr = mod.mixture_from_weights(
        [mod.bernoulli_arrivals(pk(k[0]), 0.35, n, **kw),
         mod.poisson_arrivals(pk(k[1]), 2.0, n, **kw),
         mod.ge_arrivals(pk(k[2]), 0.2, 0.3, 0.9, 0.2, n,
                         emission="bernoulli", **kw)],
        [0.5, 0.3, 0.2], pk(k[3]), n)
    rent = mod.regime_switch(
        [mod.uniform_rents(pk(k[4]), 0.35, 0.2, n, **kw),
         mod.arma_rents(pk(k[5]), 0.35, n, ar=(0.55, 0.2), ma=(0.4,), **kw)],
        [150])
    return mod.combine(arr, rent)


def _same(ref, got, trace=True):
    for f in ("total", "rent", "service", "fetch", "level_slots"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f))
    if trace:
        np.testing.assert_array_equal(ref.r_hist, got.r_hist)


@pytest.mark.parametrize("partitionable,n_seeds,anti", [(True, 2, True),
                                                        (False, None, False)])
def test_drivers_on_a_composed_scenario_match(partitionable, n_seeds, anti):
    """alpha-RR, RR and the OPT schedule on the composed scenario, against
    the reference's scenario-fused drivers; the scenario's observations
    materialised and replayed through ``trace_scenario`` give the same
    ``run_fleet`` bits."""
    n = 6
    jg, pg = _grids(n)
    jf, pf = JFleet.for_scenario(jg, T), FleetBatch.for_scenario(pg, T)
    kw = dict(chunk_size=128, n_seeds=n_seeds, antithetic=anti)
    with _both(partitionable):
        jsc, psc = _composed(js, n), _composed(ps, n)
        got = run_fleet(AlphaRR.fleet(pf), pf, scenario=psc, device=CPU, **kw)
        _same(jrun_fleet(JAlphaRR.fleet(jf), jf, scenario=jsc, **kw), got)
        _same(jrun_fleet(JRR.fleet(jf), jf.restrict_to_endpoints(),
                         scenario=jsc, **kw),
              run_fleet(RetroRenting.fleet(pf), pf.restrict_to_endpoints(),
                        scenario=psc, device=CPU, **kw))
        ref_o = jopt_fleet(jf, scenario=jsc, **kw)
        got_o = offline_opt_fleet(pf, scenario=psc, device=CPU, **kw)
        np.testing.assert_array_equal(ref_o.cost, got_o.cost)
        np.testing.assert_array_equal(ref_o.r_hist, got_o.r_hist)
        _same(ref_o.sim, got_o.sim)
        if n_seeds is None:
            x, c, _, _ = ps.materialize(psc, T, 128)
            replay = run_fleet(AlphaRR.fleet(pf), pf,
                               scenario=ps.trace_scenario(x, c, device=CPU),
                               device=CPU, chunk_size=128)
            _same(got, replay)


def test_drivers_take_the_prng_backend():
    """``prng_backend="pallas"`` on ``run_fleet`` (a fan-out), on
    ``offline_opt_fleet`` with the schedule and on
    ``evaluate_schedule_fleet``, against the reference's drivers; a backend
    it does not know and one without a scenario are refused."""
    n = 4
    jg, pg = _grids(n)
    jf, pf = JFleet.for_scenario(jg, T), FleetBatch.for_scenario(pg, T)
    k = _keys(2, seed=31)
    jsc = js.combine(js.ge_arrivals(k[0], 0.2, 0.3, 0.9, 0.2, n,
                                    emission="bernoulli"),
                     js.uniform_rents(k[1], 0.35, 0.2, n))
    psc = ps.combine(ps.ge_arrivals(_pk(k[0]), 0.2, 0.3, 0.9, 0.2, n,
                                    emission="bernoulli", device=CPU),
                     ps.uniform_rents(_pk(k[1]), 0.35, 0.2, n, device=CPU))
    kw = dict(chunk_size=128, n_seeds=2, prng_backend="pallas")
    ref = jrun_fleet([JAlphaRR.fleet(jf), JRR.fleet_lane(jf)], jf,
                     scenario=jsc, **kw)
    got = run_fleet([AlphaRR.fleet(pf), RetroRenting.fleet_lane(pf)], pf,
                    scenario=psc, device=CPU, **kw)
    _same(ref, got)
    ref_o = jopt_fleet(jf, scenario=jsc, **kw)
    got_o = offline_opt_fleet(pf, scenario=psc, device=CPU, **kw)
    np.testing.assert_array_equal(ref_o.cost, got_o.cost)
    np.testing.assert_array_equal(ref_o.r_hist, got_o.r_hist)
    r = got_o.r_hist[::2]
    _same(jeval_fleet(jf, r, scenario=jsc, **kw),
          evaluate_schedule_fleet(pf, r, scenario=psc, device=CPU, **kw),
          trace=False)
    plain = run_fleet(AlphaRR.fleet(pf), pf, scenario=psc, device=CPU,
                      chunk_size=128, n_seeds=2)
    assert not np.array_equal(plain.total, got.policy_view(got.total)[0])
    pol = AlphaRR.fleet(pf)
    with pytest.raises(ValueError, match="prng_backend must be one of"):
        run_fleet(pol, pf, scenario=psc, device=CPU, prng_backend="nope")
    x = np.zeros((n, T), np.int32)
    c = np.full((n, T), 0.3, np.float32)
    with pytest.raises(ValueError, match="needs scenario"):
        offline_opt_fleet(FleetBatch.from_dense(pg, x, c), device=CPU,
                          prng_backend="pallas")


# (K, R) either side of the fleet pricing core's bound R * (K + 4) <= 40;
# each R * (K + 3) <= 40, where evaluate_schedule_batch fuses
FLEET_FUSE = [(4, 5, True), (5, 4, True), (5, 5, False), (6, 4, True),
              (7, 4, False), (8, 3, True)]


@pytest.mark.parametrize("K,R,fused", FLEET_FUSE)
def test_fleet_schedule_pricing_fuses_below_its_own_bound(K, R, fused,
                                                          monkeypatch):
    """The fleet drivers' pricing core (``evaluate_schedule_fleet``, and
    ``offline_opt_fleet``'s schedule) fuses the rent's and the fetch's
    products into their sums while R * (K + 4) <= 40, a tighter bound than
    ``evaluate_schedule_batch``'s R * (K + 3) <= 40
    (``simulator.xla_acc_fma(..., fleet=True)``).  Random schedules on
    levels whose products round, seed after seed, until one where the
    other rounding differs from the reference."""
    import repro_torch.core.fleet as pfleet
    from repro_torch.core.simulator import xla_acc_fma
    assert xla_acc_fma(None, R, K, fleet=True) == fused
    assert xla_acc_fma(None, R, K)
    lv = np.concatenate([[0.0], np.sort(np.random.default_rng(K).uniform(
        0.05, 0.95, K - 2)), [1.0]])
    spec = [(3.0 + i, tuple(lv), tuple(1.0 - lv)) for i in range(R)]
    jg = JGrid.from_costs([JCosts(M=m, levels=a, g=g) for m, a, g in spec])
    pg = HostingGrid.from_costs([HostingCosts(M=m, levels=a, g=g)
                                 for m, a, g in spec], device=CPU)
    jf, pf = JFleet.for_scenario(jg, T), FleetBatch.for_scenario(pg, T)
    told = False
    for seed in range(6):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        jsc = js.combine(js.bernoulli_arrivals(k1, 0.4, R),
                         js.uniform_rents(k2, 0.35, 0.2, R))
        psc = ps.combine(ps.bernoulli_arrivals(_pk(k1), 0.4, R, device=CPU),
                         ps.uniform_rents(_pk(k2), 0.35, 0.2, R, device=CPU))
        r = np.random.default_rng(seed).integers(0, K, (R, T)).astype(
            np.int32)
        want = jeval_fleet(jf, r, scenario=jsc, chunk_size=128)
        _same(want, evaluate_schedule_fleet(pf, r, scenario=psc,
                                            chunk_size=128, device=CPU),
              trace=False)
        with monkeypatch.context() as m:
            m.setattr(pfleet, "xla_acc_fma", lambda *a, **kw: not fused)
            other = evaluate_schedule_fleet(pf, r, scenario=psc,
                                            chunk_size=128, device=CPU)
        if not (np.array_equal(want.rent, other.rent)
                and np.array_equal(want.fetch, other.fetch)):
            told = True
            break
    assert told

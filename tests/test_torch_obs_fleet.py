"""Obs-backed fleets, the backtracked OPT schedule and schedule pricing on
the port against the JAX package, bit for bit, on the CPU (the plain
versions of kernels S, D, B and E).

The obs-backed drivers are held to the reference's per-instance fleet
cores run without their ``shard_map`` wrapper (``tests/_fleet_ref.py``):
``run_fleet`` (one policy, the fan-out with ``PolicyLane`` and
``svc_cols``, ``with_opt_forward``, Model-2 ``svc``, the ``side`` channel,
mixed horizons, chunked, streamed) and ``offline_opt_fleet`` on its four
routes (cost only, materialised, checkpointed with the schedule,
``stream=True``).  The scenario-fused schedule paths and
``evaluate_schedule_fleet`` are held to the reference's own drivers in
both threefry layouts.  The fleet DP prices ``w = c * lv + svc`` as one
FMA and ``offline_opt_batch`` with two roundings; a float-rent case shows
the split."""
import importlib

import numpy as np
import jax
import pytest
import torch

import _fleet_ref as ref
from repro.core import scenarios as js
from repro.core.arrivals import GilbertElliot as JGE
from repro.core.costs import HostingCosts as JCosts, HostingGrid as JGrid
from repro.core.fleet import FleetBatch as JFleet
from repro.core.fleet import evaluate_schedule_fleet as jeval_fleet
from repro.core.fleet import offline_opt_fleet as jopt_fleet
from repro.core.policies import AlphaRR as JAlphaRR, MDPPolicy as JMDP
from repro.core.policies import RetroRenting as JRR
from repro.core.policies.base import PolicyLane as JLane
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.core.arrivals import GilbertElliot
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.fleet import (FleetBatch, evaluate_schedule_fleet,
                                    offline_opt_fleet, run_fleet)
from repro_torch.core.policies import (AlphaRR, MDPPolicy, PolicyLane,
                                       RetroRenting)
from repro_torch.core.policies import offline_opt as popt
from repro_torch.kernels import ops
from repro_torch.kernels.hosting import threefry_partitionable

# the module (repro.core.policies re-exports a function of the same name)
jopt_mod = importlib.import_module("repro.core.policies.offline_opt")
CPU = "cpu"


def _specs(rng, B):
    """B instances: three levels, every third on four (ragged K)."""
    out = []
    for i in range(B):
        M = float(rng.uniform(2.0, 12.0))
        if i % 3 == 2:
            out.append((M, (0.0, 0.25, 0.6, 1.0), (1.0, 0.7, 0.3, 0.0)))
        else:
            a = float(rng.uniform(0.1, 0.7))
            out.append((M, (0.0, a, 1.0), (1.0, max(0.9 - a, 0.0), 0.0)))
    return out


def _fleets(seed=0, B=9, svc=False, side=False, horizons=(40, 64, 97)):
    """The same obs-backed fleet in both packages: mixed horizons, float
    rents in [0.15, 0.55], Bernoulli-like arrivals of 0..2, optionally a
    Model-2 service matrix (counts monotone in the level) and a 0/1 side
    channel."""
    rng = np.random.default_rng(seed)
    specs = _specs(rng, B)
    Ts = rng.choice(horizons, B)
    xs = [rng.integers(0, 3, t) for t in Ts]
    cs = [rng.uniform(0.15, 0.55, t).astype(np.float32) for t in Ts]
    svcs = sides = None
    if svc:
        svcs = [np.floor(x[:, None] * np.asarray(g)[None, :]
                         + rng.random((len(x), len(g)))).astype(np.float32)
                for x, (_, _, g) in zip(xs, specs)]
    if side:
        sides = [rng.integers(0, 2, t) for t in Ts]
    jf = JFleet.from_instances([JCosts(M=m, levels=lv, g=g)
                                for m, lv, g in specs], xs, cs, svcs, sides)
    pf = FleetBatch.from_instances([HostingCosts(M=m, levels=lv, g=g)
                                    for m, lv, g in specs], xs, cs, svcs,
                                   sides, device=CPU)
    return jf, pf


def test_fleet_batch_constructors_match_the_reference():
    """``from_instances`` pads T and K as the reference; ``from_dense``
    broadcasts [T] inputs and defaults T; ``restrict_to_endpoints`` gathers
    the (0, top) service columns; ``per_slot`` / ``instance``."""
    jf, pf = _fleets(svc=True, side=True)
    for f in ("x", "c", "svc", "side", "T"):
        a, b = np.asarray(getattr(jf, f)), getattr(pf, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert pf.T_max == jf.T_max and pf.K == 4
    je, pe = jf.restrict_to_endpoints(), pf.restrict_to_endpoints()
    assert np.array_equal(np.asarray(je.svc), pe.svc)
    assert pe.K == 2 and pe.x is pf.x
    jd = JFleet.from_dense(jf.grid, np.arange(7) % 2, np.full(7, 0.25))
    pd = FleetBatch.from_dense(pf.grid, np.arange(7) % 2, np.full(7, 0.25))
    for f in ("x", "c", "T"):
        assert np.array_equal(np.asarray(getattr(jd, f)), getattr(pd, f)), f
    got = run_fleet(AlphaRR.fleet(pf), pf, device=CPU)
    want = ref.run(JAlphaRR.fleet(jf), jf)
    np.testing.assert_array_equal(want.per_slot, got.per_slot)
    one, two = want.instance(4), got.instance(4)
    assert one.total == two.total and np.array_equal(one.r_hist, two.r_hist)
    assert len(two.r_hist) == pf.T[4]


# (chunk_size, include_final_fetch, collect_trace, stream)
RUNS = [(None, True, True, False), (32, False, True, False),
        (29, True, False, False), (32, False, True, True)]


@pytest.mark.parametrize("chunk,final,trace,stream", RUNS)
def test_run_fleet_matches_the_reference_cores(chunk, final, trace, stream):
    """alpha-RR and RR (the endpoint fleet) on Model-1 observations of
    mixed horizons, chunked or not, streamed or resident."""
    jf, pf = _fleets()
    kw = dict(chunk_size=chunk, include_final_fetch=final,
              collect_trace=trace)
    got = run_fleet(AlphaRR.fleet(pf), pf, device=CPU, stream=stream, **kw)
    ref.assert_same(ref.run(JAlphaRR.fleet(jf), jf, **kw), got, trace)
    je, pe = jf.restrict_to_endpoints(), pf.restrict_to_endpoints()
    got = run_fleet(RetroRenting.fleet(pf), pe, device=CPU, stream=stream,
                    **kw)
    ref.assert_same(ref.run(JRR.fleet(jf), je, **kw), got, trace)


@pytest.mark.parametrize("chunk", [None, 25])
def test_model2_fanout_and_opt_forward_match_the_reference_cores(chunk):
    """Model-2 ``svc``: alpha-RR alone, RR on the endpoint fleet's gathered
    columns, and the fan-out of alpha-RR with RR's ``PolicyLane`` taking
    its ``svc_cols`` and both lanes' OPT frontiers."""
    jf, pf = _fleets(seed=3, svc=True)
    ref.assert_same(ref.run(JAlphaRR.fleet(jf), jf, chunk_size=chunk),
                    run_fleet(AlphaRR.fleet(pf), pf, chunk_size=chunk,
                              device=CPU))
    je, pe = jf.restrict_to_endpoints(), pf.restrict_to_endpoints()
    ref.assert_same(ref.run(JRR.fleet(jf), je, chunk_size=chunk),
                    run_fleet(RetroRenting.fleet(pf), pe, chunk_size=chunk,
                              device=CPU))
    jl = [JLane(JAlphaRR.fleet(jf)),
          JLane(JRR.fleet(jf), grid=jf.grid.restrict_to_endpoints(),
                svc_cols=jf.grid.endpoint_columns())]
    pl = [AlphaRR.fleet_lane(pf, with_svc=True),
          RetroRenting.fleet_lane(pf, with_svc=True)]
    want = ref.fanout(jl, jf, chunk_size=chunk, with_opt=True)
    got = run_fleet(pl, pf, chunk_size=chunk, with_opt_forward=True,
                    device=CPU)
    ref.assert_same(want, got)
    assert got.n_policies == 2
    np.testing.assert_array_equal(want.opt_cost, got.opt_cost)
    # each lane's frontier is the lane fleet's offline_opt_fleet cost
    np.testing.assert_array_equal(
        got.policy_view(got.opt_cost)[1],
        offline_opt_fleet(pe, checkpointed=True, collect_schedule=False,
                          device=CPU).cost)


def test_side_channel_table_policy_matches_the_reference_core():
    """MDP reads the fleet's ``side`` channel (kernel S's table variant's
    plain version), on a Model-2 fleet."""
    jf, pf = _fleets(seed=5, svc=True, side=True)
    kw = dict(p_hl=0.3, p_lh=0.2, rate_h=3.0, rate_l=0.5, emission="poisson")
    cl = [JCosts(M=float(m), levels=tuple(np.asarray(lv)[:k]),
                 g=tuple(np.asarray(g)[:k]))
          for m, lv, g, k in zip(np.asarray(jf.grid.M),
                                 np.asarray(jf.grid.levels),
                                 np.asarray(jf.grid.g),
                                 np.asarray(jf.grid.k_eff()))]
    pc = [HostingCosts(M=c.M, levels=c.levels, g=c.g) for c in cl]
    cms = [0.35] * jf.B
    want = ref.run(JMDP.fleet(jf, cl, [JGE(**kw)] * jf.B, cms), jf,
                   chunk_size=30)
    got = run_fleet(MDPPolicy.fleet(pf, pc, [GilbertElliot(**kw)] * pf.B,
                                    cms), pf, chunk_size=30, device=CPU)
    ref.assert_same(want, got)
    assert (got.level_slots[:, 1:].sum() > 0)


# (Model 2, chunk_size)
OPTS = [(False, None), (False, 32), (True, 25)]


@pytest.mark.parametrize("svc,chunk", OPTS)
def test_offline_opt_fleet_routes_match_the_reference_cores(svc, chunk):
    """Every route of the obs-backed DP -- cost only, materialised,
    checkpointed with the schedule, ``stream=True`` -- gives the
    reference cores' cost, ``r_hist`` and priced schedule."""
    jf, pf = _fleets(seed=7, svc=svc)
    cost, r_hist = ref.opt(jf, chunk)
    np.testing.assert_array_equal(cost, ref.opt(jf, chunk, True, False)[0])
    np.testing.assert_array_equal(r_hist, ref.opt(jf, chunk, True)[1])
    sim = ref.schedule(jf, r_hist, chunk)
    routes = [dict(), dict(checkpointed=True)]
    if chunk is not None:
        routes.append(dict(checkpointed=True, stream=True))
    for kw in routes:
        got = offline_opt_fleet(pf, chunk_size=chunk, device=CPU, **kw)
        np.testing.assert_array_equal(cost, got.cost)
        np.testing.assert_array_equal(r_hist, got.r_hist)
        assert got.r_hist.dtype == np.int64
        ref.assert_same(sim, got.sim)
    got = offline_opt_fleet(pf, chunk_size=chunk, checkpointed=True,
                            collect_schedule=False, device=CPU)
    np.testing.assert_array_equal(cost, got.cost)
    assert got.r_hist is None and got.sim is None
    # the schedule is constant past each row's horizon
    for i, t in enumerate(pf.T):
        assert (r_hist[i, t:] == r_hist[i, t - 1]).all()
    ref.assert_same(sim, evaluate_schedule_fleet(pf, r_hist, chunk_size=chunk,
                                                 device=CPU))


def test_obs_backed_fleet_equals_the_fused_run():
    """``FleetBatch.from_scenario`` materialises the scenario, and the
    obs-backed runs are the scenario-fused runs' bits (the reference's
    fused run besides)."""
    B, T = 6, 150
    jg = JGrid.from_costs([JCosts.three_level(4.0 + i, 0.3, 0.5)
                           for i in range(B)])
    pg = HostingGrid.from_costs([HostingCosts.three_level(4.0 + i, 0.3, 0.5)
                                 for i in range(B)], device=CPU)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    jsc = js.combine(js.bernoulli_arrivals(k1, 0.35, B),
                     js.uniform_rents(k2, 0.35, 0.2, B))
    pk = lambda k: tree_from_numpy(np.asarray(k), CPU)
    psc = ps.combine(ps.bernoulli_arrivals(pk(k1), 0.35, B, device=CPU),
                     ps.uniform_rents(pk(k2), 0.35, 0.2, B, device=CPU))
    fused = FleetBatch.for_scenario(pg, T)
    obs = FleetBatch.from_scenario(pg, psc, T, chunk_size=64)
    jobs = JFleet.from_scenario(jg, jsc, T)
    for f in ("x", "c"):
        assert np.array_equal(np.asarray(getattr(jobs, f)), getattr(obs, f))
    a = run_fleet(AlphaRR.fleet(fused), fused, scenario=psc, chunk_size=64,
                  device=CPU)
    ref.assert_same(a, run_fleet(AlphaRR.fleet(obs), obs, chunk_size=64,
                                 device=CPU))
    o1 = offline_opt_fleet(fused, scenario=psc, chunk_size=64, device=CPU)
    o2 = offline_opt_fleet(obs, chunk_size=64, device=CPU)
    np.testing.assert_array_equal(o1.cost, o2.cost)
    np.testing.assert_array_equal(o1.r_hist, o2.r_hist)
    ref.assert_same(o1.sim, o2.sim)


LAYOUTS = [True, False]


def _scenario_pair(kind, B):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(31), 3)
    pk = lambda k: tree_from_numpy(np.asarray(k), CPU)
    if kind == "ge":
        return (js.combine(js.ge_arrivals(k1, 0.3, 0.2, 0.9, 0.2, B,
                                          emission="bernoulli"),
                           js.na_rents(k2, 0.35, 0.2, B)),
                ps.combine(ps.ge_arrivals(pk(k1), 0.3, 0.2, 0.9, 0.2, B,
                                          emission="bernoulli", device=CPU),
                           ps.na_rents(pk(k2), 0.35, 0.2, B, device=CPU)))
    jg, pg = _grids(B)
    return (js.combine(js.poisson_arrivals(k1, 2.0, B),
                       js.spot_rents(k2, 0.35, B),
                       svc=js.model2_service(k3, jg.g, B, 8)),
            ps.combine(ps.poisson_arrivals(pk(k1), 2.0, B, device=CPU),
                       ps.spot_rents(pk(k2), 0.35, B, device=CPU),
                       svc=ps.model2_service(pk(k3), pg.g, B, 8,
                                             device=CPU)))


def _grids(B):
    spec = [(3.0 + i, (0.0, 0.2 + 0.1 * (i % 4), 1.0),
             (1.0, 0.6 - 0.1 * (i % 4), 0.0)) for i in range(B)]
    return (JGrid.from_costs([JCosts(M=m, levels=lv, g=g)
                              for m, lv, g in spec]),
            HostingGrid.from_costs([HostingCosts(M=m, levels=lv, g=g)
                                    for m, lv, g in spec], device=CPU))


@pytest.mark.parametrize("part", LAYOUTS)
@pytest.mark.parametrize("kind", ["ge", "model2"])
def test_fused_schedule_matches_the_reference(kind, part):
    """Scenario-fused ``offline_opt_fleet(collect_schedule=True)``,
    materialised and checkpointed (the generator state replayed from each
    chunk's checkpoint), with seed replicas and mixed horizons: cost,
    ``r_hist`` and ``sim`` are the reference driver's."""
    B = 4
    jg, pg = _grids(B)
    T = np.array([120, 77, 120, 96], np.int32)
    jf, pf = JFleet.for_scenario(jg, T), FleetBatch.for_scenario(pg, T)
    with jax.threefry_partitionable(part), threefry_partitionable(part):
        jsc, psc = _scenario_pair(kind, B)
        for ck in (False, True):
            kw = dict(chunk_size=50, n_seeds=2, checkpointed=ck)
            want = jopt_fleet(jf, scenario=jsc, **kw)
            got = offline_opt_fleet(pf, scenario=psc, device=CPU, **kw)
            np.testing.assert_array_equal(want.cost, got.cost)
            np.testing.assert_array_equal(want.r_hist, got.r_hist)
            ref.assert_same(want.sim, got.sim)
        got = offline_opt_fleet(pf, scenario=psc, stream=True, **kw,
                                device=CPU)
        np.testing.assert_array_equal(want.r_hist, got.r_hist)


@pytest.mark.parametrize("part", LAYOUTS)
def test_evaluate_schedule_fleet_matches_the_reference(part):
    """Given schedules priced on a scenario's replicas -- [B] rows repeated
    over the seeds and [B * S] rows, antithetic pairs -- and on an
    obs-backed Model-2 fleet."""
    B = 4
    jg, pg = _grids(B)
    T = np.array([90, 61, 90, 33], np.int32)
    jf, pf = JFleet.for_scenario(jg, T), FleetBatch.for_scenario(pg, T)
    rng = np.random.default_rng(9)
    with jax.threefry_partitionable(part), threefry_partitionable(part):
        jsc, psc = _scenario_pair("ge", B)
        for rows in (B, 2 * B):
            r = rng.integers(0, 3, (rows, 90))
            kw = dict(chunk_size=40, n_seeds=2, antithetic=True)
            want = jeval_fleet(jf, r, scenario=jsc, **kw)
            got = evaluate_schedule_fleet(pf, r, scenario=psc, device=CPU,
                                          **kw)
            ref.assert_same(want, got)
    jo, po = _fleets(seed=11, svc=True)
    r = rng.integers(-1, 5, (jo.B, jo.T_max))      # out-of-range levels too
    ref.assert_same(ref.schedule(jo, r, 30),
                    evaluate_schedule_fleet(po, r, chunk_size=30, device=CPU))


def test_fleet_dp_and_offline_opt_batch_round_differently():
    """The fleet DP prices ``w = c * lv + svc`` as one FMA, the reference's
    ``offline_opt_batch`` as two roundings; on float rents their costs
    differ in some rows.  The port follows each: obs-backed
    ``offline_opt_fleet`` is the fleet core's bits, ``offline_opt_batch``
    the reference's own."""
    B, T = 300, 256
    rng = np.random.default_rng(1)
    a = rng.uniform(0.1, 0.7, B)
    spec = [(float(rng.uniform(2, 20)), float(ai), float(max(0.9 - ai, 0)))
            for ai in a]
    # Bernoulli(0.35) arrivals: the optimum holds the partial level often,
    # where the two orders of w differ
    x = (rng.random((B, T)) < 0.35).astype(np.int32)
    c = rng.uniform(0.15, 0.55, (B, T)).astype(np.float32)
    jg = JGrid.from_costs([JCosts.three_level(*s) for s in spec])
    pg = HostingGrid.from_costs([HostingCosts.three_level(*s) for s in spec],
                                device=CPU)
    jf = JFleet.from_dense(jg, x, c)
    fleet_cost, fleet_r = ref.opt(jf)
    batch = jopt_mod.offline_opt_batch(jg, x, c)
    got_fleet = offline_opt_fleet(FleetBatch.from_dense(pg, x, c),
                                  device=CPU)
    got_batch = popt.offline_opt_batch(pg, x, c)
    np.testing.assert_array_equal(fleet_cost, got_fleet.cost)
    np.testing.assert_array_equal(fleet_r, got_fleet.r_hist)
    np.testing.assert_array_equal(batch.cost, got_batch.cost)
    np.testing.assert_array_equal(batch.r_hist, got_batch.r_hist)
    # the costs split (13 of the 300 rows here), the schedules do not
    assert (fleet_cost != batch.cost).sum() > 0
    np.testing.assert_array_equal(fleet_r, batch.r_hist)


def test_drivers_refuse_what_they_do_not_take():
    """The reference's ValueErrors: ``n_seeds`` needs a scenario, a fleet
    with observations takes none, ``stream`` needs a chunk size (and the DP
    the checkpointed route), cost only needs the checkpointed route."""
    jf, pf = _fleets()
    pol = AlphaRR.fleet(pf)
    with pytest.raises(ValueError, match="n_seeds= needs scenario"):
        run_fleet(pol, pf, n_seeds=2, device=CPU)
    with pytest.raises(ValueError, match="stream=True requires chunk_size"):
        run_fleet(pol, pf, stream=True, device=CPU)
    with pytest.raises(ValueError, match="requires checkpointed=True"):
        offline_opt_fleet(pf, stream=True, chunk_size=8, device=CPU)
    with pytest.raises(ValueError, match="requires checkpointed=True"):
        offline_opt_fleet(pf, collect_schedule=False, device=CPU)
    _, psc = _scenario_pair("ge", pf.B)
    with pytest.raises(ValueError, match="obs-less fleet"):
        run_fleet(pol, pf, scenario=psc, device=CPU)
    with pytest.raises(ValueError, match="needs scenario="):
        run_fleet(pol, FleetBatch.for_scenario(pf.grid, 10), device=CPU)


def test_schedule_path_launches_nothing_on_the_cpu():
    """On the CPU the wrappers of D, B and E take their plain versions: no
    launch counter moves."""
    _, pf = _fleets(seed=2)
    before = [k.launches for k in ops.KERNELS]
    got = offline_opt_fleet(pf, chunk_size=32, checkpointed=True, device=CPU)
    assert [k.launches for k in ops.KERNELS] == before
    assert np.isfinite(got.sim.total).all()
    assert (got.sim.total >= got.cost - 1e-4 * pf.T).all()


# ----------------------------------------------------------------------
# The per-instance entry points: one chunk, one horizon.
# ----------------------------------------------------------------------

def _one_instance(seed, K3=True):
    rng = np.random.default_rng(seed)
    T = 120
    spec = ((6.0, (0.0, 0.35, 1.0), (1.0, 0.45, 0.0)) if K3 else
            (9.0, (0.0, 0.2, 0.5, 1.0), (1.0, 0.7, 0.35, 0.0)))
    x = (rng.random(T) < 0.4).astype(np.int32) * rng.integers(1, 3, T)
    c = rng.uniform(0.15, 0.55, T).astype(np.float32)
    g = np.asarray(spec[2])
    svc = np.floor(x[:, None] * g[None, :]
                   + rng.random((T, len(g)))).astype(np.float32)
    return (JCosts(M=spec[0], levels=spec[1], g=spec[2]),
            HostingCosts(M=spec[0], levels=spec[1], g=spec[2]), x, c, svc)


def _same_one(a, b):
    for f in ("total", "rent", "service", "fetch"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.r_hist, b.r_hist)
    np.testing.assert_array_equal(a.level_slots, b.level_slots)


@pytest.mark.parametrize("with_svc", [False, True])
def test_run_policy_and_evaluate_schedule_match_the_reference(with_svc):
    """``run_policy`` (alpha-RR, with and without the final fetch),
    ``run_policy_batch`` ([T] arrivals broadcast over a stacked grid, an
    optional [B, T, K] svc), ``evaluate_schedule`` and
    ``evaluate_schedule_batch``."""
    from repro.core import simulator as jsim
    from repro_torch.core import simulator as psim
    jc, pc, x, c, svc = _one_instance(4)
    svc = svc if with_svc else None
    for final in (True, False):
        _same_one(jsim.run_policy(JAlphaRR(jc), jc, x, c, svc,
                                  include_final_fetch=final),
                  psim.run_policy(AlphaRR(pc), pc, x, c, svc,
                                  include_final_fetch=final, device=CPU))
    rng = np.random.default_rng(8)
    r = rng.integers(0, 3, len(x))
    _same_one(jsim.evaluate_schedule(jc, r, x, c, svc),
              psim.evaluate_schedule(pc, r, x, c, svc, device=CPU))
    jg, pg = _grids(4)
    svcb = None if svc is None else np.stack([svc] * 4)
    want = jsim.run_policy_batch(JAlphaRR.batch(jg), jg, x, c, svcb)
    got = psim.run_policy_batch(AlphaRR.batch(pg), pg, x, c, svcb)
    rb = rng.integers(0, 3, (4, len(x)))
    for a, b in ((want, got),
                 (jsim.evaluate_schedule_batch(jg, rb, x, c, svcb),
                  psim.evaluate_schedule_batch(pg, rb, x, c, svcb))):
        for f in ("total", "rent", "service", "fetch", "r_hist",
                  "level_slots"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.r_hist.dtype == b.r_hist.dtype
        np.testing.assert_array_equal(a.per_slot, b.per_slot)
    with pytest.raises(NotImplementedError, match="item 18"):
        psim.run_policy(AlphaRR(pc), pc, x, c, route=np.zeros((len(x), 3)),
                        device=CPU)


@pytest.mark.parametrize("with_svc", [False, True])
def test_offline_opt_entry_points_match_the_reference(with_svc):
    """``offline_opt`` (three and four levels), ``offline_opt_no_partial``
    and ``offline_opt_batch``, with and without a Model-2 ``svc``: cost,
    schedule and priced schedule; ``brute_force_opt`` on a short
    horizon."""
    for K3 in (True, False):
        jc, pc, x, c, svc = _one_instance(6 + K3, K3)
        svc = svc if with_svc else None
        for jf_, pf_ in ((jopt_mod.offline_opt, popt.offline_opt),
                         (jopt_mod.offline_opt_no_partial,
                          popt.offline_opt_no_partial)):
            want, got = jf_(jc, x, c, svc), pf_(pc, x, c, svc, device=CPU)
            assert want.cost == got.cost
            np.testing.assert_array_equal(want.r_hist, got.r_hist)
            assert got.r_hist.dtype == np.int64
            _same_one(want.sim, got.sim)
    jg, pg = _grids(4)
    rng = np.random.default_rng(12)
    xb = (rng.random((4, 90)) < 0.4).astype(np.int32)
    cb = rng.uniform(0.15, 0.55, (4, 90)).astype(np.float32)
    svcb = (np.floor(xb[:, :, None] * np.asarray(pg.g)[:, None, :]
                     + rng.random((4, 90, 3))).astype(np.float32)
            if with_svc else None)
    want = jopt_mod.offline_opt_batch(jg, xb, cb, svcb)
    got = popt.offline_opt_batch(pg, xb, cb, svcb)
    np.testing.assert_array_equal(want.cost, got.cost)
    np.testing.assert_array_equal(want.r_hist, got.r_hist)
    for f in ("total", "rent", "service", "fetch", "r_hist", "level_slots"):
        np.testing.assert_array_equal(getattr(want.sim, f),
                                      getattr(got.sim, f))
    jc, pc, x, c, svc = _one_instance(9)
    svc = svc[:5] if with_svc else None
    want = jopt_mod.brute_force_opt(jc, x[:5], c[:5], svc)
    got = popt.brute_force_opt(pc, x[:5], c[:5], svc, device=CPU)
    assert want.cost == got.cost
    np.testing.assert_array_equal(want.r_hist, got.r_hist)
    # the DP's optimum is the exhaustive one
    assert abs(popt.offline_opt(pc, x[:5], c[:5], svc, device=CPU).cost
               - got.cost) < 1e-5


def _small(seed, B, K, T=300):
    """B instances of K levels (random interior levels), Bernoulli(0.4)
    arrivals, float rents, a random schedule over every level."""
    rng = np.random.default_rng(seed)
    spec = []
    for _ in range(B):
        lv = tuple(np.r_[0.0, np.sort(rng.uniform(0.05, 0.95, K - 2)), 1.0])
        g = tuple(np.r_[1.0, np.sort(rng.uniform(0.05, 0.6, K - 2))[::-1],
                        0.0])
        spec.append((float(rng.uniform(2, 8)), lv, g))
    x = (rng.random((B, T)) < 0.4).astype(np.int32)
    c = rng.uniform(0.15, 0.55, (B, T)).astype(np.float32)
    r = rng.integers(0, K, (B, T))
    return (JGrid.from_costs([JCosts(M=m, levels=lv, g=g)
                              for m, lv, g in spec]),
            HostingGrid.from_costs([HostingCosts(M=m, levels=lv, g=g)
                                    for m, lv, g in spec], device=CPU),
            x, c, r)


# (family, rows, levels): on both sides of each pinned threshold; MDP and
# ABC also at one row and at R * (K + 3) of 40 and 44 (unfused: their
# bound is 30, not the static policy's 40)
SHAPES = [("schedule", 6, 3), ("schedule", 7, 3), ("schedule", 5, 5),
          ("schedule", 6, 5), ("schedule", 3, 10), ("schedule", 4, 8),
          ("alpha-RR", 1, 4), ("alpha-RR", 1, 8), ("alpha-RR", 1, 9),
          ("alpha-RR", 2, 3), ("static", 3, 10), ("static", 3, 11),
          ("static", 4, 6), ("static", 4, 8),
          ("mdp", 1, 3), ("mdp", 5, 3), ("mdp", 4, 5), ("mdp", 5, 5),
          ("mdp", 4, 8), ("abc", 1, 5), ("abc", 2, 12), ("abc", 2, 13),
          ("abc", 4, 6), ("abc", 4, 8)]

# the fusion bound of each family's R * (K + 3) (alpha-RR: one row of at
# most 8 levels)
_FUSE_BOUND = {"schedule": 40, "static": 40, "mdp": 30, "abc": 30}


def _table_policies(family, jg, pg, B):
    """MDP or ABC on the grids of ``_small`` (the reference's and the
    port's), solved for one GE chain and a mean rent (the observation:
    the side channel, or arrivals of 0 / 1 against a threshold of 0.6)."""
    from repro.core.policies import ABCPolicy as JABC
    from repro_torch.core.policies import ABCPolicy
    spec = [(float(m), tuple(map(float, lv)), tuple(map(float, g)))
            for m, lv, g in zip(np.asarray(jg.M), np.asarray(jg.levels),
                                np.asarray(jg.g))]
    ge = dict(p_hl=0.3, p_lh=0.2, rate_h=1.0, rate_l=0.2)
    JP, PP = (JMDP, MDPPolicy) if family == "mdp" else (JABC, ABCPolicy)
    return (JP.batch(jg, [JCosts(*c) for c in spec], [JGE(**ge)] * B,
                     [0.35] * B),
            PP.batch(pg, [HostingCosts(*c) for c in spec],
                     [GilbertElliot(**ge)] * B, [0.35] * B))


def _fused_case(family, B, K, seed, include_final_fetch=True):
    """One seed of ``test_small_batches_fuse_the_sums_as_the_reference``:
    checks the port against the reference and returns whether the other
    rounding of the fused sums would have differed from the reference
    (``include_final_fetch``: the policy's run with or without the final
    fetch)."""
    iff = include_final_fetch
    from repro.core import simulator as jsim
    from repro.core.policies import StaticPolicy as JStatic
    from repro_torch.core import simulator as psim
    from repro_torch.core.policies import StaticPolicy
    from repro_torch.core.scenarios.base import ObsSlab
    from repro_torch.kernels import hosting as phost
    jg, pg, x, c, r = _small(seed, B, K)
    t = torch.from_numpy
    T_len = torch.full((B,), x.shape[1], dtype=torch.int32)
    acc0 = psim.sim_acc0(B, K, CPU)
    if family == "schedule":
        want = jsim.evaluate_schedule_batch(jg, r, x, c)
        got = psim.evaluate_schedule_batch(pg, r, x, c)
        fma = psim.xla_acc_fma(None, B, K)
        _, acc = phost.schedule_chunk_plain(
            pg.levels, pg.M, T_len, 0, (torch.zeros(B, dtype=torch.int32),
                                        acc0), t(r.astype(np.int32)),
            t(c), x=t(x), g=pg.g, acc_fma=not fma)
        fields = (0, 2)
    else:
        side = np.zeros_like(x)
        if family in ("mdp", "abc"):
            J, P = _table_policies(family, jg, pg, B)
            side = np.random.default_rng(seed + 7).integers(
                0, 2, x.shape).astype(np.int32)
        elif family == "alpha-RR":
            J, P = JAlphaRR.batch(jg), AlphaRR.batch(pg)
        else:
            J, P = (JStatic.batch(jg, np.full(B, K // 2)),
                    StaticPolicy.batch(pg, np.full(B, K // 2)))
        want = jsim.run_policy_batch(J, jg, x, c, side=side,
                                     include_final_fetch=iff)
        got = psim.run_policy_batch(P, pg, x, c, side=side,
                                    include_final_fetch=iff)
        fma = psim.xla_acc_fma(P.step_fn, B, K, iff)
        (_, acc), _ = psim.sim_chunk(
            P, iff, pg.levels, pg.g, pg.M, T_len, 0,
            (P.init_fn(P.params), acc0),
            ObsSlab(t(x), t(c), None, t(side)), rent_fma=not fma)
        fields = (0,)
    for f in ("total", "rent", "service", "fetch", "r_hist", "level_slots"):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f))
    assert fma == (((B * (K + 3) <= _FUSE_BOUND[family])
                    if family != "alpha-RR" else (B == 1 and K <= 8))
                   and (iff or family == "schedule"))
    ref_sums = np.stack([want.rent, want.service, want.fetch], 1)
    other = acc["sums"].numpy().astype(np.float64)
    return any((other[:, k] != ref_sums[:, k]).any() for k in fields)


@pytest.mark.parametrize("family,B,K", SHAPES)
def test_small_batches_fuse_the_sums_as_the_reference(family, B, K):
    """On a small batch the reference's vmapped scan fuses a sum's product
    into its add (``simulator.xla_acc_fma``): ``evaluate_schedule_batch``
    the rent and the fetch while R * (K + 3) <= 40, the static policy the
    rent under the same bound, MDP and ABC the rent and the fetch while R
    * (K + 3) <= 30, alpha-RR the rent on one row of at most 8 levels.
    The port follows on both sides of each threshold, seed after seed,
    until a seed where the other rounding would differ from the reference
    (a product's rounding moves a float32 sum of ~100 only now and then,
    so one seed may not tell the two apart)."""
    told = [_fused_case(family, B, K, 1000 * i + B * 100 + K)
            for i in range(6)]
    assert any(told)


@pytest.mark.parametrize("family,B,K", [("static", 3, 6), ("alpha-RR", 1, 4),
                                        ("mdp", 2, 3), ("abc", 1, 5)])
def test_small_batches_without_the_final_fetch_fuse_nothing(family, B, K):
    """A policy's run without the final fetch (its last slot's fetch
    masked) fuses no sum on a small batch, where the same run with it
    would: the port's rent and fetch stay two roundings there
    (``simulator.xla_acc_fma``, ``xla_fetch_fma``), seed after seed,
    until one where the fused rent would differ from the reference."""
    told = [_fused_case(family, B, K, 1000 * i + B * 100 + K, False)
            for i in range(6)]
    assert any(told)


def test_one_row_fused_fleet_contracts_the_rent_as_the_reference():
    """The scenario-fused ``run_fleet`` of one alpha-RR row (and its
    one-lane fan-out with the OPT frontier) follows the same rule."""
    jg, pg, _, _, _ = _small(41, 1, 5)
    k1, k2 = jax.random.split(jax.random.PRNGKey(41))
    pk = lambda k: tree_from_numpy(np.asarray(k), CPU)
    jsc = js.combine(js.bernoulli_arrivals(k1, 0.4, 1),
                     js.uniform_rents(k2, 0.35, 0.2, 1))
    psc = ps.combine(ps.bernoulli_arrivals(pk(k1), 0.4, 1, device=CPU),
                     ps.uniform_rents(pk(k2), 0.35, 0.2, 1, device=CPU))
    from repro.core.fleet import run_fleet as jrun_fleet
    jf, pf = JFleet.for_scenario(jg, 400), FleetBatch.for_scenario(pg, 400)
    ref.assert_same(jrun_fleet(JAlphaRR.fleet(jf), jf, scenario=jsc),
                    run_fleet(AlphaRR.fleet(pf), pf, scenario=psc,
                              device=CPU))
    want = jrun_fleet([JLane(JAlphaRR.fleet(jf))], jf, scenario=jsc,
                      with_opt_forward=True)
    got = run_fleet([PolicyLane(AlphaRR.fleet(pf))], pf, scenario=psc,
                    with_opt_forward=True, device=CPU)
    ref.assert_same(want, got)
    np.testing.assert_array_equal(want.opt_cost, got.opt_cost)


def test_cost_pieces_match_the_reference():
    """``core/costs.py``'s per-slot pieces and ``per_slot_cost_matrix``
    (Model 1 and a Model-2 matrix), bitwise; ``default_float_dtype`` is
    float32 and a float64 default raises, naming the x64 item."""
    import jax.numpy as jnp
    from repro.core import costs as jc
    from repro_torch.core import costs as pc
    rng = np.random.default_rng(13)
    spec = (7.5, (0.0, 0.3, 0.65, 1.0), (1.0, 0.55, 0.2, 0.0))
    jcost, pcost = JCosts(*spec), HostingCosts(*spec)
    lv32 = np.asarray(spec[1], np.float32)
    g32 = np.asarray(spec[2], np.float32)
    t = torch.from_numpy
    for r_from, r_to in ((0, 2), (3, 1), (2, 2)):
        assert np.float32(jc.fetch_cost(jnp.asarray(lv32), r_from, r_to,
                                        np.float32(7.5))) == \
            pc.fetch_cost(t(lv32), r_from, r_to, np.float32(7.5)).item()
        np.testing.assert_array_equal(
            np.asarray(jc.retro_fetch_cost(jnp.asarray(lv32), r_from,
                                           np.float32(7.5))),
            pc.retro_fetch_cost(t(lv32), r_from, np.float32(7.5)).numpy())
    c_t, x_t = np.float32(0.37), np.int32(3)
    np.testing.assert_array_equal(
        np.asarray(jc.rent_cost(jnp.asarray(lv32), c_t)),
        pc.rent_cost(t(lv32), c_t).numpy())
    np.testing.assert_array_equal(
        np.asarray(jc.service_cost_model1(jnp.asarray(g32), x_t)),
        pc.service_cost_model1(t(g32), x_t).numpy())
    u = rng.random(6).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jc.service_cost_model2_coupled(jnp.asarray(g32), u, 4)),
        pc.service_cost_model2_coupled(t(g32), t(u), 4).numpy())
    x = rng.integers(0, 3, 50).astype(np.int32)
    c = rng.uniform(0.15, 0.55, 50).astype(np.float32)
    svc = (rng.integers(0, 6, (50, 4)) / 2).astype(np.float32)
    for s in (None, svc):
        want = jc.per_slot_cost_matrix(jcost, jnp.asarray(x), jnp.asarray(c),
                                       None if s is None else jnp.asarray(s))
        np.testing.assert_array_equal(
            np.asarray(want),
            pc.per_slot_cost_matrix(pcost, x, c, s, device=CPU).numpy())
    assert pc.default_float_dtype() == torch.float32
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with pytest.raises(NotImplementedError, match="item 1"):
            pc.default_float_dtype()
    finally:
        torch.set_default_dtype(old)

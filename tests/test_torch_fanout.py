"""The policy fan-out of ``run_fleet`` against the reference's, bit for
bit (``np.array_equal``), in both threefry layouts: one generated slab a
chunk stepped by every lane, own-grid lanes (a K = 5 fleet with K = 3 and
K = 2 lanes), mixed horizons, seeds, and the co-executed OPT frontier."""
import numpy as np
import jax
import pytest

from repro.core import scenarios as js
from repro.core.costs import HostingCosts as JCosts, HostingGrid as JGrid
from repro.core.fleet import FleetBatch as JFleet
from repro.core.fleet import run_fleet as jrun_fleet
from repro.core.policies import AlphaRR as JAlphaRR
from repro.core.policies import PolicyLane as JLane
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.fleet import FleetBatch, offline_opt_fleet, run_fleet
from repro_torch.core.policies import AlphaRR, PolicyLane, RetroRenting
from repro_torch.kernels.hosting import threefry_partitionable

LAYOUTS = [True, False]
CPU = "cpu"
MS = (2.0, 5.0, 12.0, 30.0)
T = np.array([180, 240, 240, 97], np.int32)         # mixed horizons


def _costs(cls):
    five = [cls(M=M, levels=(0.0, 0.3, 0.4, 0.5, 1.0),
                g=(1.0, 0.4, 0.3, 0.15, 0.0), c_min=0.07, c_max=1.05)
            for M in MS]
    three = [cls.three_level(M, 0.3, 0.4, c_min=0.07, c_max=1.05)
             for M in MS]
    two = [cls.two_level(M, 0.07, 1.05) for M in MS]
    return five, three, two


def _scenario(mod, key, dev=None):
    B = len(MS)
    kx, kc = (jax.random.split(key) if mod is js else
              tuple(tree_from_numpy(np.asarray(k), CPU)
                    for k in jax.random.split(key)))
    kw = {} if mod is js else dict(device=CPU)
    return mod.combine(
        mod.ge_arrivals(mod.shared_keys(kx, B), 0.4, 0.4, 0.9, 0.1, B,
                        emission="bernoulli", **kw),
        mod.spot_rents(mod.shared_keys(kc, B), 0.35, B, **kw))


def _runs(key, n_seeds, chunk):
    """(reference, port) fan-out results: lane 0 alpha-RR on the K = 5
    fleet grid, lanes 1 and 2 on their own K = 3 / K = 2 grids."""
    out = []
    for mod, Costs, Grid, Fleet, AR, Lane, run, kw in (
            (js, JCosts, JGrid, JFleet, JAlphaRR, JLane, jrun_fleet, {}),
            (ps, HostingCosts, HostingGrid, FleetBatch, AlphaRR,
             PolicyLane, run_fleet, dict(device=CPU))):
        five, three, two = _costs(Costs)
        gkw = {} if mod is js else dict(device=CPU)
        fleet = Fleet.for_scenario(Grid.from_costs(five, **gkw), T)
        lanes = [AR.fleet(fleet)]
        for costs in (three, two):
            g = Grid.from_costs(costs, **gkw)
            lanes.append(Lane(AR.batch(g), grid=g))
        out.append(run(lanes, fleet, scenario=_scenario(mod, key),
                       n_seeds=n_seeds, chunk_size=chunk,
                       with_opt_forward=True, **kw))
    return out


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_fanout_with_opt_forward_matches_the_reference(partitionable):
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        ref, got = _runs(jax.random.PRNGKey(9), n_seeds=2, chunk=64)
    assert (got.n_policies, got.n_seeds) == (3, 2)
    for f in ("total", "rent", "service", "fetch", "level_slots", "r_hist",
              "opt_cost", "T"):
        assert np.array_equal(getattr(got, f), np.asarray(getattr(ref, f))), f
    assert got.level_slots.shape == (3 * len(MS) * 2, 5)
    assert np.array_equal(got.policy_view(got.total),
                          ref.policy_view(ref.total))
    assert (got.policy_view(got.level_slots)[2][:, 2:] == 0).all()


def test_one_lane_and_each_lane_equal_their_standalone_runs():
    """A one-lane fan-out is the standalone run; lane p is its standalone
    run on its own fleet and its ``opt_cost`` that fleet's
    ``offline_opt_fleet``."""
    key = jax.random.PRNGKey(2)
    five, three, two = _costs(HostingCosts)
    fleet = FleetBatch.for_scenario(HostingGrid.from_costs(five, device=CPU),
                                    T)
    kw = dict(scenario=_scenario(ps, key), n_seeds=2, chunk_size=50,
              device=CPU)
    pol = AlphaRR.fleet(fleet)
    alone = run_fleet(pol, fleet, **kw)
    one = run_fleet([pol], fleet, **kw)
    for f in ("total", "level_slots", "r_hist"):
        assert np.array_equal(getattr(one, f), getattr(alone, f))
    lanes = [AlphaRR.fleet_lane(fleet), RetroRenting.fleet_lane(fleet)]
    fan = run_fleet(lanes, fleet, with_opt_forward=True, **kw)
    ends = fleet.restrict_to_endpoints()
    rr = run_fleet(RetroRenting.fleet(fleet), ends, **kw)
    for p, (f, res) in enumerate(((fleet, alone), (ends, rr))):
        assert np.array_equal(fan.policy_view(fan.total)[p], res.total)
        opt = offline_opt_fleet(f, checkpointed=True, collect_schedule=False,
                                **kw)
        assert np.array_equal(fan.policy_view(fan.opt_cost)[p], opt.cost)
    single = run_fleet(pol, fleet, with_opt_forward=True, **kw)
    assert single.n_policies == 1
    assert np.array_equal(single.opt_cost, fan.policy_view(fan.opt_cost)[0])


def test_fanout_refusals():
    five, _, _ = _costs(HostingCosts)
    fleet = FleetBatch.for_scenario(HostingGrid.from_costs(five, device=CPU),
                                    T)
    sc = _scenario(ps, jax.random.PRNGKey(0))
    # Model-2 lanes: alpha-RR ignores with_svc, RR binds its endpoint
    # columns; a column map over a stream without a service channel is
    # refused, as in the reference
    assert AlphaRR.fleet_lane(fleet, with_svc=True).svc_cols is None
    rr = RetroRenting.fleet_lane(fleet, with_svc=True)
    assert np.array_equal(rr.svc_cols.numpy(),
                          np.tile([0, 4], (fleet.B, 1)))
    lane = PolicyLane(AlphaRR.fleet(fleet), grid=fleet.grid,
                      svc_cols=np.zeros((fleet.B, 5), np.int32))
    with pytest.raises(ValueError, match="no Model-2 service channel"):
        run_fleet([lane], fleet, scenario=sc, device=CPU)
    short = HostingGrid.from_costs(five[:2], device=CPU)
    with pytest.raises(ValueError, match="lane grid B=2"):
        run_fleet([PolicyLane(AlphaRR.batch(short), grid=short)], fleet,
                  scenario=sc, device=CPU)
    with pytest.raises(TypeError, match="PolicyFns or PolicyLane"):
        run_fleet([AlphaRR.fleet(fleet), "RR"], fleet, scenario=sc,
                  device=CPU)

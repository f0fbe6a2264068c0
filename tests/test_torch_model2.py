"""Model-2 service on the port against the JAX package, bit for bit
(``np.array_equal``), in both threefry layouts: the shaped uniforms and
the ``model2_service`` stream, the endpoint column helpers, the fan-out
with an RR lane that gathers its endpoint columns (``svc_cols``) and the
co-executed OPT frontiers, and ``offline_opt_fleet`` on a Poisson + spot +
Model-2 scenario."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import scenarios as js
from repro.core.costs import HostingCosts as JCosts, HostingGrid as JGrid
from repro.core.fleet import FleetBatch as JFleet
from repro.core.fleet import offline_opt_fleet as jopt_fleet
from repro.core.fleet import run_fleet as jrun_fleet
from repro.core.policies import AlphaRR as JAlphaRR
from repro.core.policies import RetroRenting as JRR
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.fleet import FleetBatch, offline_opt_fleet, run_fleet
from repro_torch.core.policies import AlphaRR, PolicyLane, RetroRenting
from repro_torch.kernels import hosting as H
from repro_torch.kernels.hosting import threefry_partitionable

LAYOUTS = [True, False]
CPU = "cpu"
MS = (5.0, 20.0, 40.0, 80.0)
LAMS = np.asarray([2.0, 4.0, 8.0, 4.0], np.float32)
T = np.array([150, 200, 200, 77], np.int32)          # mixed horizons
N_MAX = 24


def _pk(key):
    return tree_from_numpy(np.asarray(key), CPU)


@jax.jit
def _ref_uniforms(keys):
    return jax.vmap(lambda k: jax.random.uniform(
        jax.random.wrap_key_data(k), (N_MAX,)))(keys)


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_shaped_uniforms_and_model2_service_match_the_reference(
        partitionable):
    """``uniform(k, (R,))`` of slot keys (even and odd R), and the
    ``model2_service`` stream materialized at chunks of 1, 37 and the
    whole horizon on the reference's Poisson arrivals (K = 3 and a
    ragged-K grid), counts past ``max_per_slot`` included."""
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 2 ** 32, (64, 2), dtype=np.uint64)
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        want = np.asarray(_ref_uniforms(jnp.asarray(keys.astype(np.uint32))))
        k0, k1 = (torch.tensor(keys[:, i].astype(np.int64)) for i in (0, 1))
        got = H.uniform_from_bits(H.shaped_bits(k0, k1, N_MAX)).numpy()
        assert np.array_equal(got, want)
        odd = H.uniform_from_bits(H.shaped_bits(k0, k1, 7)).numpy()
        assert np.array_equal(odd, np.asarray(jax.vmap(
            lambda k: jax.random.uniform(jax.random.wrap_key_data(k), (7,)))(
                jnp.asarray(keys.astype(np.uint32)))))

        key = jax.random.PRNGKey(12)
        kx, ks = jax.random.split(key)
        x, _ = js.materialize_stream(js.poisson_arrivals(kx, LAMS, 4), 120)
        x = np.asarray(x).copy()
        x[0, :5] = 30                                # past max_per_slot
        g3 = np.asarray([[1.0, 0.5, 0.0], [1.0, 0.3, 0.0],
                         [0.9, 0.4, 0.1], [1.0, 0.7, 0.2]], np.float32)
        for g in (g3, np.asarray([1.0, 0.25, 0.6, 0.0], np.float32)):
            want = np.asarray(js.materialize_stream(
                js.model2_service(ks, g, 4, N_MAX), 120, x=x))
            for chunk in (1, 37, None):
                got = ps.materialize_stream(
                    ps.model2_service(_pk(ks), g, 4, N_MAX, device=CPU), 120,
                    chunk, x=x)
                assert np.array_equal(got, want), chunk


def _grid_pair():
    costs = [JCosts.three_level(M, 0.3, 0.5, c_min=0.9, c_max=13.5)
             for M in MS]
    mine = [HostingCosts.three_level(M, 0.3, 0.5, c_min=0.9, c_max=13.5)
            for M in MS]
    return JGrid.from_costs(costs), HostingGrid.from_costs(mine, device=CPU)


def test_endpoint_columns_and_service_match_the_reference():
    """On a mixed-K grid (K = 3 rows and a K = 2 row, padded)."""
    jc = [JCosts.three_level(5.0, 0.3, 0.5), JCosts.two_level(4.0),
          JCosts(M=3.0, levels=(0.0, 0.2, 0.6, 1.0), g=(1.0, 0.7, 0.3, 0.0))]
    pc = [HostingCosts.three_level(5.0, 0.3, 0.5), HostingCosts.two_level(4.0),
          HostingCosts(M=3.0, levels=(0.0, 0.2, 0.6, 1.0),
                       g=(1.0, 0.7, 0.3, 0.0))]
    jg, pg = JGrid.from_costs(jc), HostingGrid.from_costs(pc, device=CPU)
    assert np.array_equal(pg.endpoint_columns().numpy(),
                          np.asarray(jg.endpoint_columns()))
    svc = np.random.default_rng(1).random((3, 11, 4)).astype(np.float32)
    assert np.array_equal(pg.endpoint_service(torch.tensor(svc)).numpy(),
                          np.asarray(jg.endpoint_service(jnp.asarray(svc))))


def _scenario(mod, key, g):
    B = len(MS)
    kx, kc, ks = jax.random.split(key, 3)
    if mod is ps:
        kx, kc, ks = (_pk(k) for k in (kx, kc, ks))
    kw = {} if mod is js else dict(device=CPU)
    return mod.combine(
        mod.poisson_arrivals(mod.shared_keys(kx, B), LAMS, B, **kw),
        mod.spot_rents(mod.shared_keys(kc, B), 4.5, B, **kw),
        svc=mod.model2_service(mod.shared_keys(ks, B), g, B, N_MAX, **kw))


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_model2_fanout_and_offline_opt_match_the_reference(partitionable):
    """alpha-RR on the fleet grid and RR gathering its endpoint columns,
    with the OPT frontiers, mixed horizons, two seeds, chunks of 64; and
    ``offline_opt_fleet`` on the fleet grid, both == the reference."""
    key = jax.random.PRNGKey(5)
    jg, pg = _grid_pair()
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        jf, pf = JFleet.for_scenario(jg, T), FleetBatch.for_scenario(pg, T)
        jsc, psc = _scenario(js, key, jg.g), _scenario(ps, key, pg.g)
        kw = dict(n_seeds=2, chunk_size=64, with_opt_forward=True)
        ref = jrun_fleet([JAlphaRR.fleet_lane(jf),
                          JRR.fleet_lane(jf, with_svc=True)], jf,
                         scenario=jsc, **kw)
        got = run_fleet([AlphaRR.fleet_lane(pf),
                         RetroRenting.fleet_lane(pf, with_svc=True)], pf,
                        scenario=psc, device=CPU, **kw)
        for f in ("total", "rent", "service", "fetch", "level_slots",
                  "r_hist", "opt_cost", "T"):
            assert np.array_equal(getattr(got, f),
                                  np.asarray(getattr(ref, f))), f
        kw = dict(scenario=None, n_seeds=2, chunk_size=50, checkpointed=True,
                  collect_schedule=False)
        want = jopt_fleet(jf, **{**kw, "scenario": jsc})
        opt = offline_opt_fleet(pf, device=CPU, **{**kw, "scenario": psc})
    assert np.array_equal(opt.cost, np.asarray(want.cost))
    assert np.array_equal(got.policy_view(got.opt_cost)[0], opt.cost)
    assert got.service.min() > 0 and (got.opt_cost <= got.total).all()


def test_rr_lane_gather_equals_its_own_endpoint_draws():
    """Coupled uniforms: the RR lane's gathered endpoint columns score it
    as a standalone RR run whose service stream is drawn on the endpoint
    grid's own g; the alpha-RR lane equals its standalone run."""
    key = jax.random.PRNGKey(6)
    _, pg = _grid_pair()
    pf = FleetBatch.for_scenario(pg, T)
    kw = dict(n_seeds=2, chunk_size=70, device=CPU)
    fan = run_fleet([AlphaRR.fleet_lane(pf),
                     RetroRenting.fleet_lane(pf, with_svc=True)], pf,
                    scenario=_scenario(ps, key, pg.g), **kw)
    ends = pf.restrict_to_endpoints()
    rr = run_fleet(RetroRenting.fleet(pf), ends,
                   scenario=_scenario(ps, key, ends.grid.g), **kw)
    ar = run_fleet(AlphaRR.fleet(pf), pf, scenario=_scenario(ps, key, pg.g),
                   **kw)
    for p, res in enumerate((ar, rr)):
        for f in ("total", "service", "r_hist"):
            assert np.array_equal(fan.policy_view(getattr(fan, f))[p],
                                  getattr(res, f)), (p, f)
    # a lane on its own grid without its columns, and columns without a
    # service stream, are refused as in the reference
    bare = PolicyLane(RetroRenting.fleet(pf), grid=ends.grid)
    with pytest.raises(ValueError, match="svc_cols"):
        run_fleet([bare], pf, scenario=_scenario(ps, key, pg.g), **kw)

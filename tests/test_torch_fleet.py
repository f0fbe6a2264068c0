"""Scenario-fused ``run_fleet``, ``offline_opt_fleet(checkpointed=True,
collect_schedule=False)`` and ``mc_summary`` against the JAX package's
scenario-fused drivers, bitwise, on the CPU (the plain versions of the
kernels)."""
import numpy as np
import jax
import pytest

from repro.core import scenarios as js
from repro.core.costs import HostingCosts as JCosts, HostingGrid as JGrid
from repro.core.fleet import FleetBatch as JFleet
from repro.core.fleet import mc_summary as jmc_summary
from repro.core.fleet import offline_opt_fleet as jopt_fleet
from repro.core.fleet import run_fleet as jrun_fleet
from repro.core.policies import AlphaRR as JAlphaRR
from repro.core.policies import RetroRenting as JRR
from repro.core.policies import StaticPolicy as JStatic
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.fleet import (FleetBatch, mc_summary, offline_opt_fleet,
                                    run_fleet)
from repro_torch.core.policies import (AlphaRR, PolicyLane, RetroRenting,
                                      StaticPolicy)
from repro_torch.kernels.hosting import threefry_partitionable

CPU = "cpu"
B = 5
T = [300, 217, 300, 128, 1]
SPEC = [(2.5, (0.0, 0.3, 1.0), (1.0, 0.6, 0.0)),
        (8.0, (0.0, 0.2, 0.45, 0.7, 1.0), (1.0, 0.75, 0.5, 0.2, 0.0)),
        (15.0, (0.0, 0.55, 1.0), (1.0, 0.35, 0.0)),
        (4.0, (0.0, 0.1, 1.0), (1.0, 0.8, 0.0)),
        (30.0, (0.0, 0.5, 1.0), (1.0, 0.4, 0.0))]


def _fleets():
    jg = JGrid.from_costs([JCosts(M=m, levels=lv, g=g) for m, lv, g in SPEC])
    pg = HostingGrid.from_costs([HostingCosts(M=m, levels=lv, g=g)
                                 for m, lv, g in SPEC], device=CPU)
    return JFleet.for_scenario(jg, T), FleetBatch.for_scenario(pg, T)


def _pk(key):
    return tree_from_numpy(np.asarray(key), CPU)


def _scenarios(kind):
    k1, k2 = jax.random.split(jax.random.PRNGKey(21))
    if kind == "bernoulli":
        return (js.combine(js.bernoulli_arrivals(k1, 0.35, B),
                           js.uniform_rents(k2, 0.35, 0.2, B)),
                ps.combine(ps.bernoulli_arrivals(_pk(k1), 0.35, B, device=CPU),
                           ps.uniform_rents(_pk(k2), 0.35, 0.2, B,
                                            device=CPU)))
    return (js.combine(js.ge_arrivals(k1, 0.3, 0.2, 0.9, 0.2, B,
                                      emission="bernoulli"),
                       js.na_rents(k2, 0.35, 0.2, B)),
            ps.combine(ps.ge_arrivals(_pk(k1), 0.3, 0.2, 0.9, 0.2, B,
                                      emission="bernoulli", device=CPU),
                       ps.na_rents(_pk(k2), 0.35, 0.2, B, device=CPU)))


def _same(ref, got, trace=True):
    for f in ("total", "rent", "service", "fetch", "level_slots", "T"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f))
    assert ref.n_seeds == got.n_seeds
    if trace:
        np.testing.assert_array_equal(ref.r_hist, got.r_hist)


# (scenario, n_seeds, antithetic, threefry layout)
CONFIGS = [("bernoulli", None, False, True),
           ("bernoulli", 2, True, False),
           ("ge", 2, False, True),
           ("ge", 2, True, True)]


@pytest.mark.parametrize("kind,n_seeds,anti,part", CONFIGS)
def test_alpha_rr_rr_and_opt_match_reference(kind, n_seeds, anti, part):
    jf, pf = _fleets()
    with jax.threefry_partitionable(part), threefry_partitionable(part):
        jsc, psc = _scenarios(kind)
        kw = dict(chunk_size=128, n_seeds=n_seeds, antithetic=anti)
        ref = jrun_fleet(JAlphaRR.fleet(jf), jf, scenario=jsc, **kw)
        got = run_fleet(AlphaRR.fleet(pf), pf, scenario=psc, device=CPU,
                        **kw)
        _same(ref, got)
        assert mc_summary(got, antithetic=anti).keys() == \
            jmc_summary(ref, antithetic=anti).keys()
        for k, v in jmc_summary(ref, antithetic=anti).items():
            np.testing.assert_array_equal(v, mc_summary(got,
                                                        antithetic=anti)[k])
        jf2, pf2 = jf.restrict_to_endpoints(), pf.restrict_to_endpoints()
        _same(jrun_fleet(JRR.fleet(jf), jf2, scenario=jsc, **kw),
              run_fleet(RetroRenting.fleet(pf), pf2, scenario=psc,
                        device=CPU, **kw))
        ref = jopt_fleet(jf, scenario=jsc, checkpointed=True,
                         collect_schedule=False, **kw)
        got = offline_opt_fleet(pf, scenario=psc, checkpointed=True,
                                collect_schedule=False, device=CPU, **kw)
        np.testing.assert_array_equal(ref.cost, got.cost)
        for k, v in jmc_summary(ref).items():
            np.testing.assert_array_equal(v, mc_summary(got)[k])


def test_static_and_chunking_match():
    jf, pf = _fleets()
    jsc, psc = _scenarios("bernoulli")
    ref = jrun_fleet(JStatic.fleet(jf, jf.grid.top_index()), jf,
                     scenario=jsc, chunk_size=100, include_final_fetch=False)
    got = run_fleet(StaticPolicy.fleet(pf, pf.grid.top_index()), pf,
                    scenario=psc, chunk_size=100, include_final_fetch=False,
                    device=CPU)
    _same(ref, got)
    # chunked == unchunked, and dropping the trace keeps the totals
    whole = run_fleet(AlphaRR.fleet(pf), pf, scenario=psc, device=CPU)
    for chunk in (64, 77):
        part = run_fleet(AlphaRR.fleet(pf), pf, scenario=psc,
                         chunk_size=chunk, collect_trace=chunk == 64,
                         device=CPU)
        _same(whole, part, trace=chunk == 64)
    assert part.r_hist is None
    a = offline_opt_fleet(pf, scenario=psc, checkpointed=True,
                          collect_schedule=False, device=CPU)
    b = offline_opt_fleet(pf, scenario=psc, checkpointed=True,
                          collect_schedule=False, chunk_size=50, device=CPU)
    np.testing.assert_array_equal(a.cost, b.cost)
    # OPT is a lower bound on every online policy's cost
    assert (a.cost <= whole.total + 1e-3 * np.asarray(T)).all()


def test_unported_arguments_raise():
    """What the port does not take yet raises ``NotImplementedError``
    naming its ROADMAP.md item: ``async_ingest`` (item 10), ``gather`` and
    a mesh (item 15) on every fleet driver; a column map without a service
    channel and ``antithetic`` without seeds are the reference's
    ``ValueError``s.  Matrix-valued ``M`` (the joint multi-service grids)
    is ported: ``dp_fetch_matrix`` passes it through untouched."""
    import torch
    from repro_torch.core.fleet import evaluate_schedule_fleet
    from repro_torch.core.policies.offline_opt import dp_fetch_matrix
    _, pf = _fleets()
    _, psc = _scenarios("bernoulli")
    pol = AlphaRR.fleet(pf)
    r = np.zeros((pf.B, pf.T_max), np.int32)
    drivers = (lambda **kw: run_fleet(pol, pf, scenario=psc, device=CPU,
                                      **kw),
               lambda **kw: offline_opt_fleet(pf, scenario=psc, device=CPU,
                                              **kw),
               lambda **kw: evaluate_schedule_fleet(pf, r, scenario=psc,
                                                    device=CPU, **kw))
    for i, call in enumerate(drivers):
        for kw, item in ((dict(async_ingest=True), "Queue 1 item 10"),
                         (dict(gather=True), "Queue 1 item 15"),
                         (dict(mesh=object()), "Queue 1 item 15")):
            if i == 2 and "async_ingest" in kw:
                continue                  # the reference takes none there
            with pytest.raises(NotImplementedError, match=item):
                call(**kw)
    # a Model-2 column map needs a service channel in the stream
    lane = PolicyLane(pol, grid=pf.grid,
                      svc_cols=np.zeros((pf.B, pf.K), np.int32))
    with pytest.raises(ValueError, match="no Model-2 service channel"):
        run_fleet([lane], pf, scenario=psc, device=CPU)
    fm = torch.rand((pf.B, 3, 3))
    assert dp_fetch_matrix(fm, pf.grid.levels) is fm
    with pytest.raises(ValueError, match="antithetic"):
        run_fleet(pol, pf, scenario=psc, antithetic=True, device=CPU)


def test_opt_fleet_runs_the_fused_dp_plain_version_on_the_cpu(monkeypatch):
    """``offline_opt_fleet`` on Model-1 slabs prices each chunk through the
    fused kernel D's wrapper, which on the CPU takes its plain version
    once a chunk; no launch counter moves, and the cost is the
    reference's."""
    from repro_torch.kernels import hosting, ops
    jf, pf = _fleets()
    jsc, psc = _scenarios("bernoulli")
    calls = []
    plain = hosting.dp_fwd_model1_plain

    def spy(*args, **kw):
        calls.append(args[8])                 # t0 of the chunk
        return plain(*args, **kw)

    monkeypatch.setattr(hosting, "dp_fwd_model1_plain", spy)
    before = [k.launches for k in ops.KERNELS]
    got = offline_opt_fleet(pf, scenario=psc, checkpointed=True,
                            collect_schedule=False, chunk_size=64,
                            device=CPU)
    assert [k.launches for k in ops.KERNELS] == before
    n_chunks = len(calls)
    assert n_chunks >= 2 and calls == [i * calls[1] for i in range(n_chunks)]
    ref = jopt_fleet(jf, scenario=jsc, checkpointed=True,
                     collect_schedule=False, chunk_size=64)
    np.testing.assert_array_equal(np.asarray(ref.cost), got.cost)

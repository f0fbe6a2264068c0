"""``repro_torch.figures.theorems`` against the reference module
``benchmarks/theorems.py``, bit for bit on the CPU.

On the installed jax the reference module's own fleet calls raise the
``shard_map`` scan-carry ``TypeError`` (its fleet is obs-backed,
``FleetBatch.from_instances``), so its ``run`` is called with
``run_fleet`` / ``offline_opt_fleet`` swapped for the same drivers on the
reference's per-instance cores without the wrapper
(``tests/_fleet_ref.py``); the rest of its rows come from
``repro.core.bounds``.  Both modules' ``check`` pass."""
import numpy as np

import _fleet_ref as ref
import benchmarks.theorems as bt
from repro.core.fleet import FleetOfflineResult
from repro_torch.core.fleet import (FleetBatch, offline_opt_fleet,
                                    run_fleet)
from repro_torch.core.policies import AlphaRR
from repro_torch.figures import theorems

CPU = "cpu"


def _ref_run_fleet(policy, fleet, include_final_fetch=True, **kw):
    assert not kw
    return ref.run(policy, fleet, include_final_fetch=include_final_fetch)


def _ref_offline_opt_fleet(fleet, **kw):
    assert not kw
    cost, r_hist = ref.opt(fleet)
    return FleetOfflineResult(cost=cost, r_hist=r_hist,
                              sim=ref.schedule(fleet, r_hist))


def _reference_rows(monkeypatch):
    monkeypatch.setattr(bt, "run_fleet", _ref_run_fleet)
    monkeypatch.setattr(bt, "offline_opt_fleet", _ref_offline_opt_fleet)
    return bt.run()


def test_theorem_rows_match_the_reference(monkeypatch):
    want = _reference_rows(monkeypatch)
    got = theorems.run(device=CPU)
    assert got == want
    d = {r["check"]: r for r in got}
    assert d["thm2_empirical_worst_ratio"]["value"] == 1.626086956521739
    assert theorems.check(got) and bt.check(got)


def test_the_thm2_fleet_is_the_reference_fleet(monkeypatch):
    """The 120 mixed-horizon instances, alpha-RR's totals, OPT's cost and
    its schedule priced, bitwise, from one obs-backed fleet of horizons
    24 / 40 / 64."""
    from repro.core.costs import HostingCosts as JCosts
    from repro.core.fleet import FleetBatch as JFleet
    from repro.core.policies import AlphaRR as JAlphaRR
    costs, xs, cs = theorems.instances(0)
    jf = JFleet.from_instances(
        [JCosts(M=c.M, levels=c.levels, g=c.g, c_min=c.c_min, c_max=c.c_max)
         for c in costs], xs, cs)
    pf = FleetBatch.from_instances(costs, xs, cs, device=CPU)
    assert sorted(set(pf.T.tolist())) == [24, 40, 64] and pf.B == 120
    ref.assert_same(ref.run(JAlphaRR.fleet(jf), jf, include_final_fetch=False),
                    run_fleet(AlphaRR.fleet(pf), pf,
                              include_final_fetch=False, device=CPU))
    cost, r_hist = ref.opt(jf)
    got = offline_opt_fleet(pf, device=CPU)
    np.testing.assert_array_equal(cost, got.cost)
    np.testing.assert_array_equal(r_hist, got.r_hist)
    ref.assert_same(ref.schedule(jf, r_hist), got.sim)
    # OPT's priced schedule is its cost (rents on an eighths grid: exact)
    np.testing.assert_array_equal(got.sim.total, got.cost)

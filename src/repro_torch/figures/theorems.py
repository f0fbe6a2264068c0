"""Theorem-level numerical checks (the paper's analytical 'tables'): Thm 2's
ratio bound on random instances, Thm 4's lower bounds above 1, Thm 5's
sigma bounds decaying to 1 with M, Corollary 3's universal 6 (the port of
``benchmarks/theorems.py``).

Thm 2's empirical worst ratio runs its 120 random instances of mixed
horizons (24 / 40 / 64 slots) as ONE obs-backed fleet
(``FleetBatch.from_instances``): alpha-RR through ``run_fleet`` (no final
fetch) on kernel S, alpha-OPT through the default ``offline_opt_fleet``
(the materialised DP: kernel D with its argmin table, the backtrack on
kernel B, the schedule priced on kernel E).  The other rows come from
``core.bounds``.
"""
from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import bounds
from repro_torch.core.costs import HostingCosts
from repro_torch.core.fleet import FleetBatch, offline_opt_fleet, run_fleet
from repro_torch.core.policies import AlphaRR


def instances(seed=0):
    """The reference's 120 random instances, drawn in its order:
    ``(costs_list, xs, cs)``."""
    rng = np.random.default_rng(seed)
    costs_list, xs, cs = [], [], []
    for _ in range(120):
        alpha = rng.choice([0.25, 0.375, 0.5, 0.75])
        g = rng.choice([0.125, 0.25, 0.5])
        M = rng.choice([2.0, 4.0, 8.0])
        T = int(rng.choice([24, 40, 64]))   # mixed horizons, one fleet
        x = rng.integers(0, 2, T)
        c = rng.integers(1, 17, T) / 8.0
        costs_list.append(HostingCosts.three_level(
            M, alpha, g, c_min=float(c.min()), c_max=float(c.max())))
        xs.append(x)
        cs.append(c)
    return costs_list, xs, cs


def thm2_worst_ratio(rr_total, opt_cost) -> float:
    nz = opt_cost > 1e-9
    return float(np.max(rr_total[nz] / opt_cost[nz]))


def bound_rows(worst: float):
    """The rows of the module, Thm 2's empirical worst ratio given."""
    rows = []
    bound_max = 0.0
    for alpha in [0.25, 0.5, 0.75]:
        for g in [0.1, 0.3, 0.5]:
            costs = HostingCosts.three_level(
                max(1.01, (1 - g) / alpha) * 1.1, alpha, g, 0.1, 2.0)
            bound_max = max(bound_max, bounds.corollary3_six(costs))
    rows.append({"check": "thm2_empirical_worst_ratio", "value": worst,
                 "bound": 6.0})
    rows.append({"check": "corollary3_max_bound", "value": bound_max,
                 "bound": 6.0})
    # Thm 4: lower bounds exceed 1 in the non-trivial regime
    lb = bounds.thm4_lower(HostingCosts.three_level(10, 0.4, 0.3, 0.2, 2.0))
    rows.append({"check": "thm4_lower", "value": lb, "bound": 1.0})
    # Thm 5: sigma upper bound decreases toward 1 as M grows (Remark 5)
    sig = []
    for M in [20.0, 50.0, 100.0, 200.0]:
        costs = HostingCosts.three_level(M, 0.3, 0.5, c_min=0.8, c_max=1.2)
        sig.append(bounds.thm5_sigma_upper(costs, p=0.9, c=1.0))
    rows.append({"check": "thm5_sigma_M20_200", "value": sig[-1],
                 "series": [round(s, 4) for s in sig]})
    return rows


def run(seed=0, device=None):
    dev = resolve_device(device)
    costs_list, xs, cs = instances(seed)
    fleet = FleetBatch.from_instances(costs_list, xs, cs, device=dev)
    rr = run_fleet(AlphaRR.fleet(fleet), fleet, include_final_fetch=False,
                   device=dev)
    opt = offline_opt_fleet(fleet, device=dev)
    return bound_rows(thm2_worst_ratio(rr.total, opt.cost))


def check(rows):
    d = {r["check"]: r for r in rows}
    assert d["thm2_empirical_worst_ratio"]["value"] <= 6.0 + 1e-6
    assert d["corollary3_max_bound"]["value"] <= 6.0 + 1e-9
    assert d["thm4_lower"]["value"] > 1.0
    s = d["thm5_sigma_M20_200"]["series"]
    assert all(a >= b - 1e-9 for a, b in zip(s, s[1:])), s   # decreasing in M
    assert s[-1] < 1.05                                       # -> 1
    return True

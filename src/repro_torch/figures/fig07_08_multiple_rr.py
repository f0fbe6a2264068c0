"""Figs 7-8: multiple-RR with extra intermediate levels (alpha, a1, a2) vs
alpha-RR vs RR, Gilbert-Elliot arrivals (Bern(0.9) in H, Bern(0.1) in L).
Paper values: alpha=.3 g=.4 | a1=.4 g=.3 | a2=.5 g=.15, c=0.5 (the port of
``benchmarks/fig07_08_multiple_rr.py``).

The three level-grid families -- K = 5 multiple-RR, K = 3 alpha-RR and the
K = 2 endpoint RR -- are three fan-out lanes over ONE fleet of B = |MS|
instances, each lane scoring on its own grid (Model 1: service ``g_lane *
x``); every GE / spot slab is generated once per chunk and stepped by all
three; the Monte-Carlo axis is ``n_seeds``.
"""
from __future__ import annotations

from repro_torch._device import resolve_device
from repro_torch.core import scenarios as S
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.fleet import FleetBatch, mc_stats, run_fleet
from repro_torch.core.policies import AlphaRR, PolicyLane

LEVELS = (0.0, 0.3, 0.4, 0.5, 1.0)
GS = (1.0, 0.4, 0.3, 0.15, 0.0)
GE = dict(p_hl=0.4, p_lh=0.4, rate_h=0.9, rate_l=0.1)
C_MEAN = 0.5
MS = [2.0, 5.0, 10.0, 20.0, 40.0]
FAMILIES = ("multiple-RR", "alpha-RR", "RR")


def run(T=8000, seed=0, n_seeds=4, device=None):
    dev = resolve_device(device)
    c_lo, c_hi = S.spot_bounds(C_MEAN)
    kx, kc = S.split_keys(S.prng_key(seed, dev), 2)
    fam_costs = {
        "multiple-RR": [HostingCosts(M=M, levels=LEVELS, g=GS,
                                     c_min=c_lo, c_max=c_hi) for M in MS],
        "alpha-RR": [HostingCosts.three_level(M, 0.3, 0.4, c_min=c_lo,
                                              c_max=c_hi) for M in MS],
        "RR": [HostingCosts.two_level(M, c_lo, c_hi) for M in MS],
    }
    # K = 5 fleet grid
    grid = HostingGrid.from_costs(fam_costs["multiple-RR"], device=dev)
    B = grid.B
    sc = S.combine(
        S.ge_arrivals(S.shared_keys(kx, B), GE["p_hl"], GE["p_lh"],
                      GE["rate_h"], GE["rate_l"], B, emission="bernoulli",
                      device=dev),
        S.spot_rents(S.shared_keys(kc, B), C_MEAN, B, device=dev))
    fleet = FleetBatch.for_scenario(grid, T)
    # lane 0 scores on the fleet grid; lanes 1-2 on their own K=3 / K=2
    # grids
    lanes = [AlphaRR.fleet(fleet)]
    for fam in FAMILIES[1:]:
        g_fam = HostingGrid.from_costs(fam_costs[fam], device=dev)
        lanes.append(PolicyLane(AlphaRR.batch(g_fam), grid=g_fam))
    res = run_fleet(lanes, fleet, scenario=sc, n_seeds=n_seeds, device=dev)

    tot = res.policy_view(res.total).reshape(3, B, n_seeds) / T
    mean, ci = mc_stats(tot, axis=2)                            # [3, B]
    hist = res.policy_view(res.level_slots)[0].reshape(B, n_seeds, -1)
    rows = []
    for i, M in enumerate(MS):
        row = {"M": M, "n_seeds": n_seeds}
        for f, fam in enumerate(FAMILIES):
            row[fam] = float(mean[f, i])
            row[f"{fam}_ci95"] = float(ci[f, i])
        row["multi_hist"] = hist[i].mean(axis=0)[:len(LEVELS)].tolist()
        rows.append(row)
    return rows


def check(rows):
    # Fig 7's claim: extra intermediate hosting levels reduce cost
    better = sum(1 for r in rows if r["multiple-RR"] <= r["alpha-RR"] + 1e-6)
    assert better >= len(rows) - 1, rows
    return True

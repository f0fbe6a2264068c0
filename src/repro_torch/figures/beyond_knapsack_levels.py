"""BEYOND-PAPER: data-driven hosting-level grids (the port of
``benchmarks/beyond_knapsack_levels.py``).

The paper closes with "the benefits of using more than three levels of
service hosting is an open problem" and separately builds a measured
g(alpha) curve from trajectory data (§7.2).  This joins the two: choose
the K intermediate levels *from the measured curve* (greedy
max-marginal-gain knee points, a knapsack-flavoured rule) and run
multiple-RR on the resulting grid, against the paper's 3-level alpha-RR at
its best single alpha, RR, and the uniform-grid multiple-RR.

Every candidate grid -- each 3-level curve point for the best-alpha
search, plain RR, and the knapsack / uniform multi-level grids -- is one
lane of the policy fan-out over a B = 1 fleet whose grid is the union of
every candidate's (level, g) points (31 levels at ``seed=0``).  The
Bernoulli + spot + coupled Model-2 service path is generated once per
chunk on that union grid (kernel P's service draws at K = 31); each lane
gathers its own g columns out of the union service slab (kernel S's
column map), bitwise the lane grid's own draws because the Model-2
uniforms are coupled across levels.  ``n_seeds`` Monte-Carlo sample paths
fold into the stream keys; costs are seed means.

Claim tested: measured-curve grids dominate uniform grids of the same K,
and more levels help monotonically (up to noise).
"""
from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import geolife
from repro_torch.core import scenarios as S
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.fleet import FleetBatch, mc_stats, run_fleet
from repro_torch.core.policies import AlphaRR, PolicyLane

C_MEAN = 0.55
M = 10.0
P_ARRIVAL = 0.5
MAX_PER_SLOT = 1   # Bernoulli arrivals: at most one request a slot


def pick_levels(alphas, gs, k: int):
    """Greedy: repeatedly add the level with the best marginal
    service-saving per byte ((g_prev - g) / (a - a_prev)) against the
    current grid — the fractional-knapsack rule on the measured curve."""
    pts = [(float(a), float(g)) for a, g in zip(alphas, gs) if 0.0 < a < 1.0]
    chosen = []
    for _ in range(k):
        best, best_score = None, -np.inf
        for a, g in pts:
            if any(abs(a - c[0]) < 1e-9 for c in chosen):
                continue
            grid = sorted(chosen + [(a, g)])
            # score: total envelope area improvement (lower g envelope)
            xs = [0.0] + [p[0] for p in grid] + [1.0]
            ys = [1.0] + [p[1] for p in grid] + [0.0]
            area = np.trapezoid(ys, xs)
            score = -area
            if score > best_score:
                best, best_score = (a, g), score
        chosen.append(best)
    chosen.sort()
    return chosen


def _grid_costs(levels_g, cmin, cmax):
    levels = tuple([0.0] + [a for a, _ in levels_g] + [1.0])
    gs = tuple([1.0] + [g for _, g in levels_g] + [0.0])
    return HostingCosts(M=M, levels=levels, g=gs, c_min=cmin, c_max=cmax)


def candidates(seed, dev):
    """Every candidate grid of the study and its one fleet:
    ``(curve_pts, grids_k, lanes, grid, scenario)`` -- the curve's
    interior points, ``{k: (knapsack levels, uniform levels)}``, one
    ``PolicyLane`` a candidate (the curve points', RR's, then the knapsack
    and uniform grids of k = 2, 4, 6), the B = 1 union grid and the
    scenario drawn on it."""
    al, gl, _ = geolife.gcurve_from_city(n_side=12, n_train=1200, n_test=400,
                                         seed=seed)
    kx, kc, ks = S.split_keys(S.prng_key(seed, dev), 3)
    cmin, cmax = S.spot_bounds(C_MEAN)

    # every candidate grid is one lane of a mixed-K fan-out
    curve_pts = [(float(a), float(g)) for a, g in zip(al, gl)
                 if 0.0 < a < 1.0 and 0.0 < g < 1.0]
    costs_list = [HostingCosts.three_level(M, a, g, cmin, cmax)
                  for a, g in curve_pts]
    costs_list.append(HostingCosts.two_level(M, cmin, cmax))        # RR
    g_of = lambda a: float(np.interp(a, al, gl))                    # noqa: E731
    grids_k = {}
    for k in (2, 4, 6):
        kn = pick_levels(al, gl, k)
        ua = [(i + 1) / (k + 1) for i in range(k)]
        un = [(a, g_of(a)) for a in ua]
        grids_k[k] = (kn, un)
        costs_list.append(_grid_costs(kn, cmin, cmax))
        costs_list.append(_grid_costs(un, cmin, cmax))

    # union fleet grid: one B = 1 instance holding every distinct candidate
    # (level, g) point (the same float64 values in the same order as the
    # reference, so the same columns); each lane gathers its columns
    union = sorted({(float(lv), float(g))
                    for cc in costs_list for lv, g in zip(cc.levels, cc.g)})
    u_costs = HostingCosts(M=M, levels=tuple(a for a, _ in union),
                           g=tuple(g for _, g in union),
                           c_min=cmin, c_max=cmax)
    grid = HostingGrid.from_costs([u_costs], device=dev)
    col_of = {lv: k for k, (lv, _) in enumerate(union)}
    sc = S.combine(
        S.bernoulli_arrivals(S.shared_keys(kx, 1), P_ARRIVAL, 1, device=dev),
        S.spot_rents(S.shared_keys(kc, 1), C_MEAN, 1, device=dev),
        svc=S.model2_service(S.shared_keys(ks, 1), grid.g, 1, MAX_PER_SLOT,
                             device=dev))
    lanes = []
    for cc in costs_list:
        g_c = HostingGrid.from_costs([cc], device=dev)
        cols = np.array([[col_of[float(lv)] for lv in cc.levels]], np.int32)
        lanes.append(PolicyLane(AlphaRR.batch(g_c), grid=g_c, svc_cols=cols))
    return curve_pts, grids_k, lanes, grid, sc


def run(T=4000, seed=0, n_seeds=4, device=None):
    dev = resolve_device(device)
    curve_pts, grids_k, lanes, grid, sc = candidates(seed, dev)
    n_curve = len(curve_pts)
    fleet = FleetBatch.for_scenario(grid, T)
    res = run_fleet(lanes, fleet, scenario=sc, n_seeds=n_seeds, device=dev)
    # policy-major, B = 1: row p * S + s -> [P, S]
    mean, ci = mc_stats(res.total.reshape(len(lanes), n_seeds) / T, axis=1)

    rows = []
    best = int(np.argmin(mean[:n_curve]))
    rows.append({"grid": "alpha-RR(best alpha)", "K": 1,
                 "cost": float(mean[best]), "cost_ci95": float(ci[best]),
                 "levels": [curve_pts[best][0]], "n_seeds": n_seeds})
    rows.append({"grid": "RR", "K": 0, "cost": float(mean[n_curve]),
                 "cost_ci95": float(ci[n_curve]), "levels": [],
                 "n_seeds": n_seeds})
    for j, k in enumerate((2, 4, 6)):
        kn, un = grids_k[k]
        i_kn = n_curve + 1 + 2 * j
        rows.append({"grid": "knapsack", "K": k, "cost": float(mean[i_kn]),
                     "cost_ci95": float(ci[i_kn]),
                     "levels": [round(a, 3) for a, _ in kn],
                     "n_seeds": n_seeds})
        rows.append({"grid": "uniform", "K": k, "cost": float(mean[i_kn + 1]),
                     "cost_ci95": float(ci[i_kn + 1]),
                     "levels": [round(a, 3) for a, _ in un],
                     "n_seeds": n_seeds})
    return rows


def check(rows):
    d = {(r["grid"], r["K"]): r["cost"] for r in rows}
    rr = d[("RR", 0)]
    best3 = d[("alpha-RR(best alpha)", 1)]
    # multi-level grids should not lose to plain RR, and the best knapsack
    # grid should match or beat the best single-alpha 3-level policy
    for k in (2, 4, 6):
        assert d[("knapsack", k)] <= rr * 1.02 + 1e-6
        assert d[("knapsack", k)] <= d[("uniform", k)] * 1.10 + 1e-6
    assert min(d[("knapsack", k)] for k in (2, 4, 6)) <= best3 * 1.05 + 1e-6
    return True

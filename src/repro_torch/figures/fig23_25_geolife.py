"""Figs 23-25: the shortest-path-service pipeline -- the g(alpha) curve of
the (synthetic-city) trajectory dataset from Dijkstra + the
normalised-hit-rate knapsack; then cost vs cache fraction (Fig 24) and
cost vs M at the best alpha (Fig 25) (the port of
``benchmarks/fig23_25_geolife.py``).

The g-curve is host code (``core/geolife.py``).  The cost sweeps replay
ONE recorded (arrivals, rents) sample path -- Bernoulli(0.5) arrivals and
spot-like rents, materialised once on the device by the array builders --
for every grid point, with the Model-2 service uniforms (one request a
slot) drawn on the device from a shared key.  ``n_seeds`` folds only into
the service key (the trace streams are keyless), so the CIs quantify the
service randomness on a fixed workload.  Fig 24 is one seed-fused
``run_fleet`` over the curve's interior points; Fig 25 one fan-out (alpha-RR
and RR lanes with both OPT frontiers).
"""
from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import arrivals, geolife, rentcosts
from repro_torch.core import scenarios as S
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.fleet import FleetBatch, mc_stats, run_fleet
from repro_torch.core.policies import AlphaRR
from repro_torch.figures.common import scenario_policy_suite

C_MEAN = 0.55   # operating point where the knapsack curve makes partial pay
MAX_PER_SLOT = 1   # Bernoulli arrivals: at most one request a slot


def _sweep_scenario_fn(x, c, ksvc, dev):
    """Trace playback of one shared sample path + the coupled service draws
    at each instance's own g columns."""
    def scenario_fn(grid):
        return S.combine(S.trace_arrivals(x, B=grid.B, device=dev),
                         S.trace_rents(c, B=grid.B, device=dev),
                         svc=S.model2_service(S.shared_keys(ksvc, grid.B),
                                              grid.g, grid.B, MAX_PER_SLOT,
                                              device=dev))
    return scenario_fn


def workload(T, seed, dev):
    """The figure's measured curve and its one recorded sample path:
    ``(alphas, gs, points, cmin, cmax, scenario_fn)``, ``points`` the
    curve's interior (alpha, g) pairs, ``cmin`` / ``cmax`` the recorded
    rents' range, ``scenario_fn(grid)`` the trace playback with the
    service draws on ``grid``'s g."""
    alphas, gs, _ = geolife.gcurve_from_city(n_side=12, n_train=1200,
                                             n_test=400, seed=seed)
    kx, kc, ks = S.split_keys(S.prng_key(seed, dev), 3)
    x = arrivals.bernoulli(kx, 0.5, T, device=dev)
    c = rentcosts.aws_spot_like(kc, C_MEAN, T, device=dev)
    points = [(float(a), float(g)) for a, g in zip(alphas, gs)
              if 0.0 < a < 1.0 and 0.0 < g < 1.0]
    return (alphas, gs, points, float(c.min()), float(c.max()),
            _sweep_scenario_fn(x, c, ks, dev))


def run(T=4000, seed=0, n_seeds=4, device=None):
    dev = resolve_device(device)
    alphas, gs, points, cmin, cmax, scenario_fn = workload(T, seed, dev)
    rows = [{"fig": "23", "alpha": float(a), "g": float(g),
             "served": float(1 - g)} for a, g in zip(alphas, gs)]

    # Fig 24: total cost vs cache fraction alpha (M = 10) -- one seed-fused
    # fleet over the whole knapsack curve
    costs24 = [HostingCosts.three_level(10.0, a, g, cmin, cmax)
               for a, g in points]
    grid24 = HostingGrid.from_costs(costs24, device=dev)
    fleet24 = FleetBatch.for_scenario(grid24, T)
    ar24 = run_fleet(AlphaRR.fleet(fleet24), fleet24,
                     scenario=scenario_fn(grid24), n_seeds=n_seeds,
                     device=dev)
    mean24, ci24 = mc_stats(ar24.seed_view(ar24.total) / T, axis=1)
    for (a, g), tot, ci in zip(points, mean24, ci24):
        rows.append({"fig": "24", "alpha": a, "alpha-RR": float(tot),
                     "alpha-RR_ci95": float(ci), "n_seeds": n_seeds})
    best = int(np.argmin(mean24))
    a_star, g_star = points[best]

    # Fig 25: cost vs M at the best alpha -- one fan-out run (alpha-RR + RR
    # lanes with both OPT frontiers co-executed)
    Ms = [2.0, 5.0, 10.0, 20.0, 40.0]
    costs25 = [HostingCosts.three_level(M, a_star, g_star, cmin, cmax)
               for M in Ms]
    suite = scenario_policy_suite(costs25, scenario_fn, T, n_seeds=n_seeds,
                                  include_bounds=False,
                                  chunk_size=min(1000, T), device=dev)
    for M, r in zip(Ms, suite):
        rows.append({"fig": "25", "alpha": a_star, "M": M, **r})
    return rows


def check(rows):
    curve = [(r["alpha"], r["g"]) for r in rows if r["fig"] == "23"]
    gs = [g for _, g in sorted(curve)]
    assert all(g1 >= g2 - 1e-9 for g1, g2 in zip(gs, gs[1:])), "g non-increasing"
    # footnote 1: saturates below full service even at alpha=1
    assert gs[-1] > 0.0
    f25 = [r for r in rows if r["fig"] == "25"]
    # Fig 25's headline: partial hosting pays -- alpha-RR beats RR on average
    # over the M sweep and can even undercut the *no-partial offline* OPT.
    mean_ar = np.mean([r["alpha-RR"] for r in f25])
    mean_rr = np.mean([r["RR"] for r in f25])
    assert mean_ar <= mean_rr * 1.02 + 1e-6, (mean_ar, mean_rr)
    assert any(r["alpha-RR"] < r["OPT"] * 1.05 for r in f25)
    return True

"""Figs 10-11: trace-driven Model 1 -- cluster-trace-like arrivals (the
bursty GE-Poisson stand-in for the Google cluster trace) + AWS-spot-like
ARMA rents, c = 0.135, regimes (0.239, 0.38) and (0.5, 0.7), cost vs M
(the port of ``benchmarks/fig10_11_trace.py``).

One instance per (regime x M) grid point, all sharing one base sample path
(shared bursty + spot keys); the Monte-Carlo axis is ``n_seeds``, folded
into those keys by the engine, so the whole figure is one fan-out
``run_fleet`` (alpha-RR + RR lanes, the OPT frontiers co-executed).  Rows
report seed means with 95% CIs per (regime, M).
"""
from __future__ import annotations

from repro_torch._device import resolve_device
from repro_torch.core import scenarios as S
from repro_torch.core.arrivals import GilbertElliot
from repro_torch.core.costs import HostingCosts
from repro_torch.figures.common import scenario_policy_suite

C_MEAN = 0.135
BURST = dict(base_rate=0.15, burst_rate=1.2, burst_p=0.08)
REGIMES = {"lt1": (0.239, 0.380), "ge1": (0.5, 0.7)}
MS = [2.0, 5.0, 10.0, 20.0, 40.0]

# stationary mean rate of the bursty GE background (for the LB curves)
X_MEAN = GilbertElliot(p_hl=S.BURSTY_EXIT_P, p_lh=BURST["burst_p"],
                       rate_h=BURST["burst_rate"],
                       rate_l=BURST["base_rate"]).mean_rate


def run(T=8000, seed=0, n_seeds=4, device=None):
    dev = resolve_device(device)
    c_lo, c_hi = S.spot_bounds(C_MEAN)
    kx, kc = S.split_keys(S.prng_key(seed, dev), 2)
    costs_list, meta = [], []
    for regime, (alpha, g_alpha) in REGIMES.items():
        for M in MS:
            costs_list.append(HostingCosts.three_level(
                M, alpha, g_alpha, c_min=c_lo, c_max=c_hi))
            meta.append({"regime": regime, "M": M})

    def scenario_fn(grid):
        return S.combine(
            S.bursty_arrivals(S.shared_keys(kx, grid.B), grid.B, **BURST,
                              device=dev),
            S.spot_rents(S.shared_keys(kc, grid.B), C_MEAN, grid.B,
                         device=dev))

    # the OPT curves come from the co-executed forward frontier (O(B * K)
    # DP memory, never a [B, T, K] table)
    suite = scenario_policy_suite(costs_list, scenario_fn, T,
                                  n_seeds=n_seeds, x_means=X_MEAN,
                                  c_means=C_MEAN, chunk_size=min(2000, T),
                                  device=dev)
    rows = []
    for m, r in zip(meta, suite):
        r.pop("hist")
        rows.append({**m, **r})
    return rows


def check(rows):
    for r in rows:
        assert r["alpha-OPT"] <= r["OPT"] + 1e-6
        if r["regime"] == "ge1":
            assert abs(r["alpha-OPT"] - r["OPT"]) < 5e-3
    # in the <1 regime partial hosting should win somewhere on the sweep
    gaps = [r["RR"] - r["alpha-RR"] for r in rows if r["regime"] == "lt1"]
    assert max(gaps) > -1e-6
    return True

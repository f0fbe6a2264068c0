"""Figs 1-2: total cost per slot and the alpha-RR hosting-state histogram
as a function of alpha + g(alpha).  M = 10, c = 0.35, p = 0.35, alpha = 0.4
(paper values), Bernoulli arrivals, ARMA(4, 2) spot rents (the port of
``benchmarks/fig01_02_alpha_sweep.py``).

One instance per alpha-grid point, every point on ONE base key (shared
keys: all points of a seed replica score the same sample path); the
Monte-Carlo axis is ``n_seeds``; the whole figure is one fan-out
``run_fleet`` with the OPT frontiers co-executed.
"""
from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import scenarios as S
from repro_torch.core.costs import HostingCosts
from repro_torch.figures.common import scenario_policy_suite

M, C_MEAN, P, ALPHA = 10.0, 0.35, 0.35, 0.4
T = 10000
AGS = np.linspace(0.5, 1.4, 10)


def run(T=T, seed=0, n_seeds=4, device=None):
    dev = resolve_device(device)
    c_lo, c_hi = S.spot_bounds(C_MEAN)
    kx, kc = S.split_keys(S.prng_key(seed, dev), 2)
    costs_list, meta = [], []
    for ag in AGS:
        g_alpha = float(np.clip(ag - ALPHA, 0.0, 1.0))
        costs_list.append(HostingCosts.three_level(
            M, ALPHA, g_alpha, c_min=c_lo, c_max=c_hi))
        meta.append({"alpha_plus_g": round(float(ag), 3)})

    def scenario_fn(grid):
        return S.combine(
            S.bernoulli_arrivals(S.shared_keys(kx, grid.B), P, grid.B,
                                 device=dev),
            S.spot_rents(S.shared_keys(kc, grid.B), C_MEAN, grid.B,
                         device=dev))

    suite = scenario_policy_suite(costs_list, scenario_fn, T,
                                  n_seeds=n_seeds, x_means=P, c_means=C_MEAN,
                                  device=dev)
    rows = []
    for m, r in zip(meta, suite):
        hist = r.pop("hist")
        rows.append({**m, **r, "slots_r0": hist[0], "slots_alpha": hist[1],
                     "slots_r1": hist[2]})
    return rows


def check(rows):
    """Paper claims: the partial/no-partial gap is significant iff
    alpha+g(alpha) < 1, and alpha-RR never hosts alpha when >= 1 (Thm 1)."""
    for r in rows:
        if r["alpha_plus_g"] >= 1.0:
            assert r["slots_alpha"] == 0, r      # holds for EVERY seed
            assert r["alpha-RR"] <= r["RR"] * 1.02 + 1e-6, r
    gaps_low = [r["RR"] - r["alpha-RR"] for r in rows if r["alpha_plus_g"] < 0.95]
    assert max(gaps_low) > 0.01, "partial hosting should help when a+g<1"
    return True

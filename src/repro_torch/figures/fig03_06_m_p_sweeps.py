"""Figs 3-6: cost per slot vs fetch cost M (Figs 3/4) and vs arrival
probability p (Figs 5/6), in the alpha+g(alpha) < 1 and >= 1 regimes.
Paper values: c = 0.35; (alpha, g) = (0.239, 0.380) / (0.5, 0.7) (the port
of ``benchmarks/fig03_06_m_p_sweeps.py``).

One instance per (regime x M) and (regime x p) grid point: the M-sweep
points share one base sample path, each p has its own keys (from
``prng_key(seed + 1 + i)``); the Monte-Carlo axis is ``n_seeds``; the
whole figure is one fan-out ``run_fleet`` with the OPT frontiers
co-executed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import scenarios as S
from repro_torch.core.costs import HostingCosts
from repro_torch.figures.common import scenario_policy_suite

C_MEAN = 0.35
REGIMES = {"lt1": (0.239, 0.380), "ge1": (0.5, 0.7)}
MS = [2.0, 5.0, 10.0, 20.0, 40.0]
PS = [0.15, 0.25, 0.35, 0.45, 0.6, 0.8]


def run(T=8000, seed=0, n_seeds=4, device=None):
    dev = resolve_device(device)
    c_lo, c_hi = S.spot_bounds(C_MEAN)
    km = S.split_keys(S.prng_key(seed, dev), 2)
    kp = {p: S.split_keys(S.prng_key(seed + 1 + i, dev), 2)
          for i, p in enumerate(PS)}
    costs_list, meta, kxs, kcs, ps = [], [], [], [], []
    for regime, (alpha, g_alpha) in REGIMES.items():
        for M in MS:
            costs_list.append(HostingCosts.three_level(
                M, alpha, g_alpha, c_min=c_lo, c_max=c_hi))
            kxs.append(km[0])
            kcs.append(km[1])
            ps.append(0.42)
            meta.append({"fig": "3_4", "regime": regime, "M": M, "p": 0.42})
        for p in PS:
            costs_list.append(HostingCosts.three_level(
                10.0, alpha, g_alpha, c_min=c_lo, c_max=c_hi))
            kxs.append(kp[p][0])
            kcs.append(kp[p][1])
            ps.append(p)
            meta.append({"fig": "5_6", "regime": regime, "M": 10.0, "p": p})
    kxs, kcs = torch.stack(kxs), torch.stack(kcs)
    ps = np.asarray(ps, np.float32)

    def scenario_fn(grid):
        return S.combine(S.bernoulli_arrivals(kxs, ps, grid.B, device=dev),
                         S.spot_rents(kcs, C_MEAN, grid.B, device=dev))

    suite = scenario_policy_suite(costs_list, scenario_fn, T,
                                  n_seeds=n_seeds, x_means=ps, c_means=C_MEAN,
                                  device=dev)
    return [{**m, **{k: v for k, v in r.items() if k != "hist"}}
            for m, r in zip(meta, suite)]


def check(rows):
    for r in rows:
        # online never beats its offline optimal; partial-capable OPT <= OPT
        assert r["alpha-RR"] >= r["alpha-OPT"] - 1e-6
        assert r["alpha-OPT"] <= r["OPT"] + 1e-6
        if r["regime"] == "ge1":
            assert abs(r["alpha-OPT"] - r["OPT"]) < 5e-3   # gap vanishes (Thm 1)
            assert r["alpha-RR"] <= r["RR"] + 5e-3
    return True

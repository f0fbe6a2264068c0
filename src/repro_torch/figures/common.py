"""Shared helpers of the figure modules (the port of the fused part of
``benchmarks/common.py``).

A figure is ONE ``run_fleet`` on the policy fan-out axis: lane 0 runs
alpha-RR on the figure's grids, lane 1 RR on their endpoint restrictions,
and with ``run_opt`` each lane's offline-DP frontier runs in the same chunk
loop (``with_opt_forward``), so every workload slab is generated once and
stepped by every family.  The Monte-Carlo axis is ``n_seeds``, folded into
the stream keys by the engine.  Rows are per grid point, seed means with
Student-t 95% half-widths (``mc_stats``).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core import bounds
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.fleet import (FleetBatch, FleetOfflineResult,
                                    FleetResult, mc_stats, run_fleet)
from repro_torch.core.policies import AlphaRR, RetroRenting


class FamilyResults:
    """Results of one fused {full-grid, endpoint} family run.

    ``online`` / ``offline`` rows are family-major (= lane-major), then
    instance-major, then seed-minor: row ``(fam * B + b) * S + s``.
    ``split(arr)`` returns one ``[B, S, ...]`` view per family."""

    def __init__(self, online: FleetResult,
                 offline: Optional[FleetOfflineResult], B: int,
                 us_per_slot: float):
        self.online = online
        self.offline = offline
        self.B = B
        self.us_per_slot = us_per_slot

    def split(self, a):
        S = self.online.n_seeds
        a = np.asarray(a)
        a = a.reshape((-1, self.B, S) + a.shape[1:])
        return a[0], a[1]


def fused_policy_families(costs_list: Sequence[HostingCosts],
                          scenario_fn: Callable, T, *,
                          n_seeds: Optional[int] = None,
                          chunk_size: Optional[int] = None,
                          run_opt: bool = True,
                          device=None) -> FamilyResults:
    """Run a figure's {alpha-RR, RR[, alpha-OPT, OPT]} curves as ONE
    fan-out ``run_fleet``: lane 0 alpha-RR on the figure's grids, lane 1 RR
    on their endpoint restrictions, and (``run_opt``) each lane's DP
    frontier co-executed; its minima are the OPT curves, bitwise
    ``offline_opt_fleet(checkpointed=True, collect_schedule=False)``.
    ``scenario_fn(grid) -> Scenario`` is called once, on the full grid
    (which lies on ``device``).  The run is made twice and the second is
    timed (``us_per_slot``), as the reference times a warm run."""
    B = len(costs_list)
    grid = HostingGrid.from_costs(list(costs_list), device=device)
    sc = scenario_fn(grid)
    Ts = np.broadcast_to(np.asarray(T, np.int32), (B,))
    fleet = FleetBatch.for_scenario(grid, Ts)
    lanes = [AlphaRR.fleet_lane(fleet),
             RetroRenting.fleet_lane(fleet, with_svc=sc.has_svc)]
    kw = dict(scenario=sc, chunk_size=chunk_size, n_seeds=n_seeds,
              with_opt_forward=run_opt, device=device)
    run_fleet(lanes, fleet, **kw)                  # warm-up, not timed
    t0 = time.time()
    online = run_fleet(lanes, fleet, **kw)
    us = (time.time() - t0) / (float(np.sum(Ts)) * online.n_seeds) * 1e6
    offline = (FleetOfflineResult(cost=online.opt_cost, r_hist=None,
                                  sim=None, n_seeds=online.n_seeds)
               if run_opt else None)
    return FamilyResults(online, offline, B, us)


def scenario_policy_suite(costs_list: Sequence[HostingCosts],
                          scenario_fn: Callable, T: int, *,
                          n_seeds: Optional[int] = None,
                          x_means=None, c_means=None,
                          include_bounds: bool = True,
                          include_opt: bool = True,
                          chunk_size: Optional[int] = None,
                          device=None):
    """The classic six-curve suite, one fused run per figure: one row per
    grid point with 'alpha-RR', 'RR', 'alpha-OPT', 'OPT' (per slot, seed
    means; ``<col>_ci95`` and ``n_seeds`` with ``n_seeds``), the alpha-RR
    level histogram 'hist', '_us_per_slot' and, given the analytic
    arrival / rent means, the Lemma-14 'alpha-LB' and 'LB' curves.
    Arguments as ``benchmarks/common.py:scenario_policy_suite``, plus
    ``device``."""
    B = len(costs_list)
    fam = fused_policy_families(costs_list, scenario_fn, T,
                                n_seeds=n_seeds, chunk_size=chunk_size,
                                run_opt=include_opt, device=device)
    Ts = np.broadcast_to(np.asarray(T, np.float64), (B,))

    cols = OrderedDict()
    ar_bs, rr_bs = fam.split(fam.online.total)
    cols["alpha-RR"] = ar_bs / Ts[:, None]
    cols["RR"] = rr_bs / Ts[:, None]
    if include_opt:
        aopt_bs, opt_bs = fam.split(fam.offline.cost)
        cols["alpha-OPT"] = aopt_bs / Ts[:, None]
        cols["OPT"] = opt_bs / Ts[:, None]
    hist_bs, _ = fam.split(fam.online.level_slots)     # [B, S, K]

    if include_bounds and (x_means is None or c_means is None):
        include_bounds = False
    if include_bounds:
        x_means = np.broadcast_to(np.asarray(x_means, np.float64), (B,))
        c_means = np.broadcast_to(np.asarray(c_means, np.float64), (B,))

    stats = {k: mc_stats(v, axis=1) for k, v in cols.items()}
    rows = []
    for i, costs in enumerate(costs_list):
        row = {k: float(mean[i]) for k, (mean, _) in stats.items()}
        if n_seeds is not None:
            row.update({f"{k}_ci95": float(ci[i])
                        for k, (_, ci) in stats.items()})
            row["n_seeds"] = int(n_seeds)
        row["_us_per_slot"] = fam.us_per_slot
        row["hist"] = hist_bs[i].mean(axis=0)[:costs.K].tolist()
        if include_bounds:
            row["alpha-LB"] = bounds.lemma14_opt_on_per_slot(
                costs, float(x_means[i]), float(c_means[i]))
            row["LB"] = min(float(c_means[i]), float(x_means[i]))
        rows.append(row)
    return rows

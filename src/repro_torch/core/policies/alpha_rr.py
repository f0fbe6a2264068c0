"""alpha-RetroRenting (Algorithm 1 of the paper): the port of
``repro/core/policies/alpha_rr.py``.

``alpha_rr_step`` is the O(1)-per-slot formulation over [R] rows: with
``w_t[k]`` the rent+service cost of holding level k in slot t and ``r`` the
held level, Algorithm 1's comparison reduces to the suffix minima

    S_j(t) = d_t[j] + min(0, S_j(t-1)),   d_t[j] = w_t[j] - w_t[r]

(``S = +BIG`` right after a switch), and the policy switches to
``argmin_j M|lv_j - lv_r| + S_j`` when that margin is negative.  On the
card the slot loop runs as kernel S (``kernels.hosting.sim_chunk_alpha_rr``);
this step is its plain version's body, op for op the reference's as
XLA:CPU compiles it (two multiply-adds contracted into FMAs).

ONE instance is a one-row grid (``alpha_rr_params``).
``alpha_rr_step_eager`` is the same step with the two multiply-adds
rounded twice: the reference's ``HostingController`` calls the step outside
any ``jit``, so each ``jnp`` op rounds on its own there.

``alpha_rr_literal`` is the reference's numpy transliteration of
Algorithm 1, copied as the test oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.policies.base import (OnlinePolicy, PolicyFns,
                                            PolicyLane, SlotObs, State)
from repro_torch.kernels.hosting import fma32

_BIG = float(np.float32(3.4e38))   # acts as +inf for min(0, .) gating
_TIE_EPS = float(np.float32(1e-6))  # ties break toward staying


def alpha_rr_params(costs: HostingCosts, device=None) -> dict:
    """One instance's params, a one-row grid: ``M`` [1], ``levels`` and
    ``mask`` [1, K], on ``device`` (None: the card, as every entry point
    resolves it)."""
    return alpha_rr_grid_params(HostingGrid.from_costs([costs],
                                                       device=device))


def alpha_rr_grid_params(grid: HostingGrid) -> dict:
    """[R]-leading params: fetch cost ``M``, ``levels`` and level ``mask``."""
    return {"M": grid.M.to(torch.float32),
            "levels": grid.levels.to(torch.float32),
            "mask": grid.mask}


def alpha_rr_init(params) -> State:
    R, K = params["levels"].shape
    dev = params["levels"].device
    return {"r": torch.zeros((R,), dtype=torch.int32, device=dev),
            "S": torch.full((R, K), _BIG, dtype=torch.float32, device=dev),
            "age": torch.zeros((R,), dtype=torch.int32, device=dev)}


def _mul_add_rounded(a, b, c):
    return a * b + c                                # two roundings


def alpha_rr_step(params, state: State, obs: SlotObs) -> State:
    """One slot for every row, the multiply-adds fused (the fleet scan and
    kernel S)."""
    return _step(params, state, obs, fma32)


def alpha_rr_step_eager(params, state: State, obs: SlotObs) -> State:
    """``alpha_rr_step`` with ``c * lv + svc`` and the margins rounded
    twice, as the reference's eager ``HostingController`` computes them;
    on a near tie the two roundings can pick another level."""
    return _step(params, state, obs, _mul_add_rounded)


def _step(params, state: State, obs: SlotObs, mul_add) -> State:
    # index-r selections are one-hot sums, as in the reference (exact: one
    # nonzero term)
    lv, mask = params["levels"], params["mask"]
    K = lv.shape[-1]
    r = state["r"]
    onehot_r = torch.arange(K, device=lv.device)[None, :] == r[:, None]
    age = state["age"] + 1                          # slots since t_recent
    gate = (age >= 2)[:, None]

    # XLA:CPU contracts the reference's c * lv + svc and M * |.| + S into
    # FMAs (one rounding each) inside a jit; mul_add is fma32 there
    w = mul_add(obs.c[:, None], lv, obs.svc)        # [R, K]
    d = w - torch.where(onehot_r, w, 0.0).sum(dim=1, keepdim=True)

    S_prev = state["S"]
    S_new = d + torch.clamp_max(S_prev, 0.0)        # d + min(0, S_prev)
    S = torch.where(gate, S_new, S_prev)

    lv_r = torch.where(onehot_r, lv, 0.0).sum(dim=1, keepdim=True)
    margins = mul_add(params["M"][:, None], torch.abs(lv - lv_r),
                      torch.where(gate, S, _BIG))
    margins = torch.where(mask, margins, _BIG)      # padded levels never win
    margins = torch.where(onehot_r, 0.0, margins)
    j_star = torch.argmin(margins + torch.where(onehot_r, 0.0, _TIE_EPS),
                          dim=1)
    margin_star = torch.gather(margins, 1, j_star[:, None])[:, 0]
    switch = margin_star < -0.0
    r_next = torch.where(switch, j_star.to(torch.int32), r)
    return {"r": r_next,
            "S": torch.where(switch[:, None], _BIG, S),
            "age": torch.where(switch, 0, age).to(torch.int32)}


class AlphaRR(OnlinePolicy):
    """O(1)-per-slot alpha-RetroRenting over an arbitrary level grid (K=2
    is RetroRenting, K=3 the paper's alpha-RR, K>3 multiple-RR).
    ``AlphaRR(costs)`` is one instance; ``batch`` / ``fleet`` build the
    [R]-row policy of a grid."""

    init_fn = staticmethod(alpha_rr_init)
    step_fn = staticmethod(alpha_rr_step)

    def params_on(self, device=None):
        return alpha_rr_params(self.costs, device)

    @classmethod
    def batch(cls, grid: HostingGrid) -> PolicyFns:
        return PolicyFns("alpha-RR", alpha_rr_init, alpha_rr_step,
                         alpha_rr_grid_params(grid))

    @classmethod
    def fleet(cls, fleet) -> PolicyFns:
        """Policy batch for ``core.fleet.run_fleet`` (alpha-RR carries no
        horizon state; the engine masks each row's own T)."""
        return cls.batch(fleet.grid)

    @classmethod
    def fleet_lane(cls, fleet, with_svc: bool = False) -> PolicyLane:
        """This policy as ONE entry of ``run_fleet``'s fan-out axis, on the
        fleet's own grid (a Model-2 slab applies directly, so ``with_svc``
        changes nothing)."""
        del with_svc
        return PolicyLane(cls.fleet(fleet))



class RetroRenting(AlphaRR):
    """RR of [22]: AlphaRR on the endpoint levels (0, 1); run a fleet of it
    on ``fleet.restrict_to_endpoints()``."""

    def __init__(self, costs: HostingCosts):
        super().__init__(HostingCosts.two_level(costs.M, costs.c_min,
                                                costs.c_max))

    @classmethod
    def batch(cls, grid: HostingGrid) -> PolicyFns:
        return PolicyFns("RR", alpha_rr_init, alpha_rr_step,
                         alpha_rr_grid_params(grid.restrict_to_endpoints()))

    @classmethod
    def fleet_lane(cls, fleet, with_svc: bool = False) -> PolicyLane:
        """RR as a fan-out lane on its OWN endpoint accounting grid: under
        Model 1 it prices ``g * x`` from the endpoint grid's g row; under a
        Model-2 slab (``with_svc=True``) it gathers its two columns out of
        the fleet-grid slab (``grid.endpoint_columns()``)."""
        grid = fleet.grid
        return PolicyLane(cls.fleet(fleet), grid=grid.restrict_to_endpoints(),
                          svc_cols=grid.endpoint_columns() if with_svc
                          else None)


# ----------------------------------------------------------------------
# Literal Algorithm 1 (numpy, O(t) per slot) — test oracle, copied from
# the reference.
# ----------------------------------------------------------------------

def alpha_rr_literal(costs: HostingCosts, x: np.ndarray, c: np.ndarray,
                     svc: np.ndarray | None = None) -> np.ndarray:
    """Run Algorithm 1 exactly as printed; returns r_hist (level index held
    during each slot, length T).  ``svc`` is the [T, K] realized service
    cost; None means Model 1 (g[k] * x_t)."""
    lv = np.asarray(costs.levels, np.float64)
    g = np.asarray(costs.g, np.float64)
    T = len(x)
    K = costs.K
    if svc is None:
        svc = np.asarray(x, np.float64)[:, None] * g[None, :]
    svc = np.asarray(svc, np.float64)
    c = np.asarray(c, np.float64)

    def total_cost(seq_levels: np.ndarray, lo: int, hi: int) -> float:
        idx = np.arange(lo, hi + 1)
        ks = seq_levels
        cost = float(np.sum(c[idx] * lv[ks]) + np.sum(svc[idx, ks]))
        cost += costs.M * float(np.sum(np.abs(lv[ks[1:]] - lv[ks[:-1]])))
        return cost

    r_hist = np.zeros(T, np.int64)
    r = 0
    t_recent = 0
    for t in range(1, T + 1):
        r_hist[t - 1] = r
        lo, hi = t_recent, t - 1
        n = hi - lo + 1
        best = np.full(K, np.inf)
        for j in range(K):
            for stay in range(1, n):
                seq = np.concatenate([np.full(stay, r), np.full(n - stay, j)])
                v = total_cost(seq, lo, hi)
                if v < best[j]:
                    best[j] = v
        best[r] = min(best[r], total_cost(np.full(n, r), lo, hi))
        j_star = int(np.argmin(best + 1e-6 * (np.arange(K) != r)))
        if j_star != r and best[j_star] < best[r]:
            r = j_star
            t_recent = t
    return r_hist


def alpha_rr_hosting(costs: HostingCosts, x, c, svc=None,
                     device=None) -> np.ndarray:
    """Run alpha-RR over one instance's whole arrays; returns its r_hist
    [T] (``simulator.run_policy``, kernel S on ``device``, the card by
    default)."""
    from repro_torch.core.simulator import run_policy
    return run_policy(AlphaRR(costs), costs, x, c, svc,
                      device=device).r_hist

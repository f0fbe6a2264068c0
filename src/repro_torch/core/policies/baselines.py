"""Baseline policies from the paper's simulation sections (the port of
``repro/core/policies/baselines.py``).

* ``StaticPolicy`` -- hold one level forever (never / always-partial /
  always-full).
* ``MDPPolicy`` -- §7.1.2's "MDP policy": knows the Gilbert-Elliot chain,
  its per-state rates and the mean rent; solves the average-cost MDP over
  (chain state, hosting level) by relative value iteration and plays the
  stationary policy, observing the chain state (``obs.side``).
* ``ABCPolicy`` -- "Arrival Based Caching" [26]: infers the chain state
  from the slot's arrivals (``x >= (rate_h + rate_l) / 2``) and plays the
  level minimising the expected per-slot cost with the fetch amortised
  over the inferred state's expected sojourn.

The decision tables are solved on the host in numpy, as in the reference
(``solve_mdp`` in float64), and stepped as int32 ``[R, S, K]`` tables: a
table step is ``r' = pi[row, s, r]``.  ``simulator.sim_chunk`` sends every
static, MDP and ABC step to kernel S's table variant.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.arrivals import GilbertElliot
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.policies.base import (OnlinePolicy, PolicyFns, SlotObs,
                                            State)


# ----------------------------------------------------------------------
# StaticPolicy
# ----------------------------------------------------------------------

def static_init(params) -> State:
    # slot 1 starts at level 0 (service not hosted); the target level is
    # taken at the first decision point
    return {"r": torch.zeros_like(params["level_idx"])}


def static_step(params, state: State, obs: SlotObs) -> State:
    return {"r": params["level_idx"]}


class StaticPolicy:
    """Hold one level forever (never / always-partial / always-full)."""

    @classmethod
    def batch(cls, grid: HostingGrid, level_idx) -> PolicyFns:
        """``level_idx`` is a scalar or a [B] tensor of target levels (e.g.
        ``grid.top_index()`` for always-full on mixed-K grids)."""
        idx = torch.as_tensor(level_idx, dtype=torch.int32,
                              device=grid.device).expand(grid.B).clone()
        return PolicyFns("static", static_init, static_step,
                         {"level_idx": idx})

    @classmethod
    def fleet(cls, fleet, level_idx) -> PolicyFns:
        return cls.batch(fleet.grid, level_idx)


# ----------------------------------------------------------------------
# MDP / ABC: stationary decision tables pi[s, k] -> k' (numpy, host).
# ----------------------------------------------------------------------

def _expected_svc_rates(costs: HostingCosts, rates: np.ndarray) -> np.ndarray:
    """E[service cost | chain state s, level k] = g_k * rate_s  (Model 1 and
    Model 2 agree in expectation)."""
    g = np.asarray(costs.g, np.float64)
    return rates[:, None] * g[None, :]          # [S, K]


def solve_mdp(costs: HostingCosts, ge: GilbertElliot, c_mean: float,
              iters: int = 2000, tol: float = 1e-10) -> np.ndarray:
    """Relative value iteration (float64) for the average-cost MDP over
    (chain s in {0 = L, 1 = H}, level k); the action is the next level k',
    its fetch paid now, the next slot's service drawn at s' ~ P(. | s).
    Returns pi [S, K] -> next-level index."""
    lv = np.asarray(costs.levels, np.float64)
    K = costs.K
    P = np.array([[1 - ge.p_lh, ge.p_lh], [ge.p_hl, 1 - ge.p_hl]])  # [s, s']
    rates = np.array([ge.rate_l, ge.rate_h])
    svc = _expected_svc_rates(costs, rates)     # [S, K]
    hold = c_mean * lv[None, :] + svc           # E[cost | s', k'] for holding
    fetch = costs.M * np.maximum(lv[None, :] - lv[:, None], 0.0)  # [k, k']

    V = np.zeros((2, K))
    for _ in range(iters):
        # Q[s, k, k'] = fetch[k,k'] + sum_s' P[s,s'] (hold[s',k'] + V[s',k'])
        cont = np.einsum("st,tk->sk", P, hold + V)   # [s, k']
        Q = fetch[None, :, :] + cont[:, None, :]
        V_new = Q.min(axis=2)
        V_new = V_new - V_new[0, 0]                  # relative VI normalisation
        if np.max(np.abs(V_new - V)) < tol:
            V = V_new
            break
        V = V_new
    cont = np.einsum("st,tk->sk", P, hold + V)
    Q = fetch[None, :, :] + cont[:, None, :]
    return np.argmin(Q, axis=2)                      # [S, K]


def solve_abc(costs: HostingCosts, ge: GilbertElliot,
              c_mean: float) -> np.ndarray:
    """ABC's stationary table: ``r' = argmin_k lv_k c_mean + g_k
    rate(s_hat) + M (lv_k - lv_r)^+ / sojourn(s_hat)``; returns pi [S,
    K]."""
    rates = np.array([ge.rate_l, ge.rate_h])
    sojourn = np.array([1.0 / max(ge.p_lh, 1e-9), 1.0 / max(ge.p_hl, 1e-9)])
    lv = np.asarray(costs.levels, np.float64)
    g = np.asarray(costs.g, np.float64)
    # score[s, k, k'] of choosing k' at current level k in inferred state s
    hold = float(c_mean) * lv[None, :] + rates[:, None] * g[None, :]
    fetch = costs.M * np.maximum(lv[None, :] - lv[:, None], 0.0)
    score = hold[:, None, :] + fetch[None, :, :] / sojourn[:, None, None]
    return np.argmin(score, axis=2)                  # [S, K]


def _pad_tables(tables: Sequence[np.ndarray], K: int) -> np.ndarray:
    """Stack per-instance [S, K_i] decision tables to int32 [B, S, K],
    padding the level axis with identity entries (inert: the state starts
    at 0 and a valid table maps valid levels to valid levels)."""
    out = []
    for pi in tables:
        S, Ki = pi.shape
        pad = np.tile(np.arange(K)[None, :], (S, 1))
        pad[:, :Ki] = pi
        out.append(pad)
    return np.stack(out).astype(np.int32)


# ----------------------------------------------------------------------
# The table steps (torch, [R] rows).
# ----------------------------------------------------------------------

def table_init(params) -> State:
    pi = params["pi"]
    return {"r": torch.zeros((pi.shape[0],), dtype=torch.int32,
                             device=pi.device)}


def _lookup(pi, s, r):
    """``pi[row, s, r]`` for every row: ``pi`` [R, S, K] int32, ``s`` and
    ``r`` [R]."""
    R, _, K = pi.shape
    idx = (s.to(torch.int64) * K + r.to(torch.int64))[:, None]
    return torch.gather(pi.reshape(R, -1), 1, idx)[:, 0]


def mdp_step(params, state: State, obs: SlotObs) -> State:
    """The MDP table at the observed chain state, clipped to ``[0, S -
    1]``."""
    pi = params["pi"]
    s = torch.clamp(obs.side, 0, pi.shape[-2] - 1)
    return {"r": _lookup(pi, s, state["r"])}


def abc_step(params, state: State, obs: SlotObs) -> State:
    """The ABC table at the inferred state ``float32(x) >= x_threshold``."""
    s_hat = (obs.x.to(torch.float32)
             >= params["x_threshold"]).to(torch.int32)
    return {"r": _lookup(params["pi"], s_hat, state["r"])}


#: the steps that kernel S's table variant runs
TABLE_STEPS = (static_step, mdp_step, abc_step)


def table_form(step_fn, params, K: int):
    """A table policy as kernel S's table variant reads it: ``(pi [R, S,
    K] int32, the observation it indexes pi with, thresholds [R] float32
    or None)``.  Static is the one-row table whose every entry is its
    ``level_idx`` (observation ``"none"``); MDP reads the side channel
    (``"side"``), ABC the arrivals against ``x_threshold`` (``"x"``)."""
    if step_fn is static_step:
        idx = params["level_idx"]
        return (idx[:, None, None].expand(-1, 1, K).contiguous(), "none",
                None)
    if step_fn is mdp_step:
        return params["pi"], "side", None
    if step_fn is abc_step:
        return params["pi"], "x", params["x_threshold"]
    raise ValueError(f"not a table step: {step_fn!r}")


def _table(tables, K: int, device) -> torch.Tensor:
    return torch.from_numpy(_pad_tables(tables, K)).to(device)


def _thresholds(ges: Sequence[GilbertElliot], device) -> torch.Tensor:
    # float32 of the float64 midpoint, as the reference's jnp.asarray
    return torch.from_numpy(np.asarray(
        [0.5 * (ge.rate_h + ge.rate_l) for ge in ges],
        np.float32)).to(device)


class MDPPolicy(OnlinePolicy):
    """Plays the precomputed average-cost-optimal stationary policy;
    observes the chain state via ``obs.side`` (0 = L, 1 = H).
    ``MDPPolicy(costs, ge, c_mean)`` is one instance; ``batch`` / ``fleet``
    the [B]-row policy of a grid."""

    init_fn = staticmethod(table_init)
    step_fn = staticmethod(mdp_step)

    def __init__(self, costs: HostingCosts, ge: GilbertElliot,
                 c_mean: float):
        super().__init__(costs)
        self.pi = solve_mdp(costs, ge, c_mean).astype(np.int32)  # [S, K]

    def params_on(self, device=None):
        return {"pi": _table([self.pi], self.costs.K,
                             resolve_device(device))}

    @classmethod
    def batch(cls, grid: HostingGrid, costs_list: Sequence[HostingCosts],
              ges: Sequence[GilbertElliot],
              c_means: Sequence[float]) -> PolicyFns:
        """Solve each instance's MDP on the host, stack the tables."""
        tables = [solve_mdp(cc, ge, cm)
                  for cc, ge, cm in zip(costs_list, ges, c_means)]
        return PolicyFns("MDP", table_init, mdp_step,
                         {"pi": _table(tables, grid.K, grid.device)})

    @classmethod
    def fleet(cls, fleet, costs_list, ges, c_means) -> PolicyFns:
        return cls.batch(fleet.grid, costs_list, ges, c_means)


class ABCPolicy(OnlinePolicy):
    """Arrival Based Caching [26] (module docstring).
    ``ABCPolicy(costs, ge, c_mean)`` is one instance; ``batch`` / ``fleet``
    the [B]-row policy of a grid."""

    init_fn = staticmethod(table_init)
    step_fn = staticmethod(abc_step)

    def __init__(self, costs: HostingCosts, ge: GilbertElliot,
                 c_mean: float):
        super().__init__(costs)
        self.ge = ge
        self.c_mean = float(c_mean)
        # threshold to classify the state from x_t
        self.x_threshold = 0.5 * (ge.rate_h + ge.rate_l)
        self.pi = solve_abc(costs, ge, c_mean).astype(np.int32)  # [S, K]

    def params_on(self, device=None):
        dev = resolve_device(device)
        return {"pi": _table([self.pi], self.costs.K, dev),
                "x_threshold": _thresholds([self.ge], dev)}

    @classmethod
    def batch(cls, grid: HostingGrid, costs_list: Sequence[HostingCosts],
              ges: Sequence[GilbertElliot],
              c_means: Sequence[float]) -> PolicyFns:
        tables = [solve_abc(cc, ge, cm)
                  for cc, ge, cm in zip(costs_list, ges, c_means)]
        return PolicyFns("ABC", table_init, abc_step,
                         {"pi": _table(tables, grid.K, grid.device),
                          "x_threshold": _thresholds(ges, grid.device)})

    @classmethod
    def fleet(cls, fleet, costs_list, ges, c_means) -> PolicyFns:
        return cls.batch(fleet.grid, costs_list, ges, c_means)

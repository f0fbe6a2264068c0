"""Closed-form results of the paper: Theorems 1, 2, 4 (adversarial) and the
Theorem-5 stochastic guarantee with its f/q/h machinery (the port's copy
of ``repro/core/bounds.py``, numpy only).

These are *reporting* functions: benchmarks plot them (the alpha-LB / LB
curves of Figs 1-6 and 12-15) and tests check the paper's qualitative
claims (bounds > 1, decay to 0 with M, the <= 6 corollary under
Assumption 6).

Printed-text notes (kept faithful, flagged here):
  * Theorem 5's middle case divides by (M + c) and the last by c as printed,
    although the proof's eqs. (23)/(28) normalise by c and p respectively;
    we implement the printed statement and expose the proof variant via
    ``denominator="proof"``.
  * The f/q/h expressions are upper bounds on a probability-weighted excess
    cost; outside their case regions some inner terms lose meaning, so the
    evaluators first check the case conditions and raise otherwise.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.costs import HostingCosts


# ----------------------------------------------------------------------
# Theorem 1 — when partial hosting is never used
# ----------------------------------------------------------------------

def thm1_no_partial(costs: HostingCosts) -> bool:
    """True iff alpha + g(alpha) >= 1, in which case alpha-RR never hosts
    partially and alpha-OPT abandons the partial level permanently."""
    return costs.alpha + costs.g_alpha >= 1.0


# ----------------------------------------------------------------------
# Theorem 2 / Corollary 3 — alpha-RR competitive-ratio upper bound
# ----------------------------------------------------------------------

def thm2_is_optimal_regime(costs: HostingCosts) -> bool:
    return costs.alpha * costs.c_min + costs.g_alpha >= 1.0 and costs.c_min >= 1.0


def thm2_ratio_upper(costs: HostingCosts) -> float:
    if thm2_is_optimal_regime(costs):
        return 1.0
    M, a, g = costs.M, costs.alpha, costs.g_alpha
    return 4.0 + 1.0 / M + max(1.0 / M, (1.0 - g) / (M * a))


def corollary3_six(costs: HostingCosts) -> float:
    """Under Assumption 6 the Theorem-2(b) bound is <= 6."""
    assert costs.assumption6_holds(), "Corollary 3 requires Assumption 6"
    b = thm2_ratio_upper(costs)
    assert b <= 6.0 + 1e-9
    return b


# ----------------------------------------------------------------------
# Theorem 4 — lower bound for any deterministic online policy
# ----------------------------------------------------------------------

def _f_uv(costs: HostingCosts, u: float, v: float) -> float:
    M, cmin = costs.M, costs.c_min

    def g(z):
        if abs(z - costs.alpha) < 1e-12:
            return costs.g_alpha
        if abs(z - 1.0) < 1e-12:
            return 0.0
        raise ValueError(z)

    return 1.0 + (u * M + u * cmin + g(u)) * (1.0 - v * cmin - g(v)) / (v * M)


def thm4_lower(costs: HostingCosts) -> float:
    """Lower bound on rho for any deterministic online policy with partial
    hosting allowed (the alpha-LB curves)."""
    a, g = costs.alpha, costs.g_alpha
    cmin = costs.c_min
    cond_partial = a * cmin + g < 1.0
    if cmin < 1.0 and cond_partial:                       # case (a)
        t1 = min(_f_uv(costs, a, a), _f_uv(costs, 1.0, 1.0))
        t2 = min(1.0 / (a * cmin + g), 1.0 / (cmin * 1.0 + 0.0))
        return max(min(t1, t2), 1.0)
    if cmin < 1.0:                                        # case (b)
        t1 = min(_f_uv(costs, a, 1.0), _f_uv(costs, 1.0, 1.0))
        return max(min(t1, 1.0 / cmin), 1.0)
    if cond_partial:                                      # case (c)
        t1 = min(_f_uv(costs, a, a), _f_uv(costs, 1.0, a))
        return max(min(t1, 1.0 / (a * cmin + g)), 1.0)
    return 1.0  # alpha-RR itself is optimal here (Theorem 2(a))


def thm4_lower_no_partial(costs: HostingCosts) -> float:
    """The [22] bound for policies restricted to {0, 1} (the LB curves):
    the u = v = 1 specialisation of Theorem 4."""
    cmin = costs.c_min
    if cmin >= 1.0:
        return 1.0
    return max(min(_f_uv(costs, 1.0, 1.0), 1.0 / cmin), 1.0)


# ----------------------------------------------------------------------
# Theorem 5 — stochastic guarantee (Model 2)
# ----------------------------------------------------------------------

def _sq(z):
    return z * z


def f_fn(lam, M, p, c, a, g, cmin, cmax):
    """f(lambda, M, p, c, alpha, g(alpha)) — valid when
    alpha*c/(1-g) < p < (1-alpha)*c/g (case 1)."""
    dA = p * (1 - g) - a * c            # > 0 in case 1
    dB = (1 - a) * c - p * g            # > 0 in case 1
    if dA <= 0 or dB <= 0:
        raise ValueError("f() outside its case region")
    nA = 1 + a * cmax - a * cmin
    nB = 1 + (1 - a) * (cmax - cmin)
    Mt = max(math.ceil(M * a / dA), math.ceil(M * (1 - a) / dB))
    dlA = math.exp(-4 * dA * a * M / _sq(nA))
    dlB = math.exp(-4 * dB * (1 - a) * M / _sq(nB))
    tA = lam * Mt * dlA * math.exp(-2 * (M / cmax + 1) * _sq(dA) / _sq(nA)) \
        / max(1 - math.exp(-2 * _sq(dA) / _sq(nA)), 1e-300)
    tB = lam * Mt * dlB * math.exp(-2 * ((1 - a) * M / max(1 - (1 - a) * cmin, 1e-9) + 1)
                                   * _sq(dB) / _sq(nB)) \
        / max(1 - math.exp(-2 * _sq(dB) / _sq(nB)), 1e-300)
    tF = math.exp(-2 * _sq(lam - 1) * _sq(M) * _sq(a) / (lam * Mt * _sq(1 + a * (cmax - cmin))))
    return max(M + p, M + c) * (tA + tB + tF)


def q_fn(lam, M, p, c, a, g, cmin, cmax):
    """q(...) — valid when p > max{c, (1-alpha)c/g} (case 2)."""
    dA = p - c
    dB = p * g - (1 - a) * c
    if dA <= 0 or dB <= 0:
        raise ValueError("q() outside its case region")
    nA = 1 + cmax - cmin
    nB = 1 + (1 - a) * (cmax - cmin)
    Mt = max(M / dA, math.ceil(M * (1 - a) / dB))
    dlA = math.exp(-4 * dA * a * M / _sq(nA))
    dlB = math.exp(-4 * dB * (1 - a) * M / _sq(nB))
    tA = dlA * lam * Mt * math.exp(-2 * (M / cmax + 1) * _sq(dA) / _sq(1 + cmax - a * cmin)) \
        / max(1 - math.exp(-2 * _sq(dA) / _sq(nA)), 1e-300)
    tB = dlB * lam * Mt * math.exp(-2 * (M / cmax + 1) * _sq(dB) / _sq(nB)) \
        / max(1 - math.exp(-2 * _sq(dB) / _sq(nB)), 1e-300)
    tE = math.exp(-2 * _sq(lam - 1) * _sq(M) * _sq(1 - a) / (lam * Mt * _sq(nB)))
    tF = math.exp(-2 * _sq(lam - 1) * _sq(M) * _sq(a) / (lam * Mt * _sq(1 + a * (cmax - cmin))))
    return max(a * M + a * c + g * p, M + c) * (tA + tB + tE + tF)


def h_fn(lam, M, p, c, a, g, cmin, cmax):
    """h(...) — valid when p < min{c, alpha*c/(1-g)} (case 3)."""
    dA = c - p
    dB = a * c - p * (1 - g)
    if dA <= 0 or dB <= 0:
        raise ValueError("h() outside its case region")
    nA = 1 + cmax - cmin
    nB = 1 + a * (cmax - cmin)
    Mt = max(M / dA, math.ceil(M * a / dB))
    dlA = math.exp(-4 * dA * a * M / _sq(nA))
    dlB = math.exp(-4 * dB * a * M / _sq(nB))
    tA = 2 * lam * Mt * dlA * math.exp(-2 * (M / max(1 - cmin, 1e-9) + 1)
                                       * _sq(dA) / _sq(1 + cmax - a * cmin)) \
        / max(1 - math.exp(-2 * _sq(dA) / _sq(nA)), 1e-300)
    tB = 2 * lam * Mt * dlB * math.exp(-2 * (a * M / max(1 - g - a * cmin, 1e-9) + 1)
                                       * _sq(dB) / _sq(nB)) \
        / max(1 - math.exp(-2 * _sq(dB) / _sq(nB)), 1e-300)
    tE = math.exp(-2 * _sq(lam - 1) * _sq(M) * _sq(a) / (lam * Mt * _sq(nB)))
    tF = math.exp(-2 * _sq(lam - 1) * _sq(M) / (lam * Mt * _sq(nA)))
    return max(a * M + a * c + g * p, M + p) * (tA + tB + tE + tF)


def thm5_sigma_upper(costs: HostingCosts, p: float, c: float,
                     lam_grid=None, denominator: str = "printed") -> float:
    """sigma(T) upper bound of Theorem 5; selects the case from (p, c),
    minimises over a lambda grid. Returns +inf if (p, c) falls on a case
    boundary where the theorem is silent."""
    a, g = costs.alpha, costs.g_alpha
    M, cmin, cmax = costs.M, costs.c_min, costs.c_max
    if lam_grid is None:
        lam_grid = np.linspace(1.05, 20.0, 200)

    def best(fn):
        vals = []
        for lam in lam_grid:
            try:
                vals.append(fn(lam, M, p, c, a, g, cmin, cmax))
            except (ValueError, OverflowError):
                continue
        return min(vals) if vals else math.inf

    if a * c / (1 - g) < p < (1 - a) * c / g:
        den = a * c + g * p
        return 1.0 + best(f_fn) / den
    if p > max(c, (1 - a) * c / g):
        den = (M + c) if denominator == "printed" else c
        return 1.0 + best(q_fn) / den
    if p < min(c, a * c / (1 - g)):
        den = c if denominator == "printed" else p
        return 1.0 + best(h_fn) / den
    return math.inf


def lemma14_opt_on_per_slot(costs: HostingCosts, p: float, c: float) -> float:
    """Lemma 14: E[C_t^{alpha-OPT-ON}] >= min{c, alpha*c + g(alpha)*p, p}."""
    return min(c, costs.alpha * c + costs.g_alpha * p, p)

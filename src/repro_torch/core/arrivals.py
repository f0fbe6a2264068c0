"""Request-arrival processes (the port of ``repro/core/arrivals.py``).

 - Bernoulli(p)                    (Assumptions 1/2, Figs 1-6)
 - Poisson(lam)                    (Model 2 synthetic, Figs 12-15)
 - Gilbert-Elliot 2-state Markov   (Figs 7/8 and 17-22) with Bernoulli or
   Poisson emissions per state
 - adversarial worst-case sequences (Theorem 4's constructions)
 - bursty "cluster-trace-like" generator standing in for the Google
   cluster trace [14]

The generation lives in ``core.scenarios.streams`` as counter-keyed
``Stream``s (kernel P on the card); the functions here are the
whole-horizon materialisations of those streams, bitwise the reference's
under the same key and threefry layout, kept for the array-building API.
Each materialises a B = 1 stream on ``device`` (the card by default) and
returns one row as numpy: int32 arrivals, int32 chain states.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.scenarios import base as _base
from repro_torch.core.scenarios import streams as _streams


def _mat1(stream, T: int):
    """Materialise a B = 1 arrival stream over ``T`` slots: its ``(x,
    side)`` rows."""
    x, side = _base.materialize_stream(stream, int(T))
    return x[0], side[0]


def bernoulli(key, p: float, T: int, device=None):
    return _mat1(_streams.bernoulli_arrivals(key, p, B=1, device=device),
                 T)[0]


def poisson(key, lam: float, T: int, device=None):
    return _mat1(_streams.poisson_arrivals(key, lam, B=1, device=device),
                 T)[0]


@dataclasses.dataclass(frozen=True)
class GilbertElliot:
    """Two-state Markov-modulated arrivals (Fig. 9 / 16 of the paper).

    State H emits ``rate_h`` arrivals in expectation, state L ``rate_l``.
    ``p_hl`` = P(H->L), ``p_lh`` = P(L->H).  ``emission`` is "bernoulli"
    (rates are probabilities) or "poisson" (rates are intensities).
    """

    p_hl: float
    p_lh: float
    rate_h: float
    rate_l: float
    emission: str = "poisson"

    @property
    def stationary_h(self) -> float:
        return self.p_lh / (self.p_lh + self.p_hl)

    @property
    def mean_rate(self) -> float:
        ph = self.stationary_h
        return ph * self.rate_h + (1.0 - ph) * self.rate_l

    def stream(self, key, B: int = 1, device=None) -> "_streams.Stream":
        """This chain as a fleet-fusable arrival stream (side = state)."""
        return _streams.ge_arrivals(key, self.p_hl, self.p_lh, self.rate_h,
                                    self.rate_l, B=B, emission=self.emission,
                                    device=device)

    def sample(self, key, T: int, return_states: bool = False, device=None):
        x, states = _mat1(self.stream(key, device=device), T)
        if return_states:
            return x, states
        return x


def cluster_trace_like(key, T: int, base_rate: float = 2.0,
                       burst_rate: float = 20.0, burst_p: float = 0.05,
                       diurnal_period: int = 0, device=None):
    """Synthetic stand-in for the Google cluster-usage trace [14]: a
    low-intensity Poisson background with geometric-length bursts (the
    diurnal modulation, ``diurnal_period != 0``, raises: ROADMAP.md, Queue
    1 item 17)."""
    return _mat1(_streams.bursty_arrivals(key, B=1, base_rate=base_rate,
                                          burst_rate=burst_rate,
                                          burst_p=burst_p,
                                          diurnal_period=diurnal_period,
                                          device=device), T)[0]


# ----------------------------------------------------------------------
# Adversarial constructions (proof of Theorem 4)
# ----------------------------------------------------------------------

def adversarial_fetch_bait(tau: int, T: int, device=None):
    """Arrivals every slot until slot ``tau`` (when the online policy is
    goaded into fetching), then silence: the Theorem-4 lower-bound
    construction for a policy starting at r = 0."""
    return _mat1(_streams.adversarial_fetch_bait(tau, B=1, device=device),
                 T)[0]


def adversarial_evict_bait(tau_bar: int, tau: int, T: int, device=None):
    """No arrivals until the policy evicts (slot ``tau_bar``), then arrivals
    every slot until ``tau_bar + tau``, then silence (the second
    construction in the proof of Theorem 4)."""
    return _mat1(_streams.adversarial_evict_bait(tau_bar, tau, B=1,
                                                 device=device), T)[0]

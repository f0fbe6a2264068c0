"""Request-arrival processes (the port of the part of
``repro/core/arrivals.py`` that the figures read): ``GilbertElliot``, the
two-state Markov-modulated arrival chain, with its stationary law and its
fleet stream.  The whole-horizon array builders of the reference
(``bernoulli``, ``poisson``, ``cluster_trace_like``, the adversarial
constructions) come with the rest of ``arrivals.py`` (ROADMAP.md, Queue
1 items 2 and 12)."""
from __future__ import annotations

import dataclasses

from repro_torch.core.scenarios import streams as _streams


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

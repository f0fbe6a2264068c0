"""Time-varying rent-cost processes (the part of
``repro/core/rentcosts.py`` the port needs so far): the default ARMA(4, 2)
coefficients of the spot-like rent stream.  The processes themselves are
the counter-keyed streams of ``core/scenarios/streams.py``."""
from __future__ import annotations

# Default ARMA(4,2) parameters: slowly mean-reverting with mild MA smoothing
# (stationary: AR roots outside the unit circle).
DEFAULT_AR = (0.55, 0.20, 0.10, 0.05)
DEFAULT_MA = (0.40, 0.20)

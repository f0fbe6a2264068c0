"""Time-varying rent-cost processes (the port of
``repro/core/rentcosts.py``).

The paper models rent with an ARMA(4,2) process fit to AWS EC2 spot prices
[33] (the Kaggle dataset is not available offline: ARMA(4,2) with
coefficients chosen to mimic slow-mean-reverting, positively
autocorrelated spot prices, and a Hannan-Rissanen fitter so any
user-supplied price series can be fit the way the paper describes [16]).
Also i.i.d. uniform rents and negatively-associated rents (Assumption 7
uses negative association; antithetic pairs are NA).

Generation lives in ``core.scenarios.streams`` (counter-keyed streams on
kernel P); the functions here materialise those streams over a whole
horizon, bitwise the reference's under the same key and threefry layout,
on ``device`` (the card by default), and return one float32 row as numpy.
``fit_arma`` is numpy least squares, a copy of the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Default ARMA(4,2) parameters: slowly mean-reverting with mild MA smoothing
# (stationary: AR roots outside the unit circle).
DEFAULT_AR = (0.55, 0.20, 0.10, 0.05)
DEFAULT_MA = (0.40, 0.20)


def _mat1(stream, T: int):
    # imported here: the streams import this module's coefficients
    from repro_torch.core.scenarios.base import materialize_stream
    return materialize_stream(stream, int(T))[0]


@dataclasses.dataclass(frozen=True)
class ARMAProcess:
    """ARMA(p, q):  (c_t - mu) = sum phi_i (c_{t-i} - mu) + eps_t + sum th_j eps_{t-j}."""

    mean: float
    ar: tuple = DEFAULT_AR
    ma: tuple = DEFAULT_MA
    sigma: float = 0.05
    c_min: float = 0.05
    c_max: float = 10.0

    def stream(self, key, B: int = 1, device=None):
        """This process as a fleet-fusable rent stream."""
        from repro_torch.core.scenarios.streams import arma_rents
        return arma_rents(key, self.mean, B=B, ar=self.ar, ma=self.ma,
                          sigma=self.sigma, c_min=self.c_min,
                          c_max=self.c_max, device=device)

    def sample(self, key, T: int, device=None) -> np.ndarray:
        return _mat1(self.stream(key, device=device), T)


def iid_uniform(key, c_mean: float, half_width: float, T: int,
                c_min: float = 1e-3, device=None) -> np.ndarray:
    from repro_torch.core.scenarios.streams import uniform_rents
    return _mat1(uniform_rents(key, c_mean, half_width, B=1, c_min=c_min,
                               device=device), T)


def negatively_associated(key, c_mean: float, half_width: float, T: int,
                          device=None) -> np.ndarray:
    """Antithetic-pair construction: (U, 1-U) pairs are negatively associated,
    satisfying Assumption 7's rent-process requirement."""
    from repro_torch.core.scenarios.streams import na_rents
    return _mat1(na_rents(key, c_mean, half_width, B=1, device=device), T)


def constant(c: float, T: int) -> np.ndarray:
    return np.full((T,), c, dtype=np.float32)


# ----------------------------------------------------------------------
# Hannan–Rissanen two-stage ARMA fit (what "fit the model to price data"
# [16] means operationally).
# ----------------------------------------------------------------------

def fit_arma(series: np.ndarray, p: int = 4, q: int = 2,
             ar_order_long: int = 20) -> ARMAProcess:
    """Fit ARMA(p,q) by Hannan–Rissanen: (1) long-AR fit for residuals,
    (2) OLS of the series on its own lags and lagged residuals."""
    y = np.asarray(series, dtype=np.float64)
    mu = float(y.mean())
    z = y - mu
    T = len(z)
    m = min(ar_order_long, max(p + q, T // 10))
    # stage 1: long AR via least squares
    X1 = np.stack([z[m - i - 1:T - i - 1] for i in range(m)], axis=1)
    y1 = z[m:]
    a, *_ = np.linalg.lstsq(X1, y1, rcond=None)
    eps = np.zeros(T)
    eps[m:] = y1 - X1 @ a
    # stage 2: regress z_t on p lags of z and q lags of eps
    s = max(p, q) + m
    rows = []
    targ = []
    for t in range(s, T):
        rows.append(np.concatenate([z[t - p:t][::-1], eps[t - q:t][::-1]]))
        targ.append(z[t])
    X2 = np.asarray(rows)
    y2 = np.asarray(targ)
    b, *_ = np.linalg.lstsq(X2, y2, rcond=None)
    ar = tuple(float(v) for v in b[:p])
    ma = tuple(float(v) for v in b[p:p + q])
    resid = y2 - X2 @ b
    return ARMAProcess(mean=mu, ar=ar, ma=ma, sigma=float(resid.std()),
                       c_min=float(max(y.min() * 0.5, 1e-3)),
                       c_max=float(y.max() * 1.5))


def aws_spot_like(key, c_mean: float, T: int, rel_sigma: float = 0.15,
                  c_min: float | None = None, c_max: float | None = None,
                  device=None) -> np.ndarray:
    """Convenience: ARMA(4,2) with default coefficients, scaled to a target
    mean — the shape of the paper's EC2 spot-price rent process.  The
    stream form is ``scenarios.spot_rents`` (same defaults; same bits under
    the same key)."""
    proc = ARMAProcess(mean=c_mean, sigma=rel_sigma * c_mean,
                       c_min=c_min if c_min is not None
                       else max(0.2 * c_mean, 1e-3),
                       c_max=c_max if c_max is not None else 3.0 * c_mean)
    return proc.sample(key, T, device=device)

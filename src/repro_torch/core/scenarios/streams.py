"""Primitive workload streams (the port of the uniform-driven part of
``repro/core/scenarios/streams.py``).

Arrival streams: ``bernoulli_arrivals``, ``poisson_arrivals``,
``ge_arrivals`` (Gilbert-Elliot, side = chain state; Bernoulli or Poisson
emissions), ``bursty_arrivals`` (the cluster-trace stand-in, GE-Poisson),
``adversarial_fetch_bait`` / ``adversarial_evict_bait`` (Theorem-4
constructions), ``trace_arrivals``.
Rent streams: ``uniform_rents``, ``na_rents`` (antithetic time-pairs,
Assumption 7), ``constant_rents``, ``trace_rents``, ``arma_rents`` (ARMA(p,
q), any q >= 1) and ``spot_rents`` (AWS-spot-like ARMA(4, 2) rents;
``spot_bounds`` gives their clip rails).
Service streams: ``model2_service`` (coupled per-request uniforms).

Every random draw is kernel P's (``kernels/hosting.py``), which draws and
finishes one stream's chunk in one launch on the card, and runs its plain
version on the CPU.  Each variant replaces the Pallas PRNG kernel
(``repro/kernels/hosting.py:164``, ``slot_uniform_tc``) and the consumer
code after it in ``repro/core/scenarios/streams.py``:

* ``_bernoulli_chunk`` -> ``bernoulli_arrivals_chunk``;
* ``_uniform_rents_chunk`` -> ``uniform_rents_chunk`` (``lo + u * (hi -
  lo)`` as one FMA, as XLA:CPU computes it);
* ``_na_rents_chunk`` -> ``na_rents_chunk`` (one hash for both slots of a
  pair);
* ``_ge_chunk_bernoulli`` (``_ge_states`` + ``_ge_emit``) ->
  ``ge_bernoulli_chunk``: the chain runs as a warp scan of its 2-state
  maps, not slot by slot;
* ``_ge_init``'s one draw -> ``ops.counter_uniforms`` (``jax.random.
  uniform`` there, not ``slot_uniform``: the active layout under either
  PRNG backend);
* ``_arma_chunk`` (``jax.random.normal`` on per-slot keys, then the
  ``lax.scan`` of the ARMA recursion) -> ``arma_rents_chunk``: the
  innovations drawn slot-parallel, each row's recursion walked by one
  thread; ``_arma_init``'s draws -> ``normal_chunk``.  The normal is
  ``sqrt(2) * erf_inv(u)`` with XLA's own float32 ``erf_inv`` and ``log``
  transcribed op for op (``kernels.hosting.erf_inv_plain``).

Each is bound by the threefry hash's integer operations; the kernel keeps
the draws in registers (no uniform slab in device memory, no float64) and
issues the hash's adds on the FMA pipe, leaving the integer ALU pipe to the
rotates and xors (``csrc/hosting.cu``).

* ``_poisson_chunk`` and ``_ge_emit``'s Poisson emissions (``jax.random.
  poisson``: Knuth's branch below rate 10, a key split, a uniform and
  XLA's ``log`` a round; Hormann's rejection at 10 and above, a three-way
  split, two uniforms and XLA's ``log`` and ``lgamma`` a round) ->
  ``poisson_chunk``, whose lanes take the next staged draw as soon as
  theirs ends; a GE-Poisson chunk runs the chain on ``ge_bernoulli_chunk``
  first (``emit=False``: the states only).  ``bursty_arrivals`` with a
  diurnal period (XLA's ``sin``) is not ported and raises (ROADMAP.md,
  Queue 1 item 17).
* ``_model2_chunk_fn`` (a shaped ``uniform(k, (R,))`` a slot, compared
  with every level's g) -> ``model2_service_chunk``, which draws only the
  slot's live requests.

``bernoulli_arrivals`` and ``uniform_rents`` carry a boolean ``flip`` param
(default False) mapping each slot uniform ``u -> 1 - u``: the hook that
antithetic pairing (``combinators.antithetic_pairing``, and the seed axis
of ``combinators.replicate_seeds``) uses.

The streams whose draws go through the reference's ``slot_uniform``
(Bernoulli arrivals, uniform and NA rents, the GE chain and its Bernoulli
emissions) draw in ``base.slot_layout()``, the PRNG backend's layout.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.rentcosts import DEFAULT_AR, DEFAULT_MA
from repro_torch.core.scenarios.base import (Stream, as_keys, bcast,
                                             slot_layout)
from repro_torch.kernels import hosting, ops

# Salt for draws that must not collide with any per-slot counter (slot
# counters are the nonnegative slot indices).
_INIT_SALT = 0x7FFFFFFF

_F32, _I32 = torch.float32, torch.int32


def _no_state(params):
    return ()


def _zeros_side(x):
    return torch.zeros_like(x, dtype=_I32)


# ----------------------------------------------------------------------
# Arrival streams.
# ----------------------------------------------------------------------

def _bernoulli_chunk(params, state, tids):
    x = hosting.bernoulli_arrivals_chunk(params["key"], tids, params["p"],
                                         params["flip"], slot_layout())
    return state, (x, _zeros_side(x))


def bernoulli_arrivals(key, p, B: int, device=None) -> Stream:
    """Bernoulli(p) arrivals; ``p`` scalar or per-instance [B]."""
    dev = resolve_device(device)
    return Stream("bernoulli", "arrivals", _no_state, _bernoulli_chunk,
                  {"key": as_keys(key, B, dev), "p": bcast(p, B, _F32, dev),
                   "flip": torch.zeros((B,), dtype=torch.bool, device=dev)})


def _ge_init(params):
    # start from the stationary distribution (no burn-in artifacts)
    ph = params["p_lh"] / (params["p_lh"] + params["p_hl"])
    key = params["key"]
    t = torch.full((1,), _INIT_SALT, dtype=_I32, device=key.device)
    u0 = ops.counter_uniforms(key, t)[:, 0]
    return {"s": (u0 < ph).to(_I32)}


def _ge_chunk_bernoulli(params, state, tids):
    s, states, x = hosting.ge_bernoulli_chunk(
        params["key"], tids, state["s"], params["p_hl"], params["p_lh"],
        params["rate_h"], params["rate_l"], slot_layout())
    return {"s": s}, (x, states)


def _ge_chunk_poisson(params, state, tids):
    # the chain on kernel P's GE variant (without its Bernoulli emissions,
    # in the backend's layout), the Poisson emissions at the per-slot
    # rates, salt 1, on its Poisson variant (in the active layout)
    s, states, _ = hosting.ge_bernoulli_chunk(
        params["key"], tids, state["s"], params["p_hl"], params["p_lh"],
        params["rate_h"], params["rate_l"], slot_layout(), emit=False)
    x = hosting.poisson_chunk(params["key"], tids, params["rate_l"], salt=1,
                              states=states, lam_h=params["rate_h"])
    return {"s": s}, (x, states)


def ge_arrivals(key, p_hl, p_lh, rate_h, rate_l, B: int,
                emission: str = "poisson", device=None) -> Stream:
    """Gilbert-Elliot Markov-modulated arrivals; ``side`` carries the chain
    state (1 = H), which is what the MDP / ABC baselines observe."""
    chunk = {"poisson": _ge_chunk_poisson,
             "bernoulli": _ge_chunk_bernoulli}.get(emission)
    if chunk is None:
        raise ValueError(emission)
    dev = resolve_device(device)
    params = {"key": as_keys(key, B, dev),
              "p_hl": bcast(p_hl, B, _F32, dev),
              "p_lh": bcast(p_lh, B, _F32, dev),
              "rate_h": bcast(rate_h, B, _F32, dev),
              "rate_l": bcast(rate_l, B, _F32, dev)}
    return Stream(f"ge-{emission}", "arrivals", _ge_init, chunk, params,
                  has_side=True)


def _poisson_chunk(params, state, tids):
    x = hosting.poisson_chunk(params["key"], tids, params["lam"])
    return state, (x, _zeros_side(x))


def poisson_arrivals(key, lam, B: int, device=None) -> Stream:
    """Poisson(lam) arrivals, ``lam`` scalar or per-instance [B]."""
    dev = resolve_device(device)
    return Stream("poisson", "arrivals", _no_state, _poisson_chunk,
                  {"key": as_keys(key, B, dev), "lam": bcast(lam, B, _F32,
                                                             dev)})


# burst-exit rate of the bursty (cluster-trace-like) GE background -- public
# so callers computing the process's stationary mean stay in lockstep
BURSTY_EXIT_P = 0.2


def _bursty_chunk(params, state, tids):
    state, (x, _) = _ge_chunk_poisson(params, state, tids)
    return state, (x, _zeros_side(x))


def bursty_arrivals(key, B: int, base_rate=2.0, burst_rate=20.0,
                    burst_p=0.05, diurnal_period: int = 0,
                    device=None) -> Stream:
    """The cluster-trace stand-in: GE-Poisson bursts over a low-rate
    background (``arrivals.cluster_trace_like``); its side channel is
    zeros.  The diurnal remodulation (``diurnal_period != 0``, XLA's
    ``sin``) is not ported."""
    if diurnal_period:
        raise NotImplementedError(
            "bursty_arrivals(diurnal_period != 0) draws through XLA's sin, "
            "which is not ported: ROADMAP.md, Queue 1 item 17")
    ge = ge_arrivals(key, p_hl=BURSTY_EXIT_P, p_lh=burst_p,
                     rate_h=burst_rate, rate_l=base_rate, B=B, device=device)
    return Stream("bursty", "arrivals", _ge_init, _bursty_chunk, ge.params)


def _fetch_bait_chunk(params, state, tids):
    x = (tids[None, :] < params["tau"][:, None]).to(_I32)
    return state, (x, _zeros_side(x))


def adversarial_fetch_bait(tau, B: int, device=None) -> Stream:
    """Arrivals every slot until ``tau``, then silence (Theorem 4)."""
    dev = resolve_device(device)
    return Stream("fetch-bait", "arrivals", _no_state, _fetch_bait_chunk,
                  {"tau": bcast(tau, B, _I32, dev)})


def _evict_bait_chunk(params, state, tids):
    lo = params["tau_bar"][:, None]
    hi = lo + params["tau"][:, None]
    t = tids[None, :]
    x = ((t >= lo) & (t < hi)).to(_I32)
    return state, (x, _zeros_side(x))


def adversarial_evict_bait(tau_bar, tau, B: int, device=None) -> Stream:
    """Silence until ``tau_bar``, arrivals for ``tau`` slots, silence."""
    dev = resolve_device(device)
    return Stream("evict-bait", "arrivals", _no_state, _evict_bait_chunk,
                  {"tau_bar": bcast(tau_bar, B, _I32, dev),
                   "tau": bcast(tau, B, _I32, dev)})


def _slice_trace(trace, tids):
    # clipped gather: tail slots past the trace (horizon padded to a chunk
    # multiple) repeat the last sample, keeping values a function of tids
    idx = torch.clamp_max(tids.to(torch.int64), trace.shape[1] - 1)
    return trace[:, idx]


def _trace_arrivals_chunk(params, state, tids):
    return state, (_slice_trace(params["trace"], tids),
                   _slice_trace(params["side"], tids))


def _trace_arrivals_chunk_sideless(params, state, tids):
    x = _slice_trace(params["trace"], tids)
    return state, (x, _zeros_side(x))


def trace_arrivals(x, B: Optional[int] = None, side=None,
                   device=None) -> Stream:
    """Deterministic playback of a recorded [T] / [B, T] arrival trace."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=_I32, device=dev)
    if x.dim() == 1:
        x = x[None, :].expand(B or 1, x.shape[0])
    x = x.contiguous()
    if side is None:
        return Stream("trace", "arrivals", _no_state,
                      _trace_arrivals_chunk_sideless, {"trace": x})
    side = torch.as_tensor(side, dtype=_I32, device=dev).expand(x.shape)
    return Stream("trace", "arrivals", _no_state, _trace_arrivals_chunk,
                  {"trace": x, "side": side.contiguous()}, has_side=True)


# ----------------------------------------------------------------------
# Rent streams.
# ----------------------------------------------------------------------

def _uniform_rents_chunk(params, state, tids):
    return state, hosting.uniform_rents_chunk(
        params["key"], tids, params["lo"], params["hi"], params["flip"],
        slot_layout())


def uniform_rents(key, c_mean, half_width, B: int, c_min=1e-3,
                  device=None) -> Stream:
    """i.i.d. U[c_mean - hw, c_mean + hw] rents (lower-clamped at c_min)."""
    dev = resolve_device(device)
    mean = bcast(c_mean, B, _F32, dev)
    hw = bcast(half_width, B, _F32, dev)
    return Stream("uniform", "rents", _no_state, _uniform_rents_chunk,
                  {"key": as_keys(key, B, dev),
                   "lo": torch.maximum(mean - hw, bcast(c_min, B, _F32, dev)),
                   "hi": mean + hw,
                   "flip": torch.zeros((B,), dtype=torch.bool, device=dev)})


def _na_rents_chunk(params, state, tids):
    # antithetic time-pairs: slots (2m, 2m+1) share the pair counter m and
    # see (u_m, 1 - u_m) — negatively associated (Assumption 7)
    return state, hosting.na_rents_chunk(params["key"], tids, params["lo"],
                                         params["hi"], slot_layout())


def na_rents(key, c_mean, half_width, B: int, device=None) -> Stream:
    """Negatively-associated rents via antithetic (U, 1-U) time-pairs."""
    dev = resolve_device(device)
    mean = bcast(c_mean, B, _F32, dev)
    hw = bcast(half_width, B, _F32, dev)
    return Stream("na-pairs", "rents", _no_state, _na_rents_chunk,
                  {"key": as_keys(key, B, dev), "lo": mean - hw,
                   "hi": mean + hw})


def _constant_rents_chunk(params, state, tids):
    return state, params["c"][:, None].expand(-1, tids.shape[0]).contiguous()


def constant_rents(c, B: int, device=None) -> Stream:
    dev = resolve_device(device)
    return Stream("constant", "rents", _no_state, _constant_rents_chunk,
                  {"c": bcast(c, B, _F32, dev)})


def _trace_rents_chunk(params, state, tids):
    return state, _slice_trace(params["trace"], tids)


def trace_rents(c, B: Optional[int] = None, device=None) -> Stream:
    """Deterministic playback of a recorded rent trace."""
    dev = resolve_device(device)
    c = torch.as_tensor(c, dtype=_F32, device=dev)
    if c.dim() == 1:
        c = c[None, :].expand(B or 1, c.shape[0])
    return Stream("trace", "rents", _no_state, _trace_rents_chunk,
                  {"trace": c.contiguous()})


def _arma_init(params):
    p, q = params["phi"].shape[1], params["th"].shape[1]
    key = params["key"]
    # eps holds (eps_{-1}, ..., eps_{-q}): counters q-1 .. 0
    tids = torch.arange(q - 1, -1, -1, dtype=_I32, device=key.device)
    sigma = params["sigma"]
    if q == 1:
        # XLA folds sigma into the normal's sqrt(2) for q >= 2, but rounds
        # sigma * (sqrt(2) * erf_inv(u)) twice for the one draw at q = 1
        eps = sigma[:, None] * hosting.normal_chunk(key, tids,
                                                    torch.ones_like(sigma))
    else:
        eps = hosting.normal_chunk(key, tids, sigma)
    return {"hist": torch.zeros((key.shape[0], p), dtype=_F32,
                                device=key.device), "eps": eps}


def _arma_chunk(params, state, tids):
    hist, eps, c = hosting.arma_rents_chunk(
        params["key"], tids, state["hist"], state["eps"], params["phi"],
        params["th"], params["sigma"], params["mean"], params["c_min"],
        params["c_max"])
    return {"hist": hist, "eps": eps}, c


def _coefs(v, B: int, dev):
    a = torch.as_tensor(np.asarray(v, np.float32), device=dev)
    return (a[None].expand(B, -1) if a.dim() == 1 else a).contiguous()


def arma_rents(key, mean, B: int, ar=None, ma=None, sigma=0.05, c_min=0.05,
               c_max=10.0, device=None) -> Stream:
    """ARMA(p, q) rents, clipped to Assumption-3 bounds.

    The recursion state (the last p deviations, the last q innovations)
    rides in the stream's state; innovation ``eps_t`` uses counter ``t +
    q`` (counters [0, q) seed the pre-horizon innovations in ``init_fn``),
    so any chunking replays the same series.  ``ar`` / ``ma`` default to
    ``rentcosts.DEFAULT_AR`` / ``DEFAULT_MA``; every coefficient may be
    per-instance [B, p] / [B, q]; 1 <= p <= 8 and 1 <= q <= 8 (XLA's op
    order is pinned for those; the reference itself fails at q = 0)."""
    dev = resolve_device(device)
    phi = _coefs(DEFAULT_AR if ar is None else ar, B, dev)
    th = _coefs(DEFAULT_MA if ma is None else ma, B, dev)
    if th.shape[1] < 1:
        raise ValueError("arma_rents takes an MA order q >= 1 (the "
                         "reference fails at q = 0)")
    return Stream("arma", "rents", _arma_init, _arma_chunk,
                  {"key": as_keys(key, B, dev),
                   "mean": bcast(mean, B, _F32, dev), "phi": phi, "th": th,
                   "sigma": bcast(sigma, B, _F32, dev),
                   "c_min": bcast(c_min, B, _F32, dev),
                   "c_max": bcast(c_max, B, _F32, dev)})


def spot_rents(key, c_mean, B: int, rel_sigma=0.15, c_min=None, c_max=None,
               device=None) -> Stream:
    """AWS-spot-like rents: the default ARMA(4, 2) scaled to a target mean
    (``sigma = rel_sigma * c_mean``, rails ``spot_bounds``), its parameter
    arithmetic in float64 as the reference's, cast to float32 once."""
    c_mean = np.asarray(c_mean, np.float64)
    return arma_rents(
        key, c_mean, B, sigma=rel_sigma * c_mean,
        c_min=np.maximum(0.2 * c_mean, 1e-3) if c_min is None else c_min,
        c_max=3.0 * c_mean if c_max is None else c_max, device=device)


def spot_bounds(c_mean):
    """(c_min, c_max) a ``spot_rents`` stream can ever emit (clip rails)."""
    return float(max(0.2 * c_mean, 1e-3)), float(3.0 * c_mean)


# ----------------------------------------------------------------------
# Service streams (Model 2).
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model2_chunk_fn(max_per_slot: int):
    def chunk(params, state, tids, x):
        return state, hosting.model2_service_chunk(
            params["key"], tids, x, params["g"], max_per_slot)

    return chunk


def model2_service(key, g, B: int, max_per_slot: int, device=None) -> Stream:
    """Realized Model-2 service costs, coupled across levels: request i of
    slot t draws one uniform of ``uniform(fold_in(key, t), (max_per_slot,))``
    and is forwarded (cost 1) at level k iff ``u < g[k]``; the slot's cost
    at level k counts its first ``min(x_t, max_per_slot)`` requests so
    forwarded.  ``g`` is [K] or [B, K] (pass ``grid.g``: the endpoint
    columns of the result then equal an endpoint grid's own draws)."""
    dev = resolve_device(device)
    g = torch.as_tensor(g, dtype=_F32, device=dev)
    if g.dim() == 1:
        g = g[None].expand(B, -1)
    return Stream("model2", "svc", _no_state,
                  _model2_chunk_fn(int(max_per_slot)),
                  {"key": as_keys(key, B, dev), "g": g.contiguous()})

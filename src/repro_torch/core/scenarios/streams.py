"""Primitive workload streams (the port of the uniform-driven part of
``repro/core/scenarios/streams.py``).

Arrival streams: ``bernoulli_arrivals``, ``ge_arrivals`` (Gilbert-Elliot,
side = chain state; bernoulli emissions), ``trace_arrivals``.
Rent streams: ``uniform_rents``, ``na_rents`` (antithetic time-pairs,
Assumption 7), ``constant_rents``, ``trace_rents``.

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
* ``_ge_init``'s one draw -> ``slot_uniform``.

Each is bound by the threefry hash's integer operations; the kernel keeps
the draws in registers (no uniform slab in device memory, no float64) and
issues the hash's adds on the FMA pipe, leaving the integer ALU pipe to the
rotates and xors (``csrc/hosting.cu``).  The streams that draw through
``jax.random.poisson`` / ``jax.random.normal`` in the reference
(GE-poisson emissions, bursty, ARMA / spot rents) and the Model-2 service
stream come with the sampler slice (ROADMAP.md, Queue 1 item 3).

``bernoulli_arrivals`` and ``uniform_rents`` carry a boolean ``flip`` param
(default False) mapping each slot uniform ``u -> 1 - u``: the hook that
antithetic seed replication (``combinators.replicate_seeds``) uses.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.core.scenarios.base import Stream, as_keys, bcast, slot_uniform
from repro_torch.kernels import hosting

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
                                         params["flip"])
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
    u0 = slot_uniform(key, t)[:, 0]
    return {"s": (u0 < ph).to(_I32)}


def _ge_chunk_bernoulli(params, state, tids):
    s, states, x = hosting.ge_bernoulli_chunk(
        params["key"], tids, state["s"], params["p_hl"], params["p_lh"],
        params["rate_h"], params["rate_l"])
    return {"s": s}, (x, states)


def ge_arrivals(key, p_hl, p_lh, rate_h, rate_l, B: int,
                emission: str = "poisson", device=None) -> Stream:
    """Gilbert-Elliot Markov-modulated arrivals; ``side`` carries the chain
    state (1 = H).  Only ``emission="bernoulli"`` is ported."""
    if emission == "poisson":
        raise NotImplementedError(
            "ge_arrivals(emission='poisson') draws through jax.random.poisson"
            ", which comes with the sampler slice (ROADMAP.md, Queue 1 "
            "item 3); use emission='bernoulli'")
    if emission != "bernoulli":
        raise ValueError(emission)
    dev = resolve_device(device)
    return Stream("ge-bernoulli", "arrivals", _ge_init, _ge_chunk_bernoulli,
                  {"key": as_keys(key, B, dev),
                   "p_hl": bcast(p_hl, B, _F32, dev),
                   "p_lh": bcast(p_lh, B, _F32, dev),
                   "rate_h": bcast(rate_h, B, _F32, dev),
                   "rate_l": bcast(rate_l, B, _F32, dev)},
                  has_side=True)


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
        params["key"], tids, params["lo"], params["hi"], params["flip"])


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
                                         params["hi"])


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

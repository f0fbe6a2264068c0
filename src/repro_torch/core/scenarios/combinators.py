"""Scenario combinators (the port of ``repro/core/scenarios/combinators.py``).

* ``combine``             — one stream per channel (arrivals, rents and
                            optionally Model-2 service) -> a full
                            ``Scenario``.
* ``mixture``             — per-instance mixture over [B]: instance b plays
                            component ``component[b]``'s stream.
* ``mixture_from_weights``— that assignment sampled from mixture weights
                            (``jax.random.choice``).
* ``regime_switch``       — time-based switching at fixed slot boundaries.
* ``antithetic_pairing``  — negatively-associated instance pairs: (2m, 2m+1)
                            share a key, the odd member flips its uniforms.
* ``trace_scenario``      — deterministic playback of recorded [B, T] obs.
* ``with_seed``           — fold one Monte-Carlo seed into every stream key
                            (before the per-slot counter fold).
* ``with_prng_backend``   — draw a scenario's (or stream's) ``slot_uniform``
                            draws through a PRNG backend
                            (``base.PRNG_BACKENDS``).
* ``replicate_seeds``     — the MC axis: S seed-replicas of a B-instance
                            scenario as one [B*S] scenario
                            (``antithetic=True`` pairs replicas (2m, 2m+1)
                            on flip-capable streams).
* ``tile_services``       — the per-service axis: N service-replicas of a
                            B-instance scenario as one [B*N] scenario, keys
                            salted per service except in ``shared`` channel
                            groups.

Composition happens at the stream level, so combinator outputs are
ordinary streams.  Selection is compute-all-then-select, as in the
reference: every component advances its state and draws every slot (its
kernels launch on every chunk), and ``torch.where`` picks each row's (or
slot's) values, so the selected rows are bitwise the selected component's
own output.  Every stream key of a scenario, the service stream's
included, takes the seed and service folds.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.scenarios import streams as _streams
from repro_torch.core.scenarios.base import (PRNG_BACKENDS, ObsSlab,
                                             Scenario, Stream, fold_keys,
                                             prng_dispatch, tree_leaves)
from repro_torch.kernels.hosting import shaped_uniform


def _backend_fns(init_fn, chunk_fn, backend: str):
    def init2(params):
        with prng_dispatch(backend):
            return init_fn(params)

    def chunk2(params, state, tids, *extra):
        with prng_dispatch(backend):
            return chunk_fn(params, state, tids, *extra)

    return init2, chunk2


def with_prng_backend(scenario, backend: str):
    """Draw every ``slot_uniform`` draw of a Scenario (or a single Stream)
    through ``backend`` (``base.PRNG_BACKENDS``).  "xla" returns the input
    unchanged; "pallas" wraps ``init_fn`` / ``chunk_fn`` so that they run
    under ``prng_dispatch("pallas")``: those draws (and the Bernoulli, rent
    and GE chain kernels that finish them) then come in jax's original
    threefry layout, as the reference's Pallas kernel draws them, while
    the draws that do not go through ``slot_uniform`` (Poisson, normals,
    Model-2 service) stay on the active layout."""
    if backend not in PRNG_BACKENDS:
        raise ValueError(f"prng backend must be one of {PRNG_BACKENDS}, "
                         f"got {backend!r}")
    if backend == "xla":
        return scenario
    init2, chunk2 = _backend_fns(scenario.init_fn, scenario.chunk_fn,
                                 backend)
    return scenario._replace(init_fn=init2, chunk_fn=chunk2,
                             name=f"{scenario.name}@{backend}")


def _combine_fns(arrivals: Stream, rents: Stream, svc: Optional[Stream]):
    def init_fn(params):
        st = {"arr": arrivals.init_fn(params["arr"]),
              "rent": rents.init_fn(params["rent"])}
        if svc is not None:
            st["svc"] = svc.init_fn(params["svc"])
        return st

    def chunk_fn(params, state, tids):
        sa, (x, side) = arrivals.chunk_fn(params["arr"], state["arr"], tids)
        sr, c = rents.chunk_fn(params["rent"], state["rent"], tids)
        st = {"arr": sa, "rent": sr}
        svc_v = None
        if svc is not None:            # the service draws read the arrivals
            st["svc"], svc_v = svc.chunk_fn(params["svc"], state["svc"],
                                            tids, x)
        return st, ObsSlab(x=x, c=c, svc=svc_v, side=side)

    return init_fn, chunk_fn


def combine(arrivals: Stream, rents: Stream, svc: Optional[Stream] = None,
            name: Optional[str] = None) -> Scenario:
    """Fuse per-channel streams into one Scenario; a Model-2 ``svc``
    stream draws each chunk's service costs from its arrivals."""
    for s, kind in ((arrivals, "arrivals"), (rents, "rents")):
        if s.kind != kind:
            raise ValueError(f"{s.name} is a {s.kind} stream, expected {kind}")
    if svc is not None and svc.kind != "svc":
        raise ValueError(f"{svc.name} is a {svc.kind} stream, expected svc")
    params = {"arr": arrivals.params, "rent": rents.params}
    if svc is not None:
        params["svc"] = svc.params
    init_fn, chunk_fn = _combine_fns(arrivals, rents, svc)
    name = name or f"{arrivals.name}+{rents.name}" + (
        f"+{svc.name}" if svc is not None else "")
    return Scenario(name, init_fn, chunk_fn, params,
                    has_svc=svc is not None, has_side=arrivals.has_side)


def _check_same_kind(components: Sequence[Stream]) -> str:
    kinds = {s.kind for s in components}
    if len(kinds) != 1:
        raise ValueError(f"cannot mix stream kinds {sorted(kinds)}")
    return kinds.pop()


def _map_pair(fn, a, b):
    """``fn`` on the matching tensors of two values of one structure (a
    tensor, or a tuple of them: an arrival stream's ``(x, side)``)."""
    if isinstance(a, tuple):
        return tuple(_map_pair(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _select_fns(components: Sequence[Stream], by_time: bool):
    """(init_fn, chunk_fn) of compute-all-then-select: every component's
    chunk runs, then ``torch.where`` picks per row by ``params["component"]``
    [B] (``by_time`` False) or per row and slot by the ``params["bounds"]``
    [B, n - 1] boundaries (``by_time`` True)."""
    def init_fn(params):
        return tuple(c.init_fn(p) for c, p in zip(components,
                                                   params["subs"]))

    def chunk_fn(params, state, tids, *extra):
        states, values = [], []
        for c, p, st in zip(components, params["subs"], state):
            st2, v = c.chunk_fn(p, st, tids, *extra)
            states.append(st2)
            values.append(v)
        if by_time:                                          # [B, chunk]
            sel = (tids[None, :, None] >= params["bounds"][:, None, :]).sum(
                dim=2)
        else:
            sel = params["component"][:, None]               # [B, 1]
        out = values[0]
        for i in range(1, len(values)):
            pick = sel == i
            out = _map_pair(lambda a, b: torch.where(
                pick.reshape(pick.shape + (1,) * (a.dim() - 2)), b, a),
                out, values[i])
        return tuple(states), out

    return init_fn, chunk_fn


def _component_B(components: Sequence[Stream]) -> int:
    return tree_leaves(components[0].params)[0].shape[0]


def mixture(components: Sequence[Stream], component) -> Stream:
    """Per-instance mixture: instance b emits component ``component[b]``'s
    stream (all components of one channel kind).  Every component's state
    advances on every instance; the winner is selected per instance, so
    row b is bitwise the winner's own output."""
    kind = _check_same_kind(components)
    comp = np.asarray(component.cpu() if isinstance(component, torch.Tensor)
                      else component).astype(np.int32)
    if np.any((comp < 0) | (comp >= len(components))):
        raise ValueError(f"component indices must be in [0, "
                         f"{len(components)}), got {comp}")
    dev = tree_leaves(components[0].params)[0].device
    params = {"component": torch.as_tensor(comp, device=dev),
              "subs": tuple(s.params for s in components)}
    init_fn, chunk_fn = _select_fns(tuple(components), False)
    name = "mix(" + ",".join(s.name for s in components) + ")"
    return Stream(name, kind, init_fn, chunk_fn, params,
                  has_side=any(s.has_side for s in components))


def _choice(key, n: int, B: int, weights) -> torch.Tensor:
    """``jax.random.choice(key, n, (B,), p=w / w.sum())`` with replacement:
    ``p`` the float64 weights' shares rounded to float32, their float32
    cumulative sum (left to right), ``r = cumsum[-1] * (1 - u)`` for the
    shaped uniform ``u = uniform(key, (B,))`` (kernel P on the card), and
    the left insertion point of ``r`` in the cumulative sum.  Returns [B]
    int32 on the key's device."""
    w = np.asarray(weights, np.float64)
    p = (w / w.sum()).astype(np.float32)
    if p.shape != (n,):
        raise ValueError(f"p must be a 1D vector of {n} weights, got shape "
                         f"{p.shape}")
    cum = p.copy()
    for i in range(1, n):                 # float32 adds, left to right
        cum[i] = cum[i - 1] + p[i]
    cum = torch.as_tensor(cum, device=key.device)
    r = cum[-1] * (1.0 - shaped_uniform(key, B))
    return (cum[None, :] < r[:, None]).sum(dim=1).to(torch.int32)


def mixture_from_weights(components: Sequence[Stream], weights, key,
                         B: int) -> Stream:
    """Mixture with the per-instance assignment sampled once from
    ``weights`` (the declarative form of "30% bursty, 70% Bernoulli"):
    ``jax.random.choice`` under the one [2] ``key`` (``_choice``)."""
    key = torch.as_tensor(key, dtype=torch.int64,
                          device=tree_leaves(components[0].params)[0].device)
    return mixture(components, _choice(key, len(components), B, weights))


def regime_switch(components: Sequence[Stream],
                  boundaries: Sequence[int]) -> Stream:
    """Time-based switching: slots ``[boundaries[i-1], boundaries[i])``
    play component i (global slot indices, strictly increasing, one fewer
    than components).  Every component keeps advancing its own state
    through foreign regimes, so each regime's slots are bitwise the
    component's own slots."""
    kind = _check_same_kind(components)
    if len(boundaries) != len(components) - 1:
        raise ValueError("need len(components) - 1 boundaries")
    bounds = np.asarray(boundaries, np.int32)
    if bounds.size and np.any(np.diff(bounds) <= 0):
        raise ValueError("boundaries must be strictly increasing")
    B = _component_B(components)
    dev = tree_leaves(components[0].params)[0].device
    # a [B, n - 1] leaf: every leaf carries the instance axis
    params = {"bounds": torch.as_tensor(bounds, device=dev)[None]
              .expand(B, -1).contiguous(),
              "subs": tuple(s.params for s in components)}
    init_fn, chunk_fn = _select_fns(tuple(components), True)
    name = "switch(" + ",".join(s.name for s in components) + ")"
    return Stream(name, kind, init_fn, chunk_fn, params,
                  has_side=any(s.has_side for s in components))


def antithetic_pairing(stream: Stream) -> Stream:
    """Negatively-associated instance pairs: instances (2m, 2m+1) share
    instance 2m's key and the odd member flips every slot uniform ``u -> 1
    - u``.  Needs a stream with ``key`` and ``flip`` params
    (``bernoulli_arrivals``, ``uniform_rents``); pair sums of uniforms are
    exactly ``lo + hi``."""
    if not (isinstance(stream.params, dict) and "flip" in stream.params
            and "key" in stream.params):
        raise ValueError(f"{stream.name} does not support antithetic "
                         "pairing (no flip/key params)")
    flip = stream.params["flip"]
    B = flip.shape[0]
    idx = torch.arange(B, device=flip.device)
    params = dict(stream.params)
    params["key"] = stream.params["key"][(idx // 2) * 2]
    params["flip"] = idx % 2 == 1
    return Stream(f"antithetic({stream.name})", stream.kind, stream.init_fn,
                  stream.chunk_fn, params, has_side=stream.has_side)


# ----------------------------------------------------------------------
# Monte-Carlo seed replication (the fleet drivers' ``n_seeds=`` axis).
# ----------------------------------------------------------------------

def _map_key_leaves(params, leaf_fn, key_fn, pair_fn=None):
    """Walk a params nest, applying ``key_fn`` to every ``"key"`` dict entry
    (where every random stream keeps its counter-based keys) and
    ``leaf_fn`` to every other tensor leaf.  ``pair_fn(key, flip) ->
    (key', flip')``, when given, takes over dicts that carry both ``"key"``
    and ``"flip"`` (the flip-capable streams)."""
    if isinstance(params, dict):
        if pair_fn is not None and "key" in params and "flip" in params:
            key2, flip2 = pair_fn(params["key"], params["flip"])
            return {k: (key2 if k == "key" else flip2 if k == "flip"
                        else _map_key_leaves(v, leaf_fn, key_fn, pair_fn))
                    for k, v in params.items()}
        return {k: (key_fn(v) if k == "key"
                    else _map_key_leaves(v, leaf_fn, key_fn, pair_fn))
                for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(_map_key_leaves(v, leaf_fn, key_fn, pair_fn)
                            for v in params)
    return leaf_fn(params)


def _fold_stacked(k, seeds):
    """``fold_in`` over a stacked key leaf ``[R, ..., 2]`` with per-row
    seeds ``[R]`` (broadcast over any axes between the row axis and the
    key words)."""
    flat = k.reshape(-1, 2)
    s = seeds.repeat_interleave(flat.shape[0] // seeds.shape[0])
    return fold_keys(flat, s).reshape(k.shape)


def with_seed(obj, seed: int):
    """Fold one Monte-Carlo seed into every stream key of a ``Scenario`` or
    ``Stream``: ``key -> fold_in(key, seed)``, before any per-slot fold, so
    the result is an ordinary standalone scenario — exactly the replica
    ``replicate_seeds`` packs at rows ``(b, seed)``.  Keyless streams are
    untouched."""
    def fold(k):
        return _fold_stacked(k, torch.full((k.shape[0],), int(seed),
                                           dtype=torch.int64,
                                           device=k.device))
    params = _map_key_leaves(obj.params, lambda a: a, fold)
    return obj._replace(params=params, name=f"seed{seed}({obj.name})")


def replicate_seeds(obj, n_seeds: int, antithetic: bool = False):
    """S seed-replicas of a B-instance ``Scenario`` (or ``Stream``) as one
    [B*S] object.  Row ``b * S + s`` (instance-major, seed-minor) carries
    instance ``b``'s params with ``fold_in(key, s)`` on every stream key —
    bitwise ``with_seed(obj, s)``'s row ``b``.

    ``antithetic=True`` (even S) pairs replicas on flip-capable streams:
    ``(b, 2m)`` and ``(b, 2m + 1)`` share ``fold_in(key, m)`` and the odd
    member flips every slot uniform ``u -> 1 - u``; streams without a flip
    keep the independent per-replica fold."""
    S = int(n_seeds)
    if S < 1:
        raise ValueError(f"n_seeds must be >= 1, got {n_seeds}")
    B = tree_leaves(obj.params)[0].shape[0]
    device = tree_leaves(obj.params)[0].device
    seeds = torch.arange(S, dtype=torch.int64, device=device).repeat(B)
    rep = lambda a: a.repeat_interleave(S, dim=0)
    if not antithetic:
        params = _map_key_leaves(obj.params, rep,
                                 lambda k: _fold_stacked(rep(k), seeds))
        return obj._replace(params=params, name=f"mc{S}({obj.name})")
    if S % 2:
        raise ValueError(f"antithetic replication needs an even n_seeds, "
                         f"got {n_seeds}")
    odd = (seeds % 2).to(torch.bool)
    params = _map_key_leaves(
        obj.params, rep, lambda k: _fold_stacked(rep(k), seeds),
        pair_fn=lambda k, f: (_fold_stacked(rep(k), seeds // 2),
                              torch.logical_xor(rep(f), odd)))
    return obj._replace(params=params, name=f"mc{S}a({obj.name})")


def tile_services(obj, n_services: int, shared: Sequence[str] = ("rent",)):
    """N service-replicas of a B-instance ``Scenario`` (or ``Stream``) as
    one [B*N] object, the per-service arrival axis of a multi-service
    fleet.  Row ``b * N + n`` (instance-major, service-minor) carries
    instance ``b``'s params with ``fold_in(key, n)`` on every stream key;
    non-key leaves are replicated row-wise.  ``shared`` names top-level
    param groups (``combine``'s ``"arr"`` / ``"rent"`` / ``"svc"``) whose
    keys are replicated without the fold: by default every service of an
    instance sees the same rent stream.  As in the reference, the groups
    are the top-level entries of a dict of params, so a bare stream's own
    entries (its ``"key"`` among them) are replicated without the fold.
    ``n_services=1`` returns ``obj`` itself."""
    N = int(n_services)
    if N < 1:
        raise ValueError(f"n_services must be >= 1, got {n_services}")
    if N == 1:
        return obj
    B = tree_leaves(obj.params)[0].shape[0]
    device = tree_leaves(obj.params)[0].device
    svc_ids = torch.arange(N, dtype=torch.int64, device=device).repeat(B)
    rep = lambda a: a.repeat_interleave(N, dim=0)   # noqa: E731
    folded = lambda p: _map_key_leaves(             # noqa: E731
        p, rep, lambda k: _fold_stacked(rep(k), svc_ids))
    plain = lambda p: _map_key_leaves(p, rep, rep)  # noqa: E731
    if isinstance(obj.params, dict):
        params = {k: (plain(v) if k in shared else folded(v))
                  for k, v in obj.params.items()}
    else:
        params = folded(obj.params)
    return obj._replace(params=params, name=f"svc{N}({obj.name})")


def _trace_svc_init(params):
    return ()


def _trace_svc_chunk(params, state, tids, x):
    tr = params["trace"]
    idx = torch.clamp_max(tids.to(torch.int64), tr.shape[1] - 1)
    return state, tr[:, idx]


def trace_scenario(x, c, B: Optional[int] = None, svc=None, side=None,
                   device=None) -> Scenario:
    """Deterministic playback of recorded observations through the fused
    drivers (g-curve pipelines, real traces): ``x`` / ``c`` / ``side`` [T]
    or [B, T]; ``svc`` rides as a [B, T, K] trace when given (a [T, K]
    one is broadcast over the rows).  Slots past the trace repeat its last
    sample (a clipped gather)."""
    arr = _streams.trace_arrivals(x, B=B, side=side, device=device)
    B_eff = arr.params["trace"].shape[0]
    dev = arr.params["trace"].device
    rent = _streams.trace_rents(c, B=B_eff, device=dev)
    svc_stream = None
    if svc is not None:
        svc_t = torch.as_tensor(np.asarray(svc.cpu() if isinstance(
            svc, torch.Tensor) else svc, np.float32), device=dev)
        if svc_t.dim() == 2:
            svc_t = svc_t[None].expand((B_eff,) + tuple(svc_t.shape))
        svc_stream = Stream("trace", "svc", _trace_svc_init,
                            _trace_svc_chunk, {"trace": svc_t.contiguous()})
    return combine(arr, rent, svc=svc_stream, name="trace")

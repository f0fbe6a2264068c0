"""Scenario combinators (the port of ``combine``, ``with_seed`` and
``replicate_seeds`` from ``repro/core/scenarios/combinators.py``).
Every stream key of a scenario, the service stream's included, takes the
seed fold.

* ``combine``         — one stream per channel (arrivals, rents and
                        optionally Model-2 service) -> a full ``Scenario``.
* ``with_seed``       — fold one Monte-Carlo seed into every stream key
                        (before the per-slot counter fold).
* ``replicate_seeds`` — the MC axis: S seed-replicas of a B-instance
                        scenario as one [B*S] scenario (``antithetic=True``
                        pairs replicas (2m, 2m+1) on flip-capable streams).

Mixtures, regime switching, instance-level antithetic pairing, trace
scenarios and service tiling come with later slices (ROADMAP.md, Queue 1
items 3 and 11).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.scenarios.base import (ObsSlab, Scenario, Stream,
                                             fold_keys, tree_leaves)


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

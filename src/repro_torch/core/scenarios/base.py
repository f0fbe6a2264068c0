"""Scenario abstraction: counter-keyed workload generators (the port of
``repro/core/scenarios/base.py``).

A *scenario* is a pair of plain functions over a dict of [B]-leading
tensors:

    gen_state0          = init_fn(params)
    gen_state', slab    = chunk_fn(params, gen_state, tids)

``tids`` is the ``[chunk]`` int32 vector of *global* slot indices to emit
and ``slab`` an ``ObsSlab`` of ``[B, chunk]`` observations.  The batch axis
is written out (the reference vmapped a per-instance pair).

Every random stream draws slot ``t``'s randomness through ``slot_uniform``
from ``fold_in(key, t)`` — a counter, never a position in a bulk draw — so
a stream is invariant to how the horizon is cut into chunks, and the port's
draws are bitwise jax's under the same threefry layout
(``kernels.hosting.threefry_partitionable``).  PRNG keys are [B, 2] int64
tensors of 32-bit words.

``slot_uniform`` is also the reference's PRNG backend dispatch point
(``PRNG_BACKENDS``, ``prng_dispatch``): under "pallas" the reference draws
it through its Pallas kernel, which implements only jax's original
threefry layout, so the port draws it (and the stream kernels that finish
its draws: Bernoulli arrivals, uniform and NA rents, the GE chain and its
Bernoulli emissions) in that layout, whichever is active
(``slot_layout``).  Every other draw (Poisson, normals, ARMA, Model-2
service, the GE chain's initial state) stays on the active layout, as in
the reference.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.hosting import (MASK32, is_partitionable,
                                         threefry2x32, threefry_fold)


class ObsSlab(NamedTuple):
    """One ``[B, chunk]`` window of generated observations."""

    x: torch.Tensor                        # [B, chunk] int32 arrivals
    c: torch.Tensor                        # [B, chunk] float32 rents
    svc: Optional[torch.Tensor] = None     # [B, chunk, K] service costs
    side: Optional[torch.Tensor] = None    # [B, chunk] int32 side channel


class Stream(NamedTuple):
    """One generated channel (``kind``: ``"arrivals"``, ``"rents"`` or
    ``"svc"``).

    ``chunk_fn(params, state, tids) -> (state', values)``: arrival streams
    emit ``(x, side)``, rent streams ``c``; a service stream's
    ``chunk_fn(params, state, tids, x)`` reads the chunk's arrivals and
    emits ``svc`` [B, chunk, K].  ``has_side`` marks arrival streams whose
    side channel carries the GE chain state."""

    name: str
    kind: str
    init_fn: Callable[[Any], Any]
    chunk_fn: Callable[..., Any]
    params: Any
    has_side: bool = False


class Scenario(NamedTuple):
    """A full workload generator: ``chunk_fn(params, gen_state, tids) ->
    (gen_state', ObsSlab)``."""

    name: str
    init_fn: Callable[[Any], Any]
    chunk_fn: Callable[[Any, Any, torch.Tensor], Any]
    params: Any
    has_svc: bool = False
    has_side: bool = False

    @property
    def B(self) -> int:
        return tree_leaves(self.params)[0].shape[0]


# ----------------------------------------------------------------------
# Param trees.
# ----------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """The tensor leaves of a nest of dicts / tuples / lists, in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nest of dicts / tuples / lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


# ----------------------------------------------------------------------
# Param / key plumbing shared by every stream constructor.
# ----------------------------------------------------------------------

def bcast(v, B: int, dtype, device) -> torch.Tensor:
    """A scalar or [B] value as a [B] param leaf."""
    return torch.as_tensor(v, dtype=dtype, device=device).expand(B).clone()


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a [2] int64 key: the 64-bit seed's
    high and low 32-bit words."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=resolve_device(device))


def split_keys(key, B: int) -> torch.Tensor:
    """[B, 2] independent per-instance keys from one [2] key:
    ``jax.random.split(key, B)`` under the current threefry layout."""
    k0, k1 = key[0], key[1]
    if is_partitionable():
        # fold-like split: key i hashes the counter (0, i)
        i = torch.arange(B, dtype=torch.int64, device=key.device)
        y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
        return torch.stack([y0, y1], dim=1)
    # original split: hash iota(2B) as the half-split counter pair
    counts = torch.arange(2 * B, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, counts[:B], counts[B:])
    return torch.cat([y0, y1]).reshape(B, 2)


def shared_keys(key, B: int) -> torch.Tensor:
    """[B, 2] copies of ONE key: every instance replays the same path."""
    return key[None, :].expand(B, 2).clone()


def as_keys(key, B: int, device) -> torch.Tensor:
    """A single [2] key (-> independent splits) or an explicit [B, 2] key
    array (kept), on ``device``."""
    key = torch.as_tensor(key, dtype=torch.int64, device=device)
    if key.dim() == 1:
        return split_keys(key, B)
    if key.shape[0] != B:
        raise ValueError(f"key batch {key.shape[0]} != B={B}")
    return key.contiguous()


def fold_keys(keys, data) -> torch.Tensor:
    """Row-wise ``fold_in(keys[i], data[i])``: [N, 2] keys, [N] data."""
    d = data.to(torch.int64) & MASK32
    y0, y1 = threefry_fold(keys[:, 0], keys[:, 1], d)
    return torch.stack([y0, y1], dim=1)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` of one [2] key."""
    d = torch.tensor([int(data)], dtype=torch.int64, device=key.device)
    return fold_keys(key[None], d)[0]


def slot_keys(keys, tids) -> torch.Tensor:
    """[B, chunk, 2] counter-based per-slot keys: ``fold_in(keys[i],
    tids[j])``."""
    t = (tids.to(torch.int64) & MASK32)[None, :]
    y0, y1 = threefry_fold(keys[:, 0:1], keys[:, 1:2], t)
    return torch.stack([y0, y1], dim=2)


#: Valid PRNG backends, as the reference names them: "xla" draws
#: ``slot_uniform`` in the active threefry layout, "pallas" in jax's
#: original layout (the reference's Pallas PRNG kernel implements only
#: that one).  Both run kernel P on the card.  Selected per scenario by
#: ``combinators.with_prng_backend`` or the fleet drivers' ``prng_backend=``.
PRNG_BACKENDS = ("xla", "pallas")

# the backend stack; ``slot_layout`` consults the top
_PRNG_BACKEND = ["xla"]


@contextlib.contextmanager
def prng_dispatch(backend: str):
    """Route ``slot_uniform`` (and the stream kernels that finish its
    draws) through ``backend`` inside the block."""
    if backend not in PRNG_BACKENDS:
        raise ValueError(f"prng backend must be one of {PRNG_BACKENDS}, "
                         f"got {backend!r}")
    _PRNG_BACKEND.append(backend)
    try:
        yield
    finally:
        _PRNG_BACKEND.pop()


def slot_layout() -> Optional[bool]:
    """The threefry layout of ``slot_uniform``'s draws under the current
    backend: None (the active layout) under "xla", False (the original
    layout) under "pallas"."""
    return False if _PRNG_BACKEND[-1] == "pallas" else None


def slot_uniform(keys, tids, salt: Optional[int] = None) -> torch.Tensor:
    """[B, chunk] independent U(0,1) float32 draws, one per global slot
    index: ``fold_in(key, t)`` (then the optional salt fold) and jax's
    scalar uniform, in the backend's layout (``slot_layout``).  THE
    counter-keyed primitive every stream draws through — kernel P on the
    card, its plain version on the CPU."""
    return ops.counter_uniforms(keys, tids, salt, slot_layout())


# ----------------------------------------------------------------------
# Materialization: run the same chunk_fn outside the simulator.
# ----------------------------------------------------------------------

def chunk_geometry(T: int, chunk_size: Optional[int]):
    """(n_chunks, padded T) for cutting a horizon into fixed chunks — the
    one copy shared by ``materialize`` and the fleet drivers."""
    if chunk_size is None:
        return 1, T
    chunk = int(chunk_size)
    n = max(1, math.ceil(T / chunk))
    return n, n * chunk


def chunk_tids(t0: int, chunk: int, device) -> torch.Tensor:
    """[chunk] int32 global slot indices ``t0 .. t0 + chunk - 1``."""
    return torch.arange(t0, t0 + chunk, dtype=torch.int32, device=device)


def _run_chunks(init_fn, chunk_fn, params, T: int, chunk_size, x=None):
    """Every chunk's values; ``x`` [B, T] (a service stream's arrivals,
    zero-padded past T) is cut into the chunks and handed to each."""
    n_chunks, T_pad = chunk_geometry(T, chunk_size)
    chunk = T_pad // n_chunks
    device = tree_leaves(params)[0].device
    if x is not None:
        x = torch.as_tensor(np.asarray(x, np.int32), device=device)
        x = torch.nn.functional.pad(x, (0, T_pad - T))
    state = init_fn(params)
    outs = []
    for i in range(n_chunks):
        tids = chunk_tids(i * chunk, chunk, device)
        extra = () if x is None else (
            x[:, i * chunk:(i + 1) * chunk].contiguous(),)
        state, vals = chunk_fn(params, state, tids, *extra)
        outs.append(vals)
    return outs


def _cat_crop(parts, T: int):
    if parts[0] is None:
        return None
    return torch.cat(parts, dim=1)[:, :T].cpu().numpy()


def materialize_stream(stream: Stream, T: int,
                       chunk_size: Optional[int] = None, x=None):
    """Run one stream over the whole horizon; returns its values as numpy
    arrays shaped [B, T] (an ``(x, side)`` pair for arrival streams,
    [B, T, K] for a service stream, which needs the arrivals ``x`` [B,
    T]).  Chunk-invariant: any ``chunk_size`` gives the same bits."""
    if stream.kind == "svc" and x is None:
        raise ValueError("service streams need the arrival slab x")
    outs = _run_chunks(stream.init_fn, stream.chunk_fn, stream.params, T,
                       chunk_size, x if stream.kind == "svc" else None)
    if stream.kind == "arrivals":
        return (_cat_crop([o[0] for o in outs], T),
                _cat_crop([o[1] for o in outs], T))
    return _cat_crop(outs, T)


def materialize(scenario: Scenario, T: int, chunk_size: Optional[int] = None):
    """A scenario's observations as ``(x, c, svc, side)`` numpy arrays
    shaped [B, T] (svc/side None when absent), as the reference returns."""
    outs = _run_chunks(scenario.init_fn, scenario.chunk_fn, scenario.params,
                       T, chunk_size)
    x = _cat_crop([o.x for o in outs], T)
    c = _cat_crop([o.c for o in outs], T)
    svc = _cat_crop([o.svc for o in outs], T)
    side = _cat_crop([o.side for o in outs], T) if scenario.has_side else None
    return x, c, svc, side

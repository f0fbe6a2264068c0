"""Carry the reference's numpy parameters across to the port's tensors:
``tree_from_numpy`` for the hosting engine's nests, ``params_from_jax``
for a model's parameter tree."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device


def tree_from_numpy(tree, device):
    """Turn a nest of dicts / lists / tuples / NamedTuples of numpy arrays
    into the same nest of tensors on ``device``.

    uint32 arrays (PRNG key words) become int64 tensors holding the same
    values in ``[0, 2**32)``: torch on the CPU has no uint32 ``+``, ``<<``
    or ``>>``, and the port's threefry works in int64 masked with
    ``& 0xFFFFFFFF``.  Every other dtype is kept; non-array leaves (None,
    Python scalars, strings) pass through unchanged."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_from_numpy(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        a = np.ascontiguousarray(tree)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(device)
    return tree


def _leaf_to_tensor(a, device):
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":        # ml_dtypes.bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device=None):
    """The reference's model parameter tree (``repro.models.init_params``)
    as the port's: the same nest of dicts and lists (stacked segment
    parameters stay stacked ``[n, ...]``, a ``shared_ref`` segment's empty
    ``{}`` stays empty), every leaf a tensor on ``device`` with the same
    values and dtype.  ``device`` is resolved by ``resolve_device``: the
    CUDA card by default (raising without one), the CPU only when asked.
    Leaves are numpy arrays (``ml_dtypes.bfloat16`` ones included, carried
    bit for bit) or anything ``np.asarray`` takes."""
    dev = resolve_device(device)

    def carry(t):
        if isinstance(t, dict):
            return {k: carry(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(carry(v) for v in t)
        return _leaf_to_tensor(t, dev)

    return carry(tree)

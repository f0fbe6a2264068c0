"""Carry the reference's numpy parameters across to the port's tensors."""
from __future__ import annotations

import numpy as np
import torch


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

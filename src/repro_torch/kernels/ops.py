"""Batched entry points over a leading [R] row axis, as the engine calls
them (the counterparts of ``repro/kernels/ops.py:dp_minplus`` and
``counter_uniforms``, which vmapped one-instance Pallas kernels; here the
row axis is the kernels' own)."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import hosting


def dp_minplus(J, wck, fetch, valid):
    """One DP forward chunk: ``J`` [R, K], ``wck`` [R, chunk, K], ``fetch``
    [R, K, K], ``valid`` [R, chunk] -> ``(J', args)`` (kernel D on the
    card)."""
    return hosting.dp_minplus(J, wck, fetch, valid)


def counter_uniforms(keys, tids, salt: Optional[int] = None):
    """Counter-keyed uniforms: ``keys`` [R, 2] int64 words, ``tids`` [chunk]
    int32 -> [R, chunk] float32 (kernel P on the card), under the current
    threefry layout."""
    return hosting.slot_uniform(keys, tids, salt)

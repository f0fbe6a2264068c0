"""Slotted hosting simulator (the port of ``repro/core/simulator.py``).

Conventions (paper §2.5/§2.6): ``r_hist[t]`` is the level held during slot
t (r_1 = 0); each slot costs rent + service at the held level, plus the
fetch ``M * (lv[r_{t+1}] - lv[r_t])^+`` paid when the policy upgrades.
Online policies also pay a final upgrade decided at the last slot unless
``include_final_fetch=False``.

``sim_chunk_core`` is the unit of work: slots ``[t0, t0 + chunk)`` of R
rows, carrying ``(policy state, accumulator)`` across chunks.  Slots past a
row's own horizon ``T_len`` add exactly 0.0 and freeze the state, so mixed
horizons and any chunking give the reference's bits.  Here it is a plain
Python loop over the chunk's slots on [R] tensors; ``sim_chunk`` sends
alpha-RR (and RR, its K=2 case) to kernel S instead, and the static, MDP
and ABC policies to kernel S's table variant, under Model-1 service and on
a Model-2 slab alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.policies.alpha_rr import alpha_rr_step
from repro_torch.core.policies.base import PolicyFns, SlotObs, freeze_invalid
from repro_torch.core.policies.baselines import TABLE_STEPS, table_form
from repro_torch.kernels.hosting import (gather_svc, sim_chunk_alpha_rr,
                                         sim_chunk_alpha_rr_svc,
                                         sim_chunk_table, sim_chunk_table_svc)


@dataclasses.dataclass
class BatchSimResult:
    """[B]-structured results of one batched simulation."""

    total: np.ndarray         # [B]
    fetch: np.ndarray         # [B]
    rent: np.ndarray          # [B]
    service: np.ndarray       # [B]
    r_hist: np.ndarray        # [B, T] int level indices
    level_slots: np.ndarray   # [B, K] slots spent at each level


def sim_acc0(R: int, K: int, device) -> dict:
    """Zero accumulator: [R, 3] rent/service/fetch sums and the [R, K]
    level-occupancy histogram."""
    return {"sums": torch.zeros((R, 3), dtype=torch.float32, device=device),
            "counts": torch.zeros((R, K), dtype=torch.int32, device=device)}


def model1_svc(x, g):
    """Model-1 service ``x * g``: [R, chunk] arrivals, [R, K] g ->
    [R, chunk, K] (float32(x) times g, one rounded product)."""
    return x[:, :, None].to(g.dtype) * g[:, None, :]


def _select(onehot, a):
    # a[r] per row, phrased as the reference's one-hot sum (exact)
    return torch.where(onehot, a, 0.0).sum(dim=1)


def _fetch_between(M, lv_from, lv_to):
    """Fetch cost of a transition under scalar ``M``: ``M * (lv_to -
    lv_from)^+``.  Matrix-valued ``M`` (joint multi-service grids) comes
    with the service-axis slice."""
    return M * torch.clamp_min(lv_to - lv_from, 0.0)


def sim_chunk_core(step_fn, include_final_fetch: bool, params, lv, M, T_len,
                   t0: int, carry, x, c, svc, side=None):
    """Step slots ``[t0, t0 + chunk)`` of R rows: ``lv`` [R, K], ``M`` [R],
    ``T_len`` [R] int32, ``x`` / ``c`` / ``side`` [R, chunk], ``svc``
    [R, chunk, K] (``x`` may be None for a policy that reads only the
    service costs).  Returns ``(carry', r_hist [R, chunk] int32)``; the
    sums accumulate slot by slot, in the reference's order."""
    R, K = lv.shape
    chunk = c.shape[1]
    state, acc = carry
    sums, counts = acc["sums"], acc["counts"]
    levels = torch.arange(K, device=lv.device)[None, :]
    r_hist = torch.empty((R, chunk), dtype=torch.int32, device=lv.device)
    for j in range(chunk):
        t = t0 + j
        valid = T_len > t
        r_t = state["r"]
        onehot_t = levels == r_t[:, None]
        lv_t = _select(onehot_t, lv)
        rent_t = c[:, j] * lv_t
        svc_cost_t = _select(onehot_t, svc[:, j])
        obs = SlotObs(None if x is None else x[:, j], c[:, j], svc[:, j],
                      None if side is None else side[:, j])
        new_state = freeze_invalid(valid, step_fn(params, state, obs), state)
        lv_next = _select(levels == new_state["r"][:, None], lv)
        fetch_t = _fetch_between(M, lv_t, lv_next)
        if not include_final_fetch:
            fetch_t = torch.where(T_len - 1 == t, 0.0, fetch_t)
        vec = torch.stack([rent_t, svc_cost_t, fetch_t], dim=1)
        sums = sums + torch.where(valid[:, None], vec, 0.0)
        counts = counts + torch.where(valid[:, None], onehot_t.to(torch.int32),
                                      0)
        r_hist[:, j] = r_t
        state = new_state
    return (state, {"sums": sums, "counts": counts}), r_hist


def sim_chunk(policy: PolicyFns, include_final_fetch: bool, lv, g, M, T_len,
              t0: int, carry, slab, collect_trace: bool = True,
              svc_cols=None):
    """One chunk of one fleet simulation on a generated ``ObsSlab``.
    alpha-RR runs as kernel S (the kernel on the card, its plain version on
    the CPU): under Model-1 service ``kernels.hosting.sim_chunk_alpha_rr``,
    on a Model-2 slab ``sim_chunk_alpha_rr_svc``, which gathers a lane's
    columns through ``svc_cols`` [R, K] itself.  The static, MDP and ABC
    policies run as S's table variant (``sim_chunk_table`` /
    ``sim_chunk_table_svc`` on their ``table_form``).  Any other policy
    runs the plain loop."""
    step = policy.step_fn
    if step is alpha_rr_step:
        if slab.svc is None:
            return sim_chunk_alpha_rr(policy.params, lv, g, M, T_len, t0,
                                      carry, slab.x, slab.c,
                                      include_final_fetch, collect_trace)
        return sim_chunk_alpha_rr_svc(policy.params, lv, M, T_len, t0, carry,
                                      slab.c, slab.svc, svc_cols,
                                      include_final_fetch, collect_trace)
    if step in TABLE_STEPS:
        table = table_form(step, policy.params, lv.shape[1])
        if slab.svc is None:
            return sim_chunk_table(*table, lv, g, M, T_len, t0, carry,
                                   slab.x, slab.c, slab.side,
                                   include_final_fetch, collect_trace)
        return sim_chunk_table_svc(*table, lv, M, T_len, t0, carry, slab.x,
                                   slab.c, slab.side, slab.svc, svc_cols,
                                   include_final_fetch, collect_trace)
    svc = (model1_svc(slab.x, g) if slab.svc is None
           else gather_svc(slab.svc, svc_cols))
    carry, r = sim_chunk_core(policy.step_fn, include_final_fetch,
                              policy.params, lv, M, T_len, t0, carry, slab.x,
                              slab.c, svc, slab.side)
    return carry, (r if collect_trace else None)


def schedule_chunk_core(lv, M, T_len, t0: int, carry, r, c, svc):
    """Cost of slots ``[t0, t0 + chunk)`` of given schedules ``r``
    [R, chunk] (entered from ``carry[0]``, the level held before the
    chunk; fetches charged on entry).  Same in-loop accumulation and
    valid-slot masking as ``sim_chunk_core``."""
    R, K = lv.shape
    prev, acc = carry
    sums, counts = acc["sums"], acc["counts"]
    levels = torch.arange(K, device=lv.device)[None, :]
    for j in range(r.shape[1]):
        valid = T_len > t0 + j
        r_t = r[:, j]
        onehot_t = levels == r_t[:, None]
        lv_t = _select(onehot_t, lv)
        lv_prev = _select(levels == prev[:, None], lv)
        fetch_t = _fetch_between(M, lv_prev, lv_t)
        rent_t = c[:, j] * lv_t
        svc_cost_t = _select(onehot_t, svc[:, j])
        vec = torch.stack([rent_t, svc_cost_t, fetch_t], dim=1)
        sums = sums + torch.where(valid[:, None], vec, 0.0)
        counts = counts + torch.where(valid[:, None], onehot_t.to(torch.int32),
                                      0)
        prev = torch.where(valid, r_t, prev).to(torch.int32)
    return (prev, {"sums": sums, "counts": counts})


def evaluate_schedule_batch(lv, g, M, r_hist, x, c) -> BatchSimResult:
    """Cost of [B, T] schedules on [B, T] Model-1 observations (whole
    horizon, one chunk)."""
    B, K = lv.shape
    T = r_hist.shape[1]
    T_len = torch.full((B,), T, dtype=torch.int32, device=lv.device)
    carry0 = (torch.zeros((B,), dtype=torch.int32, device=lv.device),
              sim_acc0(B, K, lv.device))
    _, acc = schedule_chunk_core(lv, M, T_len, 0, carry0, r_hist, c,
                                 model1_svc(x, g))
    sums = acc["sums"].cpu().numpy().astype(np.float64)
    return BatchSimResult(total=sums.sum(axis=1), rent=sums[:, 0],
                          service=sums[:, 1], fetch=sums[:, 2],
                          r_hist=r_hist.cpu().numpy(),
                          level_slots=acc["counts"].cpu().numpy()
                          .astype(np.int64))

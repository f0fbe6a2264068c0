"""Slotted hosting simulator (the port of ``repro/core/simulator.py``).

Conventions (paper §2.5/§2.6): ``r_hist[t]`` is the level held during slot
t (r_1 = 0); each slot costs rent + service at the held level, plus the
fetch ``M * (lv[r_{t+1}] - lv[r_t])^+`` paid when the policy upgrades.
Online policies also pay a final upgrade decided at the last slot unless
``include_final_fetch=False``; ``evaluate_schedule`` charges fetches on
entry, so offline schedules are scored the same way.

``sim_chunk_core`` is the unit of work: slots ``[t0, t0 + chunk)`` of R
rows, carrying ``(policy state, accumulator)`` across chunks.  Slots past a
row's own horizon ``T_len`` add exactly 0.0 and freeze the state, so mixed
horizons and any chunking give the reference's bits.  Here it is a plain
Python loop over the chunk's slots on [R] tensors; ``sim_chunk`` sends
alpha-RR (and RR, its K=2 case) to kernel S instead, and the static, MDP
and ABC policies to kernel S's table variant, under Model-1 service and on
a Model-2 slab alike.  A given schedule is priced by kernel E
(``kernels.hosting.schedule_chunk``).

``sim_chunk_lanes`` steps several policy lanes over one shared slab, each
lane one ``sim_chunk`` (kernel S on the card) on its own service costs.

The per-instance entry points (``run_policy``, ``run_policy_batch``,
``evaluate_schedule``, ``evaluate_schedule_batch``) are the one-chunk,
one-horizon case of the same kernels: one instance is a one-row grid.
``model2_service_matrix`` draws a Model-2 service matrix from one key
(kernel P's shaped uniform).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.costs import HostingCosts, HostingGrid, as_tensor
from repro_torch.core.policies.alpha_rr import alpha_rr_step
from repro_torch.core.policies.base import PolicyFns, SlotObs, freeze_invalid
from repro_torch.core.policies.baselines import (TABLE_STEPS, abc_step,
                                                 mdp_step, static_step,
                                                 table_form)
from repro_torch.core.scenarios.base import ObsSlab
from repro_torch.kernels.hosting import (fma32, gather_svc, schedule_chunk,
                                         shaped_uniform, sim_chunk_alpha_rr,
                                         sim_chunk_alpha_rr_svc,
                                         sim_chunk_table, sim_chunk_table_svc)


@dataclasses.dataclass
class SimResult:
    total: float
    fetch: float
    rent: float
    service: float
    r_hist: np.ndarray        # [T] int level indices
    level_slots: np.ndarray   # [K] slots spent at each level
    route: float = 0.0        # the routing term (``route=``, not ported)

    @property
    def per_slot(self) -> float:
        return self.total / len(self.r_hist)


@dataclasses.dataclass
class BatchSimResult:
    """[B]-structured results of one batched simulation."""

    total: np.ndarray         # [B]
    fetch: np.ndarray         # [B]
    rent: np.ndarray          # [B]
    service: np.ndarray       # [B]
    r_hist: np.ndarray        # [B, T] int level indices
    level_slots: np.ndarray   # [B, K] slots spent at each level

    @property
    def B(self) -> int:
        return self.total.shape[0]

    @property
    def per_slot(self) -> np.ndarray:
        return self.total / self.r_hist.shape[1]

    def instance(self, i: int) -> SimResult:
        return SimResult(total=float(self.total[i]), fetch=float(self.fetch[i]),
                         rent=float(self.rent[i]),
                         service=float(self.service[i]),
                         r_hist=self.r_hist[i], level_slots=self.level_slots[i])


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


def xla_acc_fma(step_fn, R: int, K: int,
                include_final_fetch: bool = True,
                fleet: bool = False) -> bool:
    """Whether the reference's vmapped scan over R rows of K levels fuses
    a sum's product into its add, ``sum = fma(a, b, sum)``, instead of a
    rounded product and a rounded add.  XLA:CPU contracts them on small
    batches only, by a threshold that depends on the scan body; pinned by
    test on jax 0.9.0 (``tests/test_torch_obs_fleet.py``,
    ``tests/test_torch_combinators.py``):

    * schedule pricing (``step_fn`` None): the rent ``c * lv_r`` and the
      fetch ``M * (lv_r - lv_prev)^+``, while R * (K + 3) <= 40
      (``evaluate_schedule_batch``), or while R * (K + 4) <= 40 in the
      fleet drivers' pricing core (``fleet``: ``evaluate_schedule_fleet``
      and ``offline_opt_fleet``'s schedule, scenario-fused or obs-backed);
    * the static policy: the rent, while R * (K + 3) <= 40;
    * MDP and ABC: the rent (and the fetch, ``xla_fetch_fma``), while R *
      (K + 3) <= 30;
    * alpha-RR / RR: the rent on one row of at most 8 levels (never the
      fetch);
    * a policy run without the final fetch (``include_final_fetch=False``,
      the last slot's fetch masked): nothing.

    One instance run outside a vmap (``run_policy``,
    ``evaluate_schedule``) never contracts."""
    if step_fn is None:
        return R * (K + (4 if fleet else 3)) <= 40
    if not include_final_fetch:
        return False
    if step_fn is static_step:
        return R * (K + 3) <= 40
    if step_fn is mdp_step or step_fn is abc_step:
        return R * (K + 3) <= 30
    if step_fn is alpha_rr_step:
        return R == 1 and K <= 8
    return False


def xla_fetch_fma(step_fn, R: int, K: int,
                  include_final_fetch: bool = True) -> bool:
    """Whether the reference's vmapped scan over R rows of K levels also
    fuses the fetch's product into its sum, ``fma(M, (lv_r' - lv_r)^+,
    fetch)``, in a policy's accounting (``xla_acc_fma`` for the rent and
    for schedule pricing): MDP and ABC while R * (K + 3) <= 30, with the
    final fetch; pinned by test on jax 0.9.0
    (``tests/test_torch_obs_fleet.py``)."""
    return (include_final_fetch and (step_fn is mdp_step
                                     or step_fn is abc_step)
            and R * (K + 3) <= 30)


def sim_chunk_core(step_fn, include_final_fetch: bool, params, lv, M, T_len,
                   t0: int, carry, x, c, svc, side=None,
                   rent_fma: bool = False, fetch_fma: bool = False):
    """Step slots ``[t0, t0 + chunk)`` of R rows: ``lv`` [R, K], ``M`` [R],
    ``T_len`` [R] int32, ``x`` / ``c`` / ``side`` [R, chunk], ``svc``
    [R, chunk, K] (``x`` may be None for a policy that reads only the
    service costs).  Returns ``(carry', r_hist [R, chunk] int32)``; the
    sums accumulate slot by slot, in the reference's order (the rent as
    one FMA with ``rent_fma``, ``xla_acc_fma``; the fetch with
    ``fetch_fma``, ``xla_fetch_fma``)."""
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
        new = sums + torch.where(valid[:, None], vec, 0.0)
        if rent_fma:
            new[:, 0] = torch.where(valid, fma32(c[:, j], lv_t, sums[:, 0]),
                                    sums[:, 0])
        if fetch_fma:
            keep = valid if include_final_fetch else valid & (T_len - 1 != t)
            new[:, 2] = torch.where(keep, fma32(M, torch.clamp_min(
                lv_next - lv_t, 0.0), sums[:, 2]), sums[:, 2])
        sums = new
        counts = counts + torch.where(valid[:, None], onehot_t.to(torch.int32),
                                      0)
        r_hist[:, j] = r_t
        state = new_state
    return (state, {"sums": sums, "counts": counts}), r_hist


def sim_chunk(policy: PolicyFns, include_final_fetch: bool, lv, g, M, T_len,
              t0: int, carry, slab, collect_trace: bool = True,
              svc_cols=None, rent_fma: bool = False,
              fetch_fma: bool = False):
    """One chunk of one fleet simulation on a generated ``ObsSlab``.
    alpha-RR runs as kernel S (the kernel on the card, its plain version on
    the CPU): under Model-1 service ``kernels.hosting.sim_chunk_alpha_rr``,
    on a Model-2 slab ``sim_chunk_alpha_rr_svc``, which gathers a lane's
    columns through ``svc_cols`` [R, K] itself.  The static, MDP and ABC
    policies run as S's table variant (``sim_chunk_table`` /
    ``sim_chunk_table_svc`` on their ``table_form``).  Any other policy
    runs the plain loop.  ``rent_fma``: the rent accumulated as one FMA
    (``xla_acc_fma``); ``fetch_fma``: the fetch too (``xla_fetch_fma``:
    MDP and ABC on small batches)."""
    step = policy.step_fn
    if slab.side is None and step is not alpha_rr_step:
        # the reference's engines read a zero side channel when none is given
        slab = slab._replace(side=torch.zeros_like(slab.c, dtype=torch.int32))
    if step is alpha_rr_step:
        if slab.svc is None:
            return sim_chunk_alpha_rr(policy.params, lv, g, M, T_len, t0,
                                      carry, slab.x, slab.c,
                                      include_final_fetch, collect_trace,
                                      rent_fma)
        return sim_chunk_alpha_rr_svc(policy.params, lv, M, T_len, t0, carry,
                                      slab.c, slab.svc, svc_cols,
                                      include_final_fetch, collect_trace,
                                      rent_fma)
    if step in TABLE_STEPS:
        table = table_form(step, policy.params, lv.shape[1])
        if slab.svc is None:
            return sim_chunk_table(*table, lv, g, M, T_len, t0, carry,
                                   slab.x, slab.c, slab.side,
                                   include_final_fetch, collect_trace,
                                   rent_fma, fetch_fma)
        return sim_chunk_table_svc(*table, lv, M, T_len, t0, carry, slab.x,
                                   slab.c, slab.side, slab.svc, svc_cols,
                                   include_final_fetch, collect_trace,
                                   rent_fma, fetch_fma)
    svc = (model1_svc(slab.x, g) if slab.svc is None
           else gather_svc(slab.svc, svc_cols))
    carry, r = sim_chunk_core(policy.step_fn, include_final_fetch,
                              policy.params, lv, M, T_len, t0, carry, slab.x,
                              slab.c, svc, slab.side, rent_fma, fetch_fma)
    return carry, (r if collect_trace else None)


def sim_chunk_lanes(step_fns, include_final_fetch: bool, lane_params,
                    lane_lv, lane_M, T_len, t0: int, carries, x, c,
                    lane_svc, side):
    """Step P heterogeneous policy lanes over ONE shared ``[R, chunk]``
    slab: ``carries`` a tuple of per-lane ``(state, acc)``, ``lane_lv[p]``
    [R, K_p], ``lane_M[p]`` [R], ``lane_svc[p]`` [R, chunk, K_p] the lane's
    own service costs (Model-1 prices ``x * g`` from its g, or its columns
    of a Model-2 slab); ``x``, ``c``, ``side`` the one stream.  Each lane is
    one ``sim_chunk`` on its service costs (kernel S on the card), its sums
    fused as the reference's vmapped scan fuses them (``xla_acc_fma``,
    ``xla_fetch_fma``), so lane p is bitwise its standalone chunk.
    Returns ``(carries', r_hists)``, tuples of per-lane results."""
    new_carries, r_hists = [], []
    for step_fn, params, lv, M, carry, svc in zip(
            step_fns, lane_params, lane_lv, lane_M, carries, lane_svc):
        R, K = lv.shape
        fused = (step_fn, R, K, include_final_fetch)
        carry, r = sim_chunk(PolicyFns("lane", None, step_fn, params),
                             include_final_fetch, lv, None, M, T_len, t0,
                             carry, ObsSlab(x, c, svc, side),
                             rent_fma=xla_acc_fma(*fused),
                             fetch_fma=xla_fetch_fma(*fused))
        new_carries.append(carry)
        r_hists.append(r)
    return tuple(new_carries), tuple(r_hists)


# ----------------------------------------------------------------------
# Per-instance entry points: one chunk, one horizon.
# ----------------------------------------------------------------------

_ROUTE = ("route= (the routing-cost term) is not ported yet: ROADMAP.md, "
          "Queue 1 item 11 (core/services.py)")


def _batch_obs(grid: HostingGrid, x, c, svc, side):
    """Observations broadcast to [B, T] (``svc`` [B, T, K]) tensors on the
    grid's device; ``svc`` stays None under Model 1 (the kernels price ``x
    * g`` themselves), ``side`` is zeros when not given."""
    dev, B = grid.device, grid.B
    x = as_tensor(x, dev, torch.int32)
    if x.dim() == 1:
        x = x[None, :].expand(B, -1)
    T = x.shape[1]
    c = as_tensor(c, dev, torch.float32)
    if c.dim() == 1:
        c = c[None, :].expand(B, T)
    if svc is not None:
        svc = as_tensor(svc, dev, torch.float32)
        if svc.dim() == 2:
            svc = svc[None].expand((B,) + tuple(svc.shape))
        svc = svc.contiguous()
    side = (torch.zeros((B, T), dtype=torch.int32, device=dev) if side is None
            else as_tensor(side, dev, torch.int32))
    if side.dim() == 1:
        side = side[None, :].expand(B, T)
    return x.contiguous(), c.contiguous(), svc, side.contiguous()


def _batch_result(acc, r_hist) -> BatchSimResult:
    # float64 host sums, as the reference's
    sums = acc["sums"].cpu().numpy().astype(np.float64)
    return BatchSimResult(total=sums.sum(axis=1), rent=sums[:, 0],
                          service=sums[:, 1], fetch=sums[:, 2],
                          r_hist=r_hist.cpu().numpy(),
                          level_slots=acc["counts"].cpu().numpy()
                          .astype(np.int64))


def _one(res: BatchSimResult) -> SimResult:
    rent_s, svc_s, fetch_s = (float(v) for v in (res.rent[0], res.service[0],
                                                 res.fetch[0]))
    return SimResult(total=rent_s + svc_s + fetch_s + 0.0, fetch=fetch_s,
                     rent=rent_s, service=svc_s, r_hist=res.r_hist[0],
                     level_slots=res.level_slots[0])


def _row(a):
    """One instance's array as a one-row batch (numpy or a tensor)."""
    if a is None:
        return None
    return a[None] if isinstance(a, torch.Tensor) else np.asarray(a)[None]


def _run_rows(policy: PolicyFns, grid: HostingGrid, x, c, svc, side,
              include_final_fetch: bool, vmapped: bool) -> BatchSimResult:
    x, c, svc, side = _batch_obs(grid, x, c, svc, side)
    B, T = x.shape
    T_len = torch.full((B,), T, dtype=torch.int32, device=grid.device)
    carry = (policy.init_fn(policy.params), sim_acc0(B, grid.K, grid.device))
    fused = (policy.step_fn, B, grid.K, include_final_fetch)
    (_, acc), r = sim_chunk(policy, include_final_fetch, grid.levels, grid.g,
                            grid.M, T_len, 0, carry, ObsSlab(x, c, svc, side),
                            rent_fma=vmapped and xla_acc_fma(*fused),
                            fetch_fma=vmapped and xla_fetch_fma(*fused))
    return _batch_result(acc, r)


def run_policy_batch(policy: PolicyFns, grid: HostingGrid, x, c, svc=None,
                     side=None, include_final_fetch: bool = True
                     ) -> BatchSimResult:
    """Simulate B independent instances over one horizon: ``policy`` a
    ``PolicyFns`` whose params carry a leading [B] axis (``AlphaRR.batch(
    grid)``, ...), ``grid`` the accounting grid (its device runs the
    kernels), ``x`` / ``c`` / ``side`` [T] or [B, T], ``svc`` an optional
    [B, T, K] (or [T, K]) Model-2 service matrix.  One chunk of kernel S
    (or its table variant); bitwise the reference's ``run_policy_batch``."""
    return _run_rows(policy, grid, x, c, svc, side, include_final_fetch, True)


def run_policy(policy, costs: HostingCosts, x, c, svc=None, side=None,
               include_final_fetch: bool = True, route=None,
               device=None) -> SimResult:
    """Simulate an online policy (an ``OnlinePolicy``) over one instance's
    whole horizon: ``x`` / ``c`` / ``side`` [T], ``svc`` an optional [T, K];
    a one-row ``run_policy_batch``.  ``device`` None is the card."""
    if route is not None:
        raise NotImplementedError(_ROUTE)
    dev = resolve_device(device)
    grid = HostingGrid.from_costs([costs], device=dev)
    return _one(_run_rows(policy.fns(dev), grid, _row(x), _row(c), _row(svc),
                          _row(side), include_final_fetch, False))


def _price_rows(grid: HostingGrid, r_hist, x, c, svc,
                vmapped: bool) -> BatchSimResult:
    x, c, svc, _ = _batch_obs(grid, x, c, svc, None)
    dev, (B, T) = grid.device, x.shape
    r = as_tensor(r_hist, dev, torch.int32).contiguous()
    T_len = torch.full((B,), T, dtype=torch.int32, device=dev)
    carry = (torch.zeros((B,), dtype=torch.int32, device=dev),
             sim_acc0(B, grid.K, dev))
    _, acc = schedule_chunk(grid.levels, grid.M, T_len, 0, carry, r, c,
                            x=None if svc is not None else x,
                            g=None if svc is not None else grid.g, svc=svc,
                            acc_fma=vmapped and xla_acc_fma(None, B, grid.K))
    return _batch_result(acc, r)


def evaluate_schedule_batch(grid: HostingGrid, r_hist, x, c,
                            svc=None) -> BatchSimResult:
    """The cost of [B, T] schedules ``r_hist`` (entered from level 0,
    fetches charged on entry) on [T] or [B, T] observations, ``svc`` an
    optional Model-2 service matrix: one chunk of kernel E on the grid's
    device, bitwise the reference's ``evaluate_schedule_batch``."""
    return _price_rows(grid, r_hist, x, c, svc, True)


def evaluate_schedule(costs: HostingCosts, r_hist, x, c, svc=None,
                      route=None, device=None) -> SimResult:
    """The cost of one schedule ``r_hist`` [T] (entered from level 0,
    fetches charged on entry) on ``x`` / ``c`` [T] and an optional [T, K]
    ``svc``: a one-row ``evaluate_schedule_batch``."""
    if route is not None:
        raise NotImplementedError(_ROUTE)
    grid = HostingGrid.from_costs([costs], device=resolve_device(device))
    return _one(_price_rows(grid, _row(r_hist), _row(x), _row(c), _row(svc),
                            False))


def model2_service_matrix(key, costs: HostingCosts, x,
                          max_per_slot: int | None = None, device=None):
    """Realized Model-2 service costs, coupled across levels: the [T, R]
    request uniforms ``uniform(key, (T, R))`` of one [2] key (kernel P's
    shaped uniform on the card), request ``i`` of slot ``t`` live while
    ``i < x[t]`` and forwarded at level k iff ``u < g[k]``; returns the [T,
    K] float32 counts on ``device`` (the card by default).  ``R`` is
    ``max_per_slot``, or the largest arrival count (at least 1)."""
    dev = resolve_device(device)
    x = as_tensor(x, dev, torch.int32)
    T = int(x.shape[0])
    R = int(max_per_slot if max_per_slot is not None
            else max(int(x.max()), 1))
    key = torch.as_tensor(key, dtype=torch.int64, device=dev)
    u = shaped_uniform(key, T * R).reshape(T, R)
    gv = torch.as_tensor(np.asarray(costs.g, np.float32), device=dev)
    live = torch.arange(R, device=dev)[None, :] < x[:, None]      # [T, R]
    fwd = u[:, :, None] < gv[None, None, :]                       # [T, R, K]
    return (live[:, :, None] & fwd).sum(dim=1).to(torch.float32)

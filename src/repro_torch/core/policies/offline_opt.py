"""Offline optimal hosting (alpha-OPT / OPT) by exact dynamic programming:
the port of ``repro/core/policies/offline_opt.py``.

State = level index, K states; transition cost = fetch on increments only.
``J_t(k) = min_k' [J_{t-1}(k') + M (lv_k - lv_k')^+] + w_t[k]`` with
``J_0 = [0, inf, ...]`` (service starts off-edge).

``dp_fwd_chunk`` is the chunk of the forward recursion for given service
costs: the per-slot costs ``w`` are assembled here in torch, the
relaxation runs as kernel D on a finished ``w`` (``kernels.ops.dp_minplus``:
the kernel on the card, its plain version on the CPU).  Under Model-1
service ``x * g`` the scenario-fused fleet runs the same chunk as
``kernels.hosting.dp_fwd_model1``, which assembles ``w`` itself.
``dp_backtrack_chunk`` walks an argmin table back (kernel B).

The per-instance and batched OPT (``offline_opt``, ``offline_opt_batch``,
``offline_opt_no_partial``) build a finished ``w`` with two roundings
(rent, then the add), as the reference's eager ops do -- unlike the fleet
DP, whose ``c * lv + svc`` is one FMA -- run it through D on a finished
``w`` (K <= 32), backtrack with B and price the schedule with kernel E.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.costs import (HostingCosts, HostingGrid,
                                    per_slot_cost_matrix)
from repro_torch.core.simulator import (BatchSimResult, SimResult, _batch_obs,
                                        evaluate_schedule,
                                        evaluate_schedule_batch)
from repro_torch.kernels import hosting, ops
from repro_torch.kernels.hosting import fma32


@dataclasses.dataclass
class OfflineResult:
    cost: float
    r_hist: np.ndarray        # [T] int64
    sim: SimResult


@dataclasses.dataclass
class BatchOfflineResult:
    cost: np.ndarray          # [B]
    r_hist: np.ndarray        # [B, T]
    sim: BatchSimResult


def _eval(costs, r_hist, x, c, svc=None, device=None) -> SimResult:
    return evaluate_schedule(costs, r_hist, x, c, svc, device=device)


def dp_frontier0(R: int, K: int, device) -> torch.Tensor:
    """[R, K] initial value frontier ``J_0 = [0, inf, ...]``."""
    J = torch.full((R, K), float("inf"), dtype=torch.float32, device=device)
    J[:, 0] = 0.0
    return J


def dp_fetch_matrix(M32, lv32) -> torch.Tensor:
    """[R, K, K] ``fetch[r, k_prev, k_next] = M * (lv_next - lv_prev)^+``
    for scalar per-row ``M`` [R]; explicit fetch matrices (joint
    multi-service grids) come with the service-axis slice."""
    if M32.dim() != 1:
        raise NotImplementedError(
            "matrix-valued M (joint multi-service grids) comes with the "
            "service-axis slice (ROADMAP.md, Queue 1 item 11)")
    diff = lv32[:, None, :] - lv32[:, :, None]
    return M32[:, None, None] * torch.clamp_min(diff, 0.0)


def dp_fwd_chunk(J, tids, cck, sck, lv32, kmask, fetch_mat, T_len):
    """One chunk of the forward value recursion for R rows: ``J`` [R, K],
    ``tids`` [chunk] int32, ``cck`` [R, chunk] rents, ``sck`` [R, chunk, K]
    service costs, ``lv32``/``kmask`` [R, K], ``fetch_mat`` [R, K, K],
    ``T_len`` [R].  Slots at or past a row's ``T_len`` freeze its frontier
    and write identity argmins; padded levels are priced ``+inf``.
    Returns ``(J', args [R, chunk, K])``."""
    # the reference's fused drivers run c * lv + svc as one FMA on XLA:CPU
    wck = fma32(cck[:, :, None], lv32[:, None, :], sck)
    wck = torch.where(kmask[:, None, :], wck, float("inf"))
    valid = tids[None, :] < T_len[:, None]
    return ops.dp_minplus(J, wck, fetch_mat, valid)


def dp_backtrack_chunk(k, args):
    """Backtrack [R, chunk, K] argmin tables from the levels ``k`` [R] int32
    at the chunk's end (kernel B): returns ``(k at chunk entry, r_hist [R,
    chunk] int32)``.  Chained right to left over chunks it gives the
    whole-table walk's bits."""
    return hosting.dp_backtrack(k, args)


def dp_terminal(J_T):
    """``(cost [R], k_T [R] int32)``: the terminal min and its first
    minimising level (an all-``+inf`` frontier gives 0)."""
    return torch.amin(J_T, dim=1), torch.argmin(J_T, dim=1).to(torch.int32)


def dp_backtrack(J_T, args):
    """Terminal min + whole-table backtrack: ``(cost [R], r_hist)``."""
    cost, k_T = dp_terminal(J_T)
    _, r_hist = dp_backtrack_chunk(k_T, args.contiguous())
    return cost, r_hist


def _dp_whole(M32, lv32, w):
    """The one-horizon DP of ``w`` [R, T, K] (``+inf`` on padded levels):
    kernel D on the finished ``w``, then B -> ``(cost [R], r_hist [R, T]
    int32)``."""
    R, T, K = w.shape
    valid = torch.ones((R, T), dtype=torch.bool, device=w.device)
    J_T, args = ops.dp_minplus(dp_frontier0(R, K, w.device), w.contiguous(),
                               dp_fetch_matrix(M32, lv32).contiguous(),
                               valid)
    return dp_backtrack(J_T, args)


def offline_opt_batch(grid: HostingGrid, x, c, svc=None) -> BatchOfflineResult:
    """Batched alpha-OPT on materialised observations (``x``/``c`` [T] or
    [B, T], ``svc`` an optional [B, T, K] Model-2 matrix; numpy or tensors),
    on the grid's device: the whole-horizon DP, the backtracked schedule
    and its cost (``evaluate_schedule_batch``).  Padded levels are priced
    ``+inf``.  Bitwise the reference's ``offline_opt_batch``."""
    x, c, svc_t, _ = _batch_obs(grid, x, c, svc, None)
    lv32 = grid.levels.to(torch.float32)
    s = (x[:, :, None].to(torch.float32) * grid.g[:, None, :]
         if svc_t is None else svc_t)
    # unlike the fused drivers (dp_fwd_chunk), the reference assembles this
    # w in eager ops with two roundings: rent, then + svc
    w = c[:, :, None] * lv32[:, None, :] + s
    w = torch.where(grid.mask[:, None, :], w, float("inf"))
    cost, r_hist = _dp_whole(grid.M.to(torch.float32), lv32, w)
    sim = evaluate_schedule_batch(grid, r_hist, x, c, svc_t)
    return BatchOfflineResult(cost=cost.cpu().numpy().astype(np.float64),
                              r_hist=r_hist.cpu().numpy().astype(np.int64),
                              sim=sim)


def offline_opt(costs: HostingCosts, x, c, svc=None,
                device=None) -> OfflineResult:
    """Exact alpha-OPT of one instance (``x``/``c`` [T], ``svc`` an optional
    [T, K]) and its argmin schedule, on ``device`` (None: the card).
    Bitwise the reference's ``offline_opt``."""
    dev = resolve_device(device)
    w = per_slot_cost_matrix(costs, x, c, svc, device=dev)
    lv = torch.tensor(costs.levels, dtype=torch.float32, device=dev)[None]
    M = torch.tensor([costs.M], dtype=torch.float32, device=dev)
    cost, r_hist = _dp_whole(M, lv, w[None])
    r = r_hist[0].cpu().numpy().astype(np.int64)
    return OfflineResult(cost=float(cost[0]), r_hist=r,
                         sim=_eval(costs, r, x, c, svc, dev))


def offline_opt_no_partial(costs: HostingCosts, x, c, svc=None,
                           device=None) -> OfflineResult:
    """OPT of [22]: the offline optimum restricted to levels {0, 1}."""
    c2 = HostingCosts.two_level(costs.M, costs.c_min, costs.c_max)
    svc2 = None
    if svc is not None:
        svc2 = svc[:, [0, costs.K - 1]]
    return offline_opt(c2, x, c, svc2, device=device)


def brute_force_opt(costs: HostingCosts, x, c, svc=None,
                    device=None) -> OfflineResult:
    """Exhaustive search over all K^T schedules (tests only; tiny T): every
    schedule priced in one ``evaluate_schedule_batch``, then the
    reference's scan for the first total below the best by more than
    1e-9."""
    x = np.asarray(x)
    T, K = len(x), costs.K
    codes = np.arange(K ** T)
    seqs = np.stack([(codes // K ** (T - 1 - t)) % K for t in range(T)],
                    axis=1).astype(np.int64)
    grid = HostingGrid.from_costs([costs] * len(seqs), device=device)
    rep = lambda a: None if a is None else np.broadcast_to(
        np.asarray(a)[None], (len(seqs),) + np.shape(a))
    res = evaluate_schedule_batch(grid, seqs, rep(x), rep(c), rep(svc))
    best, best_i = np.inf, None
    for i in range(len(seqs)):
        # the one-instance total, summed as evaluate_schedule sums it
        tot = (float(res.rent[i]) + float(res.service[i])
               + float(res.fetch[i]) + 0.0)
        if tot < best - 1e-9:
            best, best_i = tot, i
    seq = seqs[best_i]
    return OfflineResult(cost=best, r_hist=seq,
                         sim=_eval(costs, seq, x, c, svc, device))

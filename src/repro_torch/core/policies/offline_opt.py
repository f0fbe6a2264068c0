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
``dp_backtrack_chunk`` walks an argmin table back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.costs import HostingGrid
from repro_torch.core.simulator import (BatchSimResult,
                                        evaluate_schedule_batch, model1_svc)
from repro_torch.kernels import ops
from repro_torch.kernels.hosting import fma32


@dataclasses.dataclass
class BatchOfflineResult:
    cost: np.ndarray          # [B]
    r_hist: np.ndarray        # [B, T]
    sim: BatchSimResult


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
    """Backtrack [R, chunk, K] argmin tables from terminal levels ``k``
    [R]: returns ``(k at chunk entry, r_hist [R, chunk])``."""
    chunk = args.shape[1]
    r = torch.empty(args.shape[:2], dtype=torch.int32, device=args.device)
    for t in range(chunk - 1, -1, -1):
        r[:, t] = k
        k = torch.gather(args[:, t], 1, k[:, None].to(torch.int64))[:, 0]
    return k, r


def dp_backtrack(J_T, args):
    """Terminal min + whole-table backtrack: ``(cost [R], r_hist)``."""
    k_T = torch.argmin(J_T, dim=1).to(torch.int32)
    _, r_hist = dp_backtrack_chunk(k_T, args)
    return torch.amin(J_T, dim=1), r_hist


def offline_opt_batch(grid: HostingGrid, x, c) -> BatchOfflineResult:
    """Batched alpha-OPT on materialized Model-1 observations: ``x``/``c``
    [B, T] tensors on the grid's device.  One whole-horizon relaxation,
    then the backtracked schedule is evaluated."""
    B, K = grid.B, grid.K
    T = x.shape[1]
    lv32 = grid.levels.to(torch.float32)
    g = grid.g.to(torch.float32)
    # unlike the fused drivers (dp_fwd_chunk), the reference assembles this
    # w in its own XLA fusion with two roundings: rent, then + svc
    w = c[:, :, None] * lv32[:, None, :] + model1_svc(x, g)
    w = torch.where(grid.mask[:, None, :], w, float("inf"))
    valid = torch.ones((B, T), dtype=torch.bool, device=grid.device)
    J_T, args = ops.dp_minplus(dp_frontier0(B, K, grid.device), w,
                               dp_fetch_matrix(grid.M.to(torch.float32), lv32),
                               valid)
    cost, r_hist = dp_backtrack(J_T, args)
    sim = evaluate_schedule_batch(lv32, g, grid.M.to(torch.float32), r_hist,
                                  x, c)
    return BatchOfflineResult(cost=cost.cpu().numpy().astype(np.float64),
                              r_hist=r_hist.cpu().numpy().astype(np.int64),
                              sim=sim)

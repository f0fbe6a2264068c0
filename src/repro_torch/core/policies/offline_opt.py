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

``offline_opt_joint`` is the same DP over a ``ServiceSet``'s feasible
joint states with its explicit fetch matrix (``brute_force_joint_opt``
its exhaustive oracle, for the tests).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.costs import (HostingCosts, HostingGrid, ServiceSet,
                                    per_slot_cost_matrix)
# the module, not its names: the simulator imports the policies package,
# whose __init__ imports this module
from repro_torch.core import simulator as _sim
from repro_torch.kernels import hosting, ops
from repro_torch.kernels.hosting import fma32


@dataclasses.dataclass
class OfflineResult:
    cost: float
    r_hist: np.ndarray        # [T] int64
    sim: _sim.SimResult


@dataclasses.dataclass
class BatchOfflineResult:
    cost: np.ndarray          # [B]
    r_hist: np.ndarray        # [B, T]
    sim: _sim.BatchSimResult


def _eval(costs, r_hist, x, c, svc=None, device=None) -> _sim.SimResult:
    return _sim.evaluate_schedule(costs, r_hist, x, c, svc, device=device)


def dp_frontier0(R: int, K: int, device) -> torch.Tensor:
    """[R, K] initial value frontier ``J_0 = [0, inf, ...]``."""
    J = torch.full((R, K), float("inf"), dtype=torch.float32, device=device)
    J[:, 0] = 0.0
    return J


def dp_fetch_matrix(M32, lv32) -> torch.Tensor:
    """[R, K, K] ``fetch[r, k_prev, k_next] = M * (lv_next - lv_prev)^+``
    for scalar per-row ``M`` [R]; an explicit [R, K, K] fetch matrix (the
    joint multi-service grids of ``ServiceSet``) passes through untouched
    (at N = 1 it is bitwise this rank-one product)."""
    if M32.dim() > 1:
        return M32
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
    x, c, svc_t, _ = _sim._batch_obs(grid, x, c, svc, None)
    lv32 = grid.levels.to(torch.float32)
    s = (x[:, :, None].to(torch.float32) * grid.g[:, None, :]
         if svc_t is None else svc_t)
    # unlike the fused drivers (dp_fwd_chunk), the reference assembles this
    # w in eager ops with two roundings: rent, then + svc
    w = c[:, :, None] * lv32[:, None, :] + s
    w = torch.where(grid.mask[:, None, :], w, float("inf"))
    cost, r_hist = _dp_whole(grid.M.to(torch.float32), lv32, w)
    sim = _sim.evaluate_schedule_batch(grid, r_hist, x, c, svc_t)
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
    res = _sim.evaluate_schedule_batch(grid, seqs, rep(x), rep(c), rep(svc))
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


# ----------------------------------------------------------------------
# The joint multi-service OPT: the same DP over a ServiceSet's feasible
# joint states, fetches priced by its explicit joint matrix.
# ----------------------------------------------------------------------

@dataclasses.dataclass
class JointOfflineResult:
    """The joint capacity-respecting optimum of one ``ServiceSet``:
    ``states`` [T] indices into ``sset.joint_states()``, ``r_hist`` [N, T]
    each service's level indices (every slot feasible by construction)."""

    cost: float
    states: np.ndarray
    r_hist: np.ndarray


def _joint_slot_costs(sset: ServiceSet, xs, c, svcs):
    """``([T, J] float32 holding costs, [N, T] arrivals)`` of the joint DP,
    in numpy: the rent product first, then one service add a service in
    ascending n (Model 1 ``float32(x_n) * g_n``, or the given [T, K_n]
    ``svcs[n]``), so at N = 1 it is bitwise ``per_slot_cost_matrix``."""
    idx = sset.joint_states()
    xs = np.asarray(xs)
    if xs.ndim == 1:
        xs = np.broadcast_to(xs[None], (sset.N,) + xs.shape)
    if xs.shape[0] != sset.N:
        raise ValueError(f"xs has {xs.shape[0]} arrival rows for "
                         f"{sset.N} services")
    c32 = np.asarray(c, np.float32)
    w = c32[:, None] * sset.joint_levels()[None, :]
    for n, cc in enumerate(sset.services):
        if svcs is not None and svcs[n] is not None:
            svc_n = np.asarray(svcs[n], np.float32)
        else:
            svc_n = (xs[n][:, None].astype(np.float32)
                     * np.asarray(cc.g, np.float32)[None, :])
        w = w + svc_n[:, idx[:, n]]
    return w, xs


def _joint_result(sset: ServiceSet, cost: float, states) -> JointOfflineResult:
    states = np.asarray(states).astype(np.int64)
    return JointOfflineResult(cost=cost, states=states,
                              r_hist=sset.joint_states()[states].T
                              .astype(np.int64))


def offline_opt_joint(sset: ServiceSet, xs, c, svcs=None,
                      device=None) -> JointOfflineResult:
    """The exact joint OPT of N services sharing one edge: the one-horizon
    DP (kernel D on a finished ``w``, J <= 32, then B) over the feasible
    joint states, the capacity enforced by the state enumeration and the
    fetches priced by the explicit joint matrix.  ``xs`` [T] (common
    arrivals) or [N, T]; ``c`` [T] the edge's rents; ``svcs`` an optional
    list of per-service [T, K_n] Model-2 costs (None entries: Model 1).
    At N = 1 it is bitwise ``offline_opt``; bitwise the reference's
    ``offline_opt_joint``.  ``device`` None is the card."""
    dev = resolve_device(device)
    w, _ = _joint_slot_costs(sset, xs, c, svcs)
    fm = torch.from_numpy(sset.joint_fetch_matrix()).to(dev)[None]
    lv = torch.from_numpy(sset.joint_levels()).to(dev)[None]
    cost, states = _dp_whole(fm, lv, torch.from_numpy(w).to(dev)[None])
    return _joint_result(sset, float(cost[0]), states[0].cpu().numpy())


def brute_force_joint_opt(sset: ServiceSet, xs, c,
                          svcs=None) -> JointOfflineResult:
    """The exhaustive joint oracle (tests only; tiny J**T), in numpy: every
    joint-state sequence from all-off, each slot ``(cost + fetch) + w`` in
    float32 -- the DP's own association, so its minimum equals
    ``offline_opt_joint``'s cost exactly."""
    w, _ = _joint_slot_costs(sset, xs, c, svcs)
    fm = sset.joint_fetch_matrix()
    T, J = w.shape[0], fm.shape[0]
    best, best_seq = np.inf, None
    for code in range(J ** T):
        cost = np.float32(0.0)
        prev = 0
        seq = np.empty((T,), np.int64)
        for t in range(T):
            k = (code // (J ** t)) % J
            cost = (cost + fm[prev, k]) + w[t, k]
            prev = k
            seq[t] = k
        if cost < best:
            best, best_seq = cost, seq
    return _joint_result(sset, float(best), best_seq)

"""Fleet drivers (the port of the scenario-fused, single-device part of
``repro/core/fleet.py``).

A fleet is B hosting instances stacked on one ``HostingGrid`` with
per-instance horizons.  ``run_fleet`` steps an online policy and
``offline_opt_fleet`` prices the exact offline optimum for every instance
at once, with the observations generated on the device by a ``Scenario``
chunk by chunk: a Python loop over chunks (the reference's outer
``lax.scan``) feeds each ``[R, chunk]`` slab to kernel S (alpha-RR / RR) or
the DP's kernel D.  Device memory is O(R * chunk); no observation array
crosses from the host.

The Monte-Carlo axis (``n_seeds=S``) replicates each instance S times
(rows ``b * S + s``, instance-major) with the seed folded into every stream
key (``scenarios.replicate_seeds``); ``mc_summary`` collapses it.

**Policy fan-out.**  ``run_fleet`` also takes a sequence of policies
(``PolicyFns``, or ``PolicyLane`` binding a policy to its own accounting
grid): each ``[R, chunk]`` slab is generated ONCE per chunk and every lane
steps it with its own kernel-S launch on its own grid's rows, replicated
over seeds like the fleet's.  Under a Model-2 scenario (``combine(svc=)``)
a lane on its own grid carries ``svc_cols``, its levels' columns in the
service slab (``RetroRenting.fleet_lane(fleet, with_svc=True)``), and
kernels S and D gather them themselves.  ``with_opt_forward=True`` carries one
offline-DP frontier per lane through the same chunk loop (kernel D on the
lane's levels and mask) and returns ``FleetResult.opt_cost``.  Rows are
policy-major, ``(p * B + b) * S + s`` (``FleetResult.policy_view``); lane p
is bitwise its standalone run, ``opt_cost`` bitwise ``offline_opt_fleet``
on the lane's fleet.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md item: obs-backed fleets, ``stream=``, ``async_ingest``,
``gather``, a mesh, the materialized DP and ``collect_schedule=True``.
The port runs on one device, so no rows are padded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.costs import HostingGrid
from repro_torch.core.policies.base import (PolicyFns, PolicyLane,
                                            as_policy_lanes)
from repro_torch.core.policies.offline_opt import (dp_fetch_matrix,
                                                   dp_frontier0)
from repro_torch.core.scenarios.base import (Scenario, chunk_geometry,
                                             chunk_tids, tree_map)
from repro_torch.core.scenarios.combinators import replicate_seeds
from repro_torch.core.simulator import sim_acc0, sim_chunk
from repro_torch.kernels.hosting import dp_fwd_model1, dp_fwd_model2


@dataclasses.dataclass(frozen=True)
class FleetBatch:
    """B hosting instances with per-instance horizons, observations to be
    generated by a scenario.

    Attributes:
      grid: stacked ``HostingGrid``.
      T:    [B] int32 numpy array of horizons (T_i <= T_max); slots with
            ``t >= T_i`` freeze the instance and add exactly zero cost.
    """

    grid: HostingGrid
    T: np.ndarray

    @staticmethod
    def for_scenario(grid: HostingGrid, T) -> "FleetBatch":
        """A fleet whose observations come from ``scenario=...``; ``T`` is a
        scalar or [B] per-instance horizon vector."""
        return FleetBatch(grid=grid, T=np.broadcast_to(
            np.asarray(T, np.int32), (grid.B,)).copy())

    @property
    def B(self) -> int:
        return self.grid.B

    @property
    def K(self) -> int:
        return self.grid.K

    @property
    def T_max(self) -> int:
        return int(np.max(self.T))

    def restrict_to_endpoints(self) -> "FleetBatch":
        """The no-partial-hosting view (RR / OPT): the 2-level grid."""
        return FleetBatch(grid=self.grid.restrict_to_endpoints(), T=self.T)


@dataclasses.dataclass
class FleetResult:
    """[B]-structured results of one fleet simulation (padded time already
    sliced away).  With ``n_seeds=S`` the rows are the [B_instances * S]
    replication, instance-major; ``seed_view`` reshapes to [B, S, ...].
    With a fan-out of P lanes the rows are also policy-major, ``(p *
    B_fleet + b) * S + s``; ``policy_view`` peels the lane axis off,
    ``level_slots`` is zero-padded to the widest lane's K and ``opt_cost``
    holds each row's offline DP optimum (``with_opt_forward=True``)."""

    total: np.ndarray                 # [B]
    fetch: np.ndarray                 # [B]
    rent: np.ndarray                  # [B]
    service: np.ndarray               # [B]
    r_hist: Optional[np.ndarray]      # [B, T_max]; None without a trace
    level_slots: np.ndarray           # [B, K] slots spent at each level
    T: np.ndarray                     # [B] per-instance horizons
    n_seeds: int = 1
    n_policies: int = 1
    opt_cost: Optional[np.ndarray] = None   # [B] (with_opt_forward only)

    @property
    def B(self) -> int:
        return self.total.shape[0]

    @property
    def B_instances(self) -> int:
        return self.B // self.n_seeds

    def seed_view(self, a) -> np.ndarray:
        """Reshape a [B*S]-leading result array to [B_instances, S, ...]."""
        a = np.asarray(a)
        return a.reshape((self.B_instances, self.n_seeds) + a.shape[1:])

    def policy_view(self, a) -> np.ndarray:
        """Reshape a policy-major [P * B_fleet * S]-leading result array to
        [P, B_fleet * S, ...]: one row block per fan-out lane."""
        a = np.asarray(a)
        return a.reshape((self.n_policies, self.B // self.n_policies)
                         + a.shape[1:])


@dataclasses.dataclass
class FleetOfflineResult:
    cost: np.ndarray                  # [B]
    r_hist: Optional[np.ndarray]      # None with collect_schedule=False
    sim: Optional[FleetResult]        # None with collect_schedule=False
    n_seeds: int = 1

    def seed_view(self, a) -> np.ndarray:
        """Reshape a [B*S]-leading result array to [B_instances, S, ...]."""
        a = np.asarray(a)
        B = self.cost.shape[0] // self.n_seeds
        return a.reshape((B, self.n_seeds) + a.shape[1:])


# ----------------------------------------------------------------------
# Monte-Carlo summary over the seed axis (numpy, as in the reference).
# ----------------------------------------------------------------------

# two-sided 97.5% Student-t quantiles by degrees of freedom (n_seeds - 1)
_T975 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
         7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228}


def student_t975(df: int) -> float:
    """Two-sided 97.5% Student-t quantile (95% CI width) for ``df``."""
    if df in _T975:
        return _T975[df]
    return 2.04 if df <= 30 else 1.96


def mc_stats(v, axis: int = -1):
    """(mean, ci95 half-width) over the seed axis of ``v``; ci95 is zeros
    when that axis has one sample."""
    v = np.asarray(v, np.float64)
    S = v.shape[axis]
    mean = v.mean(axis=axis)
    if S <= 1:
        return mean, np.zeros_like(mean)
    ci = student_t975(S - 1) * v.std(axis=axis, ddof=1) / math.sqrt(S)
    return mean, ci


def mc_summary(result, fields=("total", "rent", "service", "fetch"),
               antithetic: bool = False):
    """Collapse a seed-replicated result's MC axis: ``n_seeds`` plus, per
    field, ``<f>_mean`` and ``<f>_ci95`` arrays of shape [B_instances].
    A ``FleetOfflineResult`` summarises ``cost``.  ``antithetic=True``
    averages replica pairs (2m, 2m+1) before the CI."""
    if isinstance(result, FleetOfflineResult):
        fields = tuple(f if f != "total" else "cost" for f in fields
                       if f in ("total", "cost"))
    if antithetic and result.n_seeds % 2:
        raise ValueError("antithetic summary needs an even n_seeds")
    out = {"n_seeds": result.n_seeds}
    for f in fields:
        v = result.seed_view(getattr(result, f))
        if antithetic:
            v = np.asarray(v, np.float64)
            v = (v[:, 0::2] + v[:, 1::2]) / 2.0
        mean, ci = mc_stats(v, axis=1)
        out[f"{f}_mean"] = mean
        out[f"{f}_ci95"] = ci
    return out


# ----------------------------------------------------------------------
# Shared prologue of the drivers.
# ----------------------------------------------------------------------

# arguments of the reference drivers that this slice does not port, with
# the ROADMAP.md item that brings each
_LATER = {
    "stream": "Queue 1 item 7 (host-streamed drivers)",
    "async_ingest": "Queue 1 item 10 (live stepper and ingestion)",
    "gather": "Queue 1 item 15 (multi-device / multi-process)",
    "mesh": "Queue 1 item 15 (multi-device / multi-process)",
}


def _refuse_later(**given):
    for name, value in given.items():
        if value not in (None, False):
            raise NotImplementedError(
                f"{name}= is not ported yet: ROADMAP.md, {_LATER[name]}")


def _to_device(fleet: FleetBatch, scenario: Optional[Scenario], device):
    if scenario is None:
        raise NotImplementedError(
            "obs-backed fleets are not ported yet (ROADMAP.md, Queue 1 "
            "item 7): pass scenario=")
    if scenario.B != fleet.B:
        raise ValueError(f"scenario B={scenario.B} != fleet B={fleet.B}")
    dev = resolve_device(device)
    fleet = FleetBatch(grid=fleet.grid.to(dev), T=fleet.T)
    scenario = scenario._replace(
        params=tree_map(lambda a: a.to(dev), scenario.params))
    return fleet, scenario, dev


def _replicate_mc(fleet: FleetBatch, scenario: Scenario,
                  n_seeds: Optional[int], antithetic: bool = False):
    """Expand a [B] fleet + scenario to the [B*S] Monte-Carlo replication
    (instance-major, seed-minor); unchanged when ``n_seeds`` is None."""
    if n_seeds is None:
        if antithetic:
            raise ValueError("antithetic=True needs n_seeds=")
        return fleet, scenario, 1
    S = int(n_seeds)
    rfleet = FleetBatch(grid=fleet.grid.repeat_rows(S),
                        T=np.repeat(fleet.T, S))
    return rfleet, replicate_seeds(scenario, S, antithetic=antithetic), S


def _replicate_policy(policy: PolicyFns, S: int, device) -> PolicyFns:
    return policy._replace(params=tree_map(
        lambda a: a.to(device).repeat_interleave(S, dim=0), policy.params))


# ----------------------------------------------------------------------
# Drivers.
# ----------------------------------------------------------------------

def run_fleet(policy, fleet: FleetBatch, *,
              scenario: Optional[Scenario] = None,
              chunk_size: Optional[int] = None,
              include_final_fetch: bool = True,
              collect_trace: bool = True,
              n_seeds: Optional[int] = None,
              antithetic: bool = False,
              device=None,
              stream: bool = False,
              with_opt_forward: bool = False,
              async_ingest: bool = False,
              gather: bool = False,
              mesh=None) -> FleetResult:
    """Simulate a fleet with observations generated by ``scenario``.

    Args:
      policy: a ``PolicyFns`` whose params carry a leading [B] axis matching
        ``fleet.grid`` (``AlphaRR.fleet(fleet)``; RR runs on
        ``fleet.restrict_to_endpoints()``), or a sequence of them and of
        ``PolicyLane`` entries: the fan-out axis (module docstring).
      fleet: ``FleetBatch.for_scenario(grid, T)`` (mixed horizons allowed).
      scenario: the workload generator (B rows).
      chunk_size: slots per chunk (None = the whole horizon in one chunk);
        any chunking gives the same bits.
      collect_trace: False drops the [B, T_max] ``r_hist``.
      n_seeds / antithetic: S Monte-Carlo replicas of every instance (see
        the module docstring); ``antithetic`` pairs them on flip-capable
        streams.
      device: None means the CUDA card (raises without one); ``"cpu"``
        runs the plain PyTorch versions of the kernels.
      with_opt_forward: co-execute the offline DP's frontier per lane and
        return ``opt_cost`` (a single ``PolicyFns`` is then a one-lane
        fan-out).

    Row ``b * S + s`` (``(p * B + b) * S + s`` under a fan-out) of the
    result is bitwise the reference's ``run_fleet`` under the same
    threefry layout.
    """
    _refuse_later(stream=stream, async_ingest=async_ingest, gather=gather,
                  mesh=mesh)
    lanes = as_policy_lanes(policy) or (PolicyLane(policy),)
    fleet, scenario, dev = _to_device(fleet, scenario, device)
    _check_lanes(lanes, fleet, scenario.has_svc)
    fleet, scenario, S = _replicate_mc(fleet, scenario, n_seeds, antithetic)
    T_max = fleet.T_max
    n_chunks, T_pad = chunk_geometry(T_max, chunk_size)
    chunk = T_pad // n_chunks
    T_len = torch.from_numpy(fleet.T).to(dev)
    runs = [_Lane(lane, fleet.grid, S, dev, with_opt_forward)
            for lane in lanes]
    gen = scenario.init_fn(scenario.params)
    for i in range(n_chunks):
        t0 = i * chunk
        tids = chunk_tids(t0, chunk, dev)
        gen, slab = scenario.chunk_fn(scenario.params, gen, tids)
        for run in runs:
            run.step(include_final_fetch, T_len, t0, slab,
                     collect_trace)
    # policy-major rows; hetero-K lanes' histograms zero-padded to the
    # widest lane's K
    parts = [run.result(T_max, collect_trace) for run in runs]
    sums = np.concatenate([p["sums"] for p in parts])
    counts = [p["level_slots"] for p in parts]
    K_max = max(c.shape[1] for c in counts)
    return FleetResult(
        total=sums.sum(axis=1), rent=sums[:, 0], service=sums[:, 1],
        fetch=sums[:, 2],
        r_hist=(np.concatenate([p["r_hist"] for p in parts])
                if collect_trace else None),
        level_slots=np.concatenate(
            [np.pad(c, ((0, 0), (0, K_max - c.shape[1]))) for c in counts]),
        T=np.tile(fleet.T.astype(np.int64), len(parts)), n_seeds=S,
        n_policies=len(parts),
        opt_cost=(np.concatenate([p["opt_cost"] for p in parts])
                  if with_opt_forward else None))


def _check_lanes(lanes, fleet: FleetBatch, has_svc: bool):
    """Each lane must be able to price the shared stream: a ``PolicyFns``,
    a grid of the fleet's B, and under a Model-2 slab a column map if the
    lane has its own grid (none without one)."""
    for i, lane in enumerate(lanes):
        if not isinstance(lane.fns, PolicyFns):
            raise TypeError(f"fan-out lane {i}: .fns must be a PolicyFns, "
                            f"got {type(lane.fns).__name__}")
        if lane.grid is not None and lane.grid.B != fleet.B:
            raise ValueError(f"fan-out lane {i} ({lane.name!r}): lane grid "
                             f"B={lane.grid.B} != fleet B={fleet.B}")
        if lane.svc_cols is not None and not has_svc:
            raise ValueError(
                f"fan-out lane {i} ({lane.name!r}): svc_cols= was given but "
                "the stream generates no Model-2 service channel -- a "
                "Model-1 lane prices g * x from its own grid")
        if has_svc and lane.grid is not None and lane.svc_cols is None:
            raise ValueError(
                f"fan-out lane {i} ({lane.name!r}): a lane on its own grid "
                "must map the shared Model-2 service slab onto its levels "
                "via svc_cols= (HostingGrid.endpoint_columns builds the "
                "endpoint map)")


class _Lane:
    """One fan-out lane's device state: its policy, accounting grid and
    Model-2 column map replicated over the seeds, its ``(state, acc)``
    carry, its trace chunks and, with ``with_opt``, its DP frontier."""

    def __init__(self, lane: PolicyLane, fleet_grid: HostingGrid, S: int,
                 dev, with_opt: bool):
        self.grid = (fleet_grid if lane.grid is None
                     else lane.grid.to(dev).repeat_rows(S))
        self.policy = _replicate_policy(lane.fns, S, dev)
        self.cols = (None if lane.svc_cols is None else torch.as_tensor(
            lane.svc_cols, dtype=torch.int32, device=dev)
            .repeat_interleave(S, dim=0).contiguous())
        B, K = self.grid.B, self.grid.K
        self.carry = (self.policy.init_fn(self.policy.params),
                      sim_acc0(B, K, dev))
        self.r_parts = []
        self.dp = _DpLane(self.grid, dev) if with_opt else None

    def step(self, include_final_fetch, T_len, t0, slab,
             collect_trace):
        g = self.grid
        self.carry, r = sim_chunk(self.policy, include_final_fetch, g.levels,
                                  g.g, g.M, T_len, t0, self.carry, slab,
                                  collect_trace, self.cols)
        self.r_parts.append(r)
        if self.dp is not None:
            self.dp.step(T_len, t0, slab, self.cols)

    def result(self, T_max, collect_trace) -> dict:
        acc = self.carry[1]
        return {
            "sums": acc["sums"].cpu().numpy().astype(np.float64),
            "level_slots": acc["counts"].cpu().numpy().astype(np.int64),
            "r_hist": (torch.cat(self.r_parts, dim=1)[:, :T_max].cpu()
                       .numpy() if collect_trace else None),
            "opt_cost": None if self.dp is None else self.dp.cost()}


class _DpLane:
    """The offline DP's forward frontier over one grid: the checkpointed
    cost-only pass of ``offline_opt_fleet``, one chunk at a time."""

    def __init__(self, grid: HostingGrid, dev):
        self.grid = grid
        self.lv32 = grid.levels.to(torch.float32)
        self.fetch = dp_fetch_matrix(grid.M.to(torch.float32), self.lv32)
        self.J = dp_frontier0(grid.B, grid.K, dev)

    def step(self, T_len, t0, slab, svc_cols=None):
        # kernel D assembles w itself: from x * g under Model 1, from the
        # service slab (its svc_cols columns) under Model 2
        g = self.grid
        if slab.svc is None:
            self.J, _ = dp_fwd_model1(self.J, slab.c, slab.x, g.g, self.lv32,
                                      g.mask, self.fetch, T_len, t0)
        else:
            self.J, _ = dp_fwd_model2(self.J, slab.c, slab.svc, self.lv32,
                                      g.mask, self.fetch, T_len, t0, svc_cols)

    def cost(self) -> np.ndarray:
        return torch.amin(self.J, dim=1).cpu().numpy().astype(np.float64)


def offline_opt_fleet(fleet: FleetBatch, *,
                      scenario: Optional[Scenario] = None,
                      chunk_size: Optional[int] = None,
                      n_seeds: Optional[int] = None,
                      antithetic: bool = False,
                      checkpointed: bool = False,
                      collect_schedule: bool = True,
                      device=None,
                      stream: bool = False,
                      async_ingest: bool = False,
                      gather: bool = False,
                      mesh=None) -> FleetOfflineResult:
    """Fleet alpha-OPT cost: the exact DP forward recursion over scenario
    slabs generated chunk by chunk, each instance solved at its own horizon
    (``checkpointed=True, collect_schedule=False``: the cost-only pass,
    which keeps one [R, K] frontier and no O(T) buffer).  Arguments as in
    ``run_fleet``; ``cost`` row ``b * S + s`` is bitwise the reference's."""
    _refuse_later(stream=stream, async_ingest=async_ingest, gather=gather,
                  mesh=mesh)
    if not checkpointed or collect_schedule:
        raise NotImplementedError(
            "only offline_opt_fleet(checkpointed=True, collect_schedule="
            "False) is ported; the materialized DP and the backtracked "
            "schedule come with ROADMAP.md, Queue 1 item 7")
    fleet, scenario, dev = _to_device(fleet, scenario, device)
    fleet, scenario, S = _replicate_mc(fleet, scenario, n_seeds, antithetic)
    n_chunks, T_pad = chunk_geometry(fleet.T_max, chunk_size)
    chunk = T_pad // n_chunks
    T_len = torch.from_numpy(fleet.T).to(dev)
    dp = _DpLane(fleet.grid, dev)
    gen = scenario.init_fn(scenario.params)
    for i in range(n_chunks):
        tids = chunk_tids(i * chunk, chunk, dev)
        gen, slab = scenario.chunk_fn(scenario.params, gen, tids)
        dp.step(T_len, i * chunk, slab)
    return FleetOfflineResult(cost=dp.cost(), r_hist=None, sim=None,
                              n_seeds=S)

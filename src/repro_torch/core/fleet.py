"""Fleet drivers (the port of the single-device part of
``repro/core/fleet.py``).

A fleet is B hosting instances stacked on one ``HostingGrid`` with
per-instance horizons.  ``run_fleet`` steps an online policy,
``offline_opt_fleet`` prices the exact offline optimum (and backtracks its
schedule) and ``evaluate_schedule_fleet`` prices given schedules, for every
instance at once.  A Python loop over chunks (the reference's outer
``lax.scan``) feeds each ``[R, chunk]`` slab to kernel S (alpha-RR / RR,
or its table variant), the DP's kernel D, kernel B (the backtrack) or
kernel E (schedule pricing).  A slab comes from one of two sources, and
nothing else differs between them:

* a ``Scenario`` (``FleetBatch.for_scenario`` + ``scenario=``), generated
  on the device chunk by chunk: device memory O(R * chunk), no observation
  crosses from the host;
* the fleet's own arrays (``FleetBatch.from_instances`` / ``from_dense``
  / ``from_scenario``: host numpy, zero-padded in T and K), moved to the
  device whole, or with ``stream=True`` one slab a chunk.

The Monte-Carlo axis (``n_seeds=S``, a scenario only) replicates each
instance S times (rows ``b * S + s``, instance-major) with the seed folded
into every stream key (``scenarios.replicate_seeds``); ``mc_summary``
collapses it.

**Policy fan-out.**  ``run_fleet`` also takes a sequence of policies
(``PolicyFns``, or ``PolicyLane`` binding a policy to its own accounting
grid): each ``[R, chunk]`` slab is made ONCE per chunk and every lane
steps it with its own kernel-S launch on its own grid's rows, replicated
over seeds like the fleet's.  Under Model 2 (``combine(svc=)``, or a fleet
with ``svc``) a lane on its own grid carries ``svc_cols``, its levels'
columns in the service slab (``RetroRenting.fleet_lane(fleet,
with_svc=True)``), and kernels S and D gather them themselves.
``with_opt_forward=True`` carries one offline-DP frontier per lane through
the same chunk loop (kernel D on the lane's levels and mask) and returns
``FleetResult.opt_cost``.  Rows are policy-major, ``(p * B + b) * S + s``
(``FleetResult.policy_view``); lane p is bitwise its standalone run,
``opt_cost`` bitwise ``offline_opt_fleet`` on the lane's fleet.

**The schedule** (``offline_opt_fleet(collect_schedule=True)``, the
default): materialised, D writes each chunk's argmin table and kernel B
walks the tables back; checkpointed, the forward pass keeps each chunk's
entry frontier (and generator state) and the backtrack replays each chunk
with its table, right to left.  Kernel E prices the schedule (``sim``).

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md item: ``async_ingest``, ``gather`` and a mesh.  The port runs
on one device, so no rows are padded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.costs import (HostingCosts, HostingGrid,
                                    default_float_dtype)
from repro_torch.core.policies.base import (PolicyFns, PolicyLane,
                                            as_policy_lanes)
from repro_torch.core.policies.offline_opt import (dp_backtrack_chunk,
                                                   dp_fetch_matrix,
                                                   dp_frontier0, dp_terminal)
from repro_torch.core.scenarios.base import (PRNG_BACKENDS, ObsSlab,
                                             Scenario, chunk_geometry,
                                             chunk_tids, materialize,
                                             tree_map)
from repro_torch.core.scenarios.combinators import (replicate_seeds,
                                                    with_prng_backend)
from repro_torch.core.simulator import (SimResult, sim_acc0, sim_chunk,
                                        xla_acc_fma, xla_fetch_fma)
from repro_torch.kernels.hosting import (dp_fwd_model1, dp_fwd_model2,
                                         schedule_chunk)


@dataclasses.dataclass(frozen=True)
class FleetBatch:
    """B hosting instances with per-instance horizons.

    Attributes:
      grid: stacked ``HostingGrid``.
      T:    [B] int32 numpy array of horizons (T_i <= T_max); slots with
            ``t >= T_i`` freeze the instance and add exactly zero cost.
      x:    [B, T_max] int32 arrivals, zero-padded past each T_i, on the
            host (numpy) -- or None for a fleet whose observations a
            scenario generates (``for_scenario``).
      c:    [B, T_max] float32 rents (None with a scenario).
      svc:  optional [B, T_max, K] float32 Model-2 service costs (None:
            Model 1, ``g * x`` priced in the kernels).
      side: optional [B, T_max] int32 side channel.
    """

    grid: HostingGrid
    T: np.ndarray
    x: Optional[np.ndarray] = None
    c: Optional[np.ndarray] = None
    svc: Optional[np.ndarray] = None
    side: Optional[np.ndarray] = None

    # Observations are built host-resident (numpy), as in the reference: a
    # run moves them to the device whole, or (stream=True) one slab a chunk.

    @staticmethod
    def from_instances(costs_list: Sequence[HostingCosts], xs, cs,
                       svcs=None, sides=None, device=None) -> "FleetBatch":
        """Stack per-instance traces of mixed lengths (lists of [T_i]
        arrays; ``svcs`` entries [T_i, K_i]), zero-padding T and K; the grid
        on ``device`` (None: the card)."""
        grid = HostingGrid.from_costs(costs_list, device=device)
        dt = _host_float()
        B, K = grid.B, grid.K
        lens = [int(np.shape(xi)[0]) for xi in xs]
        T_max = max(lens)
        x = np.zeros((B, T_max), np.int32)
        c = np.zeros((B, T_max), dt)
        svc = None if svcs is None else np.zeros((B, T_max, K), dt)
        side = None if sides is None else np.zeros((B, T_max), np.int32)
        for i in range(B):
            x[i, :lens[i]] = np.asarray(xs[i])
            c[i, :lens[i]] = np.asarray(cs[i])
            if svcs is not None:
                si = np.asarray(svcs[i])
                svc[i, :lens[i], :si.shape[1]] = si
            if sides is not None:
                side[i, :lens[i]] = np.asarray(sides[i])
        return FleetBatch(grid=grid, T=np.asarray(lens, np.int32), x=x, c=c,
                          svc=svc, side=side)

    @staticmethod
    def from_dense(grid: HostingGrid, x, c, svc=None, side=None,
                   T=None) -> "FleetBatch":
        """Wrap already-stacked [B, T] (or broadcastable [T]) observations;
        ``T`` defaults to the uniform full horizon."""
        dt = _host_float()
        B = grid.B
        x = np.asarray(x, np.int32)
        if x.ndim == 1:
            x = np.broadcast_to(x[None, :], (B, x.shape[0]))
        T_max = x.shape[1]
        c = np.asarray(c, dt)
        if c.ndim == 1:
            c = np.broadcast_to(c[None, :], (B, T_max))
        if svc is not None:
            svc = np.asarray(svc, dt)
            if svc.ndim == 2:
                svc = np.broadcast_to(svc[None], (B,) + svc.shape)
        if side is not None:
            side = np.asarray(side, np.int32)
            if side.ndim == 1:
                side = np.broadcast_to(side[None, :], (B, T_max))
        T = (np.full((B,), T_max, np.int32) if T is None
             else np.broadcast_to(np.asarray(T, np.int32), (B,)).copy())
        return FleetBatch(grid=grid, T=T, x=x, c=c, svc=svc, side=side)

    @staticmethod
    def for_scenario(grid: HostingGrid, T) -> "FleetBatch":
        """A fleet whose observations come from ``scenario=...``; ``T`` is a
        scalar or [B] per-instance horizon vector."""
        return FleetBatch(grid=grid, T=np.broadcast_to(
            np.asarray(T, np.int32), (grid.B,)).copy())

    @staticmethod
    def from_scenario(grid: HostingGrid, scenario: Scenario, T,
                      chunk_size: Optional[int] = None) -> "FleetBatch":
        """A scenario materialised (``scenarios.materialize``, on the
        scenario's device) into an obs-backed fleet: the fused runs are
        bitwise this fleet's."""
        T = np.broadcast_to(np.asarray(T, np.int32), (grid.B,))
        x, c, svc, side = materialize(scenario, int(T.max()), chunk_size)
        return FleetBatch.from_dense(grid, x, c, svc=svc, side=side, T=T)

    @property
    def B(self) -> int:
        return self.grid.B

    @property
    def K(self) -> int:
        return self.grid.K

    @property
    def T_max(self) -> int:
        if self.x is None:
            return int(np.max(self.T))
        return self.x.shape[1]

    def restrict_to_endpoints(self) -> "FleetBatch":
        """The no-partial-hosting view (RR / OPT): the 2-level grid, the
        service costs gathered down to the (0, top) columns on the host."""
        svc2 = None
        if self.svc is not None:
            svc = np.asarray(self.svc)
            top = self.grid.top_index().cpu().numpy()
            hi = np.take_along_axis(
                svc, np.broadcast_to(top[:, None, None],
                                     svc.shape[:2] + (1,)), axis=2)
            svc2 = np.concatenate([svc[:, :, :1], hi], axis=2)
        return FleetBatch(grid=self.grid.restrict_to_endpoints(), T=self.T,
                          x=self.x, c=self.c, svc=svc2, side=self.side)


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

    @property
    def per_slot(self) -> np.ndarray:
        return self.total / self.T

    def instance(self, i: int) -> SimResult:
        if self.r_hist is None:
            raise ValueError("no r_hist: fleet ran with collect_trace=False")
        return SimResult(total=float(self.total[i]), fetch=float(self.fetch[i]),
                         rent=float(self.rent[i]),
                         service=float(self.service[i]),
                         r_hist=self.r_hist[i, :int(self.T[i])],
                         level_slots=self.level_slots[i])

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
# Shared prologue of the drivers, and where their slabs come from.
# ----------------------------------------------------------------------

def _host_float():
    """numpy's counterpart of ``costs.default_float_dtype()`` (float32)."""
    return torch.empty((), dtype=default_float_dtype()).numpy().dtype


# arguments of the reference drivers that the port does not have yet, with
# the ROADMAP.md item that brings each
_LATER = {
    "async_ingest": "Queue 1 item 10 (live stepper and ingestion)",
    "gather": "Queue 1 item 15 (multi-device / multi-process)",
    "mesh": "Queue 1 item 15 (multi-device / multi-process)",
}


def _refuse_later(**given):
    for name, value in given.items():
        if value not in (None, False):
            raise NotImplementedError(
                f"{name}= is not ported yet: ROADMAP.md, {_LATER[name]}")


def _prepare(fleet: FleetBatch, scenario: Optional[Scenario], device,
             n_seeds: Optional[int], antithetic: bool,
             prng_backend: str = "xla"):
    """Check the fleet against its source, move the grid (and a scenario's
    params) to the device, and expand to the [B*S] Monte-Carlo replication
    (instance-major, seed-minor; a scenario's seed folded into every
    stream key), unchanged when ``n_seeds`` is None; the scenario draws
    through ``prng_backend`` (``scenarios.with_prng_backend``).  Returns
    ``(fleet, scenario, S, device)``."""
    if prng_backend not in PRNG_BACKENDS:
        raise ValueError(f"prng_backend must be one of {PRNG_BACKENDS}, "
                         f"got {prng_backend!r}")
    if prng_backend != "xla" and scenario is None:
        raise ValueError("prng_backend= needs scenario=: materialized "
                         "observations draw no slot uniforms to reroute")
    if n_seeds is None and antithetic:
        raise ValueError("antithetic=True needs n_seeds=")
    if scenario is None:
        if fleet.x is None or fleet.c is None:
            raise ValueError("a fleet without observations needs scenario= "
                             "(FleetBatch.for_scenario)")
        if n_seeds is not None:
            raise ValueError(
                "n_seeds= needs scenario=: materialized observations carry "
                "no seed axis to fold (stack replica rows yourself instead)")
    else:
        if fleet.x is not None or fleet.c is not None:
            raise ValueError(
                "scenario=... needs an obs-less fleet "
                "(FleetBatch.for_scenario); materialized observations would "
                "be silently ignored")
        if scenario.B != fleet.B:
            raise ValueError(f"scenario B={scenario.B} != fleet B={fleet.B}")
    dev = resolve_device(device)
    fleet = dataclasses.replace(fleet, grid=fleet.grid.to(dev))
    if scenario is not None:
        scenario = scenario._replace(
            params=tree_map(lambda a: a.to(dev), scenario.params))
    if n_seeds is None:
        S = 1
    else:
        S = int(n_seeds)
        fleet = FleetBatch(grid=fleet.grid.repeat_rows(S),
                           T=np.repeat(fleet.T, S))
        scenario = replicate_seeds(scenario, S, antithetic=antithetic)
    if scenario is not None:
        scenario = with_prng_backend(scenario, prng_backend)
    return fleet, scenario, S, dev


def _cut(a, sl, dev):
    """Columns ``sl`` of a [R, T, ...] array as a contiguous tensor on
    ``dev``: a slice of a resident tensor, or of a host array sent over."""
    if a is None:
        return None
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a[:, sl])).to(dev)
    return a[:, sl].contiguous().to(dev)


class _Feed:
    """Where a run's ``[R, chunk]`` slabs come from: the scenario's
    ``chunk_fn`` (its generator state threaded through ``slab``), or slices
    of the fleet's observations zero-padded to ``T_pad`` -- moved to the
    device whole, or with ``stream=True`` left on the host and sent one
    slab a chunk.  The chunk loop is the same either way."""

    def __init__(self, fleet: FleetBatch, scenario: Optional[Scenario], dev,
                 n_chunks: int, T_pad: int, stream: bool):
        self.scenario, self.dev = scenario, dev
        self.n_chunks, self.chunk = n_chunks, T_pad // n_chunks
        self.stream = stream
        self.obs = None
        if scenario is None:
            def pad(a):
                if a is None:
                    return None
                a = np.asarray(a)
                if T_pad > a.shape[1]:
                    a = np.pad(a, ((0, 0), (0, T_pad - a.shape[1]))
                               + ((0, 0),) * (a.ndim - 2))
                if stream:
                    return a
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            self.obs = [pad(a) for a in (fleet.x, fleet.c, fleet.svc,
                                         fleet.side)]

    def gen0(self):
        """The generator state at the horizon's start (None: obs-backed)."""
        if self.scenario is None:
            return None
        return self.scenario.init_fn(self.scenario.params)

    def slab(self, i: int, gen):
        """Chunk ``i``'s slab from the generator state ``gen`` at its entry:
        ``(gen', ObsSlab)``."""
        t0 = i * self.chunk
        if self.scenario is not None:
            tids = chunk_tids(t0, self.chunk, self.dev)
            return self.scenario.chunk_fn(self.scenario.params, gen, tids)
        sl = slice(t0, t0 + self.chunk)
        return None, ObsSlab(*(_cut(a, sl, self.dev) for a in self.obs))

    def to_host(self, t):
        """A per-chunk result as the stream keeps it: on the host."""
        return t.cpu() if self.stream else t


def _geometry(fleet: FleetBatch, chunk_size, stream: bool):
    if stream and chunk_size is None:
        raise ValueError("stream=True requires chunk_size")
    return chunk_geometry(fleet.T_max, chunk_size)


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
              prng_backend: str = "xla",
              device=None,
              stream: bool = False,
              with_opt_forward: bool = False,
              async_ingest: bool = False,
              gather: bool = False,
              mesh=None) -> FleetResult:
    """Simulate a fleet, its observations generated by ``scenario`` or read
    from the fleet's own arrays.

    Args:
      policy: a ``PolicyFns`` whose params carry a leading [B] axis matching
        ``fleet.grid`` (``AlphaRR.fleet(fleet)``; RR runs on
        ``fleet.restrict_to_endpoints()``), or a sequence of them and of
        ``PolicyLane`` entries: the fan-out axis (module docstring).
      fleet: ``FleetBatch.for_scenario(grid, T)`` with ``scenario=``, or an
        obs-backed fleet (``from_instances`` / ``from_dense`` /
        ``from_scenario``); mixed horizons allowed.
      scenario: the workload generator (B rows).
      chunk_size: slots per chunk (None = the whole horizon in one chunk);
        any chunking gives the same bits.
      collect_trace: False drops the [B, T_max] ``r_hist``.
      n_seeds / antithetic: S Monte-Carlo replicas of every instance (see
        the module docstring; a scenario only); ``antithetic`` pairs them
        on flip-capable streams.
      prng_backend: the scenario's PRNG backend (``"xla"`` or
        ``"pallas"``, ``scenarios.with_prng_backend``; a scenario only).
      device: None means the CUDA card (raises without one); ``"cpu"``
        runs the plain PyTorch versions of the kernels.
      stream: drive the chunks from the host (needs ``chunk_size``): an
        obs-backed fleet's observations stay on the host and one [R, chunk]
        slab crosses a chunk, the trace comes back a chunk at a time.
      with_opt_forward: co-execute the offline DP's frontier per lane and
        return ``opt_cost`` (a single ``PolicyFns`` is then a one-lane
        fan-out).

    Row ``b * S + s`` (``(p * B + b) * S + s`` under a fan-out) of the
    result is bitwise the reference's ``run_fleet`` under the same
    threefry layout (obs-backed: the reference's per-instance cores).
    """
    _refuse_later(async_ingest=async_ingest, gather=gather, mesh=mesh)
    lanes = as_policy_lanes(policy) or (PolicyLane(policy),)
    has_svc = (fleet.svc is not None if scenario is None
               else scenario.has_svc)
    _check_lanes(lanes, fleet, has_svc)
    fleet, scenario, S, dev = _prepare(fleet, scenario, device, n_seeds,
                                       antithetic, prng_backend)
    T_max = fleet.T_max
    n_chunks, T_pad = _geometry(fleet, chunk_size, stream)
    feed = _Feed(fleet, scenario, dev, n_chunks, T_pad, stream)
    T_len = torch.from_numpy(fleet.T).to(dev)
    runs = [_Lane(lane, fleet.grid, S, dev, with_opt_forward)
            for lane in lanes]
    gen = feed.gen0()
    for i in range(n_chunks):
        gen, slab = feed.slab(i, gen)
        for run in runs:
            run.step(include_final_fetch, T_len, i * feed.chunk, slab,
                     collect_trace, feed)
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


def _replicate_policy(policy: PolicyFns, S: int, device) -> PolicyFns:
    return policy._replace(params=tree_map(
        lambda a: a.to(device).repeat_interleave(S, dim=0), policy.params))


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

    def step(self, include_final_fetch, T_len, t0, slab, collect_trace,
             feed: _Feed):
        g = self.grid
        # the sums fused as the reference's vmapped scan fuses them
        fused = (self.policy.step_fn, g.B, g.K, include_final_fetch)
        self.carry, r = sim_chunk(self.policy, include_final_fetch, g.levels,
                                  g.g, g.M, T_len, t0, self.carry, slab,
                                  collect_trace, self.cols,
                                  xla_acc_fma(*fused), xla_fetch_fma(*fused))
        if collect_trace:
            self.r_parts.append(feed.to_host(r))
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
    """The offline DP's forward frontier over one grid, one chunk at a
    time: kernel D with the cost assembly fused in, from ``x * g`` under
    Model 1 or from the service slab (its ``svc_cols`` columns) under
    Model 2; with ``with_args`` it also writes the chunk's argmin table."""

    def __init__(self, grid: HostingGrid, dev):
        self.grid = grid
        self.lv32 = grid.levels.to(torch.float32)
        self.fetch = dp_fetch_matrix(grid.M.to(torch.float32), self.lv32)
        self.J = dp_frontier0(grid.B, grid.K, dev)

    def chunk(self, J, T_len, t0, slab, svc_cols=None, with_args=False):
        """``(J', args [R, chunk, K] or None)`` of one chunk from ``J``."""
        g = self.grid
        if slab.svc is None:
            return dp_fwd_model1(J, slab.c, slab.x, g.g, self.lv32, g.mask,
                                 self.fetch, T_len, t0, with_args)
        return dp_fwd_model2(J, slab.c, slab.svc, self.lv32, g.mask,
                             self.fetch, T_len, t0, svc_cols, with_args)

    def step(self, T_len, t0, slab, svc_cols=None):
        self.J, _ = self.chunk(self.J, T_len, t0, slab, svc_cols)

    def cost(self) -> np.ndarray:
        return torch.amin(self.J, dim=1).cpu().numpy().astype(np.float64)


def offline_opt_fleet(fleet: FleetBatch, *,
                      scenario: Optional[Scenario] = None,
                      chunk_size: Optional[int] = None,
                      n_seeds: Optional[int] = None,
                      antithetic: bool = False,
                      prng_backend: str = "xla",
                      checkpointed: bool = False,
                      collect_schedule: bool = True,
                      device=None,
                      stream: bool = False,
                      async_ingest: bool = False,
                      gather: bool = False,
                      mesh=None) -> FleetOfflineResult:
    """Fleet alpha-OPT: the exact DP forward recursion over the chunks'
    slabs (generated by ``scenario`` or read from the fleet), each instance
    solved at its own horizon, on kernel D with the cost assembly fused in.

    * Materialised (``checkpointed=False``, the default): D writes every
      chunk's [R, chunk, K] argmin table, and kernel B walks the tables
      back, right to left, from the terminal ``argmin`` (first minimum).
    * ``checkpointed=True``: the forward pass keeps each chunk's entry
      frontier (and, for a scenario, the generator state at the chunk's
      entry); the backtrack replays each chunk from its checkpoint with the
      table and walks it.  ``collect_schedule=False`` (checkpointed only)
      keeps one [R, K] frontier and returns the cost alone.
    * ``stream=True`` (checkpointed, with ``chunk_size``): the same passes
      driven from the host, an obs-backed fleet's observations sent one
      slab a chunk and the schedule brought back a chunk at a time.

    With the schedule, ``r_hist`` (sliced to ``T_max``, int64; constant
    past each row's horizon) is priced on the same observations by kernel
    E (``sim``).  Other arguments as in ``run_fleet``; ``cost``,
    ``r_hist`` and ``sim`` row ``b * S + s`` are bitwise the reference's.
    """
    _refuse_later(async_ingest=async_ingest, gather=gather, mesh=mesh)
    if stream and not checkpointed:
        raise ValueError("stream=True requires checkpointed=True (the "
                         "materialized backtrack needs the whole table)")
    if not collect_schedule and not checkpointed:
        raise ValueError("collect_schedule=False requires checkpointed=True")
    fleet, scenario, S, dev = _prepare(fleet, scenario, device, n_seeds,
                                       antithetic, prng_backend)
    n_chunks, T_pad = _geometry(fleet, chunk_size, stream)
    feed = _Feed(fleet, scenario, dev, n_chunks, T_pad, stream)
    chunk = feed.chunk
    T_len = torch.from_numpy(fleet.T).to(dev)
    dp = _DpLane(fleet.grid, dev)
    J, gen = dp.J, feed.gen0()
    saved = []       # per chunk: its argmin table, or its entry checkpoint
    for i in range(n_chunks):
        if checkpointed and collect_schedule:
            saved.append((gen, J))
        gen, slab = feed.slab(i, gen)
        J, args = dp.chunk(J, T_len, i * chunk, slab,
                           with_args=not checkpointed)
        if not checkpointed:
            saved.append(args)
    cost, k = dp_terminal(J)
    cost = cost.cpu().numpy().astype(np.float64)
    if not collect_schedule:
        return FleetOfflineResult(cost=cost, r_hist=None, sim=None,
                                  n_seeds=S)
    parts = []
    for i in range(n_chunks - 1, -1, -1):
        args = saved.pop()
        if checkpointed:        # replay the chunk from its checkpoint
            gen_i, J_i = args
            _, slab = feed.slab(i, gen_i)
            _, args = dp.chunk(J_i, T_len, i * chunk, slab, with_args=True)
        k, r = dp_backtrack_chunk(k, args)
        parts.append(feed.to_host(r))
    r_pad = torch.cat(parts[::-1], dim=1)
    sim = _schedule_result(fleet, feed, r_pad, T_len, S)
    return FleetOfflineResult(cost=cost, r_hist=sim.r_hist, sim=sim,
                              n_seeds=S)


def _schedule_result(fleet: FleetBatch, feed: _Feed, r_pad, T_len,
                     S: int) -> FleetResult:
    """Price [R, T_pad] schedules ``r_pad`` (a tensor, or a host array) on
    the feed's slabs with kernel E, chunk by chunk, entered from level 0;
    the result's ``r_hist`` is ``r_pad`` sliced to ``T_max`` (int64)."""
    g, dev = fleet.grid, feed.dev
    carry = (torch.zeros((g.B,), dtype=torch.int32, device=dev),
             sim_acc0(g.B, g.K, dev))
    fma = xla_acc_fma(None, g.B, g.K, fleet=True, matrix=g.matrix_m)
    gen = feed.gen0()
    for i in range(feed.n_chunks):
        gen, slab = feed.slab(i, gen)
        sl = slice(i * feed.chunk, (i + 1) * feed.chunk)
        svc = slab.svc
        carry = schedule_chunk(g.levels, g.M, T_len, i * feed.chunk, carry,
                               _cut(r_pad, sl, dev), slab.c,
                               x=slab.x if svc is None else None,
                               g=g.g if svc is None else None, svc=svc,
                               acc_fma=fma)
    acc = carry[1]
    sums = acc["sums"].cpu().numpy().astype(np.float64)
    r_hist = np.asarray(r_pad.cpu() if isinstance(r_pad, torch.Tensor)
                        else r_pad)
    return FleetResult(
        total=sums.sum(axis=1), rent=sums[:, 0], service=sums[:, 1],
        fetch=sums[:, 2], r_hist=r_hist[:, :fleet.T_max].astype(np.int64),
        level_slots=acc["counts"].cpu().numpy().astype(np.int64),
        T=fleet.T.astype(np.int64), n_seeds=S)


def evaluate_schedule_fleet(fleet: FleetBatch, r_hist, *,
                            scenario: Optional[Scenario] = None,
                            chunk_size: Optional[int] = None,
                            n_seeds: Optional[int] = None,
                            antithetic: bool = False,
                            prng_backend: str = "xla",
                            device=None,
                            stream: bool = False,
                            gather: bool = False,
                            mesh=None) -> FleetResult:
    """The cost of given schedules ``r_hist`` [B, T_max] (or [B * S, T_max]
    under ``n_seeds``; [B] rows are repeated over the replicas) on the
    fleet's observations or a scenario's, chunk by chunk on kernel E:
    entered from level 0, fetches charged on entry, nothing charged past a
    row's horizon.  Other arguments as in ``run_fleet``; bitwise the
    reference's ``evaluate_schedule_fleet``."""
    _refuse_later(gather=gather, mesh=mesh)
    B_orig = fleet.B
    fleet, scenario, S, dev = _prepare(fleet, scenario, device, n_seeds,
                                       antithetic, prng_backend)
    n_chunks, T_pad = _geometry(fleet, chunk_size, stream)
    r = np.asarray(r_hist, np.int32)
    if S > 1 and r.shape[0] == B_orig:
        r = np.repeat(r, S, axis=0)
    r = np.pad(r, ((0, 0), (0, T_pad - r.shape[1])))
    feed = _Feed(fleet, scenario, dev, n_chunks, T_pad, stream)
    return _schedule_result(fleet, feed, r if stream else
                            torch.from_numpy(r).to(dev),
                            torch.from_numpy(fleet.T).to(dev), S)

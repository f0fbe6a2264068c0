"""Multi-service hosting: N services sharing one edge node's storage (the
port of ``repro/core/services.py``).

The model (Online Service Caching and Routing at the Edge with Unknown
Arrivals, arXiv 2107.10446): each service keeps its own levels, g-curve
and fetch cost, the edge bounds the SUM of the hosted fractions, each
service sees its own arrival stream and the rent (the one edge's spot
price) is common.  The fleet engine serves it along two axes, both
bitwise the single-service paths at N = 1:

* **Per-service lanes** (online policies): service n of instance b is row
  ``b * N + n`` of an ordinary [B*N] fleet (``ServiceFleet.lane_fleet``)
  driven by a ``tile_services``-salted scenario, so every driver option
  (chunking, streaming, ``n_seeds``, the policy fan-out) applies as it
  is.  Independent lanes ignore the capacity: ``capacity_overflow``
  measures how far their schedules exceed it.
* **Joint states** (offline OPT): the feasible per-service level
  combinations of each instance become the states of a matrix-``M``
  ``HostingGrid`` (``costs.ServiceSet``), and ``joint_scenario`` reduces
  the tiled per-service slabs to one [B, chunk] joint slab (kernel G,
  ``kernels.hosting.joint_slab``: x summed, the rent and side channel of
  lane 0, each joint state's service cost gathered and summed over the
  services).  ``offline_opt_services`` runs the unchanged fleet DP over
  it: the fused kernel D up to 16 states, G's ``w`` and D on a finished w
  up to 32, kernel B for the schedule and E's matrix route for its price.

``fleet_stepper_services`` waits for the live stepper (ROADMAP.md, Queue
1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.costs import HostingGrid, ServiceSet, joint_hosting_grid
from repro_torch.core.fleet import (FleetBatch, FleetOfflineResult,
                                    FleetResult, evaluate_schedule_fleet,
                                    offline_opt_fleet, run_fleet)
from repro_torch.core.policies.alpha_rr import AlphaRR
from repro_torch.core.policies.base import PolicyFns
from repro_torch.core.scenarios.base import (ObsSlab, Scenario, tree_leaves,
                                             tree_map)
from repro_torch.core.scenarios.combinators import tile_services
from repro_torch.kernels.hosting import joint_slab


@dataclasses.dataclass(frozen=True)
class ServiceFleet:
    """B multi-service instances (one ``ServiceSet`` each, a common N) with
    per-instance horizons: the container both mappings start from."""

    sets: Tuple[ServiceSet, ...]
    T: np.ndarray                      # [B] per-instance horizons

    def __post_init__(self):
        object.__setattr__(self, "sets", tuple(self.sets))
        if not self.sets:
            raise ValueError("need at least one instance")
        Ns = {ss.N for ss in self.sets}
        if len(Ns) != 1:
            raise ValueError(f"instances must share one service count, "
                             f"got N in {sorted(Ns)}")
        object.__setattr__(
            self, "T",
            np.broadcast_to(np.asarray(self.T, np.int32),
                            (len(self.sets),)).copy())

    @property
    def B(self) -> int:
        return len(self.sets)

    @property
    def N(self) -> int:
        return self.sets[0].N

    def lane_grid(self, device=None) -> HostingGrid:
        """[B*N] single-service grid: service n of instance b is row ``b *
        N + n`` (instance-major, service-minor: ``tile_services``' rows)."""
        return HostingGrid.from_costs(
            [cc for ss in self.sets for cc in ss.services], device=device)

    def lane_fleet(self, device=None) -> FleetBatch:
        """The obs-less [B*N] lane fleet (pair it with a tiled scenario)."""
        return FleetBatch.for_scenario(self.lane_grid(device),
                                       np.repeat(self.T, self.N))

    def joint_grid(self, device=None) -> HostingGrid:
        """[B] matrix-``M`` joint-state grid (mixed state counts padded)."""
        return joint_hosting_grid(list(self.sets), device=device)

    def joint_fleet(self, device=None) -> FleetBatch:
        """The obs-less [B] joint fleet (pair it with ``joint_scenario``)."""
        return FleetBatch.for_scenario(self.joint_grid(device), self.T)


def service_fleet(sets: Sequence[ServiceSet], T) -> ServiceFleet:
    """A ``ServiceFleet`` (``T`` a scalar or [B])."""
    return ServiceFleet(sets=tuple(sets), T=T)


def service_scenario(sfleet: ServiceFleet, scenario: Scenario) -> Scenario:
    """The [B*N] per-service form of ``scenario``: a [B]-row scenario is
    ``tile_services``-expanded (keys salted per service, the rent shared);
    a [B*N]-row one passes through untouched."""
    B_sc = scenario.B
    if B_sc == sfleet.B * sfleet.N:
        return scenario
    if B_sc != sfleet.B:
        raise ValueError(f"scenario B={B_sc} matches neither B={sfleet.B} "
                         f"nor B*N={sfleet.B * sfleet.N}")
    return tile_services(scenario, sfleet.N)


def alpha_rr_per_service(sfleet: ServiceFleet, device=None) -> PolicyFns:
    """alpha-RR run on each service on its own: the ``AlphaRR`` policy
    batch of the lane fleet, each lane bitwise a standalone single-service
    run (the capacity ignored; see ``capacity_overflow``)."""
    return AlphaRR.fleet(sfleet.lane_fleet(device))


# ----------------------------------------------------------------------
# Per-service lane runs (online policies).
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ServiceFleetResult:
    """A lane-fleet ``FleetResult`` with its [B, N] row bookkeeping."""

    fleet: FleetResult
    B: int
    N: int

    def service_view(self, a) -> np.ndarray:
        """A lane-row-leading array as ``[P, B, N, S, ...]`` (the engine's
        rows ``((p * B + b) * N + n) * S + s``)."""
        a = np.asarray(a)
        S, P = self.fleet.n_seeds, self.fleet.n_policies
        return a.reshape((P, self.B, self.N, S) + a.shape[1:])

    @property
    def total(self) -> np.ndarray:
        return self.service_view(self.fleet.total)

    @property
    def edge_total(self) -> np.ndarray:
        """[P, B, S] cost of the whole edge (summed over the services)."""
        return self.total.sum(axis=2)


def run_fleet_services(policy, sfleet: ServiceFleet, *, scenario: Scenario,
                       device=None, **kwargs) -> ServiceFleetResult:
    """``run_fleet`` over the per-service lanes: ``policy`` (or a fan-out
    list) built on ``sfleet.lane_fleet()`` (``alpha_rr_per_service``),
    ``scenario`` [B]-row (tiled here) or already [B*N].  Every other
    ``run_fleet`` keyword passes through; at N = 1 this is the
    single-service ``run_fleet`` call, bit for bit."""
    res = run_fleet(policy, sfleet.lane_fleet(device),
                    scenario=service_scenario(sfleet, scenario),
                    device=device, **kwargs)
    return ServiceFleetResult(fleet=res, B=sfleet.B, N=sfleet.N)


def fleet_stepper_services(policy, sfleet: ServiceFleet, *,
                           scenario: Optional[Scenario] = None, **kwargs):
    """``fleet_stepper`` over the per-service lanes: not ported yet."""
    raise NotImplementedError(
        "fleet_stepper_services (the live stepper over the per-service "
        "lanes) is not ported yet: ROADMAP.md, Queue 1 item 10 (live "
        "stepper and ingestion)")


def evaluate_schedule_services(sfleet: ServiceFleet, r_hist, *,
                               scenario: Optional[Scenario] = None,
                               device=None, **kwargs) -> ServiceFleetResult:
    """Price per-service schedules (``r_hist`` [B, N, T] or [B*N, T]) on
    the lane fleet: ``evaluate_schedule_fleet`` on the tiled observations
    the lanes ran on."""
    r = np.asarray(r_hist)
    if r.ndim == 3:
        r = r.reshape(sfleet.B * sfleet.N, r.shape[-1])
    if scenario is not None:
        scenario = service_scenario(sfleet, scenario)
    res = evaluate_schedule_fleet(sfleet.lane_fleet(device), r,
                                  scenario=scenario, device=device, **kwargs)
    return ServiceFleetResult(fleet=res, B=sfleet.B, N=sfleet.N)


def hosted_fractions(sfleet: ServiceFleet, r_hist) -> np.ndarray:
    """[B, N, T] hosted fractions of lane schedules (``r_hist`` [B*N, T] or
    [B, N, T] level indices), in float64 on the host."""
    r = np.asarray(r_hist, np.int64)
    if r.ndim == 3:
        r = r.reshape(sfleet.B * sfleet.N, r.shape[-1])
    if r.shape[0] != sfleet.B * sfleet.N:
        raise ValueError(f"r_hist has {r.shape[0]} rows, expected "
                         f"B*N={sfleet.B * sfleet.N} (peel seed/policy axes "
                         "first)")
    lv = sfleet.lane_grid("cpu").levels.numpy()
    fr = np.take_along_axis(lv, r, axis=1)
    return fr.reshape(sfleet.B, sfleet.N, -1)


def capacity_overflow(sfleet: ServiceFleet, r_hist) -> np.ndarray:
    """[B, T] ``max(0, sum_n hosted fraction - capacity)`` a slot: how far
    independent per-service schedules exceed the shared capacity (the
    joint DP's schedules are 0 everywhere by construction)."""
    tot = hosted_fractions(sfleet, r_hist).sum(axis=1)
    cap = np.asarray([ss.cap for ss in sfleet.sets])[:, None]
    return np.maximum(tot - cap, 0.0)


# ----------------------------------------------------------------------
# Joint-state runs (the capacity-respecting offline OPT).
# ----------------------------------------------------------------------

def _flat(tree):
    """[B, N, ...] leaves as [B*N, ...] (instance-major, service-minor)."""
    return tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])), tree)


def _joint_fns(sub_init, sub_chunk):
    """(init_fn, chunk_fn) of a joint-state scenario.  The tiled
    per-service generator runs on its [B*N] rows, then kernel G reduces
    the N sub-slabs of each instance to ONE joint slab: ``x`` summed,
    ``c`` and ``side`` of service lane 0 (one edge, one rent stream), and
    each joint state's service cost gathered per service and summed --
    Model-2 slabs through ``idx`` column gathers, Model 1 from the
    per-state ``g_lane`` prices.  At N = 1 both reductions are one-term
    identities."""

    def init_fn(params):
        return sub_init(_flat(params["sub"]))

    def chunk_fn(params, state, tids):
        st2, slab = sub_chunk(_flat(params["sub"]), state, tids)
        idx = params["idx"]
        x, c, side, svc = joint_slab(
            slab.x, slab.c, slab.side, slab.svc,
            None if slab.svc is not None else params["g_lane"], idx)
        return st2, ObsSlab(x=x, c=c, svc=svc, side=side)

    return init_fn, chunk_fn


def joint_scenario(sfleet: ServiceFleet, scenario: Scenario) -> Scenario:
    """The [B] joint-state scenario that drives ``sfleet.joint_fleet()``,
    from a (possibly untiled) per-service scenario: one slab an instance
    with each joint state's service costs (``_joint_fns``).  Padded joint
    states of mixed-J fleets gather their set's last real state, priced
    ``+inf`` by the grid's mask and never selected."""
    tiled = service_scenario(sfleet, scenario)
    B, N = sfleet.B, sfleet.N
    J = max(ss.J for ss in sfleet.sets)
    idx = np.zeros((B, N, J), np.int32)
    g_lane = np.zeros((B, N, J), np.float32)
    for b, ss in enumerate(sfleet.sets):
        st = ss.joint_states()                          # [J_b, N]
        Jb = st.shape[0]
        idx[b, :, :Jb] = st.T
        idx[b, :, Jb:] = idx[b, :, Jb - 1:Jb]
        for n, cc in enumerate(ss.services):
            g_lane[b, n, :Jb] = np.asarray(cc.g, np.float32)[st[:, n]]
            g_lane[b, n, Jb:] = g_lane[b, n, Jb - 1]
    dev = tree_leaves(tiled.params)[0].device
    params = {"sub": tree_map(lambda a: a.reshape((B, N) + tuple(
                  a.shape[1:])), tiled.params),
              "idx": torch.from_numpy(idx).to(dev),
              "g_lane": torch.from_numpy(g_lane).to(dev)}
    init_fn, chunk_fn = _joint_fns(tiled.init_fn, tiled.chunk_fn)
    return Scenario(f"joint{N}({scenario.name})", init_fn, chunk_fn, params,
                    has_svc=True, has_side=tiled.has_side)


@dataclasses.dataclass
class ServiceOfflineResult:
    """The joint capacity-respecting OPT of a ``ServiceFleet``: ``joint``
    the fleet DP's result on the joint-state grid (its ``r_hist`` rows are
    joint-state indices); ``service_schedules`` translates them back."""

    joint: FleetOfflineResult
    sfleet: ServiceFleet

    @property
    def cost(self) -> np.ndarray:
        return self.joint.cost

    def service_schedules(self) -> np.ndarray:
        """[rows, N, T] per-service level-index schedules (the DP result's
        rows: instance-major, seed-minor)."""
        st = np.asarray(self.joint.r_hist, np.int64)
        S = self.joint.n_seeds
        out = np.zeros((st.shape[0], self.sfleet.N, st.shape[1]), np.int64)
        for row in range(st.shape[0]):
            states = self.sfleet.sets[row // S].joint_states()
            out[row] = states[st[row]].T
        return out


def offline_opt_services(sfleet: ServiceFleet, *, scenario: Scenario,
                         device=None, **kwargs) -> ServiceOfflineResult:
    """The joint capacity-respecting OPT: the unchanged fleet DP
    (``offline_opt_fleet``, materialised or checkpointed, chunked or
    streamed) over the joint-state grid, driven by the joint scenario;
    every keyword passes through.  Infeasible level combinations are not
    states, so the capacity costs nothing to enforce.  The grid's J must
    be at most ``kernels.hosting.DP_MAX_K`` (32) on the card."""
    dev = resolve_device(device)
    res = offline_opt_fleet(sfleet.joint_fleet(dev),
                            scenario=joint_scenario(sfleet, scenario),
                            device=dev, **kwargs)
    return ServiceOfflineResult(joint=res, sfleet=sfleet)


def offline_opt_per_service(sfleet: ServiceFleet, *, scenario: Scenario,
                            device=None, **kwargs) -> FleetOfflineResult:
    """The capacity-oblivious per-service OPT: ``offline_opt_fleet`` on
    the independent lanes.  Summed over the services it bounds the joint
    optimum from below, and equals it where the capacity never binds."""
    return offline_opt_fleet(sfleet.lane_fleet(device),
                             scenario=service_scenario(sfleet, scenario),
                             device=device, **kwargs)

"""Policy interface for the slotted hosting simulator (the port of
``repro/core/policies/base.py``).

An online policy is a pair of plain functions over a dict of [R]-leading
tensors (one row per fleet instance; the reference vmapped a per-instance
pair):

    state0 = init_fn(params)
    state' = step_fn(params, state, obs)

``obs = SlotObs(x, c, svc, side)`` carries this slot's arrivals [R], rent
[R], per-level service cost [R, K] and side channel [R].  ``state["r"]`` is
the [R] int32 index of the level each row holds during the next slot.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch


class SlotObs(NamedTuple):
    x: torch.Tensor                       # [R] int32 arrivals this slot
    c: torch.Tensor                       # [R] float32 rent this slot
    svc: torch.Tensor                     # [R, K] service cost per level
    side: Optional[torch.Tensor] = None   # [R] int32 side info


State = Dict[str, Any]


def freeze_invalid(valid, new_state: State, old_state: State) -> State:
    """The mixed-horizon masking rule: ``new_state`` on rows whose slot is
    valid, the unchanged ``old_state`` past the row's own horizon.  On valid
    rows ``torch.where`` selects, so a uniform-horizon run is unchanged."""
    out = {}
    for k, n in new_state.items():
        v = valid.reshape(valid.shape + (1,) * (n.dim() - 1))
        out[k] = torch.where(v, n, old_state[k])
    return out


class PolicyFns(NamedTuple):
    """A policy in pure-function form: ``params`` carry a leading [R] axis."""

    name: str
    init_fn: Callable[[Any], State]
    step_fn: Callable[[Any, State, SlotObs], State]
    params: Any


class PolicyLane(NamedTuple):
    """ONE entry of ``run_fleet``'s policy fan-out axis.

    ``grid=None`` means the lane runs on the fleet's own grid.  A lane with
    its own grid (same B, its own K / levels / g -- e.g.
    ``grid.restrict_to_endpoints()`` for RR) prices Model-1 service
    ``g_lane * x`` from its own g row; under a Model-2 scenario it must
    carry ``svc_cols``, a [B, K_lane] int map of its levels' columns in the
    service slab generated once on the fleet grid (coupled uniforms make
    the gathered columns bitwise the lane grid's own draws; kernels S and D
    gather them themselves)."""

    fns: PolicyFns
    grid: Optional[Any] = None       # HostingGrid; None -> fleet.grid
    svc_cols: Optional[Any] = None   # [B, K_lane] columns into fleet svc

    @property
    def name(self) -> str:
        return self.fns.name


def as_policy_lanes(policy) -> Optional[Tuple[PolicyLane, ...]]:
    """``None`` for a single ``PolicyFns`` (the classic path); otherwise the
    normalised tuple of ``PolicyLane`` entries of a fan-out request."""
    if isinstance(policy, PolicyFns):
        return None
    if isinstance(policy, PolicyLane):
        return (policy,)
    lanes = []
    for entry in policy:
        if isinstance(entry, PolicyLane):
            lanes.append(entry)
        elif isinstance(entry, PolicyFns):
            lanes.append(PolicyLane(entry))
        else:
            raise TypeError(f"fan-out entries must be PolicyFns or "
                            f"PolicyLane, got {type(entry).__name__}")
    if not lanes:
        raise ValueError("policy fan-out needs at least one lane")
    return tuple(lanes)


class OnlinePolicy:
    """Thin class wrapper over a pure ``(init_fn, step_fn)`` pair for ONE
    instance (the port of ``repro/core/policies/base.py:OnlinePolicy``).

    Subclasses set ``init_fn`` / ``step_fn`` as staticmethods and define
    ``params_on(device)``, the params built from ``self.costs`` on a device
    (None: the card, as every entry point resolves it): in the port one
    instance is a one-row grid, so params and state carry a leading [1]
    axis."""

    init_fn: Optional[Callable[[Any], State]] = None
    step_fn: Optional[Callable[[Any, State, SlotObs], State]] = None

    def __init__(self, costs):
        self.costs = costs

    @property
    def name(self) -> str:
        return type(self).__name__

    def params_on(self, device=None) -> Any:
        """Tensors parameterising the pure pair for ``self.costs``."""
        raise NotImplementedError

    @property
    def params(self) -> Any:
        """``params_on`` the default device (the card)."""
        return self.params_on()

    def fns(self, device=None) -> PolicyFns:
        """This policy as a ``PolicyFns``, its params on ``device``."""
        cls = type(self)
        return PolicyFns(self.name, cls.init_fn, cls.step_fn,
                         self.params_on(device))

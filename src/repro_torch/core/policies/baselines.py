"""Baseline policies: ``StaticPolicy`` (the port of the static part of
``repro/core/policies/baselines.py``).  The MDP and ABC tables come with the
policy slice (ROADMAP.md, Queue 1 item 4)."""
from __future__ import annotations

import torch

from repro_torch.core.costs import HostingGrid
from repro_torch.core.policies.base import PolicyFns, SlotObs, State


def static_init(params) -> State:
    # slot 1 starts at level 0 (service not hosted); the target level is
    # taken at the first decision point
    return {"r": torch.zeros_like(params["level_idx"])}


def static_step(params, state: State, obs: SlotObs) -> State:
    return {"r": params["level_idx"]}


class StaticPolicy:
    """Hold one level forever (never / always-partial / always-full)."""

    @classmethod
    def batch(cls, grid: HostingGrid, level_idx) -> PolicyFns:
        """``level_idx`` is a scalar or a [B] tensor of target levels (e.g.
        ``grid.top_index()`` for always-full on mixed-K grids)."""
        idx = torch.as_tensor(level_idx, dtype=torch.int32,
                              device=grid.device).expand(grid.B).clone()
        return PolicyFns("static", static_init, static_step,
                         {"level_idx": idx})

    @classmethod
    def fleet(cls, fleet, level_idx) -> PolicyFns:
        return cls.batch(fleet.grid, level_idx)

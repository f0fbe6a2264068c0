"""HostingController: alpha-RR driving a serving runtime (the port of
``repro/core/hosting_controller.py``).

Each scheduler slot the controller observes (request count, spot rent,
realised per-level service costs), advances the policy one step and returns
the level the engine must host for the next slot.  It accounts fetch, rent
and service cost as eq. (1), in numpy float64 as the reference does.  The
policy runs as a one-row grid (its params and state carry a leading [1]
axis); ``state_dict`` stores the state without that axis, in the
reference's checkpoint layout.

The step rounds as the reference's controller does.  That controller calls
alpha-RR's step outside any ``jit``, so every ``jnp`` op rounds on its own:
``c * lv + svc`` and the margins ``M * |lv - lv_r| + S`` are two roundings
each, where the fused fleet scan (and kernel S) contracts them into one
FMA.  So an alpha-RR policy steps here with ``alpha_rr_step_eager``; on a
near tie the two can choose different levels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.costs import HostingCosts
from repro_torch.core.policies.alpha_rr import (AlphaRR, alpha_rr_step,
                                                alpha_rr_step_eager)
from repro_torch.core.policies.base import SlotObs

# the eager-rounding counterpart of a fused step, where they differ
_EAGER_STEP = {alpha_rr_step: alpha_rr_step_eager}


@dataclasses.dataclass
class SlotRecord:
    slot: int
    level_idx: int
    level: float
    x: int
    rent: float
    service: float
    fetch: float

    @property
    def total(self) -> float:
        return self.rent + self.service + self.fetch


class HostingController:
    def __init__(self, costs: HostingCosts, policy_cls=AlphaRR, device=None):
        self.device = resolve_device(device)
        self.policy = policy_cls(costs)
        # all accounting uses the POLICY's own level grid (RetroRenting
        # rebuilds a 2-level instance)
        self.costs = self.policy.costs
        fns = self.policy.fns(self.device)
        self._params = fns.params
        self._step = _EAGER_STEP.get(fns.step_fn, fns.step_fn)
        self.state = fns.init_fn(self._params)
        self.slot = 0
        self.records: list[SlotRecord] = []

    @property
    def level_idx(self) -> int:
        return int(self.state["r"][0])

    @property
    def level(self) -> float:
        return float(self.costs.levels[self.level_idx])

    def step(self, x_t: int, c_t: float,
             svc_t: Optional[np.ndarray] = None) -> int:
        """Advance one slot.  ``svc_t`` is the realised per-level service
        cost vector (Model 2); None uses the deterministic Model-1 costs.
        Returns the level index to host for the NEXT slot."""
        lv = np.asarray(self.costs.levels)
        g = np.asarray(self.costs.g)
        if svc_t is None:
            svc_t = g * float(x_t)
        svc_t = np.asarray(svc_t, np.float32)
        if svc_t.shape[0] != self.costs.K:
            raise ValueError(f"svc vector has {svc_t.shape[0]} levels, policy "
                             f"uses {self.costs.K} (pass costs matching the "
                             f"policy's grid)")
        r_prev = self.level_idx
        dev = self.device
        obs = SlotObs(torch.tensor([x_t], dtype=torch.int32, device=dev),
                      torch.tensor([c_t], dtype=torch.float32, device=dev),
                      torch.from_numpy(svc_t[None]).to(dev),
                      torch.zeros((1,), dtype=torch.int32, device=dev))
        self.state = self._step(self._params, self.state, obs)
        r_next = self.level_idx
        fetch = self.costs.M * max(lv[r_next] - lv[r_prev], 0.0)
        self.records.append(SlotRecord(
            slot=self.slot, level_idx=r_prev, level=float(lv[r_prev]),
            x=int(x_t), rent=float(c_t * lv[r_prev]),
            service=float(svc_t[r_prev]), fetch=float(fetch)))
        self.slot += 1
        return r_next

    # ---- accounting ---------------------------------------------------
    def total_cost(self) -> float:
        return float(sum(r.total for r in self.records))

    def cost_breakdown(self) -> Dict[str, float]:
        return {
            "fetch": float(sum(r.fetch for r in self.records)),
            "rent": float(sum(r.rent for r in self.records)),
            "service": float(sum(r.service for r in self.records)),
            "total": self.total_cost(),
        }

    def level_histogram(self) -> np.ndarray:
        h = np.zeros(self.costs.K, np.int64)
        for r in self.records:
            h[r.level_idx] += 1
        return h

    # ---- checkpointing (fault tolerance) -------------------------------
    def state_dict(self) -> Dict:
        return {
            "slot": self.slot,
            "policy_state": {k: v[0].cpu().numpy()
                             for k, v in self.state.items()},
            "records": [(r.slot, r.level_idx, r.level, r.x, r.rent, r.service,
                         r.fetch) for r in self.records],
        }

    def load_state_dict(self, sd: Dict):
        self.slot = int(sd["slot"])
        self.state = {k: torch.as_tensor(np.asarray(v),
                                         device=self.device)[None]
                      for k, v in sd["policy_state"].items()}
        self.records = [SlotRecord(*row) for row in sd["records"]]

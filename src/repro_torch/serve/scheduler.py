"""Slot-based request scheduler (the port of ``repro/serve/scheduler.py``):
arrivals + spot rents + the ``HostingController`` (alpha-RR) + the
``ServingEngine`` in the paper's edge-hosting loop, for ONE instance.

The numpy ``rng`` is drawn in the reference's order (prompts, then the
Model-2 coins), so one seed gives the same prompts and coins in both.  As
in the reference, prompt tokens are drawn from the *tiny* config's
vocabulary whatever config the engine serves.  ``LiveFleetScheduler``
waits for the fleet stepper (ROADMAP.md Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ArchSpec
from repro_torch.core.costs import HostingCosts
from repro_torch.core.hosting_controller import HostingController
from repro_torch.core.policies.alpha_rr import AlphaRR
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.partial import make_plans


@dataclasses.dataclass
class EdgeServingReport:
    total_cost: float
    breakdown: Dict[str, float]
    level_histogram: np.ndarray
    served_edge: int
    served_partial: int
    forwarded: int
    n_requests: int
    n_slots: int

    def summary(self) -> str:
        h = self.level_histogram
        return (f"slots={self.n_slots} requests={self.n_requests} "
                f"edge={self.served_edge} partial={self.served_partial} "
                f"cloud={self.forwarded} | cost={self.total_cost:.2f} "
                f"(fetch={self.breakdown['fetch']:.2f} rent={self.breakdown['rent']:.2f} "
                f"svc={self.breakdown['service']:.2f}) | slots@level={h.tolist()}")


class EdgeServingScheduler:
    """One slot = one batched prefill opportunity.  The engine executes,
    the controller (alpha-RR) re-plans; a fetch switches the active plan at
    once and the controller accounts its cost.  The controller runs on the
    engine's device."""

    def __init__(self, spec: ArchSpec, M: float, alpha: Optional[float] = None,
                 policy_cls=AlphaRR, seed: int = 0,
                 engine: ServingEngine = None, use_model2: bool = None):
        self.spec = spec
        self.engine = engine or ServingEngine(spec)
        self.plans, g_alpha = make_plans(spec, alpha, model_cfg=self.engine.cfg)
        alpha = [l for l in self.plans if 0.0 < l < 1.0][0]
        self.costs = HostingCosts.three_level(M=M, alpha=alpha, g_alpha=g_alpha)
        self.controller = HostingController(self.costs, policy_cls,
                                            device=self.engine.device)
        self.rng = np.random.default_rng(seed)
        self.use_model2 = (use_model2 if use_model2 is not None
                           else spec.partial_plan == "expert_subset")
        self.stats = {"edge": 0, "partial": 0, "cloud": 0, "requests": 0}

    def _prompts(self, n: int, seq: int = 8) -> Optional[np.ndarray]:
        if n == 0:
            return None
        return self.rng.integers(0, self.spec.tiny.vocab_size, size=(n, seq))

    def run(self, arrivals: np.ndarray, rents: np.ndarray,
            run_model: bool = True) -> EdgeServingReport:
        assert len(arrivals) == len(rents)
        for x_t, c_t in zip(arrivals, rents):
            lv = self.controller.level          # policy's own level value
            plan = self.plans[min(self.plans, key=lambda l: abs(l - lv))]
            x_t = int(x_t)
            if run_model:
                res = self.engine.serve_slot(self._prompts(x_t), plan, self.rng)
                self.stats["edge"] += res.served_edge
                self.stats["partial"] += res.served_partial
                self.stats["cloud"] += res.forwarded
                self.stats["requests"] += res.n_requests
                realized = res.service_cost
            else:
                realized = None
            # realised per-level service costs for the controller's
            # retrospection (coupled across levels, Model 2) or Model-1 g*x
            if self.use_model2:
                u = self.rng.random(max(x_t, 1))[:x_t]
                svc = np.array([float(np.sum(u < gk))
                                for gk in self.controller.costs.g])
                if realized is not None and plan.kind == "expert_subset":
                    svc[self.controller.level_idx] = realized
            else:
                svc = None
            self.controller.step(x_t, float(c_t), svc)
        br = self.controller.cost_breakdown()
        return EdgeServingReport(
            total_cost=br["total"], breakdown=br,
            level_histogram=self.controller.level_histogram(),
            served_edge=self.stats["edge"], served_partial=self.stats["partial"],
            forwarded=self.stats["cloud"], n_requests=self.stats["requests"],
            n_slots=len(arrivals))

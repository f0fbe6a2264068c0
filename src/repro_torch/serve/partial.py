"""Partial-hosting plans (the port of ``repro/serve/partial.py``): how a
hosting level r in {0, alpha, 1} is realised for an architecture.

Model 1 (layer_prefix): host the first round(alpha * n_segments) segments
+ the LM head; the edge produces an early-exit draft; the cloud completes.
g(alpha) is the residual value fraction the cloud must still provide.

Model 2 (expert_subset) waits for the MoE slice (ROADMAP.md Queue 1
item 13): its bytes fraction needs the MoE parameter tree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import ArchSpec


@dataclasses.dataclass(frozen=True)
class HostingPlan:
    level: float                      # fraction of the service hosted
    kind: str                         # none | layer_prefix | expert_subset | full
    n_segments: Optional[int] = None  # layer_prefix: segments resident
    expert_mask: Optional[np.ndarray] = None   # expert_subset: [E] 0/1
    bytes_fraction: float = 0.0       # actual fraction of weight bytes resident
    g_value: float = 1.0              # service cost per request at this level


def make_plans(spec: ArchSpec, alpha: Optional[float] = None,
               model_cfg=None):
    """Returns ``({0.0: none-plan, alpha: partial-plan, 1.0: full-plan},
    g(alpha))``.  ``model_cfg`` overrides ``spec.model`` (e.g. the engine
    serves the reduced config).  The reference's Model-2 arguments
    (``popularity``, ``top_k_samples``, ``seed``) come with the MoE
    slice."""
    alpha = alpha if alpha is not None else spec.alpha_default
    cfg = model_cfg if model_cfg is not None else spec.model
    plans = {0.0: HostingPlan(level=0.0, kind="none", g_value=1.0),
             1.0: HostingPlan(level=1.0, kind="full", bytes_fraction=1.0,
                              g_value=0.0)}
    if spec.partial_plan == "expert_subset" and cfg.n_routed_experts:
        raise NotImplementedError(
            "expert_subset plans wait for the MoE slice (ROADMAP.md Queue 1 "
            "item 13)")
    n_seg = max(1, int(round(alpha * len(cfg.segments))))
    g_alpha = spec.g_alpha_default
    plans[alpha] = HostingPlan(level=alpha, kind="layer_prefix",
                               n_segments=n_seg, bytes_fraction=alpha,
                               g_value=g_alpha)
    return plans, g_alpha

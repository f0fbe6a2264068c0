"""Plan-aware serving engine (the port of ``repro/serve/engine.py``).

The engine owns the model parameters and executes whichever
``HostingPlan`` the controller has made resident:

  * none          -> every request is forwarded (cloud serves; cost 1/req)
  * layer_prefix  -> run the resident segment prefix + LM head (early-exit
                     draft); the cloud completes the residual (cost g(a)/req)
  * full          -> everything served at the edge (cost 0/req)

(``expert_subset`` waits for the MoE slice, ROADMAP.md Queue 1 item 13.)
Serving a batch is one eager prefill ``forward`` and the argmax of the last
position's logits; on the card attention runs kernel F and every Mamba2
layer kernel M.  Only the last position is unembedded: the reference
computes the logits of every position and keeps the last.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import (check_ported, forward,
                                            init_params, logits_fn)
from repro_torch.serve.partial import HostingPlan


@dataclasses.dataclass
class SlotServiceResult:
    n_requests: int
    served_edge: int          # fully served at the edge
    served_partial: int       # draft at edge, completed by cloud
    forwarded: int            # fully cloud-served
    service_cost: float       # the paper's C_S for this slot
    edge_tokens: np.ndarray | None = None


class ServingEngine:
    """``params`` default to a random init drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 when None).  ``device`` is the
    card unless the caller passes ``"cpu"``."""

    def __init__(self, spec: ArchSpec, params=None, generator=None,
                 use_tiny: bool = True, device=None):
        self.spec = spec
        self.cfg = spec.tiny if use_tiny else spec.model
        check_ported(self.cfg)
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = init_params(self.cfg, generator, self.device)
        self.params = params
        #: fp32 logits of the last position of the last batch served
        self.last_logits: Optional[torch.Tensor] = None

    # ---- model execution ------------------------------------------------
    def _run_batch(self, prompts: np.ndarray, plan: HostingPlan):
        if plan.expert_mask is not None:
            raise NotImplementedError("expert masks wait for the MoE slice "
                                      "(ROADMAP.md Queue 1 item 13)")
        n_seg = plan.n_segments if plan.kind == "layer_prefix" else None
        with torch.inference_mode():
            tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                     device=self.device)
            hidden, _, _ = forward(self.params, self.cfg, {"tokens": tokens},
                                   n_segments=n_seg)
            self.last_logits = logits_fn(self.params, self.cfg,
                                         hidden[:, -1])
            return self.last_logits.argmax(dim=-1).cpu().numpy()

    # ---- the slot-level service contract --------------------------------
    def serve_slot(self, prompts: Optional[np.ndarray], plan: HostingPlan,
                   rng: np.random.Generator) -> SlotServiceResult:
        """Serve one scheduler slot's batch under ``plan`` and account the
        paper's service cost."""
        n = 0 if prompts is None else len(prompts)
        if n == 0:
            return SlotServiceResult(0, 0, 0, 0, 0.0)
        if plan.kind == "none":
            return SlotServiceResult(n, 0, 0, n, float(n))
        if plan.kind == "full":
            toks = self._run_batch(prompts, plan)
            return SlotServiceResult(n, n, 0, 0, 0.0, toks)
        if plan.kind == "layer_prefix":
            toks = self._run_batch(prompts, plan)   # early-exit draft
            # Model 1: every request gets a partial answer now; the residual
            # value g(a) per request comes from the cloud
            return SlotServiceResult(n, 0, n, 0, plan.g_value * n, toks)
        if plan.kind == "expert_subset":
            raise NotImplementedError("expert_subset plans wait for the MoE "
                                      "slice (ROADMAP.md Queue 1 item 13)")
        raise ValueError(plan.kind)

    # ---- fleet-level grouped serving ------------------------------------
    def serve_groups(self, groups, rng: np.random.Generator
                     ) -> List[SlotServiceResult]:
        """Serve ``[(plan, prompts), ...]`` (one concatenated batch per
        resident plan); one ``SlotServiceResult`` per group, in order."""
        return [self.serve_slot(prompts, plan, rng)
                for plan, prompts in groups]

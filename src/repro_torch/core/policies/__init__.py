"""Online and offline hosting policies (the port of ``repro.core.policies``)."""
from repro_torch.core.policies.alpha_rr import (AlphaRR, RetroRenting,
                                                alpha_rr_grid_params,
                                                alpha_rr_hosting,
                                                alpha_rr_init,
                                                alpha_rr_literal,
                                                alpha_rr_params,
                                                alpha_rr_step,
                                                alpha_rr_step_eager)
from repro_torch.core.policies.base import (OnlinePolicy, PolicyFns,
                                            PolicyLane, SlotObs,
                                            as_policy_lanes, freeze_invalid)
from repro_torch.core.policies.baselines import (ABCPolicy, MDPPolicy,
                                                 StaticPolicy, abc_step,
                                                 mdp_step, solve_abc,
                                                 solve_mdp, static_init,
                                                 static_step, table_init)

__all__ = [
    "AlphaRR", "RetroRenting", "alpha_rr_grid_params", "alpha_rr_hosting",
    "alpha_rr_init",
    "alpha_rr_literal", "alpha_rr_params", "alpha_rr_step",
    "alpha_rr_step_eager", "OnlinePolicy", "PolicyFns", "PolicyLane",
    "SlotObs", "as_policy_lanes", "freeze_invalid", "StaticPolicy",
    "MDPPolicy", "ABCPolicy", "solve_mdp", "solve_abc", "static_init",
    "static_step", "table_init", "mdp_step", "abc_step",
]

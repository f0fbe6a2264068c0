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
# last: offline_opt imports the simulator, which imports the modules above.
# Unlike the reference, the function offline_opt is not re-exported: it
# would shadow the module of the same name (repro_torch.core.policies.
# offline_opt), which callers import from this package.
from repro_torch.core.policies.offline_opt import (BatchOfflineResult,
                                                   OfflineResult,
                                                   brute_force_opt,
                                                   offline_opt_batch,
                                                   offline_opt_no_partial)

__all__ = [
    "AlphaRR", "RetroRenting", "alpha_rr_grid_params", "alpha_rr_hosting",
    "alpha_rr_init",
    "alpha_rr_literal", "alpha_rr_params", "alpha_rr_step",
    "alpha_rr_step_eager", "OnlinePolicy", "PolicyFns", "PolicyLane",
    "SlotObs", "as_policy_lanes", "freeze_invalid", "StaticPolicy",
    "MDPPolicy", "ABCPolicy", "solve_mdp", "solve_abc", "static_init",
    "static_step", "table_init", "mdp_step", "abc_step",
    "offline_opt_batch", "offline_opt_no_partial",
    "brute_force_opt", "OfflineResult", "BatchOfflineResult",
]

"""The paper's hosting engine in PyTorch (the port of ``repro.core``):
cost model, counter-keyed scenarios, policies, the per-slot simulator, the
offline DP and the fleet drivers."""
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.simulator import (SimResult, evaluate_schedule,
                                        model2_service_matrix, run_policy)
from repro_torch.core.fleet import (FleetBatch, FleetOfflineResult,
                                    FleetResult, evaluate_schedule_fleet,
                                    mc_stats, mc_summary, offline_opt_fleet,
                                    run_fleet)
from repro_torch.core import arrivals, bounds, gcurve, rentcosts

__all__ = [
    "HostingCosts", "HostingGrid", "run_policy", "evaluate_schedule",
    "SimResult", "model2_service_matrix", "FleetBatch", "FleetOfflineResult",
    "FleetResult", "evaluate_schedule_fleet", "mc_stats", "mc_summary",
    "offline_opt_fleet", "run_fleet", "arrivals", "rentcosts", "bounds",
    "gcurve",
]

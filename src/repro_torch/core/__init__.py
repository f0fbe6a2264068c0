"""The paper's hosting engine in PyTorch (the port of ``repro.core``):
cost model, counter-keyed scenarios, policies, the per-slot simulator, the
offline DP and the fleet drivers."""
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.fleet import (FleetBatch, FleetOfflineResult,
                                    FleetResult, evaluate_schedule_fleet,
                                    mc_stats, mc_summary, offline_opt_fleet,
                                    run_fleet)

__all__ = [
    "HostingCosts", "HostingGrid", "FleetBatch", "FleetOfflineResult",
    "FleetResult", "evaluate_schedule_fleet", "mc_stats", "mc_summary",
    "offline_opt_fleet", "run_fleet",
]

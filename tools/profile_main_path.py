#!/usr/bin/env python3
"""Where the time of the port's main paths goes on one CUDA card.

    python3 tools/profile_main_path.py [--T 16384]
        [--path fleet|figures|serving|composed|both] [--only FIGURE ...]

Fleet path: the ``chip_smoke.py`` workload at full width (4,096 rows, K = 3,
chunks of 4,096) for a shorter horizon under ``torch.profiler``: alpha-RR
and alpha-OPT on Bernoulli arrivals + uniform rents, and alpha-RR on
Gilbert-Elliot arrivals + NA rents; the device time is also grouped into
kernels D (fused, and on a finished w), S, P (the stream kernels and
the GE chain kernel) and the rest.

Figures: each of the port's figure modules (``repro_torch/figures``) at
its default size, one ``run()`` (the figure's warm-up fan-out and its timed
fan-out), the fan-out of ``chip_smoke.py``'s phase 8 (alpha-RR and RR
lanes with the OPT frontiers over Bernoulli arrivals and spot rents, 4,096
rows), its Model-2 leg (phase 9: Poisson arrivals, spot rents, Model-2
service, RR gathering its endpoint columns) and its Markov leg (phase 10:
GE-Poisson arrivals at 200 / 10, spot rents, service at 260 requests a
slot; the alpha-RR / RR fan-out, then MDP and ABC) at horizon T; the
device time is grouped as for the fleet path, the ARMA, Poisson and
service kernels each on their own.  ``--only`` names the figure modules
(``chip_smoke.FIGURES``' keys) to profile, without the legs.

Composed leg (``--path composed``): ``chip_smoke.py``'s phase 13 at
horizon T, the alpha-RR / RR fan-out and the OPT with its backtracked
schedule over the weighted mixture of arrivals and the regime-switched
rents; grouped as the fleet path, kernels B and E and the shaped uniform
each on their own.

Serving path: zamba2-1.2b at full width and depth in bf16 (seeded random
weights), one ``serve_slot`` of 8 prompts of 2,048 tokens under the full
plan and under the layer-prefix plan, each after a warm-up; the device time
is also grouped into kernel F, kernel M, matrix products and the rest.

For each run it prints the wall time, the summed device time of all kernels
(their busy share of the wall time; these runs use one stream) and the
costliest device operations.  The profiler's own overhead is in the wall
time; compare shares, not absolute seconds, with chip_smoke.py.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import (FleetBatch, HostingGrid,  # noqa: E402
                              offline_opt_fleet, run_fleet)
from repro_torch.core.policies import (ABCPolicy, AlphaRR,  # noqa: E402
                                       MDPPolicy, RetroRenting)


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# device kernels by group, name fragments: the serving path's and the
# fleet path's
SERVING_GROUPS = (
    ("kernel F (wgmma)", ("flash_fwd_wgmma_kernel",)),
    ("kernel F (fma)", ("flash_fwd_fma_kernel",)),
    ("kernel M (mma)", ("ssd_scan_mma_kernel",)),
    ("kernel M (fma)", ("ssd_scan_fma_kernel",)),
    ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "cublas")))
FLEET_GROUPS = (
    ("kernel D (fused cost assembly)", ("dp_fwd_kernel",)),
    ("kernel D (finished w)", ("dp_minplus_kernel",)),
    ("kernel S (alpha-RR, table)", ("sim_kernel",)),
    ("kernel P (streams)", ("counter_stream_kernel",)),
    ("kernel P (GE chain)", ("ge_chain_kernel",)),
    ("kernel P (ARMA)", ("arma_rents_kernel",)),
    ("kernel P (Poisson)", ("poisson_kernel",)),
    ("kernel P (Model-2 service)", ("model2_service_kernel",)),
    ("kernel P (shaped uniform)", ("shaped_uniform_kernel",)),
    ("kernel B (backtrack)", ("dp_backtrack_kernel",)),
    ("kernel E (schedule pricing)", ("schedule_kernel",)))


def profiled(label, fn, top=10, groups=()):
    fn()                                      # warm-up (kernel build, caches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if _device_us(e) > 0
               and getattr(e, "device_type", None) is not None
               and "cuda" in str(e.device_type).lower()]
    busy_us = sum(_device_us(e) for e in kernels)
    print(f"\n== {label}: wall {wall:.3f} s, device busy "
          f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f}% of wall)")
    for e in sorted(kernels, key=_device_us, reverse=True)[:top]:
        print(f"   {_device_us(e) / 1e3:10.2f} ms  {e.count:7d} calls  "
              f"{e.key[:90]}")
    if groups:
        left = list(kernels)
        for name, frags in groups:
            mine = [e for e in left
                    if any(f in e.key.lower() for f in frags)]
            left = [e for e in left if e not in mine]
            us = sum(_device_us(e) for e in mine)
            print(f"   group {name}: {us / 1e3:.2f} ms "
                  f"({100 * us / max(busy_us, 1):.1f}% of device time)")
        us = sum(_device_us(e) for e in left)
        print(f"   group the rest (elementwise, copies, the rest): "
              f"{us / 1e3:.2f} ms ({100 * us / max(busy_us, 1):.1f}%)")
    sys.stdout.flush()


def profile_fleet(T, dev):
    B = cs.N_M * cs.N_ALPHA
    grid = cs.fleet_grid(cs.N_M, cs.N_ALPHA, dev)
    fleet = FleetBatch.for_scenario(grid, T)
    kw = dict(chunk_size=cs.CHUNK, n_seeds=cs.N_SEEDS, device=dev)
    bern = cs.bernoulli_uniform(B, dev)
    ge = cs.ge_na(B, dev)
    profiled(f"alpha-RR, bernoulli + uniform, T={T}",
             lambda: run_fleet(AlphaRR.fleet(fleet), fleet, scenario=bern,
                               collect_trace=False, **kw), top=12,
             groups=FLEET_GROUPS)
    profiled(f"alpha-OPT, bernoulli + uniform, T={T}",
             lambda: offline_opt_fleet(fleet, scenario=bern,
                                       checkpointed=True,
                                       collect_schedule=False, **kw),
             top=12, groups=FLEET_GROUPS)
    profiled(f"alpha-RR, GE + NA, T={T}",
             lambda: run_fleet(AlphaRR.fleet(fleet), fleet, scenario=ge,
                               collect_trace=False, **kw), groups=FLEET_GROUPS)


def profile_figures(T, dev, only=None):
    for name, (mod, n_rows, T_fig) in cs.FIGURES.items():
        if only and name not in only:
            continue
        profiled(f"{name} run(), {n_rows} fleet rows, T={T_fig}",
                 lambda: mod.run(device=dev), top=12, groups=FLEET_GROUPS)
    if only:
        return
    fleet = FleetBatch.for_scenario(cs.fleet_grid(cs.N_M, cs.N_ALPHA, dev), T)
    lanes = [AlphaRR.fleet_lane(fleet), RetroRenting.fleet_lane(fleet)]
    sc = cs.bernoulli_spot(fleet.B, dev)
    profiled(f"fan-out alpha-RR + RR with the OPT frontiers, bernoulli + "
             f"spot, T={T}",
             lambda: run_fleet(lanes, fleet, scenario=sc,
                               chunk_size=cs.CHUNK, n_seeds=cs.N_SEEDS,
                               with_opt_forward=True, collect_trace=False,
                               device=dev), top=12, groups=FLEET_GROUPS)
    lanes = [AlphaRR.fleet_lane(fleet, with_svc=True),
             RetroRenting.fleet_lane(fleet, with_svc=True)]
    m2 = cs.model2_scenario(fleet.grid, dev)
    profiled(f"Model-2 fan-out alpha-RR + RR with the OPT frontiers, "
             f"Poisson + spot + service, T={T}",
             lambda: run_fleet(lanes, fleet, scenario=m2,
                               chunk_size=cs.CHUNK, n_seeds=cs.N_SEEDS,
                               with_opt_forward=True, collect_trace=False,
                               device=dev), top=12, groups=FLEET_GROUPS)
    costs, ges, cms = cs.markov_instances(fleet.B)
    fleet = FleetBatch.for_scenario(
        HostingGrid.from_costs(costs, device=dev), T)
    kw = dict(scenario=cs.markov_scenario(fleet.grid, ges, cms, dev),
              chunk_size=cs.CHUNK, n_seeds=cs.N_SEEDS, collect_trace=False,
              device=dev)
    lanes = [AlphaRR.fleet_lane(fleet, with_svc=True),
             RetroRenting.fleet_lane(fleet, with_svc=True)]
    mdp = MDPPolicy.fleet(fleet, costs, ges, cms)
    abc = ABCPolicy.fleet(fleet, costs, ges, cms)
    profiled(f"Markov leg: fan-out alpha-RR + RR, MDP, ABC, GE-Poisson + "
             f"spot + service at {cs.MARKOV_MAX}, T={T}",
             lambda: (run_fleet(lanes, fleet, **kw),
                      run_fleet(mdp, fleet, **kw),
                      run_fleet(abc, fleet, **kw)),
             top=12, groups=FLEET_GROUPS)


def profile_composed(T, dev):
    grid = cs.fleet_grid(cs.N_M, cs.N_ALPHA, dev)
    scen = cs.composed_scenario(cs.COMPOSED_B, dev)
    for name, fn in cs.composed_runs(grid, scen, T, cs.CHUNK, dev).items():
        profiled(f"composed leg: {name}, T={T}", fn, top=12,
                 groups=FLEET_GROUPS)


def profile_serving(dev):
    spec = get_arch("zamba2-1.2b")
    eng = cs.ServingEngine(spec, generator=torch.Generator(dev).manual_seed(0),
                           use_tiny=False, device=dev)
    plans, _ = cs.make_plans(spec, model_cfg=eng.cfg)
    prompts = np.random.default_rng(0).integers(
        0, eng.cfg.vocab_size, (cs.SERVE_B, cs.SERVE_S))
    rng = np.random.default_rng(1)
    for level in (1.0, 0.4):
        plan = plans[level]
        profiled(f"zamba2-1.2b serve_slot {plan.kind}, {cs.SERVE_B} x "
                 f"{cs.SERVE_S} tokens, bf16",
                 lambda: eng.serve_slot(prompts, plan, rng), top=15,
                 groups=SERVING_GROUPS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--T", type=int, default=16384)
    ap.add_argument("--path", choices=("fleet", "figures", "serving",
                                       "composed", "both"), default="both")
    ap.add_argument("--only", nargs="*", choices=tuple(cs.FIGURES),
                    help="with --path figures: these figure modules only, "
                         "none of the fan-out legs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA card available", file=sys.stderr)
        return 2
    dev = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(torch.cuda.get_device_name(0), "|", smi, "| torch",
          torch.__version__, flush=True)
    if args.path in ("fleet", "both"):
        profile_fleet(args.T, dev)
    if args.path == "figures":
        profile_figures(args.T, dev, args.only)
    if args.path == "composed":
        profile_composed(args.T, dev)
    if args.path in ("serving", "both"):
        profile_serving(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

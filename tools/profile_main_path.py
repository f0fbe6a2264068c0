#!/usr/bin/env python3
"""Where the time of the port's main path goes on one CUDA card.

    python3 tools/profile_main_path.py [--T 16384]

Runs the ``chip_smoke.py`` workload at full width (4,096 rows, K = 3,
chunks of 4,096) for a shorter horizon under ``torch.profiler``: alpha-RR
and alpha-OPT on Bernoulli arrivals + uniform rents, and alpha-RR on
Gilbert-Elliot arrivals + NA rents.  For each run it prints the wall time,
the summed device time of all kernels (their busy share of the wall time;
overlapping kernels would count twice, and these runs use one stream) and
the ten costliest device operations.  The profiler's own overhead is in
the wall time; compare shares, not absolute seconds, with chip_smoke.py.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.core import (FleetBatch, offline_opt_fleet,  # noqa: E402
                              run_fleet)
from repro_torch.core.policies import AlphaRR  # noqa: E402


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profiled(label, fn):
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
    for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
        print(f"   {_device_us(e) / 1e3:10.2f} ms  {e.count:7d} calls  "
              f"{e.key[:90]}")
    sys.stdout.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=16384)
    T = ap.parse_args().T
    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA card available", file=sys.stderr)
        return 2
    dev = "cuda"
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    B = cs.N_M * cs.N_ALPHA
    grid = cs.fleet_grid(cs.N_M, cs.N_ALPHA, dev)
    fleet = FleetBatch.for_scenario(grid, T)
    kw = dict(chunk_size=cs.CHUNK, n_seeds=cs.N_SEEDS, device=dev)
    bern = cs.bernoulli_uniform(B, dev)
    ge = cs.ge_na(B, dev)
    profiled(f"alpha-RR, bernoulli + uniform, T={T}",
             lambda: run_fleet(AlphaRR.fleet(fleet), fleet, scenario=bern,
                               collect_trace=False, **kw))
    profiled(f"alpha-OPT, bernoulli + uniform, T={T}",
             lambda: offline_opt_fleet(fleet, scenario=bern,
                                       checkpointed=True,
                                       collect_schedule=False, **kw))
    profiled(f"alpha-RR, GE + NA, T={T}",
             lambda: run_fleet(AlphaRR.fleet(fleet), fleet, scenario=ge,
                               collect_trace=False, **kw))
    return 0


if __name__ == "__main__":
    sys.exit(main())

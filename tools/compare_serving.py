#!/usr/bin/env python3
"""Compare the serving path of several checkouts on one CUDA card.

    python3 tools/compare_serving.py PARENT . . PARENT

Each argument is the root of a checkout (for example a parent commit
unpacked with ``git archive`` into a git-ignored directory).  Each runs in
a process of its own, in the order given, so that alternating the trees
(parent, change, change, parent) spreads the card's and the host's drift
over both.  Per tree: zamba2-1.2b at full width and depth in bf16 (seeded
weights, as ``chip_smoke.py`` builds them), two warm-up ``serve_slot``
calls, then three timed full-plan ``serve_slot`` calls on 8 prompts of
2,048 tokens, then three runs of ``EdgeServingScheduler`` over 60 slots,
then one more under ``torch.profiler``; it prints the walls (s), the
scheduler's ms per slot, and for the profiled run its device busy time,
its kernel launches and its costliest kernels.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path


def measure(root: str) -> str:
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.partial import make_plans
    from repro_torch.serve.scheduler import EdgeServingScheduler

    _build.build_all()
    spec = get_arch("zamba2-1.2b")
    eng = ServingEngine(spec, generator=torch.Generator("cuda").manual_seed(0),
                        use_tiny=False, device="cuda")
    plans, _ = make_plans(spec, model_cfg=eng.cfg)
    prompts = np.random.default_rng(0).integers(0, eng.cfg.vocab_size,
                                                (8, 2048))
    rng = np.random.default_rng(1)
    eng.serve_slot(prompts, plans[1.0], rng)
    eng.serve_slot(prompts, plans[0.4], rng)
    full = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.serve_slot(prompts, plans[1.0], rng)
        torch.cuda.synchronize()
        full.append(time.perf_counter() - t)
    data = np.random.default_rng(2)
    arrivals, rents = data.integers(0, 5, 60), data.uniform(0.5, 2.5, 60)
    sched = []
    for _ in range(3):
        t = time.perf_counter()
        EdgeServingScheduler(spec, M=5.0, engine=eng, seed=0).run(arrivals,
                                                                  rents)
        torch.cuda.synchronize()
        sched.append((time.perf_counter() - t) / 60 * 1e3)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        EdgeServingScheduler(spec, M=5.0, engine=eng, seed=0).run(arrivals,
                                                                  rents)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if "cuda" in str(getattr(e, "device_type", "")).lower()
               and e.device_time_total > 0]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.device_time_total, reverse=True)
    lines = [f"      {e.device_time_total / 1e3:8.2f} ms {e.count:6d} x "
             f"{e.key[:70]}" for e in top[:6]]
    return (f"{root}: serve_slot full s {[round(x, 4) for x in full]} | "
            f"scheduler ms/slot {[round(x, 2) for x in sched]}\n"
            f"   profiled scheduler run: wall {wall:.3f} s, device busy "
            f"{busy:.1f} ms, {sum(e.count for e in kernels)} kernel "
            f"launches\n" + "\n".join(lines))


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(measure(argv[1]), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, __file__, "--one", root]
                             ).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Device: the card's name and power limit; build the CUDA kernels of
   ``src/repro_torch/kernels/csrc/hosting.cu`` with nvcc (build seconds).
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes, bit for bit (``torch.equal``): P (both threefry layouts,
   with and without a salt), D (+inf-padded levels, frozen slots), S
   (alpha-RR on K = 3 and on a mixed K = 5 grid, RR on K = 2).  Kernel times
   are CUDA-event medians after a warm-up.
3. The main path at full width: 1,024 instances (32 M x 32 (alpha, g)) x 4
   seeds = 4,096 rows, T = 65,536, chunks of 4,096: alpha-RR and RR through
   ``run_fleet``, alpha-OPT and OPT through ``offline_opt_fleet``
   (checkpointed, cost only), ``mc_summary`` of each.  Launch counters are
   zeroed just before and read just after; every kernel must have run.
4. A second leg with Gilbert-Elliot arrivals and NA rents, antithetic seeds.
5. Card == CPU: legs 3 and 4 rerun at 64 rows and T = 4,096 on the card and
   on the CPU (the plain versions), compared exactly.

The last three lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import (FleetBatch, HostingCosts, HostingGrid,  # noqa: E402
                              mc_summary, offline_opt_fleet, run_fleet)
from repro_torch.core import scenarios as sc  # noqa: E402
from repro_torch.core.policies import AlphaRR, RetroRenting  # noqa: E402
from repro_torch.core.policies.alpha_rr import alpha_rr_init  # noqa: E402
from repro_torch.core.policies.offline_opt import (dp_fetch_matrix,  # noqa: E402
                                                   dp_frontier0)
from repro_torch.core.simulator import sim_acc0  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import hosting as H  # noqa: E402
from repro_torch.kernels.hosting import fma32  # noqa: E402

N_M, N_ALPHA, N_SEEDS = 32, 32, 4
T_MAIN, T_GE, T_SMALL, CHUNK = 65536, 8192, 4096, 4096
SMALL_INSTANCES = 16
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, the only non-tensor rate listed;
# the kernels' 32-bit integer and compare ops are counted against it, so
# their bound is a lower bound
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
SOURCE = "src/repro_torch/kernels/csrc/hosting.cu"


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=5, warmup=1):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def tree_equal(a, b):
    if isinstance(a, dict):
        return all(tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return all(tree_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a, b)


def nbytes(*tensors):
    """Bytes of the tensors: each input read once, each output written once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def tree_max_abs(a, b):
    if isinstance(a, dict):
        return max(tree_max_abs(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return max(tree_max_abs(x, y) for x, y in zip(a, b))
    if a is None:
        return 0.0
    a, b = a.double(), b.double()
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


# ----------------------------------------------------------------------
# Workload.
# ----------------------------------------------------------------------

def fleet_grid(n_m, n_alpha, device):
    """32 M values log-spaced in [2, 50] x 32 (alpha, g) pairs, alpha in
    [0.1, 0.7], g(alpha) = clip(0.9 - alpha, 0, 1); instance-major over M."""
    costs = [HostingCosts.three_level(float(M), float(a),
                                      float(np.clip(0.9 - a, 0.0, 1.0)))
             for M in np.geomspace(2.0, 50.0, N_M)[:n_m]
             for a in np.linspace(0.1, 0.7, N_ALPHA)[:n_alpha]]
    return HostingGrid.from_costs(costs, device=device)


def bernoulli_uniform(B, device):
    return sc.combine(
        sc.bernoulli_arrivals(sc.prng_key(0, device), 0.35, B, device=device),
        sc.uniform_rents(sc.prng_key(1, device), 0.35, 0.2, B, device=device))


def ge_na(B, device):
    return sc.combine(
        sc.ge_arrivals(sc.prng_key(2, device), 0.3, 0.2, 0.9, 0.2, B,
                       emission="bernoulli", device=device),
        sc.na_rents(sc.prng_key(3, device), 0.35, 0.2, B, device=device))


def run_leg(grid, scenario, T, antithetic, device, label, timings):
    """alpha-RR, RR, alpha-OPT and OPT of one fleet; returns the results."""
    fleet = FleetBatch.for_scenario(grid, T)
    ends = fleet.restrict_to_endpoints()
    kw = dict(scenario=scenario, chunk_size=min(CHUNK, T), n_seeds=N_SEEDS,
              antithetic=antithetic, device=device)
    runs = {
        "alpha-RR": lambda: run_fleet(AlphaRR.fleet(fleet), fleet,
                                      collect_trace=False, **kw),
        "RR": lambda: run_fleet(RetroRenting.fleet(fleet), ends,
                                collect_trace=False, **kw),
        "alpha-OPT": lambda: offline_opt_fleet(
            fleet, checkpointed=True, collect_schedule=False, **kw),
        "OPT": lambda: offline_opt_fleet(
            ends, checkpointed=True, collect_schedule=False, **kw),
    }
    out = {}
    for name, fn in runs.items():
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        timings[f"{label}/{name}"] = time.perf_counter() - t0
    return out


def check_leg(res, T, label):
    """Finite values of the expected shape, OPT below the online policies,
    alpha-OPT below OPT (the endpoint grid is a sub-grid)."""
    R = res["alpha-RR"].total.shape[0]
    tol = 1e-3 * T
    for name, r in res.items():
        v = r.total if hasattr(r, "total") else r.cost
        require(v.shape == (R,) and np.isfinite(v).all(),
                f"{label}: {name} not finite / wrong shape")
    a_rr, rr = res["alpha-RR"].total, res["RR"].total
    a_opt, opt = res["alpha-OPT"].cost, res["OPT"].cost
    require((a_rr >= a_opt - tol).all(), f"{label}: alpha-RR below alpha-OPT")
    require((rr >= opt - tol).all(), f"{label}: RR below OPT")
    require((a_opt <= opt + tol).all(), f"{label}: alpha-OPT above OPT")
    require((res["alpha-RR"].level_slots.sum(1) == T).all(),
            f"{label}: level_slots do not sum to T")
    summ = {name: mc_summary(r) for name, r in res.items()}
    for name, s in summ.items():
        key = "total_mean" if "total_mean" in s else "cost_mean"
        require(s[key].shape == (R // N_SEEDS,)
                and np.isfinite(s[key]).all(), f"{label}: {name} summary")
    return summ


# ----------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ----------------------------------------------------------------------

def kernel_checks(dev):
    """Returns {kernel name: record} with ms, plain_ms, max_abs_err and
    bound numbers at the main path's shapes."""
    R, chunk = N_M * N_ALPHA * N_SEEDS, CHUNK
    grid = fleet_grid(N_M, N_ALPHA, dev).repeat_rows(N_SEEDS)
    scen = sc.replicate_seeds(bernoulli_uniform(N_M * N_ALPHA, dev), N_SEEDS)
    keys = scen.params["arr"]["key"]
    t0 = T_MAIN - chunk
    tids = sc.base.chunk_tids(t0, chunk, dev)
    rec = {}

    # P: both layouts, with and without a salt
    err = 0.0
    for part in (True, False):
        for salt in (None, 1):
            k = H.slot_uniform(keys, tids, salt, part)
            p = H.slot_uniform_plain(keys, tids, salt, part)
            torch.cuda.synchronize()
            require(torch.equal(k, p), f"P differs (layout {part}, "
                                       f"salt {salt})")
            err = max(err, tree_max_abs(k, p))
    ms = cuda_ms(lambda: H.slot_uniform(keys, tids, None, True))
    plain_ms = cuda_ms(lambda: H.slot_uniform_plain(keys, tids, None, True),
                       reps=3)
    # per draw: 2 threefry blocks of 79 32-bit ops (2 xors for the third
    # key word, 2 adds, 20 x (add, rotate, xor) with a rotate one funnel
    # shift, 5 key injections of 3 adds) and 5 for the layout's xor and the
    # bits -> float mapping
    ops = R * chunk * (2 * 79 + 5)
    rec["slot_uniform"] = dict(
        replaces="src/repro/kernels/hosting.py:164", ms=ms, plain_ms=plain_ms,
        max_abs_err=err, ops=ops, nbytes=nbytes(keys, tids, k),
        shape=f"R={R} chunk={chunk} (4 variants compared)")
    log(f"P ok: {ms:.3f} ms, plain {plain_ms:.3f} ms")

    # slab data shared by D and S
    gen = scen.init_fn(scen.params)
    gen, slab = scen.chunk_fn(scen.params, gen, tids)
    x, c = slab.x, slab.c
    g32 = torch.Generator(device="cpu").manual_seed(5)
    T_len = torch.randint(t0, t0 + 2 * chunk, (R,), generator=g32,
                          dtype=torch.int32).to(dev)

    # D: +inf-padded levels (a quarter of the rows mask out a level), rows
    # frozen part-way, some all-+inf frontiers
    K = grid.K
    kmask = grid.mask.clone()
    kmask[::4, 1] = False
    lv32 = grid.levels
    svc = x[:, :, None].float() * grid.g[:, None, :]
    wck = torch.where(kmask[:, None, :],
                      fma32(c[:, :, None], lv32[:, None, :], svc),
                      float("inf"))
    fetch = dp_fetch_matrix(grid.M, lv32)
    valid = tids[None, :] < T_len[:, None]
    J = dp_frontier0(R, K, dev)
    J[1::4] = float("inf")
    J[2::4] = torch.rand((len(range(2, R, 4)), K), generator=g32).to(dev)
    k = H.dp_minplus(J, wck, fetch, valid)
    p = H.dp_minplus_plain(J, wck, fetch, valid)
    torch.cuda.synchronize()
    require(tree_equal(k, p), "D differs from its plain version")
    ms = cuda_ms(lambda: H.dp_minplus(J, wck, fetch, valid))
    plain_ms = cuda_ms(lambda: H.dp_minplus_plain(J, wck, fetch, valid),
                       reps=3)
    # per row and slot: K*K adds, K*(K-1) compares, K adds of w
    ops = R * chunk * (K * K + K * (K - 1) + K)
    rec["dp_minplus"] = dict(
        replaces="src/repro/kernels/hosting.py:116", ms=ms, plain_ms=plain_ms,
        max_abs_err=tree_max_abs(k, p), ops=ops,
        nbytes=nbytes(J, wck, fetch, valid, *k),
        shape=f"R={R} chunk={chunk} K={K}")
    log(f"D ok: {ms:.3f} ms, plain {plain_ms:.3f} ms")

    # S: alpha-RR on K = 3 (timed), a mixed K = 5 grid, RR on K = 2; each
    # from a non-trivial carry (one kernel chunk first)
    mixed = HostingGrid.from_costs(
        [HostingCosts(M=float(m), levels=(0.0, 0.2, 0.45, 0.7, 1.0),
                      g=(1.0, 0.75, 0.5, 0.2, 0.0)) if i % 2 else
         HostingCosts.three_level(float(m), 0.3, 0.6)
         for i, m in enumerate(np.geomspace(2, 50, R))], device=dev)
    cases = [("alpha-RR K=3", AlphaRR.batch(grid), grid),
             ("alpha-RR mixed K=5", AlphaRR.batch(mixed), mixed),
             ("RR K=2", RetroRenting.batch(grid),
              grid.restrict_to_endpoints())]
    err = 0.0
    for name, pol, gg in cases:
        carry = (alpha_rr_init(pol.params), sim_acc0(R, gg.K, dev))
        carry, _ = H.sim_chunk_alpha_rr(pol.params, gg.levels, gg.g, gg.M,
                                        T_len, t0 - chunk, carry, x, c)
        args = (pol.params, gg.levels, gg.g, gg.M, T_len, t0, carry, x, c)
        k = H.sim_chunk_alpha_rr(*args)
        p = H.sim_chunk_alpha_rr_plain(*args)
        torch.cuda.synchronize()
        require(tree_equal(k, p), f"S differs from its plain version ({name})")
        err = max(err, tree_max_abs(k, p))
        if name == "alpha-RR K=3":
            (st, acc), _ = k
            timed_bytes = nbytes(*pol.params.values(), gg.levels, gg.g, gg.M,
                                 T_len, *carry[0].values(),
                                 *carry[1].values(), x, c, *st.values(),
                                 *acc.values())
            ms = cuda_ms(lambda: H.sim_chunk_alpha_rr(*args,
                                                      collect_trace=False))
            plain_ms = cuda_ms(lambda: H.sim_chunk_alpha_rr_plain(
                *args, collect_trace=False), reps=3, warmup=0)
        log(f"S ok: {name}")
    # per row and slot: K products x*g, K FMAs (2 ops), K subtractions,
    # 2K for the suffix minima, 4K for the margins (sub, abs, FMA), K tie
    # adds, K-1 compares, and about 10 for the accounting
    ops = R * chunk * (12 * K + 9)
    rec["sim_chunk_alpha_rr"] = dict(
        replaces="src/repro/core/simulator.py:147", ms=ms,
        plain_ms=plain_ms, max_abs_err=err, ops=ops, nbytes=timed_bytes,
        shape=f"R={R} chunk={chunk} K={K} (3 grids compared)")
    log(f"S timed: {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return rec


# ----------------------------------------------------------------------

DEVICE = "cuda"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    dev = DEVICE
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t:.1f} s "
        f"(nvcc {_build.BUILD_SECONDS.get('hosting')})")

    # phase 2
    rec = kernel_checks(dev)
    log("kernels == plain versions on the card")

    # phase 3: the main path at full width; counters read around it only
    timings = {}
    B = N_M * N_ALPHA
    grid = fleet_grid(N_M, N_ALPHA, dev)
    H.reset_launches()
    main_res = run_leg(grid, bernoulli_uniform(B, dev), T_MAIN, False, dev,
                       "main", timings)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in H.KERNELS}
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched on the main path")
    summ = check_leg(main_res, T_MAIN, "main")
    for name, s in summ.items():
        key = "total_mean" if "total_mean" in s else "cost_mean"
        log(f"main {name}: {timings['main/' + name]:.2f} s; per-slot seed "
            f"means of instances 0..3: "
            f"{np.round(s[key][:4] / T_MAIN, 6).tolist()}")

    # phase 4: GE arrivals, NA rents, antithetic seeds
    ge_res = run_leg(grid, ge_na(B, dev), T_GE, True, dev, "ge", timings)
    summ = check_leg(ge_res, T_GE, "ge")
    for name, s in summ.items():
        key = "total_mean" if "total_mean" in s else "cost_mean"
        log(f"ge {name}: {timings['ge/' + name]:.2f} s; per-slot seed means "
            f"of instances 0..3: {np.round(s[key][:4] / T_GE, 6).tolist()}")

    # phase 5: card == CPU on reduced legs
    for label, make in (("main", bernoulli_uniform), ("ge", ge_na)):
        anti = label == "ge"
        outs = []
        for d in (dev, "cpu"):
            g_small = fleet_grid(1, SMALL_INSTANCES, d)
            outs.append(run_leg(g_small, make(SMALL_INSTANCES, d), T_SMALL,
                                anti, d, f"small-{label}-{d}", timings))
        for name in outs[0]:
            a, b = outs[0][name], outs[1][name]
            for f in ("total", "rent", "service", "fetch", "level_slots",
                      "cost"):
                if hasattr(a, f):
                    require(np.array_equal(getattr(a, f), getattr(b, f)),
                            f"card != CPU: {label} {name} {f}")
        log(f"card == CPU: {label} leg, {N_SEEDS * SMALL_INSTANCES} rows, "
            f"T={T_SMALL} ({timings[f'small-{label}-cpu/alpha-RR']:.1f} s "
            f"alpha-RR on the CPU)")
    log("timings (s): " + json.dumps({k: round(v, 3)
                                      for k, v in timings.items()}))

    kernels = []
    for name, r in rec.items():
        t_bytes = r["nbytes"] / PEAK_BYTES * 1e3
        t_ops = r["ops"] / PEAK_OPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": r["replaces"], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the fleet path's hosting kernels of several checkouts in turns on
one CUDA card.

    python3 tools/compare_hosting.py PARENT . . PARENT
    python3 tools/compare_hosting.py --only "P service,P Poisson" PARENT . . PARENT
    python3 tools/compare_hosting.py --only "S table,DP chunk,S" PARENT . . PARENT
    python3 tools/compare_hosting.py --only "D on a finished w,S wide" PARENT . . PARENT

Each ROOT is the root of a checkout (a ``git archive`` of another commit
unpacked into a git-ignored directory, say).  For each, in the order
given, a fresh process imports that checkout's ``repro_torch`` and times,
at ``chip_smoke.py``'s fleet shapes (4,096 rows, K = 3, a chunk of 4,096
slots of Bernoulli arrivals and uniform rents): kernel S without and with
the trace, the DP chunk as the checkout's fleet runs it (the fused kernel
D where the checkout has it, else the float64 ``fma32`` assembly + kernel
D on the finished w), kernel D on a finished w, kernel P's uniforms, and
one chunk of each of the fleet's four random streams as the checkout's
streams generate it (antithetic seed replicas): Bernoulli arrivals,
uniform rents, NA rents and Gilbert-Elliot arrivals (kernel P's fused
variants where the checkout has them, else kernel P's uniforms and the
PyTorch code after them); where the checkout has them, kernels D and S on
the Model-2 fan-out's slab (Poisson arrivals, spot rents, Model-2
service) for alpha-RR's own columns and RR's endpoint columns, one
chunk of that fan-out's Poisson arrivals (rates cycled over {2, 4, 8})
and one of its Model-2 service (K = 3, 24 requests a slot at most, on
those arrivals; the same at K = 16, and at each K of ``SERVICE_KS``
(evenly spread levels) that the checkout takes);
where the checkout has it, one chunk of kernel P's ARMA rents (the spot
stream, p = 4, q = 2) at the fleet's shape; where the checkout has the
Markov leg, one chunk of its Poisson draws on Hormann's branch (the GE
chain's states at rates 200 / 10, salt 1); where the checkout has them,
kernel B walking back the fused D's own argmin table of that chunk
(``dp_fwd_model1(..., with_args=True)``) and kernel E pricing the
schedule it gives under Model 1 ("B", "E"), each also with its table or
schedule one word off a 16-byte boundary ("B, 4-byte route", "E, 4-byte
route": the redesigned kernels' cp.async route), and E on a schedule of
levels out of range and on horizons that end before the chunk (its
parts: nothing counted; the copies alone); D's ARGS route at the fleet's
shape ("DP chunk, argmin table"), and D with and without the table on
horizons that end before the chunk (its staging and the identity
alone); alpha-RR's S on such horizons ("S, horizons before the
chunk"); where the checkout has S's table variant and the Markov leg,
the table variant on that leg's chunk (``TABLE_TIMINGS``: MDP, ABC and
the static table on its Model-2 slab, with the trace, on horizons
before the chunk, under Model 1) and D's ARGS route on its slab.  Times are
CUDA-event medians of batches of back-to-back calls, each batch queued
behind ~10 ms of ``torch.cuda._sleep`` so that it runs back to back;
beside each, the cycles a slot at the SM clock nvidia-smi reads while
the card runs it.  Last, the host wall of each figure module's ``run()``
at the reference's default size (its warm-up and timed fan-outs, as
``chip_smoke.py`` times it), the median of five after one untimed run.
Also kernel D on a finished w at K = 16 and 32 (random w, every slot
valid) and S's gather route at ``beyond_knapsack_levels``' call and its
parts (``STUDY_TIMINGS``; cycles a slot over its 4,000 slots).
One JSON line per root, then a table.  ``--only`` takes
comma-separated prefixes of the timings' names, times only those and
skips the figure walls.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


# the service draws' level counts timed at the fleet's shape: the static
# instances end at K = 5, the bands of a run-time K start at 6, 9, 17, 25
SERVICE_KS = (3, 4, 5, 6, 7, 8, 9, 12, 16, 17, 24, 25, 31, 32)


def _one(root: Path, only=()) -> dict:
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import scenarios as sc
    from repro_torch.core.policies import AlphaRR, RetroRenting
    from repro_torch.core.policies.alpha_rr import alpha_rr_init
    from repro_torch.core.policies.offline_opt import (dp_fetch_matrix,
                                                       dp_frontier0)
    from repro_torch.core.simulator import sim_acc0
    from repro_torch.kernels import hosting as H

    def ms_and_clock(fn, batch=10, reps=5, slots=None):
        fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)         # ~10 ms at 1,980 MHz
            a.record()
            for _ in range(batch):
                fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / batch)
        ms = float(np.median(times))
        for _ in range(max(20, int(400 / ms))):   # ~0.4 s of work
            fn()
        clock = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.split()[0])
        torch.cuda.synchronize()
        return {"ms": ms, "sm_clock_mhz": clock,
                "cycles_per_slot": ms * 1e-3 * clock * 1e6 / (slots or chunk)}

    def want(name):
        return not only or any(name.startswith(p) for p in only)

    dev, chunk = "cuda", cs.CHUNK
    R = cs.N_M * cs.N_ALPHA * cs.N_SEEDS
    grid = cs.fleet_grid(cs.N_M, cs.N_ALPHA, dev).repeat_rows(cs.N_SEEDS)
    scen = sc.replicate_seeds(cs.bernoulli_uniform(cs.N_M * cs.N_ALPHA, dev),
                              cs.N_SEEDS)
    t0 = cs.T_MAIN - chunk
    tids = sc.base.chunk_tids(t0, chunk, dev)
    _, slab = scen.chunk_fn(scen.params, scen.init_fn(scen.params), tids)
    x, c = slab.x, slab.c
    T_len = torch.full((R,), cs.T_MAIN, dtype=torch.int32, device=dev)
    pol = AlphaRR.batch(grid)
    sim = (pol.params, grid.levels, grid.g, grid.M, T_len, t0,
           (alpha_rr_init(pol.params), sim_acc0(R, grid.K, dev)), x, c)
    lv, fetch = grid.levels, dp_fetch_matrix(grid.M, grid.levels)
    J = dp_frontier0(R, grid.K, dev)
    w = torch.where(grid.mask[:, None, :],
                    H.fma32(c[:, :, None], lv[:, None, :],
                            x[:, :, None].float() * grid.g[:, None, :]),
                    float("inf"))
    valid = tids[None, :] < T_len[:, None]

    def old_route():
        ww = torch.where(grid.mask[:, None, :],
                         H.fma32(c[:, :, None], lv[:, None, :],
                                 x[:, :, None].float() * grid.g[:, None, :]),
                         float("inf"))
        return H.dp_minplus(J, ww, fetch, tids[None, :] < T_len[:, None])

    if hasattr(H, "dp_fwd_model1"):
        fused = (J, c, x, grid.g, lv, grid.mask, fetch, T_len, t0)
        dp_chunk = ("fused kernel D", lambda: H.dp_fwd_model1(*fused))
    else:
        dp_chunk = ("fma32 assembly + kernel D", old_route)
    B, S = cs.N_M * cs.N_ALPHA, cs.N_SEEDS
    key = lambda seed: sc.prng_key(seed, dev)  # noqa: E731
    streams = {
        "P Bernoulli chunk": sc.bernoulli_arrivals(key(0), 0.35, B,
                                                   device=dev),
        "P uniform rents chunk": sc.uniform_rents(key(1), 0.35, 0.2, B,
                                                  device=dev),
        "P NA rents chunk": sc.na_rents(key(3), 0.35, 0.2, B, device=dev),
        "P GE chunk": sc.ge_arrivals(key(2), 0.3, 0.2, 0.9, 0.2, B,
                                     emission="bernoulli", device=dev)}
    stream_ms = {}
    for name, st in streams.items():
        if not want(name):
            continue
        st = sc.replicate_seeds(st, S, antithetic=True)
        state = st.init_fn(st.params)
        slow = name == "P GE chunk" and not hasattr(H, "ge_bernoulli_chunk")
        stream_ms[name] = ms_and_clock(
            lambda st=st, state=state: st.chunk_fn(st.params, state, tids),
            batch=1 if slow else 10, reps=3 if slow else 5)
    timed = {"P uniforms": lambda: ms_and_clock(lambda: H.slot_uniform(
                 scen.params["arr"]["key"], tids)),
             "S": lambda: ms_and_clock(lambda: H.sim_chunk_alpha_rr(
                 *sim, collect_trace=False)),
             "S with trace": lambda: ms_and_clock(
                 lambda: H.sim_chunk_alpha_rr(*sim)),
             "DP chunk": lambda: dict(ms_and_clock(dp_chunk[1], batch=3),
                                      route=dp_chunk[0]),
             "D on a finished w": lambda: ms_and_clock(
                 lambda: H.dp_minplus(J, w, fetch, valid), batch=3)}
    out = {"root": str(root), "card": torch.cuda.get_device_name(0),
           **stream_ms,
           **{name: fn() for name, fn in timed.items() if want(name)}}
    if hasattr(H, "arma_rents_chunk") and want("P ARMA chunk"):
        spot = cs.spot_params(B, dev)
        eps0 = H.normal_chunk(spot["key"], sc.base.chunk_tids(0, 2, dev)
                              .flip(0), spot["sigma"])
        a_args = (spot["key"], tids, torch.zeros((R, 4), device=dev), eps0,
                  spot["phi"], spot["th"], spot["sigma"], spot["mean"],
                  spot["c_min"], spot["c_max"])
        out["P ARMA chunk"] = ms_and_clock(
            lambda: H.arma_rents_chunk(*a_args))
    if hasattr(H, "dp_fwd_model2"):
        m2 = sc.replicate_seeds(
            cs.model2_scenario(cs.fleet_grid(cs.N_M, cs.N_ALPHA, dev), dev),
            cs.N_SEEDS)
        arr = m2.params["arr"]
        if want("P Poisson chunk"):
            out["P Poisson chunk"] = ms_and_clock(
                lambda: H.poisson_chunk(arr["key"], tids, arr["lam"]),
                batch=5)
        sv = m2.params["svc"]
        x_m2 = H.poisson_chunk(arr["key"], tids, arr["lam"])
        if want("P service chunk"):
            out["P service chunk"] = ms_and_clock(
                lambda: H.model2_service_chunk(sv["key"], tids, x_m2,
                                               sv["g"], cs.M2_MAX), batch=5)
            g16 = cs.k16_grid(cs.N_M * cs.N_ALPHA, dev).repeat_rows(
                cs.N_SEEDS).g
            out["P service chunk, K = 16"] = ms_and_clock(
                lambda: H.model2_service_chunk(sv["key"], tids, x_m2, g16,
                                               cs.M2_MAX), batch=5)
            for K in SERVICE_KS:
                if K > getattr(H, "M2_MAX_K", 16):
                    continue
                gk = torch.linspace(1.0, 0.0, K, device=dev).expand(
                    R, K).contiguous()
                out[f"P service chunk, spread K = {K}"] = ms_and_clock(
                    lambda gk=gk: H.model2_service_chunk(
                        sv["key"], tids, x_m2, gk, cs.M2_MAX), batch=3)
        _, sl = m2.chunk_fn(m2.params, m2.init_fn(m2.params), tids)
        for name, lane, cols, P in (
                ("alpha-RR", grid, None, AlphaRR),
                ("RR", grid.restrict_to_endpoints(), grid.endpoint_columns(),
                 RetroRenting)):
            d = (dp_frontier0(R, lane.K, dev), sl.c, sl.svc, lane.levels,
                 lane.mask, dp_fetch_matrix(lane.M, lane.levels), T_len, t0,
                 cols)
            p = P.batch(lane)
            s = (p.params, lane.levels, lane.M, T_len, t0,
                 (alpha_rr_init(p.params), sim_acc0(R, lane.K, dev)), sl.c,
                 sl.svc, cols, True, False)
            if want(f"D on a Model-2 slab, {name}"):
                out[f"D on a Model-2 slab, {name}"] = ms_and_clock(
                    lambda d=d: H.dp_fwd_model2(*d))
            if want(f"S on a Model-2 slab, {name}"):
                out[f"S on a Model-2 slab, {name}"] = ms_and_clock(
                    lambda s=s: H.sim_chunk_alpha_rr_svc(*s))
    if hasattr(cs, "markov_scenario") and want("P Poisson chunk, Hormann"):
        costs, ges, cms = cs.markov_instances(cs.N_M * cs.N_ALPHA)
        mk = sc.replicate_seeds(cs.markov_scenario(
            cs.HostingGrid.from_costs(costs, device=dev), ges, cms, dev),
            cs.N_SEEDS)
        arr = mk.params["arr"]
        _, sl = mk.chunk_fn(mk.params, mk.init_fn(mk.params), tids)
        p_args = (arr["key"], tids, arr["rate_l"], 1, sl.side, arr["rate_h"])
        out["P Poisson chunk, Hormann"] = ms_and_clock(
            lambda: H.poisson_chunk(*p_args), batch=5)
    if hasattr(H, "dp_fwd_model1"):
        # D's ARGS route: the argmin table written besides (the
        # materialised DP's call), and on horizons that end before the
        # chunk (the frozen identity written, no slot walked)
        ahead = fused[:7] + (torch.full_like(T_len, t0), t0)
        for name, a, w in (
                ("DP chunk, argmin table", fused, True),
                ("DP chunk, argmin table, horizons before the chunk", ahead,
                 True),
                ("DP chunk, horizons before the chunk", ahead, False)):
            if want(name):
                out[name] = ms_and_clock(
                    lambda a=a, w=w: H.dp_fwd_model1(*a, w), batch=3)
    if want("S, horizons before the chunk"):
        # alpha-RR's S with no slot in its horizon: its staging alone
        before = sim[:4] + (torch.full_like(T_len, t0),) + sim[5:]
        out["S, horizons before the chunk"] = ms_and_clock(
            lambda: H.sim_chunk_alpha_rr(*before, collect_trace=False))
    if (hasattr(H, "sim_chunk_table_svc") and hasattr(cs, "markov_scenario")
            and any(want(n) for n in TABLE_TIMINGS)):
        out.update(_table_timings(cs, H, dev, t0, tids, T_len, ms_and_clock,
                                  want))
    for K in (16, 32):
        name = f"D on a finished w, K = {K}"
        if want(name):
            out[name] = ms_and_clock(
                lambda K=K: H.dp_minplus(*_finished_w(R, chunk, K, dev)),
                batch=3)
    if any(want(n) for n in STUDY_TIMINGS):
        out.update(_study_timings(cs, H, dev, ms_and_clock, want))
    if hasattr(H, "dp_backtrack") and (want("B") or want("E")):
        J1, args = H.dp_fwd_model1(J, c, x, grid.g, lv, grid.mask, fetch,
                                   T_len, t0, True)
        k = torch.argmin(J1, 1).to(torch.int32)
        r = H.dp_backtrack(k, args)[1]
        sched = (lv, grid.M, T_len, t0,
                 (torch.zeros_like(k), sim_acc0(R, grid.K, dev)))
        # the 4-byte route where the checkout's B and E have one (its
        # inputs one word off 16 bytes)
        routes = [("", args, r)] + ([(", 4-byte route", H.misaligned(args),
                                      H.misaligned(r))]
                                    if hasattr(H, "misaligned") else [])
        for suffix, a, rr in routes:
            if want("B" + suffix):
                out["B" + suffix] = ms_and_clock(
                    lambda a=a: H.dp_backtrack(k, a))
            if want("E" + suffix):
                out["E" + suffix] = ms_and_clock(
                    lambda rr=rr: H.schedule_chunk(*sched, rr, c, x=x,
                                                   g=grid.g))
        # E's parts: no level in range (nothing counted, every term 0), no
        # slot in its horizon (the copies alone)
        r_out = torch.full_like(r, -1)
        before = (lv, grid.M, torch.full_like(T_len, t0)) + sched[3:]
        for name, a in (("E, levels out of range", sched + (r_out,)),
                        ("E, horizons before the chunk", before + (r,))):
            if want(name):
                out[name] = ms_and_clock(
                    lambda a=a: H.schedule_chunk(*a, c, x=x, g=grid.g))
    walls = {}
    for name, entry in ([] if only else cs.FIGURES.items()):
        mod = entry[0]
        mod.run(device=dev)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mod.run(device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        walls[name] = float(np.median(times)) * 1e3
    out["figure walls ms"] = walls
    return out


# S's table variant on the Markov leg's chunk (chip_smoke.markov_scenario:
# 4,096 rows, K = 3, a Model-2 slab of up to 260 requests a slot), MDP
# reading the side channel without the trace unless named otherwise, and
# its parts; D's ARGS route on that leg's slab for alpha-RR's columns
TABLE_TIMINGS = ("S table", "S table, ABC", "S table, static",
                 "S table, with trace", "S table, horizons before the chunk",
                 "S table, Model 1", "S table, Model 1, with trace",
                 "D on a Model-2 slab, argmin table")


def _table_timings(cs, H, dev, t0, tids, T_len, ms_and_clock, want):
    import torch

    from repro_torch.core import scenarios as sc
    from repro_torch.core.policies import ABCPolicy, MDPPolicy
    from repro_torch.core.policies.baselines import static_step, table_form
    from repro_torch.core.policies.offline_opt import (dp_fetch_matrix,
                                                       dp_frontier0)
    from repro_torch.core.simulator import sim_acc0
    costs, ges, cms = cs.markov_instances(cs.N_M * cs.N_ALPHA)
    grid = cs.HostingGrid.from_costs(costs, device=dev)
    scen = sc.replicate_seeds(cs.markov_scenario(grid, ges, cms, dev),
                              cs.N_SEEDS)
    _, sl = scen.chunk_fn(scen.params, scen.init_fn(scen.params), tids)
    rg = grid.repeat_rows(cs.N_SEEDS)
    R, K = rg.levels.shape

    def rep(t):
        return t.repeat_interleave(cs.N_SEEDS, dim=0)

    pols = {}
    for name, P in (("MDP", MDPPolicy), ("ABC", ABCPolicy)):
        p = P.batch(grid, costs, ges, cms)
        pols[name] = table_form(p.step_fn, {k: rep(v) for k, v in
                                            p.params.items()}, K)
    pols["static"] = table_form(static_step, {"level_idx": torch.full(
        (R,), K - 1, dtype=torch.int32, device=dev)}, K)
    r0 = {"r": torch.zeros(R, dtype=torch.int32, device=dev)}

    def svc_args(tab, T, trace):
        return (*tab, rg.levels, rg.M, T, t0, (r0, sim_acc0(R, K, dev)),
                sl.x, sl.c, sl.side, sl.svc, None, True, trace)

    before = torch.full_like(T_len, t0)
    m1 = (*pols["MDP"], rg.levels, rg.g, rg.M, T_len, t0,
          (r0, sim_acc0(R, K, dev)), sl.x, sl.c, sl.side, True)
    calls = {
        "S table": (H.sim_chunk_table_svc, svc_args(pols["MDP"], T_len,
                                                    False)),
        "S table, ABC": (H.sim_chunk_table_svc, svc_args(pols["ABC"], T_len,
                                                         False)),
        "S table, static": (H.sim_chunk_table_svc,
                            svc_args(pols["static"], T_len, False)),
        "S table, with trace": (H.sim_chunk_table_svc,
                                svc_args(pols["MDP"], T_len, True)),
        "S table, horizons before the chunk": (
            H.sim_chunk_table_svc, svc_args(pols["MDP"], before, False)),
        "S table, Model 1": (H.sim_chunk_table, m1 + (False,)),
        "S table, Model 1, with trace": (H.sim_chunk_table, m1 + (True,)),
        "D on a Model-2 slab, argmin table": (
            H.dp_fwd_model2, (dp_frontier0(R, K, dev), sl.c, sl.svc,
                              rg.levels, rg.mask,
                              dp_fetch_matrix(rg.M, rg.levels), T_len, t0,
                              None, True))}
    return {name: ms_and_clock(lambda f=f, a=a: f(*a))
            for name, (f, a) in calls.items() if want(name)}


_FINISHED_W = {}


def _finished_w(R, chunk, K, dev):
    """D's inputs on a finished w at K levels, made once: random w in [0,
    2), the fetch of K evenly spread levels (M = 8), a zero frontier, every
    slot valid."""
    import torch

    from repro_torch.core.policies.offline_opt import dp_fetch_matrix
    if K not in _FINISHED_W:
        _FINISHED_W.clear()
        gen = torch.Generator(device=dev).manual_seed(K)
        lv = torch.linspace(0.0, 1.0, K, device=dev).expand(R, K)
        _FINISHED_W[K] = (
            torch.zeros((R, K), device=dev),
            torch.rand((R, chunk, K), generator=gen, device=dev) * 2,
            dp_fetch_matrix(torch.full((R,), 8.0, device=dev),
                            lv.contiguous()),
            torch.ones((R, chunk), dtype=torch.bool, device=dev))
    return _FINISHED_W[K]


# S's gather route (alpha-RR on a slab of 17 to 32 levels, a lane
# gathering its columns): at beyond_knapsack_levels' own call (its K = 8
# lane of the 31-level union slab, 4 rows x 4,000 slots, with the trace)
# and its parts -- without the trace, on the lane's columns gathered
# beforehand (the bulk route's staging), on horizons that end before the
# chunk (the staging, the cook, the accounting and the trace: no step of
# the policy), the study's lanes of 2, 3, 4 and 6 levels (its 26 lanes: 19
# of 3 levels, one of 2, two each of 4, 6 and 8); at fleet width (a K =
# 3 lane of that slab at 4,096 x 4,096, the Model-2 leg's arrivals at up
# to 24 requests a slot), also on its columns gathered beforehand
STUDY_TIMINGS = ("S wide", "S wide, no trace",
                 "S wide, columns gathered beforehand",
                 "S wide, horizons before the chunk", "S wide, K = 2 lane",
                 "S wide, K = 3 lane", "S wide, K = 4 lane",
                 "S wide, K = 6 lane", "S wide, fleet width",
                 "S wide, fleet width, columns gathered beforehand")


def _study_timings(cs, H, dev, ms_and_clock, want):
    import numpy as np
    import torch

    from repro_torch.core import scenarios as sc
    from repro_torch.core.policies import AlphaRR
    from repro_torch.core.policies.alpha_rr import alpha_rr_init
    from repro_torch.core.simulator import sim_acc0
    from repro_torch.figures import beyond_knapsack_levels as bk
    T, seeds = cs.GCURVE_T, cs.N_SEEDS
    curve_pts, _, lanes, ugrid, usc = bk.candidates(0, dev)
    scen = sc.replicate_seeds(usc, seeds)
    _, slab = scen.chunk_fn(scen.params, scen.init_fn(scen.params),
                            sc.base.chunk_tids(0, T, dev))

    def lane_args(lane, c, svc, T_len, rows, cols=None, trace=True):
        reps = rows // lane.grid.B
        g = lane.grid.repeat_rows(reps)
        if cols is None:
            cols = torch.as_tensor(np.repeat(lane.svc_cols, reps, axis=0),
                                   dtype=torch.int32, device=dev)
        pol = AlphaRR.batch(g)
        return (pol.params, g.levels, g.M, T_len, 0,
                (alpha_rr_init(pol.params), sim_acc0(rows, g.K, dev)), c,
                svc, cols, True, trace)

    def gathered(a):
        return a[:7] + (H.gather_svc(a[7], a[8]), None) + a[9:]

    T4 = torch.full((seeds,), T, dtype=torch.int32, device=dev)
    a8 = lane_args(lanes[-2], slab.c, slab.svc, T4, seeds)
    calls = {
        "S wide": a8,
        "S wide, no trace": a8[:10] + (False,),
        "S wide, columns gathered beforehand": gathered(a8),
        "S wide, horizons before the chunk": lane_args(
            lanes[-2], slab.c, slab.svc, torch.zeros_like(T4), seeds),
        **{f"S wide, K = {lane.grid.K} lane": lane_args(
            lane, slab.c, slab.svc, T4, seeds)
           for lane in (lanes[len(curve_pts)], lanes[0], lanes[-6],
                        lanes[-4])}}
    out = {name: ms_and_clock(lambda a=a: H.sim_chunk_alpha_rr_svc(*a),
                              reps=10, slots=T)
           for name, a in calls.items() if want(name)}
    fleet = ("S wide, fleet width",
             "S wide, fleet width, columns gathered beforehand")
    if any(want(n) for n in fleet):
        R, chunk = cs.N_M * cs.N_ALPHA * seeds, cs.CHUNK
        Kf = ugrid.g.shape[1]
        fk = sc.split_keys(sc.prng_key(33, dev), R)
        ftids = sc.base.chunk_tids(cs.T_MAIN - chunk, chunk, dev)
        fx = H.poisson_chunk(fk, ftids, torch.from_numpy(np.resize(
            np.float32(cs.M2_LAMS), R)).to(dev))
        fsvc = H.model2_service_chunk(fk, ftids, fx, ugrid.g.expand(
            R, Kf).contiguous(), cs.M2_MAX)
        gen = torch.Generator(device="cpu").manual_seed(29)
        fc = (torch.rand((R, chunk), generator=gen) * 3).to(dev)
        cols3 = torch.as_tensor(np.repeat(lanes[0].svc_cols, R, axis=0),
                                dtype=torch.int32, device=dev)
        fa = lane_args(lanes[0], fc, fsvc, torch.full(
            (R,), cs.T_MAIN, dtype=torch.int32, device=dev), R, cols3,
            trace=False)
        for name, a in zip(fleet, (fa, gathered(fa))):
            if want(name):
                out[name] = ms_and_clock(
                    lambda a=a: H.sim_chunk_alpha_rr_svc(*a), reps=10)
    return out


def main() -> int:
    args = sys.argv[1:]
    only = []
    if args[:1] == ["--only"] and len(args) > 1:
        only, args = args[1].split(","), args[2:]
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(_one(Path(args[1]).resolve(), only)), flush=True)
        return 0
    roots = args
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rows = []
    for root in roots:
        run = subprocess.run([sys.executable, __file__,
                              *(["--only", ",".join(only)] if only else []),
                              "--one", root],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stderr[-3000:], file=sys.stderr)
            return run.returncode
        rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    for r in rows:
        print(r["root"] + ": " + "; ".join(
            f"{k} {v['ms']:.4f} ms ({v['cycles_per_slot']:.0f} cycles a slot "
            f"at {v['sm_clock_mhz']:.0f} MHz)"
            for k, v in r.items() if isinstance(v, dict) and "ms" in v))
        walls = r.get("figure walls ms", {})
        print(r["root"] + ": figure walls " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in walls.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

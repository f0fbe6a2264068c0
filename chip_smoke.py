#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card -- the fleet
path (scenario-fused and obs-backed, with the backtracked OPT schedule),
the paper's figures and theorem checks on it, and LM serving -- and check
them.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Device: the card's name and power limit; build every kernel library
   (``src/repro_torch/kernels/csrc/*.cu``), one nvcc each, all started
   together (build seconds).  TF32 is switched off for matmuls and cuDNN.
2. Hosting kernels against their plain PyTorch versions on the card, at the
   fleet path's shapes, bit for bit (``torch.equal``): every variant of P,
   under both threefry layouts (the uniforms with and without a salt,
   Bernoulli arrivals and uniform rents with the antithetic replicas'
   flips, NA-pair rents, the spot rents' scaled normals, the
   Gilbert-Elliot chunk from a carried-in state), on the fleet's slab, on
   an odd t0 with R - 3 rows and 1,001 slots and on one slot; each is
   timed, and its SASS (``cuobjdump -sass``) counted for the integer-pipe
   bound; P's ARMA chunk with per-instance coefficients over three chunks
   in a row, the state carried (1,000 slots, 1,001 from t0 = 1,000, then
   4,096; R - 3 rows), and over Figs 10-11's two chunks of 2,000 on 40
   rows, in both layouts, timed at the fleet's shape against the
   integer-pipe bound of its normals and the latency bound of its
   recursion (the log prints the Poisson and ARMA kernels' previous
   design's time beside each, ``PREV_MS``); the same chunk at q = 1 (the
   composed leg's ARMA(2, 1): 4,096 rows over 4,096, 1,001 and one slot,
   R - 3 rows with per-instance coefficients, one row), timed at 4,096 x
   4,096; P's shaped uniform of one key at n = 1,024 (``jax.random.
   choice``'s draw), 1, 2 and 6,001 x 7 (``model2_service_matrix``'s, T *
   R odd), and that matrix card == CPU, both layouts, timed at 1,024 and
   42,007; D with the cost assembly fused in
   (the fleet's kernel: K = 3 and 2, ragged slabs of R - 3 rows and chunks
   of 1,000, 1,001 and 1, K = 16, each with and without the argmin table;
   +inf-padded levels, frozen slots, all-+inf frontiers), also against
   the route it replaces (float64 ``fma32`` assembly + kernel D on the
   finished w) on the same slab; D on a finished w (the fleet's K = 3
   chunk, then K = 16 and 32 at 4,096 x 4,096 on random w, each timed
   against its bound, the log printing the previous design's time, then
   at its tiles' edges: K of 1 to 32, a slot either side of its tile,
   1,000, 1,001 and one slot, 1, 31 and 33 rows, prefix masks and masks
   with holes, and its 4-byte route on an aligned chunk); S (alpha-RR on K = 3
   and on a mixed K = 5 grid, RR on K = 2, ragged slabs, K = 16, with and
   without the final fetch and the trace).  D and S report cycles per
   slot at the SM clock nvidia-smi reads while they run.  Model 2 (reduced
   slabs: 256 rows x 1,024 slots, 253 rows x 1,001 slots from an odd t0,
   one slot at the top of the counters; both layouts): P's Poisson draws
   at rates {0, 0.15, 1.2, 2, 4, 8, 9.99} a row and in the salted GE form
   over two chunks with the chain's state carried, P's Model-2 service at
   K = 3, 5 and 16 (24 and 7 requests a slot), D and S on the service slab
   with and without a column map (K = 2 lanes taking endpoint columns),
   with and without the argmin table / trace; the same at the figures'
   shapes (Figs 12-15: 76 rows x 6,000 slots; Figs 10-11: GE-Poisson, 40
   rows x two chunks of 2,000); and at the Model-2 fan-out's shape (4,096
   rows x 4,096 slots, K = 3: alpha-RR's and RR's D and S), where each is
   timed against its bound and its plain version's one call is timed.
   Figs 17-22 (the same reduced slabs, both layouts): P's Poisson draws at
   rates {10, 10.5, 37, 200, 1e5} a row (Hormann's rejection), at rows
   mixing 0, 2, 9.99, 10 and 200, and in the salted GE form at 200 / 10
   over two chunks with the chain's state carried; the service draws at
   260 requests a slot with slots past 260; S's table variant (static,
   MDP, ABC) under Model 1 and on the service slab, with and without a
   column map, the trace and the final fetch, K = 3, 2 and 16; then at
   Figs 17-22's own chunks (84 rows, the figure's scenario over its six
   chunks of 512, the last one's horizon ending after 440 slots: the
   Poisson and service draws and MDP's and ABC's table variant on the
   slab's levels and on RR's endpoint columns, each chunk); then at the
   Markov leg's shape (4,096 x 4,096, K = 3) each timed, the Poisson
   draws with their mean Hormann rounds and the share that reach
   ``lgamma``, Hormann's bound by pipe from ``poisson_kernel``'s own SASS
   (``nvdisasm -gi`` on the library's line tables: a round's hashes and
   the code every round runs, on every round; the code past the quick
   tests, ``lgamma`` included, on the rounds that reach it), the larger
   pipe's.
   The g-curve modules (default layout): Figs 23-25's recorded path (P's
   Bernoulli and ARMA variants on one row x 4,000 slots, equal to the
   array builders' rows), the service draws at one request a slot on Fig
   24's 76 x 4,000 slab and Fig 25's four 20 x 1,000 chunks, D and S on
   those chunks (alpha-RR, RR's endpoint columns); the study's 31-level
   union slab (4 x 4,000) with S for its lanes of 2, 3 and 8 levels; then
   slabs of 17, 24, 31 and 32 levels (256 x 1,024 and 253 x 1,001): the
   service draws in both layouts (also at 6, 8, 9 and 16 levels, the ends
   of their bands of a run-time K), alpha-RR's S and the static table on
   lanes of 3 and 8 levels gathering their columns; the service draws on
   31 levels and S on the 31-level slab timed at the study's shape and at
   4,096 x 4,096, S also on its lane's columns gathered beforehand (its
   bulk route), against the policy's latency bound and the gather's
   32-byte sectors, and at the study's call its parts (no trace; horizons
   before the chunk: no policy step; the lanes of 2 and 3 levels); S's
   gather route on few rows (1, 4, 5, 31, and a row either side of its
   few-rows route's one wave) bit for bit, half on a grid of values.
   The backtracked schedule's kernels: D's ARGS route (the argmin table
   written) timed at the fleet's shape; B (the backtrack) on D's own table
   of a fleet chunk (also one word off a 16-byte boundary: the 4-byte
   cp.async route), on R - 3 rows x 1,001 slots, a slot either side of a
   tile and of the ring's worth of tiles, a bulk chunk of 33 rows, and on
   random tables at K = 32, 1 and 2; E (schedule pricing) on the
   backtracked schedule at the fleet's shape (also on its 4-byte route),
   on a ragged slab from an odd t0 with levels out of range, at the same
   tile and ring edges, on Model-2 slabs of 5 and 32 levels through a
   column map, on a schedule that changes level every slot and on one
   that never does, and at K = 32, each with its sums' products fused and
   not (carried sums of -0 in every fifth row); B and E timed at the
   fleet's shape on both routes (the log prints the old design's time
   beside the new, ``PREV_MS``, and each one's share of its byte bound),
   B also on one block of 32 rows (its whole kernel) beside its walk's
   assumed floor (``B_STEP_CYCLES``), with its walk's shared-memory
   wavefronts a step modelled from the stage layout at K = 3 and K = 32
   (both in the log only); S with the rent fused (S, then E's rent pass over
   S's trace) on one alpha-RR row and three static rows (the reference's
   small batches, ``simulator.xla_acc_fma``).  Then S's table variant and
   D's ARGS route where their tiles and rings turn over (the library's
   ``sim_tile_slots`` / ``sim_ring_stages`` / ``dp_tile_slots`` /
   ``dp_args_stages``): a slot either side of a tile and of the ring,
   whole 16-byte groups either side of the ring, one slot, R - 3 rows,
   chunks of 1,001; the table variant at K = 2, 3, 5 and 16 for the
   static, MDP and ABC tables (side channels of -1 .. 2) under Model 1 and
   on Model-2 slabs with and without a column map, with and without the
   trace and the final fetch; D at K = 3, 5 and 16 with and without a
   column map; and the table variant with the rent and the fetch fused
   (MDP / ABC on small batches, ``simulator.xla_fetch_fma``).  D's ARGS
   route is timed at the fleet's shape (old -> new in the log, its cycles
   a slot and its share of the byte bound) and on the Model-2 fan-out's
   slab; S's table variant on the Markov leg's slab with its parts (no
   slot in the horizon, the static table, the trace).
3. The fleet path at full width: 1,024 instances (32 M x 32 (alpha, g)) x 4
   seeds = 4,096 rows, T = 65,536, chunks of 4,096: alpha-RR and RR through
   ``run_fleet``, alpha-OPT and OPT through ``offline_opt_fleet``
   (checkpointed, cost only), ``mc_summary`` of each.  Launch counters are
   zeroed just before and read just after; P's Bernoulli and uniform-rent
   variants, the fused D and S must have run, D on a finished w, P's other
   variants and the plain code the kernels replace (``fma32``'s float64
   FMA, the per-slot GE and ARMA loops) must not have run on the card.
4. A second fleet leg with Gilbert-Elliot arrivals and NA rents,
   antithetic seeds, its counters zeroed before and read after: P's GE
   and NA variants once per chunk and run, P's uniforms once per run (the
   chain's initial draw) and nothing else of P, no plain code on the
   card.  Every fleet run on the card is made three times: the counters
   cover the first pass, the printed wall time is the median of the three
   in microseconds.
5. Card == CPU: legs 3 and 4 rerun at 64 rows and T = 4,096 on the card and
   on the CPU (the plain versions), compared exactly.
6. The policy fan-out on the card: alpha-RR and RR lanes with the OPT
   frontiers over Bernoulli arrivals and spot rents (64 instances x 4
   seeds, T = 4,096): each lane == its standalone run and ``opt_cost`` ==
   ``offline_opt_fleet`` of its fleet, bit for bit; card == CPU on the same
   fan-out at 16 instances x 4 seeds, T = 2,048.
7. The paper's Figs 1-8 and 10-15 through the port's figure modules
   (``repro_torch/figures``) at the reference's default sizes: Figs 1-2
   (10 grid points x 4 seeds, T = 10,000), Figs 3-6 (22 x 4, T = 8,000),
   Figs 7-8 (5 x 4, T = 8,000; K = 5, 3 and 2 lanes), Figs 10-11 (10 x 4,
   T = 8,000; bursty GE-Poisson arrivals), Figs 12-15 (19 x 4, T = 6,000;
   Poisson arrivals and Model-2 service, no DP), Figs 17-22 (21 x 4, T =
   3,000 in chunks of 512; GE-Poisson at 200 / 10, Model-2 service at 260
   a slot, alpha-RR / RR and the MDP and ABC baselines), Figs 23-25 (the
   g-curve, then 19 curve points x 4 seeds and 5 M x 4 seeds, T = 4,000;
   trace playback, Model-2 service at one request a slot, D for Fig 25's
   OPT frontiers) and ``beyond_knapsack_levels`` (26 lanes of 2 to 8
   levels on one 31-level slab, 4 seeds, T = 4,000); each module's
   ``check(rows)`` must pass, its counters are zeroed before and read
   after: P's streams, S (Figs 17-22: its table variant too) and (Figs
   1-6, 10-11, 23-25) D must have run, the service draws and S on more
   than 16 levels in the study and nowhere else, no plain code.  Then
   card == CPU for the two g-curve modules at ``run(T=400, n_seeds=2)``.
8. The fan-out at the fleet leg's width: 1,024 instances x 4 seeds, T =
   65,536 in chunks of 4,096, Bernoulli(0.35) arrivals and spot rents at
   mean 0.35, alpha-RR and RR lanes with the OPT frontiers; per chunk one
   launch of P's Bernoulli and ARMA variants and two each of S and D, one
   of P's normals a run.
9. Model 2 at the fleet leg's width: 1,024 instances x 4 seeds, T =
   65,536 in chunks of 4,096, Poisson arrivals at rates cycled over {2, 4,
   8}, spot rents at mean 4.5, Model-2 service (24 requests a slot) on the
   fleet grid's g; alpha-RR and RR (gathering its endpoint columns) lanes
   with the OPT frontiers; per chunk one launch of P's Poisson, service
   and ARMA variants and two each of S and D on the slab, none of the
   plain code; each lane == its standalone run and ``opt_cost`` ==
   ``offline_opt_fleet``; card == CPU at 16 instances x 4 seeds, T =
   1,024.
10. The Markov fan-out at the fleet leg's width: 1,024 instances x 4
   seeds, T = 65,536 in chunks of 4,096; Figs 17-22's three regimes
   cycled over the instances (GE-Poisson at 200 / 10), alpha 0.16, g
   0.76, the figure's (M, c) sweep cycled, spot rents, Model-2 service of
   up to 260 requests a slot; alpha-RR and RR (its endpoint columns) as
   one fan-out, MDP and ABC each their own ``run_fleet``; per chunk and
   run one launch each of P's GE, Poisson, service and ARMA variants,
   two of S for the fan-out and one of S's table variant for MDP and for
   ABC, none of the plain code; each lane == its standalone run; card ==
   CPU at 16 instances x 4 seeds, T = 1,024.
11. Obs-backed fleets at the fleet leg's width: 1,024 instances x 4 seeds
   = 4,096 rows, T = 16,384 in chunks of 4,096, Bernoulli(0.35) arrivals
   and U[0.15, 0.55] rents, the seed-replicated scenario materialised
   (0.54 GB on the host) into ``FleetBatch.from_dense``; alpha-RR, RR and
   OPT on four routes (cost only, materialised, checkpointed with the
   schedule, ``stream=True``), each run three times (counters over the
   first): S, D (its ARGS route on the schedule routes), B and E once a
   chunk and route, no P, no plain code; every route == the
   scenario-fused run (``n_seeds=4``) bit for bit, the three schedules
   one, their price == ``evaluate_schedule_fleet(scenario=)``.  Then
   ``offline_opt_batch`` on the first 2,048 slots (D on a finished w, B,
   E) == the CPU on 64 rows; the Model-2 leg's scenario on 256 rows, T =
   2,048, obs-backed (RR on ``restrict_to_endpoints()``) == fused.
12. ``figures.theorems.run()`` on the card (Thm 2's 120 mixed-horizon
   instances as one obs-backed fleet) == on the CPU, ``check`` passes.
   A kernel's ``launches`` in the last lines add up phases 3, 4, 7 to 13
   (and the serving path's for F and M); D's ARGS route, B, E and D on a
   finished w launch in phases 11-13 only, the shaped uniform and ARMA at
   q = 1 in phase 13 only; the Poisson variant's Hormann
   record counts the launches in which the kernel drew an item on
   Hormann's branch (the kernel counts them), which must be those of Figs
   17-22 and phase 10 only.
13. A composed scenario at the fleet leg's width: 1,024 instances x 4
   antithetic seeds = 4,096 rows, T = 16,384 in chunks of 4,096; arrivals
   ``mixture_from_weights`` (0.5, 0.3, 0.2) of Bernoulli(0.35), Poisson(2)
   and GE-Bernoulli, rents ``regime_switch`` from U[0.15, 0.55] to ARMA(2,
   1) at slot 6,000; the alpha-RR / RR fan-out and ``offline_opt_fleet``
   with the backtracked schedule, each run three times, counted from the
   scenario's construction (the mixture's choice: one launch of P's
   shaped uniform) through the first pass: every stream once a chunk and
   run, ARMA at q = 1 among them, S, D's ARGS route, B and E, no plain
   code.  Its observations materialised and replayed through
   ``trace_scenario`` give the fan-out's bits; ``with_prng_backend(
   "pallas")`` draws the slot uniforms (the Bernoulli rows, the uniform
   regime) as the original layout and the rest as the default one; card ==
   CPU on one instance of each component x 4 seeds, T = 6,144.
14. Kernels F (flash attention) and M (SSD scan) against their plain
   versions on the card, each within a stated tolerance.  Each has two
   kernels, chosen by an explicit dispatch: F's wgmma kernel (bf16, hd 64 /
   128) and its fp32-FMA kernel (the rest), M's mma.sync kernel (bf16, dh /
   ds multiples of 16 up to 128, chunk <= 128) and its fp32-FMA kernel (the
   rest).  At the serving path's shapes (batch 8, 2,048 tokens,
   zamba2-1.2b's heads and widths, bf16, timed) and at variants on both
   sides of each dispatch edge: F in fp32, decoding one query over a
   2,048-key cache, a ragged q tile, a ragged key tile, non-causal over a
   ragged key length, GQA at hd 128, bf16 at hd 32; M with an initial state
   and a ragged length, the scheduler's 8-token chunk, ds = 128, a chunk of
   256, fp32.  Each variant requires that the dispatch launched the kernel
   it names.  The FMA kernels are also timed on the main bf16 input.
15. The LM serving path at full width and depth: zamba2-1.2b in bf16 from
   a seeded generator (38 Mamba2 layers, 6 shared-attention
   applications), ``ServingEngine.serve_slot`` under each plan (none,
   layer prefix at alpha 0.4 = 5 segments, full) on 8 prompts of 2,048
   tokens, then ``EdgeServingScheduler`` for 60 slots.  Counters are zeroed
   just before and read just after; per full forward F's wgmma kernel runs
   6 times and M's mma kernel 38 times, per prefix forward 3 and 12; the
   FMA kernels never run there.
16. Card == CPU for the serving path at zamba2's tiny fp32 config with the
   same weights: logits within 1e-4, argmax tokens equal where the CPU's
   top-2 margin is wider.

Kernel times are CUDA-event medians after a warm-up, over batches of
back-to-back calls for the kernels (so that the host's launch overhead
is not counted as the kernel's time).  The last three lines
are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import (FleetBatch, HostingCosts, HostingGrid,  # noqa: E402
                              evaluate_schedule_fleet, mc_summary,
                              offline_opt_fleet, run_fleet)
from repro_torch.core import scenarios as sc  # noqa: E402
from repro_torch.core import services as SV  # noqa: E402
from repro_torch.core.costs import ServiceSet, joint_hosting_grid  # noqa: E402
from repro_torch.core.arrivals import GilbertElliot  # noqa: E402
from repro_torch.core.policies import (ABCPolicy, AlphaRR,  # noqa: E402
                                       MDPPolicy, RetroRenting,
                                       StaticPolicy)
from repro_torch.figures import fig01_02_alpha_sweep  # noqa: E402
from repro_torch.figures import fig03_06_m_p_sweeps  # noqa: E402
from repro_torch.figures import fig07_08_multiple_rr  # noqa: E402
from repro_torch.figures import fig10_11_trace  # noqa: E402
from repro_torch.figures import fig12_15_poisson_model2  # noqa: E402
from repro_torch.figures import fig17_22_markov_mdp  # noqa: E402
from repro_torch.figures import fig23_25_geolife  # noqa: E402
from repro_torch.figures import beyond_knapsack_levels  # noqa: E402
from repro_torch.figures import theorems  # noqa: E402
from repro_torch.core import arrivals, rentcosts, simulator  # noqa: E402
from repro_torch.core.policies.alpha_rr import alpha_rr_init  # noqa: E402
from repro_torch.core.policies.baselines import table_form  # noqa: E402
from repro_torch.core.policies.offline_opt import (dp_fetch_matrix,  # noqa: E402
                                                   dp_frontier0,
                                                   offline_opt_batch)
from repro_torch.core.simulator import sim_acc0  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import hosting as H  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.hosting import fma32  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.serve.partial import make_plans  # noqa: E402
from repro_torch.serve.scheduler import EdgeServingScheduler  # noqa: E402

N_M, N_ALPHA, N_SEEDS = 32, 32, 4
T_MAIN, T_GE, T_SMALL, CHUNK = 65536, 8192, 4096, 4096
SMALL_INSTANCES = 16
# cycles of the spin that each timed batch of kernel calls waits behind
# (~10 ms at the H100's 1,980 MHz)
SPACER_CYCLES = 20_000_000
# every fleet run on the card is timed this many times (the median is
# printed, in microseconds); the launch counters cover the first pass
REPEATS = 3
# the spot rents' mean, as the figures draw them
SPOT_MEAN = 0.35
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, the only non-tensor rate listed;
# the kernels' 32-bit integer and compare ops are counted against it, so
# their bound is a lower bound
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# dense bf16 tensor-core rate (data sheet): the least time for the bf16
# products of F and M, whatever units the kernels use
PEAK_BF16 = 989e12
CSRC = "src/repro_torch/kernels/csrc/"
# the serving path: batch, prompt length, the scheduler's slots
SERVE_B, SERVE_S, SERVE_SLOTS = 8, 2048, 60
# each launcher's CUDA kernel (the symbol in its source)
KERNEL_SYMBOLS = {
    "slot_uniform": "counter_stream_kernel<kUniform>",
    "bernoulli_arrivals_chunk": "counter_stream_kernel<kBernoulli>",
    "uniform_rents_chunk": "counter_stream_kernel<kUniformRents>",
    "na_rents_chunk": "counter_stream_kernel<kNaRents>",
    "normal_chunk": "counter_stream_kernel<kNormal>",
    "ge_bernoulli_chunk": "ge_chain_kernel<EMIT>",
    "arma_rents_chunk": "arma_rents_kernel",
    "arma_rents_chunk ma1": "arma_rents_kernel<P, kMa1Sum / kMa1Chain, ROWS> "
                            "(an MA order of 1)",
    "shaped_uniform": "shaped_uniform_kernel",
    "poisson_chunk": "poisson_kernel<SALT, STATES>",
    "poisson_chunk rejection": "poisson_kernel<SALT, STATES> (Hormann)",
    "model2_service_chunk": "model2_service_kernel",
    "model2_service_chunk wide": "model2_service_kernel<KM> (the bands of a "
                                 "run-time K at 17 to 32 levels)",
    "dp_fwd_model1": "dp_fwd_kernel<K, ARGS, false>",
    "dp_fwd_model2": "dp_fwd_kernel<K, ARGS, true>",
    "dp_fwd_model1 args": "dp_fwd_kernel<K, true, false> (the ARGS route: "
                          "the argmin table written)",
    "dp_fwd_model2 args": "dp_fwd_kernel<K, true, true> (the ARGS route on "
                          "a Model-2 slab)",
    "dp_minplus": "dp_minplus_kernel",
    "dp_backtrack": "dp_backtrack_kernel<BULK>",
    "schedule_chunk": "schedule_kernel<SVC, FMA, BULK, false>",
    "schedule_chunk matrix": "schedule_kernel<SVC, FMA, BULK, true> (a "
                             "joint grid's explicit fetch matrix)",
    "joint_slab": "joint_slab_kernel<SVC>",
    "joint_slab w": "joint_slab_kernel<true> (the w route: w = fma(c, lv, "
                    "svc) on a slab of 17 to 32 states)",
    "dp_fwd_model2 joint": "dp_fwd_kernel<K, ARGS, true> (a joint grid's "
                           "slab and fetch matrices)",
    "dp_minplus joint": "dp_minplus_kernel<KB, CW> (a joint grid's fetch "
                        "matrices, 17 to 32 states, on G's w)",
    "sim_chunk_alpha_rr": "sim_kernel<K, false, false>",
    "sim_chunk_alpha_rr_svc": "sim_kernel<K, true, false>",
    "sim_chunk_alpha_rr_svc wide": "sim_kernel<K, true, false> (a slab of "
                                   "17 to 32 levels, the gather route)",
    "sim_chunk_table": "sim_kernel<K, false, true>",
    "sim_chunk_table_svc": "sim_kernel<K, true, true>",
    "flash_attention_wgmma": "flash_fwd_wgmma_kernel",
    "flash_attention_fma": "flash_fwd_fma_kernel",
    "ssd_scan_mma": "ssd_scan_mma_kernel",
    "ssd_scan_fma": "ssd_scan_fma_kernel",
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=5, warmup=1, batch=1):
    """Median milliseconds of one ``fn()`` over ``reps`` CUDA-event timed
    runs of ``batch`` back-to-back calls each.  Each run starts behind
    ~10 ms of ``torch.cuda._sleep``, during which the host queues the
    batch, so the batch runs back to back: a kernel's time is not its
    wrapper's, even on a host slower than the kernel."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPACER_CYCLES)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def timed_once(fn):
    """``fn()`` called once, timed by CUDA events: (ms, its result) -- for
    the plain versions, whose one call at the fleet's shape takes up to
    seconds and whose result is held against the kernel's."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


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


def sm_clock_mhz(fn, ms):
    """The SM clock (nvidia-smi, MHz) read while the card runs about 0.4 s
    of back-to-back ``fn()`` calls of ``ms`` each."""
    for _ in range(max(50, int(400 / max(ms, 1e-3)))):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    torch.cuda.synchronize()
    return float(out.split()[0])


def sub_rows(tensors, rows):
    """The first ``rows`` rows of each tensor, contiguous."""
    return tuple(t[:rows].contiguous() for t in tensors)


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


def fleet_instances(idx, device):
    """``fleet_grid``'s instances ``idx`` as a grid of their own."""
    Ms = np.geomspace(2.0, 50.0, N_M)
    alphas = np.linspace(0.1, 0.7, N_ALPHA)
    costs = [HostingCosts.three_level(
        float(Ms[i // N_ALPHA]), float(alphas[i % N_ALPHA]),
        float(np.clip(0.9 - alphas[i % N_ALPHA], 0.0, 1.0))) for i in idx]
    return HostingGrid.from_costs(costs, device=device)


def k16_grid(B, device):
    """B instances on 16 levels (g = 1 - level), M log-spaced in [2, 50]."""
    lv = np.linspace(0.0, 1.0, 16)
    return HostingGrid.from_costs(
        [HostingCosts(M=float(m), levels=tuple(lv), g=tuple(1.0 - lv))
         for m in np.geomspace(2.0, 50.0, B)], device=device)


def bernoulli_uniform(B, device):
    return sc.combine(
        sc.bernoulli_arrivals(sc.prng_key(0, device), 0.35, B, device=device),
        sc.uniform_rents(sc.prng_key(1, device), 0.35, 0.2, B, device=device))


def bernoulli_spot(B, device):
    """Bernoulli(0.35) arrivals and spot rents at mean 0.35: the figures'
    workload at fleet width."""
    return sc.combine(
        sc.bernoulli_arrivals(sc.prng_key(4, device), 0.35, B, device=device),
        sc.spot_rents(sc.prng_key(5, device), SPOT_MEAN, B, device=device))


def spot_params(B, device):
    """The seed-replicated spot-rent stream's params at B instances."""
    return sc.replicate_seeds(bernoulli_spot(B, device),
                              N_SEEDS).params["rent"]


def ge_na(B, device):
    return sc.combine(
        sc.ge_arrivals(sc.prng_key(2, device), 0.3, 0.2, 0.9, 0.2, B,
                       emission="bernoulli", device=device),
        sc.na_rents(sc.prng_key(3, device), 0.35, 0.2, B, device=device))


# the composed leg: the fleet leg's instances, its horizon, the regime
# switch's slot (mid-chunk) and the mixture weights; the CPU's row subset
# (one instance of each component) runs this horizon and chunk (the switch
# falls in its last chunk)
COMPOSED_B, COMPOSED_T, COMPOSED_SWITCH = N_M * N_ALPHA, 16384, 6000
COMPOSED_WEIGHTS = (0.5, 0.3, 0.2)
COMPOSED_SUB_T, COMPOSED_SUB_CHUNK = 6144, 2048


def composed_scenario(B, device):
    """The composed workload: arrivals a weighted mixture (0.5, 0.3, 0.2)
    of Bernoulli(0.35), Poisson(2) and the GE + NA leg's GE chain with
    Bernoulli emissions; rents a regime switch at slot 6,000 from
    U[0.15, 0.55] to ARMA(2, 1) rents around 0.35 (q = 1)."""
    k = lambda s: sc.prng_key(s, device)  # noqa: E731
    arr = sc.mixture_from_weights(
        [sc.bernoulli_arrivals(k(9), 0.35, B, device=device),
         sc.poisson_arrivals(k(10), 2.0, B, device=device),
         sc.ge_arrivals(k(11), 0.3, 0.2, 0.9, 0.2, B, emission="bernoulli",
                        device=device)], COMPOSED_WEIGHTS, k(12), B)
    rent = sc.regime_switch(
        [sc.uniform_rents(k(13), 0.35, 0.2, B, device=device),
         sc.arma_rents(k(14), 0.35, B, ar=(0.55, 0.2), ma=(0.4,),
                       device=device)], [COMPOSED_SWITCH])
    return sc.combine(arr, rent)


# the Model-2 fan-out: Poisson rates cycled over the instances, spot rents
# at Figs 12-15's mean, Model-2 service of up to 24 requests a slot
M2_LAMS, M2_RENT, M2_MAX = (2.0, 4.0, 8.0), 4.5, 24
# Figs 17-22's service cap (the Markov leg's)
MARKOV_MAX = fig17_22_markov_mdp.MAX_PER_SLOT


def model2_scenario(grid, device):
    """Poisson arrivals (rates cycled over ``M2_LAMS``), spot rents at mean
    4.5 and Model-2 service on ``grid``'s g (the endpoint grid's g gives
    the same draws' endpoint columns)."""
    B = grid.B
    lam = np.resize(np.asarray(M2_LAMS, np.float32), B)
    return sc.combine(
        sc.poisson_arrivals(sc.prng_key(6, device), lam, B, device=device),
        sc.spot_rents(sc.prng_key(7, device), M2_RENT, B, device=device),
        svc=sc.model2_service(sc.prng_key(8, device), grid.g, B, M2_MAX,
                              device=device))


def timed_passes(runs, device, label, timings, counted=False):
    """Run every ``runs`` entry (name -> thunk) once a pass, REPEATS passes
    on the card (one on the CPU); ``timings[label/name]`` gains the wall
    seconds of each.  Returns the first pass's results and, with
    ``counted``, the launch counts and plain-code card calls read right
    after it (the later passes only time)."""
    out, counts = {}, None
    for i in range(REPEATS if device != "cpu" else 1):
        for name, fn in runs.items():
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            if device != "cpu":
                torch.cuda.synchronize()
            timings.setdefault(f"{label}/{name}", []).append(
                time.perf_counter() - t0)
            out.setdefault(name, res)
        if counted and i == 0:
            counts = (launch_counts(), card_calls())
    return out, counts


def run_leg(grid, scenario, T, antithetic, device, label, timings,
            counted=False):
    """alpha-RR, RR, alpha-OPT and OPT of one fleet; returns the results
    (and the launch counts of the first pass, with ``counted``)."""
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
    out, counts = timed_passes(runs, device, label, timings, counted)
    return (out, counts) if counted else out


def median_us(timings, key):
    return float(np.median(timings[key])) * 1e6


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
# Kernel P's variants.
# ----------------------------------------------------------------------

# per variant: threefry blocks a slot on the fleet's slabs (an NA pair's
# two slots share one draw) and the other 32-bit ops a slot (the bits ->
# float mapping and the layout's xor, 5 a draw; the flips, compares and
# the rents' FMA (2); the chain's map and emission select)
P_WORK = {"slot_uniform": (2, 5), "slot_uniform salt": (3, 5),
          "bernoulli_arrivals_chunk": (2, 5 + 2),
          "uniform_rents_chunk": (2, 5 + 4),
          "na_rents_chunk": (1, 5 / 2 + 4),
          "normal_chunk": (2, 5 + 110),
          "ge_bernoulli_chunk": (5, 2 * 5 + 6)}
# the float32 operations of one normal past the uniform (an FMA counts 2):
# XLA's erf_inv with both its log1p branches, its log and Giles's
# polynomial, the scale; the ARMA(4, 2) step adds its dots, the
# innovation, the clip
NORMAL_FLOPS = 110
ARMA_STEP_FLOPS = 4 + 3 + 1 + 3 + 1 + 3
# the ARMA(4, 2) step's dependent chain through x_{t-1}: phi0 * h0, three
# adds of the AR dot, + e, + the MA dot; at an assumed 4 cycles a
# dependent float32 instruction on sm_90
ARMA_CHAIN_OPS, FP32_LATENCY = 6, 4
# the composed leg's ARMA(2, 1) step (an FMA counts 2): phi0 * h0, the
# second AR term's FMA, + e, the MA term's FMA, + mean, the clip; its
# dependent chain through x_{t-1}: phi0 * h0, the FMA, + e, the MA FMA
ARMA1_STEP_FLOPS, ARMA1_CHAIN_OPS = 1 + 2 + 1 + 2 + 1 + 2, 4


def minplus_ops(R, chunk, K):
    """D on a finished w, per row and slot: K*K adds, K*(K-1) compares, K
    adds of w."""
    return R * chunk * (K * K + K * (K - 1) + K)


def finished_w(R, chunk, K, device, seed=0):
    """D's inputs on a finished w at K levels: random w in [0, 2), the
    fetch of K evenly spread levels (M = 8), a zero frontier, every slot
    valid."""
    gen = torch.Generator(device=device).manual_seed(seed + K)
    lv = torch.linspace(0.0, 1.0, K, device=device).expand(R, K)
    return (torch.zeros((R, K), device=device),
            torch.rand((R, chunk, K), generator=gen, device=device) * 2,
            dp_fetch_matrix(torch.full((R,), 8.0, device=device),
                            lv.contiguous()),
            torch.ones((R, chunk), dtype=torch.bool, device=device))


# D on a finished w at its tiles' edges: these K (its instances of one K,
# the first of its bands and the bands' edges), a slot either side of its
# tile (hosting.cu: dpm_tile), 1,000 and 1,001 slots and one, on 1, 31 and
# 33 rows in turns, with prefix masks and masks with holes
MINPLUS_EDGE_KS = (1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32)


def minplus_edges(dev):
    """D on a finished w == its plain version, bit for bit, at its tiles'
    edges (``MINPLUS_EDGE_KS``): costs on a coarse grid (ties in trans),
    all-+inf frontiers, levels priced +inf; once on inputs one word off 16
    bytes (the 4-byte route on an aligned chunk)."""
    lib = _build.library("hosting")
    n = 0
    for ki, K in enumerate(MINPLUS_EDGE_KS):
        tile = lib.dp_minplus_tile_slots(K)
        for ci, chunk in enumerate((1, tile - 1, tile, tile + 1, 1000, 1001,
                                    16 * tile)):
            R = (1, 31, 33)[(ki + ci) % 3]
            gen = torch.Generator(device="cpu").manual_seed(R * chunk + K)
            lv = torch.sort(torch.randint(0, 9, (R, K), generator=gen) / 8,
                            dim=1)[0]
            M = torch.randint(1, 4, (R,), generator=gen).float()
            J = torch.randint(0, 8, (R, K), generator=gen) / 2
            J[1::5], J[2::5, 1:] = float("inf"), float("inf")
            w = torch.randint(0, 6, (R, chunk, K), generator=gen) / 4
            w[(torch.rand((R, 1, K), generator=gen) < 0.15).expand(
                R, chunk, K)] = float("inf")
            for holes in (False, True):
                valid = (torch.rand((R, chunk), generator=gen) < 0.7
                         if holes else torch.arange(chunk)[None, :]
                         < torch.randint(0, chunk + 2, (R, 1),
                                         generator=gen))
                args = tuple(t.to(dev) for t in (
                    J, w, dp_fetch_matrix(M, lv), valid))
                require(tree_equal(H.dp_minplus(*args),
                                   H.dp_minplus_plain(*args)),
                        f"D on a finished w differs from its plain version "
                        f"at R={R} chunk={chunk} K={K} holes={holes}")
                n += 1
        args = tuple(H.misaligned(t) for t in finished_w(33, 16 * tile, K,
                                                         dev))
        require(tree_equal(H.dp_minplus(*args), H.dp_minplus_plain(*args)),
                f"D on a finished w differs from its plain version on its "
                f"4-byte route at K={K}")
        n += 1
    log(f"D on a finished w ok at its tiles' edges: {n} calls compared")


def sim_chain_ops(K):
    """The dependent ops a slot on alpha-RR's chain in S's policy warp
    (hosting.cu: sim_kernel): the select of w_r (K - 1 selects after its
    first), w - w_r, the add of min(0, S), the margin's FMA, the mask's
    select, + EPS, the first-index argmin (a compare and a select a
    level after the first), the switch test and r's select."""
    return (K - 1) + 5 + 2 * (K - 1) + 2
# the ms of the design each redesigned kernel replaced, at the same shape
# (PERF.md section 6; NVIDIA H100 80GB HBM3, 700 W): the log prints old ->
# new
PREV_MS = {"poisson_chunk": 1.8543, "arma_rents_chunk": 0.2784,
           "model2_service_chunk": 0.5514, "dp_backtrack": 0.7466,
           "schedule_chunk": 0.5994, "sim_chunk_table_svc": 0.3011,
           "sim_chunk_table": 0.2539, "dp_fwd_model1 args": 0.5082,
           "dp_minplus": 3.2147, "sim_chunk_alpha_rr_svc wide": 1.0761}
# B's walk, cycles a slot and row: one dependent shared load (~30-33
# cycles on sm_90, assumed, not measured here) and the add of its
# address: the walk's floor, beside one block's whole kernel measured
B_STEP_CYCLES = 35
# the consumer code of the reference that each variant finishes in-kernel
P_CONSUMER = {
    "slot_uniform": None,
    "bernoulli_arrivals_chunk": "src/repro/core/scenarios/streams.py:67",
    "uniform_rents_chunk": "src/repro/core/scenarios/streams.py:256",
    "na_rents_chunk": "src/repro/core/scenarios/streams.py:275",
    "normal_chunk": "src/repro/core/scenarios/streams.py:316",
    "ge_bernoulli_chunk": "src/repro/core/scenarios/streams.py:139"}
# what each P variant replaces: the Pallas PRNG kernel, or (the normals)
# XLA's jax.random.normal in _arma_eps_at, which no TPU kernel computes
P_REPLACES = {"normal_chunk": "src/repro/core/scenarios/streams.py:316"}
# each variant's kernel in the SASS (a fragment of its mangled name)
P_SASS = {"slot_uniform": "counter_stream_kernelILi0ELb0E",
          "slot_uniform salt": "counter_stream_kernelILi0ELb1E",
          "bernoulli_arrivals_chunk": "counter_stream_kernelILi1ELb0E",
          "uniform_rents_chunk": "counter_stream_kernelILi2ELb0E",
          "na_rents_chunk": "counter_stream_kernelILi3ELb0E",
          "normal_chunk": "counter_stream_kernelILi4ELb0E",
          "ge_bernoulli_chunk": "ge_chain_kernelILb1E"}
# SASS opcodes that issue on the integer ALU pipe (64 lanes a clock per SM
# on Hopper, the CUDA C++ Programming Guide's throughput table for compute
# capability 9.0): logic, shifts, 3-input adds, compares, selects, min /
# max, lea, byte permutes.  IMAD, VIADD and the float ops issue on the FMA
# pipe.
ALU_OPS = {"LOP3", "SHF", "IADD3", "ISETP", "FSETP", "SEL", "FSEL", "IMNMX",
           "FMNMX", "VIMNMX", "LEA", "PRMT", "PLOP3", "BMSK", "IABS", "P2R",
           "R2P"}
# SASS opcodes on the FMA pipe (the same table: float32 add, multiply and
# FMA at 128 lanes a clock per SM; integer multiply-add at 64) and on the
# transcendental unit (MUFU: 16)
FMA_FLOAT_OPS = {"FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I",
                 "HFMA2"}
FMA_INT_OPS = {"IMAD", "IMUL", "VIADD", "IMAD32I", "IMUL32I"}
XU_OPS = {"MUFU"}
P_SLOTS = 4                       # slots a thread (lane) draws: kSlots
# the salted uniforms' slot loop is not unrolled: its code holds one slot
P_SLOTS_IN_CODE = {"slot_uniform salt": 1}


def p_variants(dev):
    """Kernel P's variants on the fleet's rows: {name: (keys, the args
    after the counters)}; the uniforms draw with the arrivals' keys, the
    antithetic replicas flip half the rows, the GE chunk starts from the
    GE leg's initial states."""
    B = N_M * N_ALPHA
    bern = sc.replicate_seeds(bernoulli_uniform(B, dev), N_SEEDS,
                              antithetic=True).params
    ge = sc.replicate_seeds(ge_na(B, dev), N_SEEDS, antithetic=True)
    arr, rent = bern["arr"], bern["rent"]
    gep, nap = ge.params["arr"], ge.params["rent"]
    spot = spot_params(B, dev)
    require(bool(arr["flip"].any()) and not bool(arr["flip"].all()),
            "the antithetic replicas must flip half the rows")
    return {
        "slot_uniform": (arr["key"], (None,)),
        "slot_uniform salt": (arr["key"], (1,)),
        "bernoulli_arrivals_chunk": (arr["key"], (arr["p"], arr["flip"])),
        "uniform_rents_chunk": (rent["key"], (rent["lo"], rent["hi"],
                                              rent["flip"])),
        "na_rents_chunk": (nap["key"], (nap["lo"], nap["hi"])),
        "normal_chunk": (spot["key"], (spot["sigma"],)),
        "ge_bernoulli_chunk": (gep["key"], (
            ge.init_fn(ge.params)["arr"]["s"], gep["p_hl"], gep["p_lh"],
            gep["rate_h"], gep["rate_l"])),
    }


def p_call(specs, name, rows, tids, part, plain=False):
    """Variant ``name``'s wrapper (or its plain version) on the first
    ``rows`` rows."""
    keys, args = specs[name]
    fn = getattr(H, name.split()[0] + ("_plain" if plain else ""))
    return fn(keys[:rows], tids, *(a[:rows] if isinstance(a, torch.Tensor)
                                   else a for a in args), part)


def sass_functions():
    """{function: [opcode, ...]} of the built hosting library's SASS
    (``cuobjdump -sass``), its static instructions in order."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass",
                           str(_build.library_path("hosting"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs = {}
    for part in sass.split("Function : ")[1:]:
        funcs[part.split(None, 1)[0]] = [m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)",
            part)]
    return funcs


def pipe_ops(ops, scale=1.0):
    """A list of SASS opcodes by pipe, times ``scale``: ``alu`` (the
    ALU_OPS), ``ffma`` (FMA_FLOAT_OPS), ``imad`` (FMA_INT_OPS), ``xu``
    (XU_OPS) and ``all``."""
    return {"alu": sum(o in ALU_OPS for o in ops) * scale,
            "ffma": sum(o in FMA_FLOAT_OPS for o in ops) * scale,
            "imad": sum(o in FMA_INT_OPS for o in ops) * scale,
            "xu": sum(o in XU_OPS for o in ops) * scale,
            "all": len(ops) * scale}


def pipe_cycles(c):
    """SM clocks the ``pipe_ops`` counts ``c`` (summed over the work) hold
    each pipe: the ALU pipe 64 lanes a clock, the FMA pipe 128 float
    lanes a clock of which the integer multiply-adds take its 64-lane
    heavy half, the transcendental unit 16."""
    return {"alu": c["alu"] / 64,
            "fma": max(c["imad"] / 64, (c["ffma"] + c["imad"]) / 128),
            "xu": c["xu"] / 16}


def p_sass_ops(funcs):
    """{variant: (ALU-pipe ops a slot, all ops a slot)}, counted in the
    SASS of the built hosting library (``sass_functions``): a kernel's
    static instructions over the slots its code holds (a thread's four,
    one for the salted uniforms' loop).  The static count includes the
    scalar stores of a ragged edge and the prologue (for the GE kernel
    and the salted uniforms once per slot or tile where it runs once a
    thread), so it slightly overstates the work."""
    counts = {}
    for name, ops in funcs.items():
        for var, frag in P_SASS.items():
            if frag in name:
                n = P_SLOTS_IN_CODE.get(var, P_SLOTS)
                counts[var] = (sum(o in ALU_OPS for o in ops) / n,
                               len(ops) / n)
    require(set(counts) == set(P_SASS),
            f"kernel P's SASS: found {sorted(counts)}")
    return counts


def na_sass_ops(sass, tids):
    """NA rents' (ALU-pipe, all) ops a slot: the NA kernel's static code
    holds a hash for each of a thread's slots, of which it runs one per
    pair it sees, so its count is the uniforms' per draw times the draws
    a slot of these counters needs (0.5 on whole pairs; the epilogue's few
    ops are left out, which keeps it a lower bound)."""
    draws = int(torch.unique(tids // 2).numel()) / tids.numel()
    return tuple(v * draws for v in sass["slot_uniform"])


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

    # P: every stream variant against its plain version at the fleet's
    # rows, under both layouts: the uniforms with and without a salt,
    # Bernoulli arrivals and uniform rents with the antithetic replicas'
    # flips, NA rents, the GE chunk from a carried-in state; on the fleet's
    # slab, on an odd t0 with R - 3 rows and 1,001 slots, and on one slot
    specs = p_variants(dev)
    slabs = [("fleet slab", R, t0, chunk),
             ("odd t0, R - 3 rows, 1,001 slots", R - 3, t0 + 1, 1001),
             ("one slot", R, 2 ** 31 - 1, 1)]
    for part in (True, False):
        for label, rows, first, n in slabs:
            tt = sc.base.chunk_tids(first, n, dev)
            for name in specs:
                k = p_call(specs, name, rows, tt, part)
                p = p_call(specs, name, rows, tt, part, plain=True)
                torch.cuda.synchronize()
                require(tree_equal(k, p), f"P {name} differs from its plain "
                                          f"version ({label}, layout {part})")
        log(f"P ok: {len(specs)} variants x {len(slabs)} slabs, "
            f"{'partitionable' if part else 'original'} layout")
    clock = sm_clock_mhz(lambda: H.slot_uniform(keys, tids), 0.1)
    funcs = sass_functions()
    sass = p_sass_ops(funcs)
    sass["na_rents_chunk"] = na_sass_ops(sass, tids)
    # a threefry block's ops by pipe: the uniforms' kernel over its slots'
    # two blocks (its bits-to-float mapping included)
    sass["block pipes"] = pipe_ops(funcs[next(
        f for f in funcs if P_SASS["slot_uniform"] in f)], 1 / (2 * P_SLOTS))
    sass["hormann"] = hormann_sass(sass["block pipes"])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name in specs:
        k = p_call(specs, name, R, tids, True)
        ms = cuda_ms(lambda: p_call(specs, name, R, tids, True), reps=7,
                     batch=10)
        blocks, extra = P_WORK[name]
        alu, total = sass[name]
        r = dict(ms=ms, sm_clock_mhz=clock, alu_ops_per_slot=alu,
                 ops_per_slot=total,
                 int_pipe_bound_ms=R * chunk * alu / (64 * n_sm * clock * 1e3),
                 issue_bound_ms=R * chunk * total / (128 * n_sm * clock * 1e3))
        log(f"P {name} timed: {ms:.4f} ms; SASS: {alu:.1f} ALU-pipe of "
            f"{total:.1f} ops a slot -> integer-pipe bound "
            f"{r['int_pipe_bound_ms']:.4f} ms, issue bound "
            f"{r['issue_bound_ms']:.4f} ms at {clock:.0f} MHz")
        if name == "slot_uniform salt":
            rec["slot_uniform"].update(
                {f"salt_{key}": v for key, v in r.items()
                 if key != "sm_clock_mhz"})
            continue
        r.update(
            replaces=P_REPLACES.get(name, "src/repro/kernels/hosting.py:164"),
            consumer=P_CONSUMER[name], max_abs_err=0.0,
            plain_ms=cuda_ms(lambda: p_call(specs, name, R, tids, True,
                                            plain=True), reps=3),
            ops=R * chunk * (blocks * 79 + extra),
            nbytes=nbytes(specs[name][0], tids, *(
                a for a in specs[name][1] if isinstance(a, torch.Tensor)),
                *(k if isinstance(k, tuple) else (k,))),
            shape=f"R={R} chunk={chunk}, partitionable layout; "
                  f"{2 * len(slabs)} slabs compared")
        rec[name] = r
        log(f"   plain {r['plain_ms']:.3f} ms")

    rec["arma_rents_chunk"] = arma_checks(dev, R, chunk, clock, n_sm,
                                          sass["normal_chunk"])
    rec.update(composed_kernel_checks(dev, R, chunk, clock, n_sm,
                                      sass["normal_chunk"]))
    rec.update(svc_kernel_checks(dev, clock, n_sm, sass))
    mrec, markov_svc = markov_kernel_checks(dev, clock, n_sm, sass)
    rec.update(mrec)
    rec["model2_service_chunk"].update(
        {f"markov_{k}": v for k, v in markov_svc.items()})
    rec.update(gcurve_kernel_checks(dev, clock, n_sm, sass))

    # slab data shared by D and S
    gen = scen.init_fn(scen.params)
    gen, slab = scen.chunk_fn(scen.params, gen, tids)
    x, c = slab.x, slab.c
    g32 = torch.Generator(device="cpu").manual_seed(5)
    T_len = torch.randint(t0, t0 + 2 * chunk, (R,), generator=g32,
                          dtype=torch.int32).to(dev)

    # D, both kernels, on one slab: +inf-padded levels (a quarter of the
    # rows mask out a level), rows frozen part-way, some all-+inf frontiers
    K = grid.K
    kmask = grid.mask.clone()
    kmask[::4, 1] = False
    lv32 = grid.levels
    fetch = dp_fetch_matrix(grid.M, lv32)
    J = dp_frontier0(R, K, dev)
    J[1::4] = float("inf")
    J[2::4] = torch.rand((len(range(2, R, 4)), K), generator=g32).to(dev)
    valid = tids[None, :] < T_len[:, None]

    def old_route():
        """The fleet DP's chunk before the fusion: the float64 fma32
        assembly of w, the +inf padding, then kernel D on the finished w."""
        svc = x[:, :, None].float() * grid.g[:, None, :]
        w = torch.where(kmask[:, None, :],
                        fma32(c[:, :, None], lv32[:, None, :], svc),
                        float("inf"))
        return H.dp_minplus(J, w, fetch, tids[None, :] < T_len[:, None])

    # the fused kernel D (the fleet path's): with and without the argmin
    # table, at the fleet's K = 3 and (OPT) K = 2, and on ragged slabs --
    # R - 3 rows, a chunk of 1,000 (ragged against the 64-slot tile), of
    # 1,001 (the 4-byte cp.async route) and of 1; plus a K = 16 grid
    ends = grid.restrict_to_endpoints()
    k16 = k16_grid(300, dev)
    fused_cases = [
        ("K=3", (J, c, x, grid.g, lv32, kmask, fetch, T_len, t0)),
        ("K=2", (dp_frontier0(R, 2, dev), c, x, ends.g, ends.levels,
                 ends.mask, dp_fetch_matrix(ends.M, ends.levels), T_len,
                 t0)),
        ("K=3 R-3 chunk=1000", sub_rows(
            (J, c[:, :1000], x[:, :1000], grid.g, lv32, kmask, fetch,
             T_len), R - 3) + (t0,)),
        ("K=3 chunk=1001", (J, c[:, :1001].contiguous(),
                            x[:, :1001].contiguous(), grid.g, lv32, kmask,
                            fetch, T_len, t0)),
        ("K=3 chunk=1", (J, c[:, :1].contiguous(), x[:, :1].contiguous(),
                         grid.g, lv32, kmask, fetch, T_len, t0 + chunk - 1)),
        ("K=16 R=300 chunk=999", (dp_frontier0(300, 16, dev),
                                  c[:300, :999].contiguous(),
                                  x[:300, :999].contiguous(), k16.g,
                                  k16.levels, k16.mask,
                                  dp_fetch_matrix(k16.M, k16.levels),
                                  T_len[:300], t0)),
    ]
    for name, args in fused_cases:
        for with_args in (False, True):
            k = H.dp_fwd_model1(*args, with_args)
            p = H.dp_fwd_model1_plain(*args, with_args)
            torch.cuda.synchronize()
            require(tree_equal(k, p), f"fused D differs from its plain "
                                      f"version ({name}, args {with_args})")
        log(f"D (fused) ok: {name}, argmin table on and off")
    fused = fused_cases[0][1]
    k = H.dp_fwd_model1(*fused, True)
    o = old_route()
    torch.cuda.synchronize()
    require(tree_equal(k, o), "fused D differs from the old route")
    ms = cuda_ms(lambda: H.dp_fwd_model1(*fused), reps=10, batch=10)
    args_ms = cuda_ms(lambda: H.dp_fwd_model1(*fused, True), reps=5,
                      batch=10)
    old_ms = cuda_ms(old_route, reps=5, batch=3)
    plain_ms = cuda_ms(lambda: H.dp_fwd_model1_plain(*fused), reps=3)
    clock = sm_clock_mhz(lambda: H.dp_fwd_model1(*fused), ms)
    Jk = k[0]
    # per row and slot: K products x*g, K FMAs (2 each), K*K adds, K*(K-1)
    # compares, K adds of w
    ops = R * chunk * (K + 2 * K + K * K + K * (K - 1) + K)
    rec["dp_fwd_model1"] = dict(
        replaces="src/repro/kernels/hosting.py:116", ms=ms,
        plain_ms=plain_ms, old_route_ms=old_ms, args_ms=args_ms,
        sm_clock_mhz=clock, cycles_per_slot=ms * 1e-3 * clock * 1e6 / chunk,
        max_abs_err=tree_max_abs(k, o), ops=ops,
        nbytes=nbytes(J, c, x, grid.g, lv32, kmask, fetch, T_len, Jk),
        shape=f"R={R} chunk={chunk} K={K}, no argmin table (the fleet's "
              f"call); {len(fused_cases)} slabs compared with and without")
    log(f"D (fused) timed: {ms:.4f} ms ({args_ms:.4f} ms writing the argmin "
        f"table), old route {old_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"{rec['dp_fwd_model1']['cycles_per_slot']:.1f} cycles a slot at "
        f"{clock:.0f} MHz")
    # the same kernel's ARGS route (the materialised DP and the backtrack's
    # replays): the [R, chunk, K] argmin table written besides
    args_plain_ms, kp = timed_once(lambda: H.dp_fwd_model1_plain(*fused,
                                                                 True))
    require(tree_equal(k, kp), "fused D's argmin table differs from its "
                               "plain version")
    a_rec = rec["dp_fwd_model1 args"] = dict(
        replaces="src/repro/kernels/hosting.py:116", ms=args_ms,
        prev_ms=PREV_MS["dp_fwd_model1 args"], plain_ms=args_plain_ms,
        max_abs_err=tree_max_abs(k, kp), ops=ops, sm_clock_mhz=clock,
        cycles_per_slot=args_ms * 1e-3 * clock * 1e6 / chunk,
        nbytes=nbytes(J, c, x, grid.g, lv32, kmask, fetch, T_len, *k),
        shape=f"R={R} chunk={chunk} K={K}, writing the argmin table "
              f"(with_args=True)")
    a_bound = a_rec["nbytes"] / PEAK_BYTES * 1e3
    log(f"D's ARGS route timed: {a_rec['prev_ms']:.4f} -> {args_ms:.4f} ms "
        f"({a_rec['cycles_per_slot']:.1f} cycles a slot at {clock:.0f} MHz; "
        f"{a_bound / args_ms:.1%} of its byte bound {a_bound:.4f} ms; "
        f"{args_ms / ms:.3f} x the route without the table)")

    # kernel D on a finished w (offline_opt_batch's; off the fleet path):
    # the fleet's K = 3 chunk, then K = 16 and 32 on random w, each
    # against its byte bound, then its tiles' edges
    wck = torch.where(kmask[:, None, :],
                      fma32(c[:, :, None], lv32[:, None, :],
                            x[:, :, None].float() * grid.g[:, None, :]),
                      float("inf"))
    k = H.dp_minplus(J, wck, fetch, valid)
    p = H.dp_minplus_plain(J, wck, fetch, valid)
    torch.cuda.synchronize()
    require(tree_equal(k, p), "D differs from its plain version")
    ms = cuda_ms(lambda: H.dp_minplus(J, wck, fetch, valid), batch=3)
    plain_ms = cuda_ms(lambda: H.dp_minplus_plain(J, wck, fetch, valid),
                       reps=3)
    rec["dp_minplus"] = dict(
        replaces="src/repro/kernels/hosting.py:116", ms=ms, plain_ms=plain_ms,
        max_abs_err=tree_max_abs(k, p), ops=minplus_ops(R, chunk, K),
        nbytes=nbytes(J, wck, fetch, valid, *k), sm_clock_mhz=clock,
        cycles_per_slot=ms * 1e-3 * clock * 1e6 / chunk,
        shape=f"R={R} chunk={chunk} K={K}; a finished w (offline_opt_batch), "
              f"off the fleet path; by_k: K = 16 and 32 on random w, every "
              f"slot valid")
    del wck, k, p
    by_k = {}
    for KK in (16, 32):
        args = finished_w(R, chunk, KK, dev)
        k = H.dp_minplus(*args)
        p = H.dp_minplus_plain(*args)
        torch.cuda.synchronize()
        require(tree_equal(k, p), f"D differs from its plain version at K "
                                  f"= {KK}")
        t_bytes = nbytes(*args, *k) / PEAK_BYTES * 1e3
        t_ops = minplus_ops(R, chunk, KK) / PEAK_OPS * 1e3
        by_k[KK] = dict(ms=cuda_ms(lambda: H.dp_minplus(*args), batch=3),
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations")
        del args, k, p
    rec["dp_minplus"]["by_k"] = by_k
    r = rec["dp_minplus"]
    bound = r["nbytes"] / PEAK_BYTES * 1e3
    log(f"D (finished w) timed: K = 3 {PREV_MS['dp_minplus']:.4f} -> "
        f"{ms:.4f} ms ({bound / ms:.1%} of its byte bound {bound:.4f} ms; "
        f"{r['cycles_per_slot']:.1f} cycles a slot at {clock:.0f} MHz), "
        + ", ".join(f"K = {KK} {v['ms']:.4f} ms ({v['bound_ms'] / v['ms']:.1%}"
                    f" of its bound {v['bound_ms']:.4f} ms, {v['bound_by']})"
                    for KK, v in by_k.items())
        + f"; plain {plain_ms:.3f} ms")
    minplus_edges(dev)

    # S: alpha-RR on K = 3 (timed), a mixed K = 5 grid, RR on K = 2, each
    # from a non-trivial carry (one kernel chunk first); then ragged slabs
    # (R - 3 rows, chunks of 1,000, 1,001 and 1), K = 16, the final fetch
    # dropped, the trace off
    mixed = HostingGrid.from_costs(
        [HostingCosts(M=float(m), levels=(0.0, 0.2, 0.45, 0.7, 1.0),
                      g=(1.0, 0.75, 0.5, 0.2, 0.0)) if i % 2 else
         HostingCosts.three_level(float(m), 0.3, 0.6)
         for i, m in enumerate(np.geomspace(2, 50, R))], device=dev)
    ends = grid.restrict_to_endpoints()
    # (label, policy grid, rows, slots, include_final_fetch, trace)
    cases = [("alpha-RR K=3", grid, R, chunk, True, True),
             ("alpha-RR mixed K=5", mixed, R, chunk, True, True),
             ("RR K=2", ends, R, chunk, True, True),
             ("alpha-RR K=3 R-3 chunk=1000, no final fetch", grid, R - 3,
              1000, False, True),
             ("RR K=2 chunk=1001, no trace", ends, R, 1001, True, False),
             ("alpha-RR K=3 chunk=1", grid, R, 1, False, True),
             ("alpha-RR K=16 R=300 chunk=999", k16, 300, 999, True, True)]
    err = 0.0
    for name, gg, rows, n, iff, trace in cases:
        pol = AlphaRR.batch(gg)
        xs, cs_ = x[:rows, :n].contiguous(), c[:rows, :n].contiguous()
        gs = sub_rows((gg.levels, gg.g, gg.M), rows)
        params = {k_: v[:rows].contiguous() for k_, v in pol.params.items()}
        carry = (alpha_rr_init(params), sim_acc0(rows, gg.K, dev))
        carry, _ = H.sim_chunk_alpha_rr(params, *gs, T_len[:rows],
                                        t0 - n, carry, xs, cs_)
        args = (params, *gs, T_len[:rows], t0, carry, xs, cs_, iff)
        k = H.sim_chunk_alpha_rr(*args, collect_trace=trace)
        p = H.sim_chunk_alpha_rr_plain(*args, collect_trace=trace)
        torch.cuda.synchronize()
        require(tree_equal(k, p), f"S differs from its plain version ({name})")
        err = max(err, tree_max_abs(k, p))
        if name == "alpha-RR K=3":
            (st, acc), _ = k
            timed_bytes = nbytes(*params.values(), *gs, T_len,
                                 *carry[0].values(), *carry[1].values(), x,
                                 c, *st.values(), *acc.values())
            timed = args
        log(f"S ok: {name}")
    ms = cuda_ms(lambda: H.sim_chunk_alpha_rr(*timed, collect_trace=False),
                 reps=10, batch=10)
    trace_ms = cuda_ms(lambda: H.sim_chunk_alpha_rr(*timed), reps=5,
                       batch=10)
    plain_ms = cuda_ms(lambda: H.sim_chunk_alpha_rr_plain(
        *timed, collect_trace=False), reps=3, warmup=0)
    clock = sm_clock_mhz(
        lambda: H.sim_chunk_alpha_rr(*timed, collect_trace=False), ms)
    # per row and slot: K products x*g, K FMAs (2 ops), K subtractions,
    # 2K for the suffix minima, 4K for the margins (sub, abs, FMA), K tie
    # adds, K-1 compares, and about 10 for the accounting
    ops = R * chunk * (12 * K + 9)
    rec["sim_chunk_alpha_rr"] = dict(
        replaces="src/repro/core/simulator.py:147", ms=ms, trace_ms=trace_ms,
        plain_ms=plain_ms, sm_clock_mhz=clock,
        cycles_per_slot=ms * 1e-3 * clock * 1e6 / chunk, max_abs_err=err,
        ops=ops, nbytes=timed_bytes,
        shape=f"R={R} chunk={chunk} K={K}, no trace (the fleet's call); "
              f"{len(cases)} slabs compared")
    cycles = rec["sim_chunk_alpha_rr"]["cycles_per_slot"]
    log(f"S timed: {ms:.4f} ms ({trace_ms:.4f} ms with the trace), plain "
        f"{plain_ms:.3f} ms, {cycles:.1f} cycles a slot at {clock:.0f} MHz")
    return rec


def bt_wavefronts(r, K, chunk):
    """The shared-memory wavefronts of each of B's walk steps, averaged:
    at slot j a walker warp's 8 rows (a lane each, rows 8w .. 8w + 7 of a
    32-row block) load word rl * as + jl * K + r[row, j] of their stage
    (rl the row in the block, jl the slot in its tile, as the row stride);
    a step takes as many wavefronts as the most rows one bank serves.
    Rows past a whole block of 32 are left out.  The tile and the row
    stride are the library's (hosting.cu: be_tile, be_stride)."""
    lib = _build.library("hosting")
    ts = lib.be_tile_slots(K, chunk, 0)
    rows = r.shape[0] // 32 * 32
    j = torch.arange(chunk, device=r.device)
    tile = (chunk - 1 - j) // ts
    jl = j - torch.clamp(chunk - (tile + 1) * ts, min=0)
    rl = torch.arange(rows, device=r.device) % 32
    bank = (rl[:, None] * lib.be_row_stride(ts * K) + jl[None, :] * K
            + r[:rows].long()) % 32
    hits = torch.zeros((rows // 8, chunk, 32), dtype=torch.int32,
                       device=r.device)
    hits.scatter_add_(2, bank.view(rows // 8, 8, chunk).transpose(1, 2),
                      torch.ones((rows // 8, chunk, 8), dtype=torch.int32,
                                 device=r.device))
    return float(hits.amax(dim=2).float().mean())


def table_and_args_edges(dev):
    """S's table variant and D's ARGS route against their plain versions,
    bit for bit, where their redesign's tiles and rings turn over (the
    library's own sizes: ``sim_tile_slots`` / ``sim_ring_stages``,
    ``dp_tile_slots`` / ``dp_args_stages``): a slot either side of a tile
    and of the ring's worth of tiles (chunk % 4 != 0: the 4-byte routes),
    whole 16-byte groups either side of the ring (S's tensor copies, D's
    bulk write-back), one slot, R - 3 rows; S at K = 2, 3, 5 and 16 for
    the static (one table row), MDP and ABC tables (two), side channels
    of -1 .. 2 (clipped), thresholds inside the arrivals' range, with and
    without the trace and the final fetch, under Model 1 and on Model-2
    slabs with and without a column map; D at K = 3, 5 and 16, with and
    without a column map; and S's small batches with the rent and the
    fetch fused (E passes over its trace).  Returns the count of calls
    compared."""
    lib = _build.library("hosting")
    gen = np.random.default_rng(24)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    t0 = 8192
    n_cmp = 0

    def inputs(R, chunk, K, Kf):
        lv = np.sort(gen.random((R, K)).astype(np.float32), axis=1)
        lv[:, 0] = 0.0
        d = dict(lv=t(lv), g=t(np.clip(0.9 - lv, 0, 1).astype(np.float32)),
                 M=t((gen.random(R) * 20 + 0.5).astype(np.float32)),
                 T_len=t(gen.integers(t0 - 3, t0 + chunk + 3, R)
                         .astype(np.int32)),
                 c=t((gen.random((R, chunk)) * 1.5).astype(np.float32)),
                 x=t(gen.integers(0, 30, (R, chunk)).astype(np.int32)),
                 side=t(gen.integers(-1, 3, (R, chunk)).astype(np.int32)),
                 svc=t((gen.integers(0, 8, (R, chunk, Kf)) / 2)
                       .astype(np.float32)),
                 cols=t(np.sort(gen.permuted(np.tile(np.arange(Kf), (R, 1)),
                                             axis=1)[:, :K], 1)
                        .astype(np.int32)))
        return d

    def table(policy, R, K):
        if policy == "static":
            return (t(np.repeat(gen.integers(0, K, (R, 1, 1)), K, 2)
                      .astype(np.int32)), "none", None)
        pi = t(gen.integers(0, K, (R, 2, K)).astype(np.int32))
        if policy == "mdp":
            return pi, "side", None
        return pi, "x", t(gen.choice(np.float32([0.5, 1.5, 14.5]), R))

    def same(what, k, p):
        nonlocal n_cmp
        torch.cuda.synchronize()
        require(tree_equal(k, p), f"{what} differs from its plain version")
        n_cmp += 1

    # S: (R, chunk, K, service) around its tiles and rings
    cases = []
    for K, svc in ((3, "model1"), (3, "model2"), (2, "model1"),
                   (5, "model2"), (16, "model2"), (16, "model1")):
        tile = lib.sim_tile_slots(K, svc != "model1")
        ring = lib.sim_ring_stages(K, svc != "model1") * tile
        require(tile > 0 and tile % 16 == 0 and ring >= 2 * tile,
                f"S's table tile at K = {K}: {tile} slots, ring {ring}")
        if K == 3:
            cases += [(4093, n, K, svc) for n in (tile - 1, tile + 1,
                                                  ring - 1, ring + 1,
                                                  ring - 4, ring + 4)]
            cases += [(37, 1, K, svc), (4093, 1001, K, svc)]
        else:
            cases += [(61, 2 * ring + 1, K, svc), (64, 2 * ring + 4, K, svc)]
    cases += [(4093, lib.sim_ring_stages(3, 1)
               * lib.sim_tile_slots(3, 1) + 4, 3, "model2-cols")]
    for i, (R, chunk, K, svc) in enumerate(cases):
        d = inputs(R, chunk, K, 5 if svc == "model2-cols" else K)
        for j, policy in enumerate(("static", "mdp", "abc")):
            trace, iff = (i + j) % 2 == 0, (i + j) % 3 != 0
            carry = ({"r": t(gen.integers(0, K, R).astype(np.int32))},
                     {"sums": t((gen.random((R, 3)) * 100)
                                .astype(np.float32)),
                      "counts": t(gen.integers(0, 50, (R, K))
                                  .astype(np.int32))})
            tab = table(policy, R, K)
            if svc == "model1":
                a = (*tab, d["lv"], d["g"], d["M"], d["T_len"], t0, carry,
                     d["x"], d["c"], d["side"], iff, trace)
                kern, plain = H.sim_chunk_table, H.sim_chunk_table_plain
            else:
                a = (*tab, d["lv"], d["M"], d["T_len"], t0, carry, d["x"],
                     d["c"], d["side"], d["svc"],
                     d["cols"] if svc == "model2-cols" else None, iff, trace)
                kern = H.sim_chunk_table_svc
                plain = H.sim_chunk_table_svc_plain
            same(f"S's table variant ({R} rows, {chunk} slots, K = {K}, "
                 f"{svc}, {policy}, trace {trace}, final fetch {iff})",
                 kern(*a), plain(*a))
    log(f"S's table variant == its plain version at its tiles' and rings' "
        f"edges: {len(cases) * 3} cases")

    # D's ARGS route: (R, chunk, K, service) around its tiles and rings
    cases = []
    for K in (3, 5, 16):
        tile = lib.dp_tile_slots(K)
        ring = lib.dp_args_stages(K, 0) * tile
        require(tile > 0 and tile % 16 == 0 and lib.dp_args_stages(K, 1) >= 1
                and ring >= tile, f"D's tile at K = {K}: {tile} slots")
        if K == 3:
            cases += [(4093, n, K, "model1") for n in (
                tile - 1, tile + 1, ring - 1, ring + 1, ring - 4, ring + 4,
                1, 1001)]
            cases += [(4093, ring + 4, K, "model2"),
                      (4093, ring - 1, K, "model2-cols"),
                      (37, ring + 4, K, "model2-cols")]
        else:
            cases += [(61, 2 * ring + 1, K, "model1"),
                      (64, 2 * ring + 4, K, "model2")]
    for R, chunk, K, svc in cases:
        d = inputs(R, chunk, K, 5 if svc == "model2-cols" else K)
        kmask = t(gen.random((R, K)) < 0.85)
        kmask[:, 0] = True
        J = (gen.random((R, K)) * 3).astype(np.float32)
        J[0::7] = np.inf
        J = torch.where(kmask, t(J), float("inf"))
        fetch = dp_fetch_matrix(d["M"], d["lv"])
        if svc == "model1":
            a = (J, d["c"], d["x"], d["g"], d["lv"], kmask, fetch,
                 d["T_len"], t0, True)
            same(f"D's ARGS route ({R} rows, {chunk} slots, K = {K})",
                 H.dp_fwd_model1(*a), H.dp_fwd_model1_plain(*a))
        else:
            cols = d["cols"] if svc == "model2-cols" else None
            a = (J, d["c"], d["svc"], d["lv"], kmask, fetch, d["T_len"], t0,
                 cols, True)
            same(f"D's ARGS route ({R} rows, {chunk} slots, K = {K}, "
                 f"{svc})", H.dp_fwd_model2(*a), H.dp_fwd_model2_plain(*a))
    log(f"D's ARGS route == its plain version at its tiles' and rings' "
        f"edges: {len(cases)} cases")

    # S's table variant with the rent and the fetch fused (MDP / ABC on
    # a small batch, simulator.xla_fetch_fma), with and without the trace
    for R, K, policy, svc in ((5, 3, "mdp", "model1"), (2, 12, "abc", "model1"),
                              (3, 6, "mdp", "model2")):
        d = inputs(R, 777, K, K)
        for trace in (False, True):
            carry = ({"r": t(gen.integers(0, K, R).astype(np.int32))},
                     {"sums": t((gen.random((R, 3)) * 100)
                                .astype(np.float32)),
                      "counts": t(gen.integers(0, 50, (R, K))
                                  .astype(np.int32))})
            tab = table(policy, R, K)
            if svc == "model1":
                a = (*tab, d["lv"], d["g"], d["M"], d["T_len"], t0, carry,
                     d["x"], d["c"], d["side"], True, trace, True, True)
                kern, plain = H.sim_chunk_table, H.sim_chunk_table_plain
            else:
                a = (*tab, d["lv"], d["M"], d["T_len"], t0, carry, d["x"],
                     d["c"], d["side"], d["svc"], None, True, trace, True,
                     True)
                kern = H.sim_chunk_table_svc
                plain = H.sim_chunk_table_svc_plain
            same(f"S's table variant, the rent and the fetch fused ({R} "
                 f"rows, K = {K}, {policy}, {svc}, trace {trace})",
                 kern(*a), plain(*a))
    log("S's table variant with the rent and the fetch fused == its plain "
        "version (small batches)")
    return n_cmp


def schedule_kernel_checks(dev):
    """Kernels B (the DP's backtrack) and E (schedule pricing) against
    their plain versions, bit for bit, on both routes (bulk copies; and
    4-byte copies, on ragged chunks and on the fleet's shape with one
    input a word off a 16-byte boundary): at the fleet's shape (4,096 rows
    x 4,096 slots, K = 3: the fused D's own argmin table of a scenario
    chunk walked back, the schedule it gives priced, E with its sums'
    products fused and not), on ragged slabs (R - 3 rows, 1,001 slots, an
    odd t0), a slot either side of a tile and of the ring's worth of
    tiles, a bulk chunk of odd R, at K = 1, 2 and 32 (random tables; E on
    levels out of range too), and E on Model-2 slabs through a column map
    (5 and 32 levels), on a schedule that changes level every slot and on
    one that never does; then S with the rent fused (one alpha-RR row,
    three static rows: the reference's small batches).  Returns the
    records of B and E, timed at the fleet's shape on both routes, B also
    on one block of 32 rows (its whole kernel); the log adds B's walk's
    assumed floor and its bank wavefronts a step, modelled from the stage
    layout at K = 3 and 32."""
    R, chunk, K = N_M * N_ALPHA * N_SEEDS, CHUNK, 3
    grid = fleet_grid(N_M, N_ALPHA, dev).repeat_rows(N_SEEDS)
    scen = sc.replicate_seeds(bernoulli_uniform(N_M * N_ALPHA, dev), N_SEEDS)
    t0 = T_MAIN - chunk
    _, slab = scen.chunk_fn(scen.params, scen.init_fn(scen.params),
                            sc.base.chunk_tids(t0, chunk, dev))
    x, c = slab.x, slab.c
    T_len = torch.full((R,), T_MAIN, dtype=torch.int32, device=dev)
    T_len[::7] = t0 + 1000                      # horizons inside the chunk
    fetch = dp_fetch_matrix(grid.M, grid.levels)
    J, args = H.dp_fwd_model1(dp_frontier0(R, K, dev), c, x, grid.g,
                              grid.levels, grid.mask, fetch, T_len, t0, True)
    k = torch.argmin(J, dim=1).to(torch.int32)
    rng = np.random.default_rng(22)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    lib = _build.library("hosting")
    bt = lib.be_tile_slots(K, chunk, 0)
    ring = lib.be_ring_stages() * bt
    rec = {}

    # B
    def d_table(rows, n):                       # D's own table, cut
        return k[:rows].contiguous(), args[:rows, :n].contiguous()

    def random_table(rows, n, KK):
        return (t(rng.integers(0, KK, rows).astype(np.int32)),
                t(rng.integers(0, KK, (rows, n, KK)).astype(np.int32)))

    b1 = lib.be_tile_slots(1, 1 << 20, 0)
    cases = [("fleet slab", k, args),
             ("fleet slab, 4-byte route", k, H.misaligned(args)),
             ("R - 3 rows, 1,001 slots", *d_table(R - 3, 1001)),
             (f"a tile - 1 ({bt - 1} slots)", *d_table(R - 3, bt - 1)),
             (f"a tile + 1 ({bt + 1})", *d_table(R - 3, bt + 1)),
             (f"the ring - 1 ({ring - 1}), 300 rows",
              *d_table(300, ring - 1)),
             (f"the ring + 1 ({ring + 1}), 300 rows",
              *d_table(300, ring + 1)),
             (f"33 rows, the ring + 4 ({ring + 4}): bulk",
              *d_table(33, ring + 4)),
             ("K = 32, 65 rows", *random_table(65, 777, 32)),
             (f"K = 1, 65 rows, {4 * b1 + 1} slots",
              *random_table(65, 4 * b1 + 1, 1)),
             ("K = 2, 257 rows, 999 slots", *random_table(257, 999, 2))]
    walks = {}
    for name, kk, aa in cases:
        kb = H.dp_backtrack(kk, aa)
        pb = H.dp_backtrack_plain(kk, aa)
        torch.cuda.synchronize()
        require(tree_equal(kb, pb), f"B differs from its plain version "
                                    f"({name})")
        log(f"B ok: {name}")
        if name in ("fleet slab", "K = 32, 65 rows"):
            walks[aa.shape[2]] = bt_wavefronts(kb[1], aa.shape[2],
                                               aa.shape[1])
    ms = cuda_ms(lambda: H.dp_backtrack(k, args), reps=10, batch=10)
    a_narrow = H.misaligned(args)
    narrow_ms = cuda_ms(lambda: H.dp_backtrack(k, a_narrow), reps=10,
                        batch=10)
    k32, a32 = d_table(32, chunk)
    one_block_ms = cuda_ms(lambda: H.dp_backtrack(k32, a32), reps=10,
                           batch=10)
    clock = sm_clock_mhz(lambda: H.dp_backtrack(k, args), ms)
    plain_ms, _ = timed_once(lambda: H.dp_backtrack_plain(k, args))
    kb, r = H.dp_backtrack(k, args)
    b_bytes = nbytes(k, args, kb, r)
    rec["dp_backtrack"] = dict(
        replaces="src/repro/core/policies/offline_opt.py:162 (no TPU "
                 "kernel: the reverse lax.scan of dp_backtrack_chunk)",
        ms=ms, prev_ms=PREV_MS["dp_backtrack"], plain_ms=plain_ms,
        narrow_ms=narrow_ms, one_block_ms=one_block_ms,
        one_block_cycles_per_slot=one_block_ms * clock * 1e3 / chunk,
        sm_clock_mhz=clock, cycles_per_slot=ms * clock * 1e3 / chunk,
        max_abs_err=0.0, ops=R * chunk, nbytes=b_bytes,
        shape=f"R={R} chunk={chunk} K={K}: D's table of a fleet chunk "
              f"(bulk route; narrow_ms: the 4-byte route; one_block_ms: "
              f"its first 32 rows, one block's whole kernel, copies "
              f"included)")
    b = rec["dp_backtrack"]
    b_bound = b_bytes / PEAK_BYTES * 1e3
    log(f"B timed: {b['prev_ms']:.4f} -> {ms:.4f} ms ({b_bound / ms:.1%} "
        f"of its byte bound {b_bound:.4f} ms; {b['cycles_per_slot']:.1f} "
        f"cycles a slot at {clock:.0f} MHz); the 4-byte route "
        f"{narrow_ms:.4f} ms; one block of 32 rows (its whole kernel, "
        f"copies included) {one_block_ms:.4f} ms, "
        f"{b['one_block_cycles_per_slot']:.1f} cycles a slot; the walk's "
        f"floor {chunk * B_STEP_CYCLES / (clock * 1e3):.4f} ms "
        f"({B_STEP_CYCLES} cycles a slot, assumed, not measured); bank "
        f"wavefronts a walk step, from a model of the stage layout (not "
        f"counted on the card): {walks[3]:.3f} at K = 3 (D's table), "
        f"{walks[32]:.3f} at K = 32 (a random table); plain "
        f"{plain_ms:.1f} ms")

    # E
    et = lib.be_tile_slots(3, chunk, 1)
    ering = lib.be_ring_stages() * et
    sums = (rng.random((R, 3)) * 100).astype(np.float32)
    sums[::5] = -0.0                    # x + 0 is +0: masked slots count
    sums = t(sums)
    carry = (t(rng.integers(0, K, R).astype(np.int32)),
             {"sums": sums, "counts": t(rng.integers(0, 50, (R, K))
                                        .astype(np.int32))})
    svc = t((rng.integers(0, 8, (R, 1001, 5)) / 2).astype(np.float32))
    cols = t(np.tile(np.int32([0, 2, 4]), (R, 1)))
    svc32 = t((rng.integers(0, 8, (300, 333, 32)) / 2).astype(np.float32))
    cols32 = t(np.tile(np.int32([0, 13, 31]), (300, 1)))
    r_odd = t(rng.integers(-1, K + 1, (R, 1001)).astype(np.int32))
    r_every = t(np.tile((np.arange(1001) % K).astype(np.int32), (R, 1)))
    r_never = t(np.repeat(rng.integers(0, K, (R, 1)).astype(np.int32),
                          1001, axis=1))
    k32 = HostingGrid.from_costs([HostingCosts(
        M=4.0, levels=tuple(np.linspace(0, 1, 32)),
        g=tuple(1 - np.linspace(0, 1, 32)))] * 65, device=dev)

    def e_case(rows, n, rr, tt0=t0, model2=None):
        """E's arguments on the fleet's first rows and slots, schedule rr
        (Model 1; model2: (svc, cols) instead)."""
        a_ = (grid.levels[:rows].contiguous(), grid.M[:rows].contiguous(),
              T_len[:rows].contiguous(), tt0, (
                  carry[0][:rows].contiguous(),
                  {k_: v[:rows].contiguous() for k_, v in carry[1].items()}),
              rr[:rows, :n].contiguous(), c[:rows, :n].contiguous())
        if model2 is not None:
            return a_, dict(svc=model2[0][:rows, :n].contiguous(),
                            svc_cols=model2[1][:rows].contiguous())
        return a_, dict(x=x[:rows, :n].contiguous(),
                        g=grid.g[:rows].contiguous())

    fleet = ((grid.levels, grid.M, T_len, t0, carry, r, c),
             dict(x=x, g=grid.g))
    ecases = [
        ("fleet slab",) + fleet,
        ("fleet slab, 4-byte route", fleet[0][:5] + (H.misaligned(r), c),
         fleet[1]),
        ("R - 3 rows, 1,001 slots, odd t0",
         *e_case(R - 3, 1001, r_odd, t0 + 1)),
        ("Model-2 slab of 5 levels, a column map",
         *e_case(R, 1001, r_odd, model2=(svc, cols))),
        ("Model-2 slab of 32 levels, a column map, 300 rows",
         *e_case(300, 333, r_odd, model2=(svc32, cols32))),
        (f"a tile - 1 ({et - 1} slots)", *e_case(R - 3, et - 1, r)),
        (f"a tile + 1 ({et + 1})", *e_case(R - 3, et + 1, r)),
        (f"the ring - 1 ({ering - 1}), 300 rows",
         *e_case(300, ering - 1, r_odd)),
        (f"the ring + 1 ({ering + 1}), 300 rows",
         *e_case(300, ering + 1, r_odd)),
        (f"33 rows, the ring + 4 ({ering + 4}): bulk",
         *e_case(33, ering + 4, r_odd)),
        ("a new level every slot, 1,001 slots",
         *e_case(R, 1001, r_every)),
        ("one level a row throughout, 1,000 slots",
         *e_case(R, 1000, r_never)),
        ("K = 32, 65 rows", (k32.levels, k32.M, T_len[:65], t0, (
            carry[0][:65].contiguous(), {
                "sums": sums[:65].contiguous(), "counts": t(rng.integers(
                    0, 9, (65, 32)).astype(np.int32))}), t(rng.integers(
                        -1, 33, (65, 777)).astype(np.int32)),
            c[:65, :777].contiguous()),
         dict(x=x[:65, :777].contiguous(), g=k32.g))]
    for name, a, kw in ecases:
        for fma in (False, True):
            ke = H.schedule_chunk(*a, **kw, acc_fma=fma)
            pe = H.schedule_chunk_plain(*a, **kw, acc_fma=fma)
            torch.cuda.synchronize()
            require(tree_equal(ke, pe), f"E differs from its plain version "
                                        f"({name}, fused sums {fma})")
        log(f"E ok: {name}, the sums' products fused and not")
    a, kw = ecases[0][1], ecases[0][2]
    ms = cuda_ms(lambda: H.schedule_chunk(*a, **kw), reps=10, batch=10)
    a_narrow, kw_narrow = ecases[1][1], ecases[1][2]
    narrow_ms = cuda_ms(lambda: H.schedule_chunk(*a_narrow, **kw_narrow),
                        reps=10, batch=10)
    clock = sm_clock_mhz(lambda: H.schedule_chunk(*a, **kw), ms)
    plain_ms, _ = timed_once(lambda: H.schedule_chunk_plain(*a, **kw))
    out = H.schedule_chunk(*a, **kw)
    e_bytes = nbytes(grid.levels, grid.M, T_len, carry[0],
                     *carry[1].values(), r, c, x, grid.g, out[0],
                     *out[1].values())
    # per row and slot: the two level selects, the fetch (sub, max, mul),
    # the rent and the service products, three adds, the count
    rec["schedule_chunk"] = dict(
        replaces="src/repro/core/simulator.py:390 (no TPU kernel: the "
                 "lax.scan of schedule_chunk_core)",
        ms=ms, prev_ms=PREV_MS["schedule_chunk"], plain_ms=plain_ms,
        narrow_ms=narrow_ms, sm_clock_mhz=clock,
        cycles_per_slot=ms * clock * 1e3 / chunk, max_abs_err=0.0,
        ops=R * chunk * 10, nbytes=e_bytes,
        shape=f"R={R} chunk={chunk} K={K}: a backtracked schedule priced "
              f"under Model 1 (bulk route; narrow_ms: the 4-byte route)")
    e = rec["schedule_chunk"]
    e_bound = e_bytes / PEAK_BYTES * 1e3
    log(f"E timed: {e['prev_ms']:.4f} -> {ms:.4f} ms ({e_bound / ms:.1%} "
        f"of its byte bound {e_bound:.4f} ms; {e['cycles_per_slot']:.1f} "
        f"cycles a slot at {clock:.0f} MHz); the 4-byte route "
        f"{narrow_ms:.4f} ms; plain {plain_ms:.1f} ms")

    # S with the rent fused: one alpha-RR row, three static rows
    from repro_torch.core.policies.baselines import static_step
    for name, rows in (("alpha-RR", 1), ("static", 3)):
        gg = HostingGrid.from_costs([HostingCosts(
            M=5.0, levels=(0.0, 0.3, 0.7, 1.0), g=(1.0, 0.5, 0.2, 0.0))]
            * rows, device=dev)
        xs, cs_ = x[:rows].contiguous(), c[:rows].contiguous()
        acc = sim_acc0(rows, 4, dev)
        if name == "alpha-RR":
            params = AlphaRR.batch(gg).params
            sa = (params, gg.levels, gg.g, gg.M, T_len[:rows].contiguous(),
                  t0, (alpha_rr_init(params), acc), xs, cs_, True, True,
                  True)
            kern, plain = H.sim_chunk_alpha_rr, H.sim_chunk_alpha_rr_plain
        else:
            tab = table_form(static_step, {"level_idx": torch.full(
                (rows,), 2, dtype=torch.int32, device=dev)}, 4)
            sa = (*tab, gg.levels, gg.g, gg.M, T_len[:rows].contiguous(), t0,
                  ({"r": torch.zeros(rows, dtype=torch.int32, device=dev)},
                   acc), xs, cs_, None, True, True, True)
            kern, plain = H.sim_chunk_table, H.sim_chunk_table_plain
        ks, ps = kern(*sa), plain(*sa)
        torch.cuda.synchronize()
        require(tree_equal(ks, ps), f"S with the rent fused differs from "
                                    f"its plain version ({name})")
        log(f"S ok: {name}, {rows} row(s), the rent fused")
    return rec


def arma_checks(dev, R, chunk, clock, n_sm, normal_sass):
    """Kernel P's ARMA chunk against its plain version, bit for bit, in
    both layouts: per-instance coefficients (p = 4, q = 2, as the spot
    rents), three chunks in a row with the state carried -- 1,000 slots
    (ragged against the tile), 1,001 (chunk % 4 != 0) from t0 = 1,000,
    then the fleet's 4,096; R - 3 rows (32 rows a block), then 40 rows
    (the figures' slabs, 8 rows a block) over Figs 10-11's two chunks of
    2,000.  Timed on the spot stream's own params at the fleet's shape.
    Returns its record."""
    spot = spot_params(N_M * N_ALPHA, dev)
    g = torch.Generator(device="cpu").manual_seed(11)
    err = 0.0
    for rows, chunks in ((R - 3, ((0, 1000), (1000, 1001), (2001, chunk))),
                         (40, ((0, 2000), (2000, 2000)))):
        phi = (torch.rand((rows, 4), generator=g) * 0.15).to(dev)
        th = (torch.rand((rows, 2), generator=g) * 0.3).to(dev)
        keys, sig, mean, lo, hi = (spot[k][:rows].contiguous() for k in (
            "key", "sigma", "mean", "c_min", "c_max"))
        for part in (True, False):
            eps0 = H.normal_chunk(keys, sc.base.chunk_tids(0, 2, dev).flip(0),
                                  sig, part)
            k_state = p_state = (torch.zeros((rows, 4), device=dev), eps0)
            for t0, n in chunks:
                tids = sc.base.chunk_tids(t0, n, dev)
                k = H.arma_rents_chunk(keys, tids, *k_state, phi, th, sig,
                                       mean, lo, hi, part)
                pl = H.arma_rents_chunk_plain(keys, tids, *p_state, phi, th,
                                              sig, mean, lo, hi, part)
                torch.cuda.synchronize()
                require(tree_equal(k, pl), f"ARMA differs from its plain "
                                           f"version ({rows} rows, t0={t0}, "
                                           f"{n} slots, layout {part})")
                err = max(err, tree_max_abs(k, pl))
                k_state, p_state = k[:2], pl[:2]
            log(f"P arma_rents_chunk ok: {rows} rows, {len(chunks)} chunks, "
                f"state carried, per-instance coefficients, "
                f"{'partitionable' if part else 'original'} layout")
    tids = sc.base.chunk_tids(T_MAIN - chunk, chunk, dev)
    st = {"hist": torch.zeros((R, 4), device=dev),
          "eps": H.normal_chunk(spot["key"],
                                sc.base.chunk_tids(0, 2, dev).flip(0),
                                spot["sigma"])}
    args = (spot["key"], tids, st["hist"], st["eps"], spot["phi"],
            spot["th"], spot["sigma"], spot["mean"], spot["c_min"],
            spot["c_max"])
    ms = cuda_ms(lambda: H.arma_rents_chunk(*args), reps=7, batch=10)
    plain_ms = cuda_ms(lambda: H.arma_rents_chunk_plain(*args), reps=1,
                       warmup=0)
    alu, total = normal_sass
    out = H.arma_rents_chunk(*args)
    r = dict(
        replaces="src/repro/core/scenarios/streams.py:330", ms=ms,
        prev_ms=PREV_MS["arma_rents_chunk"], plain_ms=plain_ms,
        max_abs_err=err, sm_clock_mhz=clock,
        cycles_per_slot=ms * 1e-3 * clock * 1e6 / chunk,
        int_pipe_bound_ms=R * chunk * alu / (64 * n_sm * clock * 1e3),
        issue_bound_ms=R * chunk * total / (128 * n_sm * clock * 1e3),
        latency_bound_ms=chunk * ARMA_CHAIN_OPS * FP32_LATENCY
        / (clock * 1e3),
        ops=R * chunk * (2 * 79 + 5 + NORMAL_FLOPS + ARMA_STEP_FLOPS),
        nbytes=nbytes(*args, *out),
        shape=f"R={R} chunk={chunk} p=4 q=2 (the spot rents), partitionable "
              f"layout; 5 chunks x 2 layouts compared (R - 3 and 40 rows)")
    log(f"P arma_rents_chunk timed: {PREV_MS['arma_rents_chunk']:.4f} -> "
        f"{ms:.4f} ms (previous design -> this one), plain {plain_ms:.1f} "
        f"ms; "
        f"bounds: integer pipe (the normals' hashes) "
        f"{r['int_pipe_bound_ms']:.4f} ms, issue "
        f"{r['issue_bound_ms']:.4f} ms, the recursion's latency "
        f"{r['latency_bound_ms']:.4f} ms ({ARMA_CHAIN_OPS} dependent ops "
        f"x {FP32_LATENCY} cycles a slot at {clock:.0f} MHz)")
    return r


def composed_kernel_checks(dev, R, chunk, clock, n_sm, normal_sass):
    """The composed leg's two P variants against their plain versions, bit
    for bit, in both layouts.  ARMA at q = 1 (the leg's ARMA(2, 1) rents,
    per-instance coefficients on the second check): its 4,096 rows over a
    chunk of 4,096 from t0 = 0, then 1,001 slots and one, the state
    carried; on one row (the kMa1Chain instance) over 4,000, 999 and one
    slot.  The shaped uniform of one key: ``jax.random.choice``'s (1,024,)
    draw and ``model2_service_matrix``'s (6,001, 7) one (T * R odd: the
    original layout appends a 0 counter), and that matrix on the card ==
    on the CPU.  Returns their records, timed at the leg's shapes."""
    rep = sc.replicate_seeds(composed_scenario(N_M * N_ALPHA, dev), N_SEEDS,
                             antithetic=True)
    arma = rep.params["rent"]["subs"][1]
    require(arma["th"].shape == (R, 1), "the composed leg's ARMA is q = 1")
    g = torch.Generator(device="cpu").manual_seed(17)
    err = 0.0
    for rows, chunks, per_row in ((R, ((0, chunk), (chunk, 1001),
                                       (chunk + 1001, 1)), False),
                                  (R - 3, ((5, 999), (1004, 64)), True),
                                  (1, ((0, 4000), (4000, 999), (4999, 1)),
                                   True)):
        keys, sig, mean, lo, hi, phi, th = (arma[k][:rows].contiguous() for k
                                           in ("key", "sigma", "mean",
                                               "c_min", "c_max", "phi",
                                               "th"))
        if per_row:
            phi = (torch.rand((rows, 2), generator=g) * 0.4).to(dev)
            th = (torch.rand((rows, 1), generator=g) * 0.6).to(dev)
        for part in (True, False):
            eps0 = sig[:, None] * H.normal_chunk(
                keys, sc.base.chunk_tids(0, 1, dev), torch.ones_like(sig),
                part)
            k_state = p_state = (torch.zeros((rows, 2), device=dev), eps0)
            for t0, n in chunks:
                tids = sc.base.chunk_tids(t0, n, dev)
                before = H.arma_rents_chunk.ma1_launches
                k = H.arma_rents_chunk(keys, tids, *k_state, phi, th, sig,
                                       mean, lo, hi, part)
                pl = H.arma_rents_chunk_plain(keys, tids, *p_state, phi, th,
                                              sig, mean, lo, hi, part)
                torch.cuda.synchronize()
                require(H.arma_rents_chunk.ma1_launches == before + 1,
                        "ARMA at q = 1 did not count its launch")
                require(tree_equal(k, pl), f"ARMA q = 1 differs from its "
                                           f"plain version ({rows} rows, "
                                           f"t0={t0}, {n} slots, layout "
                                           f"{part})")
                err = max(err, tree_max_abs(k, pl))
                k_state, p_state = k[:2], pl[:2]
        log(f"P arma_rents_chunk q = 1 ok: {rows} rows, {len(chunks)} "
            f"chunks, state carried, both layouts")
    tids = sc.base.chunk_tids(0, chunk, dev)
    eps0 = arma["sigma"][:, None] * H.normal_chunk(
        arma["key"], sc.base.chunk_tids(0, 1, dev),
        torch.ones_like(arma["sigma"]))
    args = (arma["key"], tids, torch.zeros((R, 2), device=dev), eps0,
            arma["phi"], arma["th"], arma["sigma"], arma["mean"],
            arma["c_min"], arma["c_max"])
    ms = cuda_ms(lambda: H.arma_rents_chunk(*args), reps=7, batch=10)
    plain_ms, _ = timed_once(lambda: H.arma_rents_chunk_plain(*args))
    out = H.arma_rents_chunk(*args)
    alu, total = normal_sass
    recs = {"arma_rents_chunk ma1": dict(
        replaces="src/repro/core/scenarios/streams.py:330", ms=ms,
        plain_ms=plain_ms, max_abs_err=err, sm_clock_mhz=clock,
        cycles_per_slot=ms * 1e-3 * clock * 1e6 / chunk,
        int_pipe_bound_ms=R * chunk * alu / (64 * n_sm * clock * 1e3),
        issue_bound_ms=R * chunk * total / (128 * n_sm * clock * 1e3),
        latency_bound_ms=chunk * ARMA1_CHAIN_OPS * FP32_LATENCY
        / (clock * 1e3),
        ops=R * chunk * (2 * 79 + 5 + NORMAL_FLOPS + ARMA1_STEP_FLOPS),
        nbytes=nbytes(*args, *out),
        shape=f"R={R} chunk={chunk} p=2 q=1 (the composed leg's rents), "
              f"partitionable layout; 8 chunks x 2 layouts compared (R, "
              f"R - 3 and 1 rows)")}
    log(f"P arma_rents_chunk q = 1 timed: {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms; bounds: integer pipe (the normals' hashes) "
        f"{recs['arma_rents_chunk ma1']['int_pipe_bound_ms']:.4f} ms, the "
        f"recursion's latency "
        f"{recs['arma_rents_chunk ma1']['latency_bound_ms']:.4f} ms")

    key = sc.prng_key(12, dev)
    for part in (True, False):
        for n in (COMPOSED_B, 1, 2, 6001 * 7):
            k = H.shaped_uniform(key, n, part)
            p = H.shaped_uniform_plain(key, n, part)
            torch.cuda.synchronize()
            require(torch.equal(k, p), f"the shaped uniform differs from its "
                                       f"plain version (n={n}, layout "
                                       f"{part})")
        gx = torch.Generator(device="cpu").manual_seed(3)
        x = torch.randint(0, 8, (6001,), generator=gx, dtype=torch.int32)
        costs = HostingCosts(M=4.0, levels=(0.0, 0.3, 0.7, 1.0),
                             g=(1.0, 0.6, 0.2, 0.0))
        with H.threefry_partitionable(part):
            m_card = simulator.model2_service_matrix(key, costs, x, 7,
                                                     device=dev)
            m_cpu = simulator.model2_service_matrix(key.cpu(), costs, x, 7,
                                                    device="cpu")
        require(torch.equal(m_card.cpu(), m_cpu),
                f"model2_service_matrix: card != CPU (layout {part})")
    log("P shaped_uniform ok: n = 1,024, 1, 2 and 6,001 x 7, both layouts; "
        "model2_service_matrix (6,001 x 7 requests, 4 levels) card == CPU")
    for name, n, shape in (
            ("shaped_uniform", COMPOSED_B,
             f"n={COMPOSED_B} (jax.random.choice's draw in "
             f"mixture_from_weights), partitionable layout; also n = 6,001 "
             f"x 7 (model2_service_matrix) and 1, 2, both layouts"),
            ("shaped_uniform model2", 6001 * 7, None)):
        ms = cuda_ms(lambda: H.shaped_uniform(key, n), reps=7, batch=20)
        plain_ms, out = timed_once(lambda: H.shaped_uniform_plain(key, n))
        r = dict(ms=ms, plain_ms=plain_ms,
                 ops=n * (79 + 5), nbytes=nbytes(key, out))
        log(f"P {name} timed: {ms:.4f} ms (n = {n}), plain {plain_ms:.3f} ms")
        if shape is None:
            recs["shaped_uniform"].update(
                model2_ms=ms, model2_plain_ms=plain_ms, model2_n=n,
                model2_bound_ms=max(r["nbytes"] / PEAK_BYTES,
                                    r["ops"] / PEAK_OPS) * 1e3)
            continue
        r.update(replaces="src/repro/core/scenarios/combinators.py:212",
                 consumer="src/repro/core/simulator.py:499", max_abs_err=0.0,
                 shape=shape)
        recs[name] = r
    return recs


# ----------------------------------------------------------------------
# Phase 2, Model 2: P's Poisson and service variants, D and S on a
# Model-2 service slab.
# ----------------------------------------------------------------------

POISSON_LAMS = (0.0, 0.15, 1.2, 2.0, 4.0, 8.0, 9.99)
# the 32-bit operations of one Knuth round past its three threefry blocks
# (an FMA counts 2): XLA's log (~25), the uniform's mapping (5), the add
# and the compare
KNUTH_ROUND_OPS = 32
# of one live request of the service kernel past its block: its word
# (the layout's xor; each level's integer threshold on the word stands
# for the uniform's mapping) and a compare and an add a level
M2_REQUEST_OPS = 1


def svc_grids(dev, rows):
    """The Model-2 checks' grids on ``rows`` rows: the fleet's K = 3, a
    mixed K = 5 grid (every other row K = 3, padded) and a K = 16 grid."""
    g3 = fleet_grid(N_M, N_ALPHA, dev).repeat_rows(N_SEEDS)
    g3 = HostingGrid(*sub_rows((g3.M, g3.levels, g3.g, g3.mask), rows))
    g5 = HostingGrid.from_costs(
        [HostingCosts(M=float(m), levels=(0.0, 0.2, 0.45, 0.7, 1.0),
                      g=(1.0, 0.75, 0.5, 0.2, 0.0)) if i % 2 else
         HostingCosts.three_level(float(m), 0.3, 0.6)
         for i, m in enumerate(np.geomspace(2, 50, rows))], device=dev)
    return g3, g5, k16_grid(rows, dev)


def svc_lane_args(grid, rows, T_len, t0, c, svc, cols, with_args, trace):
    """D's and S's arguments for a lane on ``grid`` (its first ``rows``
    rows; ``cols`` None: the grid's own levels, else the endpoint lane
    gathering ``cols``) over the slab ``c`` / ``svc`` from ``t0``."""
    lane = grid.restrict_to_endpoints() if cols is not None else grid
    dev = c.device
    J = dp_frontier0(rows, lane.K, dev)
    J[1::7] = float("inf")
    d = (J, c, svc, lane.levels, lane.mask,
         dp_fetch_matrix(lane.M, lane.levels), T_len, t0, cols, with_args)
    pol = (RetroRenting if cols is not None else AlphaRR).batch(lane)
    carry = (alpha_rr_init(pol.params), sim_acc0(rows, lane.K, dev))
    s = (pol.params, lane.levels, lane.M, T_len, t0, carry, c, svc, cols,
         trace, trace)
    return d, s


def svc_kernel_checks(dev, clock, n_sm, sass):
    """Kernel P's Poisson and Model-2 service variants and kernels D and S
    on a Model-2 slab against their plain versions, bit for bit.  Reduced
    slabs in both layouts: 256 rows x 1,024 slots, 253 rows from an odd t0
    x 1,001 slots, 256 rows x one slot at the top of the counters; Poisson
    rates cycled over {0, 0.15, 1.2, 2, 4, 8, 9.99} a row, and the salted
    GE form over two chunks with the chain's state carried; service at K =
    3, 5 and 16 (24 and 7 requests a slot, arrivals past the cap
    included; 100 on arrivals up to 120, so that a slot's requests span
    several of a warp's passes, with rows of empty slots and negative
    arrivals); D with and without the argmin table, S with and without the
    trace, each on the slab's own levels and on a K = 2 lane gathering the
    endpoint columns (bulk copies on the aligned slab where the columns
    fit a stage, 4-byte copies otherwise).  Then the figures' shapes (Figs
    12-15: 76 rows x 6,000 slots; Figs 10-11: GE-Poisson on 40 rows x two
    chunks of 2,000) and the Model-2 fan-out's slab at the fleet's shape
    (4,096 rows x 4,096 slots, K = 3), each kernel there timed and held
    against its plain version, whose one call is timed too.  Returns their
    records."""
    R, chunk = N_M * N_ALPHA * N_SEEDS, CHUNK
    rows = 256
    t0 = T_MAIN - chunk
    gen = torch.Generator(device="cpu").manual_seed(17)
    keys = sc.split_keys(sc.prng_key(9, dev), rows)
    lam = torch.from_numpy(np.resize(np.float32(POISSON_LAMS), rows)).to(dev)
    grids = svc_grids(dev, rows)
    slabs = [("256 rows x 1,024 slots", rows, t0, 1024),
             ("253 rows, odd t0, 1,001 slots", rows - 3, t0 + 1, 1001),
             ("256 rows, one slot", rows, 2 ** 31 - 1, 1)]
    names = ("poisson_chunk", "model2_service_chunk", "dp_fwd_model2",
             "dp_fwd_model2 args", "sim_chunk_alpha_rr_svc")
    err = {k: 0.0 for k in names}
    n_cmp = {k: 0 for k in names}

    def same(name, k, p, what):
        torch.cuda.synchronize()
        require(tree_equal(k, p), f"{name} differs from its plain version "
                                  f"({what})")
        err[name] = max(err[name], tree_max_abs(k, p))
        n_cmp[name] += 1

    def lanes_same(grid, n_rows, T_len, first, c, svc, what, withs):
        """D and S on ``grid``'s own levels and on its endpoint columns,
        under each (with_args / trace) flag of ``withs``."""
        for cols in (None, grid.endpoint_columns()):
            for w in withs:
                d, s_ = svc_lane_args(grid, n_rows, T_len, first, c, svc,
                                      cols, w, w)
                lbl = (f"{what}, K={2 if cols is not None else grid.K} of "
                       f"{grid.K}, args / trace {w}")
                same("dp_fwd_model2", H.dp_fwd_model2(*d),
                     H.dp_fwd_model2_plain(*d), lbl)
                same("sim_chunk_alpha_rr_svc", H.sim_chunk_alpha_rr_svc(*s_),
                     H.sim_chunk_alpha_rr_svc_plain(*s_), lbl)

    def ge_poisson_same(n_rows, chunks, part, what):
        """The GE form: the chain's states over ``chunks`` (t0, n) in a
        row, its state carried, the Poisson emissions at the per-slot
        rates, salt 1."""
        ge = sc.ge_arrivals(keys[:n_rows], 0.2, 0.08,
                            lam[:n_rows].flip(0).contiguous(),
                            lam[:n_rows].contiguous(), n_rows, device=dev)
        s, pp = ge.init_fn(ge.params)["s"], ge.params
        for first, n in chunks:
            tt = sc.base.chunk_tids(first, n, dev)
            s, states, _ = H.ge_bernoulli_chunk(
                pp["key"], tt, s, pp["p_hl"], pp["p_lh"], pp["rate_h"],
                pp["rate_l"], part, emit=False)
            same("poisson_chunk",
                 H.poisson_chunk(pp["key"], tt, pp["rate_l"], 1, states,
                                 pp["rate_h"], part),
                 H.poisson_chunk_plain(pp["key"], tt, pp["rate_l"], 1,
                                       states, pp["rate_h"], part),
                 f"{what}, GE states, t0={first}, {n} slots")

    for part in (True, False):
        lay = "partitionable" if part else "original"
        for label, n_rows, first, n in slabs:
            tt = sc.base.chunk_tids(first, n, dev)
            kk, ll = keys[:n_rows].contiguous(), lam[:n_rows].contiguous()
            x = H.poisson_chunk(kk, tt, ll, partitionable=part)
            same("poisson_chunk", x,
                 H.poisson_chunk_plain(kk, tt, ll, partitionable=part),
                 f"{label}, {lay}")
            x = x.clone()
            x[::5, ::3] = 30                         # past the 24-request cap
            # up to 120 requests (a slot over several of a warp's passes),
            # rows of empty slots, negative arrivals
            x_wide = x * 4
            x_wide[1::6] = 120
            x_wide[2::6] = 0
            x_wide[3::6, ::2] = -4
            T_len = torch.randint(first, first + 2 * n, (n_rows,),
                                  generator=gen).clamp_max(2 ** 31 - 1).to(
                                      torch.int32).to(dev)
            c = (torch.rand((n_rows, n), generator=gen) * 9).to(dev)
            for grid in grids:
                gr = HostingGrid(*sub_rows((grid.M, grid.levels, grid.g,
                                            grid.mask), n_rows))
                for n_max, xx in ((M2_MAX, x), (100, x_wide), (7, x)):
                    svc = H.model2_service_chunk(kk, tt, xx, gr.g, n_max,
                                                 part)
                    same("model2_service_chunk", svc,
                         H.model2_service_chunk_plain(kk, tt, xx, gr.g,
                                                      n_max, part),
                         f"{label}, K={gr.K}, {n_max} requests, {lay}")
                lanes_same(gr, n_rows, T_len, first, c, svc,
                           f"{label}, {lay}", (False, True))
        ge_poisson_same(rows, ((t0, 1000), (t0 + 1000, 1001)), part, lay)
        log(f"Model-2 kernels ok: Poisson, service, D and S on reduced "
            f"slabs, {lay} layout")

    # the figures' shapes, in the default layout: Figs 12-15's one chunk
    # (76 rows x 6,000 slots: Poisson at {2, 4, 8}, service on K = 3, S
    # with its trace for alpha-RR and RR), Figs 10-11's GE-Poisson chunks
    n_rows, n = 76, 6000
    tt = sc.base.chunk_tids(0, n, dev)
    kk = keys[:n_rows].contiguous()
    ll = torch.from_numpy(np.resize(np.float32(M2_LAMS), n_rows)).to(dev)
    x = H.poisson_chunk(kk, tt, ll)
    same("poisson_chunk", x, H.poisson_chunk_plain(kk, tt, ll),
         "Figs 12-15's chunk")
    gr = HostingGrid(*sub_rows((grids[0].M, grids[0].levels, grids[0].g,
                                grids[0].mask), n_rows))
    svc = H.model2_service_chunk(kk, tt, x, gr.g, M2_MAX)
    same("model2_service_chunk", svc,
         H.model2_service_chunk_plain(kk, tt, x, gr.g, M2_MAX),
         "Figs 12-15's chunk")
    T_len = torch.full((n_rows,), n, dtype=torch.int32, device=dev)
    c = (torch.rand((n_rows, n), generator=gen) * 9).to(dev)
    lanes_same(gr, n_rows, T_len, 0, c, svc, "Figs 12-15's chunk", (True,))
    ge_poisson_same(40, ((0, 2000), (2000, 2000)), None, "Figs 10-11's chunks")
    log(f"Model-2 kernels ok at the figures' shapes; compared "
        f"{sum(n_cmp.values())} calls in all: {n_cmp}")

    # the Model-2 fan-out's slab at the fleet's shape: timed, and held
    # against the plain versions there too
    grid = fleet_grid(N_M, N_ALPHA, dev)
    scen = sc.replicate_seeds(model2_scenario(grid, dev), N_SEEDS)
    tids = sc.base.chunk_tids(t0, chunk, dev)
    gen_state = scen.init_fn(scen.params)
    _, slab = scen.chunk_fn(scen.params, gen_state, tids)
    arr, sv = scen.params["arr"], scen.params["svc"]
    rgrid = grid.repeat_rows(N_SEEDS)
    K = rgrid.K
    T_len = torch.full((R,), T_MAIN, dtype=torch.int32, device=dev)
    alu_block = sass["slot_uniform"][0] / 2     # ALU-pipe ops a block
    N = R * chunk
    fleet = "the Model-2 leg's slab"
    rec = {}

    def bound_int(blocks):
        return blocks * alu_block / (64 * n_sm * clock * 1e3)

    p_args = (arr["key"], tids, arr["lam"])
    x = H.poisson_chunk(*p_args)
    plain_ms, xp = timed_once(lambda: H.poisson_chunk_plain(*p_args))
    same("poisson_chunk", x, xp, fleet)
    rounds = float(torch.where(arr["lam"][:, None] > 0, x + 1, 0)
                   .double().sum())
    blocks = N + 3 * rounds
    rec["poisson_chunk"] = dict(
        replaces="src/repro/core/scenarios/streams.py:82",
        consumer="src/repro/core/scenarios/streams.py:98",
        ms=cuda_ms(lambda: H.poisson_chunk(*p_args), reps=7, batch=5),
        prev_ms=PREV_MS["poisson_chunk"], plain_ms=plain_ms,
        sm_clock_mhz=clock,
        mean_rounds=rounds / N, alu_ops_per_block=alu_block,
        int_pipe_bound_ms=bound_int(blocks),
        ops=79 * blocks + KNUTH_ROUND_OPS * rounds,
        nbytes=nbytes(*p_args, x),
        shape=f"R={R} chunk={chunk}, rates {M2_LAMS} cycled, partitionable "
              f"layout; {n_cmp['poisson_chunk']} calls compared, this one "
              f"included")
    n_live = torch.clamp(slab.x, 0, M2_MAX)
    live = float(n_live.double().sum())
    live_slots = float((n_live > 0).double().sum())
    # the share of lanes that hold a request in the kernel's passes (its
    # 128-slot spans at this shape, 32 requests a pass)
    per_span = n_live.reshape(R, -1, 128).sum(dim=2).double()
    pass_fill = live / float(32 * torch.ceil(per_span / 32).sum())
    m_args = (sv["key"], tids, slab.x, sv["g"], M2_MAX)
    out = H.model2_service_chunk(*m_args)
    plain_ms, outp = timed_once(lambda: H.model2_service_chunk_plain(*m_args))
    same("model2_service_chunk", out, outp, fleet)
    require(torch.equal(out, slab.svc), "the fan-out's service slab differs "
                                        "from model2_service_chunk's")
    rec["model2_service_chunk"] = dict(
        replaces="src/repro/core/scenarios/streams.py:402",
        consumer="src/repro/core/scenarios/streams.py:403",
        ms=cuda_ms(lambda: H.model2_service_chunk(*m_args), reps=7, batch=5),
        prev_ms=PREV_MS["model2_service_chunk"], plain_ms=plain_ms,
        sm_clock_mhz=clock, live_requests_per_slot=live / N,
        live_slots_share=live_slots / N, pass_fill=pass_fill,
        int_pipe_bound_ms=bound_int(live_slots + live),
        ops=79 * (live_slots + live) + live * (M2_REQUEST_OPS + 2 * K),
        nbytes=nbytes(sv["key"], tids, slab.x, sv["g"], out),
        shape=f"R={R} chunk={chunk} K={K}, {M2_MAX} requests a slot at "
              f"most, partitionable layout; "
              f"{n_cmp['model2_service_chunk']} calls compared, this one "
              f"included")
    d_args, s_args = svc_lane_args(rgrid, R, T_len, t0, slab.c, slab.svc,
                                   None, False, False)
    e_args, r_args = svc_lane_args(rgrid, R, T_len, t0, slab.c, slab.svc,
                                   rgrid.endpoint_columns(), False, False)
    d_args = (dp_frontier0(R, K, dev),) + d_args[1:]     # the fleet's J_0
    e_args = (dp_frontier0(R, 2, dev),) + e_args[1:]
    outs = {}
    for key, fn, args in (("d", H.dp_fwd_model2, d_args),
                          ("e", H.dp_fwd_model2, e_args),
                          ("s", H.sim_chunk_alpha_rr_svc, s_args),
                          ("r", H.sim_chunk_alpha_rr_svc, r_args)):
        outs[key] = fn(*args)
    plain = {}
    for key, fn, args in (("d", H.dp_fwd_model2_plain, d_args),
                          ("e", H.dp_fwd_model2_plain, e_args),
                          ("s", H.sim_chunk_alpha_rr_svc_plain, s_args),
                          ("r", H.sim_chunk_alpha_rr_svc_plain, r_args)):
        plain[key] = timed_once(lambda: fn(*args))
        name = ("dp_fwd_model2" if key in "de" else
                "sim_chunk_alpha_rr_svc")
        who = "RR, the endpoint columns" if key in "er" else "alpha-RR"
        same(name, outs[key], plain[key][1], f"{fleet}, {who}")
    Jk = outs["d"][0]
    ms = cuda_ms(lambda: H.dp_fwd_model2(*d_args), reps=10, batch=10)
    rec["dp_fwd_model2"] = dict(
        replaces="src/repro/kernels/hosting.py:116", ms=ms,
        plain_ms=plain["d"][0], cols_plain_ms=plain["e"][0],
        cols_ms=cuda_ms(lambda: H.dp_fwd_model2(*e_args), reps=10,
                        batch=10),
        args_ms=cuda_ms(lambda: H.dp_fwd_model2(*d_args[:-1], True), reps=5,
                        batch=10),
        sm_clock_mhz=clock,
        cycles_per_slot=ms * 1e-3 * clock * 1e6 / chunk,
        ops=N * (2 * K + K * K + K * (K - 1) + K),
        nbytes=nbytes(*d_args[:7], Jk),
        shape=f"R={R} chunk={chunk} K={K}, no column map, no argmin "
              f"table: alpha-RR's frontier; cols_ms: RR's K = 2 columns of "
              f"the same slab (both by bulk copies); "
              f"{n_cmp['dp_fwd_model2']} calls compared, these two "
              f"included")
    # the ARGS route on the same slab: the argmin table written besides
    da = d_args[:-1] + (True,)
    ka = H.dp_fwd_model2(*da)
    a_plain_ms, pa = timed_once(lambda: H.dp_fwd_model2_plain(*da))
    same("dp_fwd_model2 args", ka, pa, f"{fleet}, alpha-RR, argmin table")
    a_ms = rec["dp_fwd_model2"]["args_ms"]
    rec["dp_fwd_model2 args"] = dict(
        replaces="src/repro/kernels/hosting.py:116", ms=a_ms,
        plain_ms=a_plain_ms, sm_clock_mhz=clock,
        cycles_per_slot=a_ms * 1e-3 * clock * 1e6 / chunk,
        ops=rec["dp_fwd_model2"]["ops"], nbytes=nbytes(*d_args[:7], *ka),
        shape=f"R={R} chunk={chunk} K={K}, no column map, writing the "
              f"argmin table (with_args=True): the Model-2 obs leg's "
              f"materialised OPT")
    del ka, pa
    (st, acc), _ = outs["s"]
    ms = cuda_ms(lambda: H.sim_chunk_alpha_rr_svc(*s_args), reps=10,
                 batch=10)
    pol_params, carry = s_args[0], s_args[5]
    rec["sim_chunk_alpha_rr_svc"] = dict(
        replaces="src/repro/core/simulator.py:147", ms=ms,
        plain_ms=plain["s"][0], cols_plain_ms=plain["r"][0],
        cols_ms=cuda_ms(lambda: H.sim_chunk_alpha_rr_svc(*r_args), reps=10,
                        batch=10),
        sm_clock_mhz=clock,
        cycles_per_slot=ms * 1e-3 * clock * 1e6 / chunk,
        ops=N * (11 * K + 9),
        nbytes=nbytes(*pol_params.values(), rgrid.levels, rgrid.M, T_len,
                      *carry[0].values(), *carry[1].values(), slab.c,
                      slab.svc, *st.values(), *acc.values()),
        shape=f"R={R} chunk={chunk} K={K}, no column map, no trace: "
              f"alpha-RR's call; cols_ms: RR's K = 2 columns of the same "
              f"slab (both by bulk copies); "
              f"{n_cmp['sim_chunk_alpha_rr_svc']} calls compared, these "
              f"two included")
    for name, r in rec.items():
        r["max_abs_err"] = err[name]
        log(f"{name} timed: "
            + (f"{r['prev_ms']:.4f} -> " if "prev_ms" in r else "")
            + f"{r['ms']:.4f} ms, plain {r['plain_ms']:.1f} ms"
            + (f", integer-pipe bound {r['int_pipe_bound_ms']:.4f} ms"
               if "int_pipe_bound_ms" in r else "")
            + (f", {r['cols_ms']:.4f} ms on RR's columns (plain "
               f"{r['cols_plain_ms']:.1f} ms)" if "cols_ms" in r else ""))
    m2 = rec["model2_service_chunk"]
    log(f"   Poisson: {rec['poisson_chunk']['mean_rounds']:.3f} rounds a "
        f"slot; service: {m2['live_requests_per_slot']:.3f} live requests "
        f"a slot, {m2['live_slots_share']:.4f} of the slots live, lanes "
        f"busy in {m2['pass_fill']:.4f} of its passes, "
        f"{m2['int_pipe_bound_ms'] / m2['ms']:.1%} of its integer-pipe "
        f"bound; every kernel == its plain version at the fleet's shape")
    return rec


# ----------------------------------------------------------------------
# Phase 2, Figs 17-22: P's Poisson variant at rates of 10 and above
# (Hormann's rejection), the service draws at 260 requests a slot, and S's
# table variant (static, MDP, ABC).
# ----------------------------------------------------------------------

REJECTION_LAMS = (10.0, 10.5, 37.0, 200.0, 1e5)


def _source_span(lines, name):
    """(first, last) 1-based lines of the device function ``name`` in
    hosting.cu: its signature's line to the next line that is ``}``."""
    first = next(i for i, ln in enumerate(lines, 1)
                 if re.search(rf"\b{name}\(", ln) and "__device__" in ln)
    last = next(i for i, ln in enumerate(lines[first:], first + 1)
                if ln.rstrip() == "}")
    return first, last


# poisson_kernel<true, true> in the SASS (a fragment of its mangled name)
POISSON_GE_SASS = "poisson_kernelILb1ELb1E"


def sass_with_lines(frag):
    """[(opcode, [hosting.cu lines])] of the built hosting library's
    kernel whose mangled name holds ``frag``, in order: ``nvdisasm -c -gi``
    on the library's cubins (``cuobjdump -xelf`` of each part's object,
    ``_build.library_objects``) gives each instruction's
    source line and the lines it is inlined at, a comment a frame,
    innermost first (lines of other files, the CUDA headers', are
    dropped).  Subroutines reached by
    CALL, placed after the kernel's own code (the divisions' and square
    roots' slow paths), are left out."""
    bin_dir = Path(_build._nvcc()).parent
    texts = []
    with tempfile.TemporaryDirectory() as tmp:
        # a directory an object: the parts' cubins share one name
        for i, obj in enumerate(_build.library_objects("hosting")):
            d = Path(tmp) / str(i)
            d.mkdir()
            subprocess.run([str(bin_dir / "cuobjdump"), "-xelf", "all",
                            str(obj)], cwd=d, capture_output=True,
                           check=True, timeout=300)
            texts += [subprocess.run([str(bin_dir / "nvdisasm"), "-c", "-gi",
                                      str(c)], capture_output=True,
                                     text=True, check=True,
                                     timeout=600).stdout
                      for c in sorted(d.glob("*.cubin"))]
    bodies = []
    for text in texts:
        lines = text.splitlines()
        starts = [i for i, ln in enumerate(lines)
                  if re.match(r"\s*\.section\s+\.text\.", ln)]
        for i, j in zip(starts, starts[1:] + [len(lines)]):
            if frag in lines[i]:
                bodies.append(lines[i + 1:j])
    require(len(bodies) == 1, f"{frag}: {len(bodies)} kernels in the SASS")
    body = bodies[0]
    targets = {m.group(1) for ln in body for m in re.finditer(
        r"CALL\S*\s+`\(([^)]+)\)", ln)}
    out, chain, fresh = [], [], True
    for ln in body:
        if "//## File" in ln:
            # an instruction's stack: one comment a frame, innermost first,
            # each naming its line and the line it is inlined at
            if fresh:
                chain, fresh = [], False
            chain += [int(n) for f, n in re.findall(
                r'"([^"]+)", line (\d+)', ln) if f.endswith("hosting.cu")]
            continue
        lab = re.match(r"\s*([^\s/][^\s]*):\s*$", ln)
        if lab and lab.group(1) in targets:
            break                            # the subroutines from here
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_]*)", ln)
        if m:
            out.append((m.group(1), chain))
            fresh = True
    require(len(out) > 100 and any(chain for _, chain in out),
            f"{frag}: {len(out)} instructions, none with a line of "
            f"hosting.cu")
    return out


def hormann_sass(blk):
    """Hormann's round by pipe, counted in the SASS of the built
    ``poisson_kernel<true, true>`` (the GE form's instance, which the
    Markov leg runs).  The library carries line tables (``-lineinfo``), so
    ``nvdisasm -gi`` names each instruction's source line and the lines
    it is inlined at; an instruction belongs to the round when one of
    those lines lies in ``hormann_round``.  Of those: ``hash`` (in
    ``threefry2x32``: the five blocks), ``slow`` (from the line of the
    log before ``lgamma`` on, ``lgamma`` included: the code that only
    rounds past the quick tests run) and ``round`` (the rest, which every
    round runs).  Subroutines reached by CALL (the divisions' slow paths,
    for arguments that no round here gives them) are left out.  Static
    counts: a branch's two sides both count.  Returns {class: pipe_ops}
    and the check that ``hash`` holds five blocks (its ALU ops over 5 x
    ``blk``'s)."""
    src = (Path(__file__).resolve().parent / CSRC / "hosting.cu"
           ).read_text().splitlines()
    spans = {f: _source_span(src, f) for f in
             ("hormann_round", "xla_lgamma1pf", "threefry2x32")}
    h0, h1 = spans["hormann_round"]
    slow_from = next(i for i in range(h0, h1 + 1)
                     if "const float sl = " in src[i - 1])
    inside = lambda f, ln: spans[f][0] <= ln <= spans[f][1]  # noqa: E731
    ops = {"hash": [], "round": [], "slow": []}
    for op, chain in sass_with_lines(POISSON_GE_SASS):
        at = [v for v in chain if inside("hormann_round", v)]
        if not at:
            continue
        if any(inside("threefry2x32", v) for v in chain):
            ops["hash"].append(op)
        elif at[0] >= slow_from or any(inside("xla_lgamma1pf", v)
                                       for v in chain):
            ops["slow"].append(op)
        else:
            ops["round"].append(op)
    counts = {k: pipe_ops(v) for k, v in ops.items()}
    five = counts["hash"]["alu"] / (5 * blk["alu"])
    require(0.6 <= five <= 1.6, f"Hormann's round in the SASS: its hashes "
                                f"hold {five:.2f} x five blocks' ALU ops")
    counts["five_blocks_ratio"] = five
    return counts


def hormann_pipes(sass, blocks, rounds, slow):
    """The Poisson draws' instructions on Hormann's branch by pipe:
    ``blocks`` threefry blocks outside the rounds (the items' keys) at
    the uniforms' kernel's count a block, and ``rounds`` rounds, of which
    ``slow`` pass the quick tests, at ``hormann_sass``' counts (a round's
    hashes and its ``round`` code on every round, its ``slow`` code on the
    slow ones).  Returns (the summed counts, the per-round counts)."""
    blk, hs = sass["block pipes"], sass["hormann"]
    tot = {k: blocks * blk[k] + rounds * (hs["hash"][k] + hs["round"][k])
           + slow * hs["slow"][k] for k in blk}
    return tot, {c: hs[c] for c in ("hash", "round", "slow")}

# of one table step past its staging: the observation (a compare or two
# selects and the clip), the lookup's index and load, and the
# accounting's ~10 ops
TABLE_STEP_OPS = 6 + 2 + 10
# the rows on which the service draws' plain version runs at the Markov
# leg's shape (its 260 words a slot in int64 fill the card at 4,096 rows)
SVC_ROWS = 128


def markov_instances(n_inst):
    """fig17_22's instances cycled to ``n_inst``: instance i takes regime i
    % 3 and (M, c) sweep point (i // 3) % 7 -- (costs, GE chains, mean
    rents)."""
    regimes = list(fig17_22_markov_mdp.REGIMES.values())
    sweep = list(dict.fromkeys(
        [(50.0, cm) for cm in fig17_22_markov_mdp.C_SWEEP]
        + [(M, 20.0) for M in fig17_22_markov_mdp.M_SWEEP]))
    costs, ges, cms = [], [], []
    for i in range(n_inst):
        M, cm = sweep[(i // 3) % len(sweep)]
        lo, hi = sc.spot_bounds(cm)
        costs.append(HostingCosts.three_level(
            M, fig17_22_markov_mdp.ALPHA, fig17_22_markov_mdp.G_ALPHA,
            c_min=lo, c_max=hi))
        ges.append(GilbertElliot(emission="poisson", **regimes[i % 3]))
        cms.append(cm)
    return costs, ges, cms


def markov_scenario(grid, ges, cms, device):
    """GE-Poisson arrivals at each instance's regime (rates 200 / 10),
    spot rents at its mean and Model-2 service of up to 260 requests a
    slot on ``grid``'s g; per-instance keys."""
    B = grid.B
    f32 = lambda v: np.asarray(v, np.float32)            # noqa: E731
    keys = [sc.split_keys(sc.prng_key(s, device), B) for s in (12, 13, 14)]
    return sc.combine(
        sc.ge_arrivals(keys[0], f32([g.p_hl for g in ges]),
                       f32([g.p_lh for g in ges]),
                       f32([g.rate_h for g in ges]),
                       f32([g.rate_l for g in ges]), B, device=device),
        sc.spot_rents(keys[1], f32(cms), B, device=device),
        svc=sc.model2_service(keys[2], grid.g, B, MARKOV_MAX, device=device))


def fig_chunks_same(dev, same):
    """Figs 17-22's own chunks, in the default layout: its 21 instances x 4
    seeds = 84 rows over T = 3,000 in the six chunks of 512 that the figure
    runs (the last one's horizon ends after 440 slots), the figure's
    scenario drawn chunk by chunk with the generators' state carried.  At
    every chunk the Poisson draws (salt 1, the GE chain's states, rates 200
    / 10), the service draws at 260 on K = 3 and S's table variant for MDP
    and ABC, on the slab's own levels and on RR's endpoint columns (its
    state carried from chunk to chunk), each against its plain version by
    ``same(name, kernel, plain, what)``."""
    fig = fig17_22_markov_mdp
    T, chunk = 3000, fig.CHUNK
    costs, ges, cms, _, scenario_fn = fig.instances(0, dev)
    grid = HostingGrid.from_costs(costs, device=dev)
    scen = sc.replicate_seeds(scenario_fn(grid), N_SEEDS)
    arr, sv = scen.params["arr"], scen.params["svc"]
    rgrid = grid.repeat_rows(N_SEEDS)
    R = rgrid.B
    rep = lambda t: t.repeat_interleave(N_SEEDS, dim=0)   # noqa: E731
    T_len = torch.full((R,), T, dtype=torch.int32, device=dev)
    ends = [HostingCosts.two_level(cc.M, cc.c_min, cc.c_max) for cc in costs]
    lanes = []                  # (label, policy, levels, M, columns)
    for lbl, g_, cs_, cols in (
            ("own levels", grid, costs, None),
            ("RR's endpoint columns", grid.restrict_to_endpoints(), ends,
             rgrid.endpoint_columns())):
        for pol in (MDPPolicy.batch(g_, cs_, ges, cms),
                    ABCPolicy.batch(g_, cs_, ges, cms)):
            pol = pol._replace(params={k: rep(v)
                                       for k, v in pol.params.items()})
            lanes.append((f"{pol.name}, {lbl}", pol, rep(g_.levels),
                          rep(g_.M), cols))
    carries = [(pol.init_fn(pol.params), sim_acc0(R, lv.shape[1], dev))
               for _, pol, lv, _, _ in lanes]
    state = scen.init_fn(scen.params)
    for i in range(-(-T // chunk)):
        t0 = i * chunk
        tids = sc.base.chunk_tids(t0, chunk, dev)
        state, slab = scen.chunk_fn(scen.params, state, tids)
        what = f"Figs 17-22's chunk at t0={t0}"
        p_args = (arr["key"], tids, arr["rate_l"], 1, slab.side,
                  arr["rate_h"])
        same("poisson_chunk rejection", H.poisson_chunk(*p_args),
             H.poisson_chunk_plain(*p_args), what)
        m_args = (sv["key"], tids, slab.x, sv["g"], MARKOV_MAX)
        svc = H.model2_service_chunk(*m_args)
        same("model2_service_chunk 260", svc,
             H.model2_service_chunk_plain(*m_args), what)
        require(torch.equal(svc, slab.svc), f"{what}: the figure's service "
                                            f"slab differs")
        for j, (lbl, pol, lv, M, cols) in enumerate(lanes):
            a = (*table_form(pol.step_fn, pol.params, lv.shape[1]), lv, M,
                 T_len, t0, carries[j], slab.x, slab.c, slab.side, slab.svc,
                 cols, True, True)
            k = H.sim_chunk_table_svc(*a)
            same("sim_chunk_table_svc", k, H.sim_chunk_table_svc_plain(*a),
                 f"{what}, {lbl}")
            carries[j] = k[0]


def markov_kernel_checks(dev, clock, n_sm, sass):
    """P's Poisson variant at rates of 10 and above, the service draws at
    260 requests a slot and S's table variant against their plain
    versions, bit for bit.  Reduced slabs in both layouts (256 rows x
    1,024 slots; 253 rows from an odd t0 x 1,001 slots; 256 rows x one
    slot at the top of the counters): Poisson rates {10, 10.5, 37, 200,
    1e5} a row, rows mixing 0, 2, 9.99, 10 and 200, and the salted GE form
    at 200 / 10 over two chunks with the chain's state carried; the
    service draws at 260 with slots past 260; the table variant for
    static, MDP and ABC under Model 1 and on the Model-2 slab (its own
    levels, and RR's endpoint columns), with and without the trace and
    the final fetch, at K = 3, 2 and 16.  Then Figs 17-22's own chunks
    (``fig_chunks_same``) and the Markov leg's slab (4,096 rows x 4,096
    slots, K = 3), each kernel timed there against its bound and its plain
    version's one call.  Returns their records."""
    R, chunk = N_M * N_ALPHA * N_SEEDS, CHUNK
    rows = 256
    t0 = T_MAIN - chunk
    gen = torch.Generator(device="cpu").manual_seed(23)
    keys = sc.split_keys(sc.prng_key(15, dev), rows)
    lam = torch.from_numpy(np.resize(np.float32(REJECTION_LAMS), rows)).to(
        dev)
    mixed = torch.from_numpy(np.resize(np.float32(
        [0.0, 2.0, 9.99, 10.0, 200.0]), rows)).to(dev)
    slabs = [("256 rows x 1,024 slots", rows, t0, 1024),
             ("253 rows, odd t0, 1,001 slots", rows - 3, t0 + 1, 1001),
             ("256 rows, one slot", rows, 2 ** 31 - 1, 1)]
    names = ("poisson_chunk rejection", "model2_service_chunk 260",
             "sim_chunk_table", "sim_chunk_table_svc")
    n_cmp = {k: 0 for k in names}

    def same(name, k, p, what):
        torch.cuda.synchronize()
        require(tree_equal(k, p), f"{name} differs from its plain version "
                                  f"({what})")
        n_cmp[name] += 1

    def table_same(grid, cols, n_rows, T_len, first, x, c, side, svc, what,
                   odd):
        """S's table variant for static, MDP and ABC on ``grid`` (its
        endpoint lane with ``cols``), under Model 1 (``svc`` None) or on
        the slab; the trace and the final fetch on for every other policy
        (``odd`` shifts which)."""
        lane = grid.restrict_to_endpoints() if cols is not None else grid
        lv, M = lane.levels, lane.M
        costs, ges, cms = markov_instances(n_rows)
        if cols is not None:                     # the endpoint lane's own
            costs = [HostingCosts.two_level(cc.M, cc.c_min, cc.c_max)
                     for cc in costs]
        pols = [StaticPolicy.batch(lane, lane.top_index()),
                MDPPolicy.batch(lane, costs, ges, cms),
                ABCPolicy.batch(lane, costs, ges, cms)]
        for i, pol in enumerate(pols):
            flag = (i + odd) % 2 == 0
            carry = (pol.init_fn(pol.params), sim_acc0(n_rows, lane.K, dev))
            lbl = f"{what}, {pol.name}, K={lane.K}, trace {flag}"
            tab = table_form(pol.step_fn, pol.params, lane.K)
            if svc is None:
                a = (*tab, lv, lane.g, M, T_len, first, carry, x, c, side,
                     flag, flag)
                same("sim_chunk_table", H.sim_chunk_table(*a),
                     H.sim_chunk_table_plain(*a), lbl)
            else:
                a = (*tab, lv, M, T_len, first, carry, x, c, side, svc,
                     cols, flag, flag)
                same("sim_chunk_table_svc", H.sim_chunk_table_svc(*a),
                     H.sim_chunk_table_svc_plain(*a), lbl)

    for part in (True, False):
        lay = "partitionable" if part else "original"
        for label, n_rows, first, n in slabs:
            tt = sc.base.chunk_tids(first, n, dev)
            kk = keys[:n_rows].contiguous()
            for lm, what in ((lam, "rates >= 10"), (mixed, "mixed rates")):
                ll = lm[:n_rows].contiguous()
                x = H.poisson_chunk(kk, tt, ll, partitionable=part)
                same("poisson_chunk rejection", x,
                     H.poisson_chunk_plain(kk, tt, ll, partitionable=part),
                     f"{label}, {what}, {lay}")
            x = x.clone()
            x[::4, ::3] = 300                        # past the 260 cap
            grids = svc_grids(dev, n_rows)
            T_len = torch.randint(first, first + 2 * n, (n_rows,),
                                  generator=gen).clamp_max(2 ** 31 - 1).to(
                                      torch.int32).to(dev)
            c = (torch.rand((n_rows, n), generator=gen) * 300).to(dev)
            side = torch.randint(-1, 3, (n_rows, n), generator=gen,
                                 dtype=torch.int32).to(dev)
            for grid in (grids[0], grids[2]):
                gr = HostingGrid(*sub_rows((grid.M, grid.levels, grid.g,
                                            grid.mask), n_rows))
                svc = H.model2_service_chunk(kk, tt, x, gr.g, MARKOV_MAX,
                                             part)
                same("model2_service_chunk 260", svc,
                     H.model2_service_chunk_plain(kk, tt, x, gr.g,
                                                  MARKOV_MAX, part),
                     f"{label}, K={gr.K}, {lay}")
                table_same(gr, None, n_rows, T_len, first, x, c, side, None,
                           f"{label}, Model 1, {lay}", 0)
                for odd, cols in enumerate((None, gr.endpoint_columns())):
                    table_same(gr, cols, n_rows, T_len, first, x, c, side,
                               svc, f"{label}, Model 2, {lay}", odd)
        # the salted GE form at the figure's rates, two chunks in a row
        ge = sc.ge_arrivals(keys, 0.4, 0.4, 200.0, 10.0, rows, device=dev)
        s, pp = ge.init_fn(ge.params)["s"], ge.params
        for first, n in ((t0, 1000), (t0 + 1000, 1001)):
            tt = sc.base.chunk_tids(first, n, dev)
            s, states, _ = H.ge_bernoulli_chunk(
                pp["key"], tt, s, pp["p_hl"], pp["p_lh"], pp["rate_h"],
                pp["rate_l"], part, emit=False)
            same("poisson_chunk rejection",
                 H.poisson_chunk(pp["key"], tt, pp["rate_l"], 1, states,
                                 pp["rate_h"], part),
                 H.poisson_chunk_plain(pp["key"], tt, pp["rate_l"], 1,
                                       states, pp["rate_h"], part),
                 f"GE 200 / 10, t0={first}, {n} slots, {lay}")
        log(f"Figs 17-22 kernels ok: Poisson rejection, service at 260, S's "
            f"table variant on reduced slabs, {lay} layout")
    fig_chunks_same(dev, same)
    log(f"Figs 17-22 kernels ok at the figure's chunks; compared {n_cmp}")

    # the Markov leg's slab at the fleet's shape: timed, and held against
    # the plain versions there too
    costs, ges, cms = markov_instances(N_M * N_ALPHA)
    grid = HostingGrid.from_costs(costs, device=dev)
    scen = sc.replicate_seeds(markov_scenario(grid, ges, cms, dev), N_SEEDS)
    tids = sc.base.chunk_tids(t0, chunk, dev)
    _, slab = scen.chunk_fn(scen.params, scen.init_fn(scen.params), tids)
    arr, sv = scen.params["arr"], scen.params["svc"]
    rgrid = grid.repeat_rows(N_SEEDS)
    rep = lambda t: t.repeat_interleave(N_SEEDS, dim=0)   # noqa: E731
    alu_block = sass["slot_uniform"][0] / 2     # ALU-pipe ops a block
    N = R * chunk
    fleet = "the Markov leg's slab"
    rec = {}

    def bound_int(blocks):
        return blocks * alu_block / (64 * n_sm * clock * 1e3)

    p_args = (arr["key"], tids, arr["rate_l"], 1, slab.side, arr["rate_h"])
    x = H.poisson_chunk(*p_args)
    plain_ms, xp = timed_once(lambda: H.poisson_chunk_plain(*p_args))
    same("poisson_chunk rejection", x, xp, fleet)
    a0, a1 = H._slot_keys(arr["key"], tids, 1)
    rate = torch.where(slab.side == 1, arr["rate_h"][:, None],
                       arr["rate_l"][:, None])
    _, rounds, slow = H.poisson_rejection_plain(a0, a1, rate, stats=True)
    del a0, a1, rate
    blocks = 2 * N + 5 * rounds
    tot, per = hormann_pipes(sass, 2 * N, rounds, slow)
    pipes = {k: v / (n_sm * clock * 1e3)
             for k, v in pipe_cycles(tot).items()}
    top = max(pipes, key=pipes.get)
    rec["poisson_chunk rejection"] = dict(
        replaces="src/repro/core/scenarios/streams.py:98",
        consumer="src/repro/core/scenarios/streams.py:98",
        ms=cuda_ms(lambda: H.poisson_chunk(*p_args), reps=7, batch=5),
        plain_ms=plain_ms, sm_clock_mhz=clock, mean_rounds=rounds / N,
        lgamma_share=slow / rounds, alu_ops_per_block=alu_block,
        int_pipe_bound_ms=bound_int(blocks), alu_pipe_bound_ms=pipes["alu"],
        fma_pipe_bound_ms=pipes["fma"], xu_pipe_bound_ms=pipes["xu"],
        pipe_bound_ms=pipes[top], bound_pipe=top,
        hash_pipe_ops=per["hash"], round_pipe_ops=per["round"],
        slow_pipe_ops=per["slow"],
        five_blocks_ratio=sass["hormann"]["five_blocks_ratio"],
        ops=79 * blocks + sum(
            n * (per[c]["ffma"] + per[c]["imad"] + per[c]["alu"])
            for c, n in (("round", rounds), ("slow", slow))),
        nbytes=nbytes(*(a for a in p_args if isinstance(a, torch.Tensor)),
                      x),
        shape=f"R={R} chunk={chunk}, the GE states' rates 200 / 10 (salt "
              f"1), partitionable layout; "
              f"{n_cmp['poisson_chunk rejection']} calls compared, this one "
              f"included")
    m_args = (sv["key"], tids, slab.x, sv["g"], MARKOV_MAX)
    out = H.model2_service_chunk(*m_args)
    # the plain version hashes [rows, slots, 260] int64 words, which do not
    # fit the card at 4,096 rows: it is held and timed on the first 128
    sub_k, sub_x, sub_g = sub_rows((sv["key"], slab.x, sv["g"]), SVC_ROWS)
    plain_ms, outp = timed_once(lambda: H.model2_service_chunk_plain(
        sub_k, tids, sub_x, sub_g, MARKOV_MAX))
    same("model2_service_chunk 260", out[:SVC_ROWS], outp,
         f"{fleet}, its first {SVC_ROWS} rows")
    require(torch.equal(out, slab.svc), "the Markov leg's service slab "
                                        "differs from model2_service_chunk's")
    n_live = torch.clamp(slab.x, 0, MARKOV_MAX)
    live = float(n_live.double().sum())
    live_slots = float((n_live > 0).double().sum())
    markov_svc = dict(
        ms=cuda_ms(lambda: H.model2_service_chunk(*m_args), reps=7, batch=3),
        plain_ms=plain_ms, live_requests_per_slot=live / N,
        int_pipe_bound_ms=bound_int(live_slots + live),
        plain_rows=SVC_ROWS)
    del out, outp
    T_len = torch.full((R,), T_MAIN, dtype=torch.int32, device=dev)
    mdp = MDPPolicy.batch(grid, costs, ges, cms)
    abc = ABCPolicy.batch(grid, costs, ges, cms)
    mdp = mdp._replace(params={k: rep(v) for k, v in mdp.params.items()})
    abc = abc._replace(params={k: rep(v) for k, v in abc.params.items()})
    recs = {}
    for pol in (mdp, abc):
        carry = (pol.init_fn(pol.params), sim_acc0(R, rgrid.K, dev))
        a = (*table_form(pol.step_fn, pol.params, rgrid.K), rgrid.levels,
             rgrid.M, T_len, t0, carry, slab.x, slab.c, slab.side, slab.svc,
             None, True, False)
        k = H.sim_chunk_table_svc(*a)
        plain_ms, p = timed_once(lambda: H.sim_chunk_table_svc_plain(*a))
        same("sim_chunk_table_svc", k, p, f"{fleet}, {pol.name}")
        recs[pol.name] = dict(
            ms=cuda_ms(lambda: H.sim_chunk_table_svc(*a), reps=10,
                       batch=10),
            plain_ms=plain_ms, args=a, out=k)
    # Model 1 on the same rows: MDP on the slab's arrivals and its side
    a1_ = (*table_form(mdp.step_fn, mdp.params, rgrid.K), rgrid.levels,
           rgrid.g, rgrid.M, T_len, t0,
           (mdp.init_fn(mdp.params), sim_acc0(R, rgrid.K, dev)), slab.x,
           slab.c, slab.side, True, False)
    k1 = H.sim_chunk_table(*a1_)
    plain1_ms, p1 = timed_once(lambda: H.sim_chunk_table_plain(*a1_))
    same("sim_chunk_table", k1, p1, f"{fleet}, MDP, Model 1")
    ms1 = cuda_ms(lambda: H.sim_chunk_table(*a1_), reps=10, batch=10)
    K = rgrid.K
    # the table variant's parts on the same slab: no slot in its horizon
    # (the staging alone), the static table (no observation staged), the
    # trace written; Model 1 with the trace
    from repro_torch.core.policies.baselines import static_step
    a_mdp = recs["MDP"]["args"]
    stat = table_form(static_step, {"level_idx": torch.full(
        (R,), K - 1, dtype=torch.int32, device=dev)}, K)
    parts = {"horizons before the chunk": a_mdp[:5] + (
                 torch.full_like(T_len, t0),) + a_mdp[6:],
             "static": stat + a_mdp[3:],
             "with the trace": a_mdp[:14] + (True,)}
    parts_ms = {name: cuda_ms(lambda a=a: H.sim_chunk_table_svc(*a),
                              reps=10, batch=10)
                for name, a in parts.items()}
    trace1_ms = cuda_ms(lambda: H.sim_chunk_table(*(a1_[:13] + (True,))),
                        reps=10, batch=10)
    for name, r_, args, carry, out, extra in (
            ("sim_chunk_table_svc", recs["MDP"], recs["MDP"]["args"],
             recs["MDP"]["args"][7], recs["MDP"]["out"], (slab.svc,)),
            ("sim_chunk_table", dict(ms=ms1, plain_ms=plain1_ms), a1_,
             a1_[8], k1, (slab.x, rgrid.g))):
        (st, acc), _ = out
        pi = args[0]
        rec[name] = dict(
            replaces="src/repro/core/simulator.py:147", ms=r_["ms"],
            prev_ms=PREV_MS[name], plain_ms=r_["plain_ms"],
            sm_clock_mhz=clock,
            cycles_per_slot=r_["ms"] * 1e-3 * clock * 1e6 / chunk,
            ops=N * TABLE_STEP_OPS,
            nbytes=nbytes(pi, rgrid.levels, rgrid.M, T_len,
                          *carry[0].values(), *carry[1].values(),
                          slab.c, slab.side, *extra, *st.values(),
                          *acc.values()),
            shape=f"R={R} chunk={chunk} K={K}, MDP (the side channel), no "
                  f"trace; {n_cmp[name]} calls compared, this one included")
    rec["sim_chunk_table_svc"]["abc_ms"] = recs["ABC"]["ms"]
    rec["sim_chunk_table_svc"]["parts_ms"] = parts_ms
    rec["sim_chunk_table"]["parts_ms"] = {"with the trace": trace1_ms}
    for name, r in rec.items():
        r["max_abs_err"] = 0.0
        log(f"{name} timed: "
            + (f"{r['prev_ms']:.4f} -> " if "prev_ms" in r else "")
            + f"{r['ms']:.4f} ms, plain {r['plain_ms']:.1f} ms"
            + (f" ({r['cycles_per_slot']:.1f} cycles a slot at "
               f"{r['sm_clock_mhz']:.0f} MHz; "
               f"{r['nbytes'] / PEAK_BYTES * 1e3 / r['ms']:.1%} of its "
               f"byte bound)" if "prev_ms" in r else "")
            + (f", integer-pipe bound of its blocks "
               f"{r['int_pipe_bound_ms']:.4f} ms; pipes from the SASS (ALU "
               f"{r['alu_pipe_bound_ms']:.4f}, FMA "
               f"{r['fma_pipe_bound_ms']:.4f}, XU "
               f"{r['xu_pipe_bound_ms']:.4f} ms): bound "
               f"{r['pipe_bound_ms']:.4f} ms by the {r['bound_pipe']} pipe "
               f"({r['pipe_bound_ms'] / r['ms']:.1%}); a round's hashes "
               f"{r['hash_pipe_ops']} ({r['five_blocks_ratio']:.3f} x five "
               f"blocks' ALU ops), the rest of every round "
               f"{r['round_pipe_ops']}, of a slow round "
               f"{r['slow_pipe_ops']}"
               if "pipe_bound_ms" in r else "")
            + (f", ABC {r['abc_ms']:.4f} ms" if "abc_ms" in r else "")
            + "".join(f", {k} {v:.4f} ms"
                      for k, v in r.get("parts_ms", {}).items()))
    pr = rec["poisson_chunk rejection"]
    log(f"   Poisson (Hormann): {pr['mean_rounds']:.4f} rounds a draw, "
        f"{pr['lgamma_share']:.4f} of them reach lgamma; service at "
        f"{MARKOV_MAX} requests a slot: {markov_svc['ms']:.4f} ms, "
        f"{markov_svc['live_requests_per_slot']:.3f} live requests a slot, "
        f"integer-pipe bound {markov_svc['int_pipe_bound_ms']:.4f} ms, "
        f"plain {markov_svc['plain_ms']:.1f} ms on {SVC_ROWS} rows; "
        f"compared {n_cmp}")
    return rec, markov_svc


# ----------------------------------------------------------------------
# Phase 2, the g-curve modules (Figs 23-25, beyond_knapsack_levels): their
# own chunks, and Model-2 slabs of more than 16 levels.
# ----------------------------------------------------------------------

# the modules' horizon and Fig 25's chunk, at their defaults
GCURVE_T, FIG25_CHUNK = 4000, 1000
# the slab widths past 16 levels held against the plain versions, and
# the service draws' bands below them (each band's ends)
WIDE_KS = (17, 24, 31, 32)
BAND_KS = (6, 8, 9, 16)
# the level counts at which the service draws are timed at fleet width
# (the static instances end at K = 5, their 16-byte stores at 4; the bands
# of a run-time K start at 6, 9, 17 and 25)
SERVICE_SWEEP_KS = (3, 4, 5, 6, 8, 9, 12, 16, 17, 24, 25, 31, 32)


def gcurve_kernel_checks(dev, clock, n_sm, sass):
    """The g-curve modules' kernels against their plain versions, bit for
    bit.  Their own chunks, in the default layout: Figs 23-25's recorded
    path (P's Bernoulli and ARMA variants on one row x 4,000 slots, the
    array builders' output), the service draws at one request a slot on
    K = 3 over Fig 24's slab (19 curve points x 4 seeds = 76 rows x
    4,000) and Fig 25's four chunks of 1,000 (5 M x 4 seeds = 20 rows, at
    a curve point), with D's and S's svc variants for alpha-RR and RR's
    endpoint columns on those chunks (state carried); the study's union
    slab (4 rows x 4,000, K = 31) with S for its lanes of K = 2, 3 and 8.
    Then slabs of Kf = 17, 24, 31 and 32 levels, aligned (256 rows x
    1,024 slots) and ragged (253 rows from an odd t0 x 1,001): the
    service draws at 24 and one request a slot in both layouts (also at
    the bands' ``BAND_KS``), and on
    the default layout's slabs alpha-RR's S (trace and final fetch on and
    off) and the static table on lanes of 3 and 8 levels gathering their
    columns.  Timed: the service draws on
    31 levels and S on the 31-level slab at the study's shape and at a
    fleet-width chunk (4,096 x 4,096; the Model-2 leg's arrivals at 24 a
    slot), and the service draws on that chunk at each K of
    ``SERVICE_SWEEP_KS`` (evenly spread levels).  Returns their records."""
    n_cmp = {}

    def same(name, k, p, what):
        torch.cuda.synchronize()
        require(tree_equal(k, p), f"{name} differs from its plain version "
                                  f"({what})")
        n_cmp[name] = n_cmp.get(name, 0) + 1

    T = GCURVE_T
    tids = sc.base.chunk_tids(0, T, dev)
    fig, bk = fig23_25_geolife, beyond_knapsack_levels
    # Figs 23-25's recorded path on one row, and the builders' rows
    kx, kc, _ = sc.split_keys(sc.prng_key(0, dev), 3)
    bern = sc.bernoulli_arrivals(kx, 0.5, 1, device=dev).params
    b_args = (bern["key"], tids, bern["p"], bern["flip"])
    x1 = H.bernoulli_arrivals_chunk(*b_args)
    same("bernoulli_arrivals_chunk", x1,
         H.bernoulli_arrivals_chunk_plain(*b_args), "Figs 23-25, 1 x 4,000")
    spot = sc.spot_rents(kc, fig.C_MEAN, 1, device=dev)
    st, pp = spot.init_fn(spot.params), spot.params
    a_args = (pp["key"], tids, st["hist"], st["eps"], pp["phi"], pp["th"],
              pp["sigma"], pp["mean"], pp["c_min"], pp["c_max"])
    c1 = H.arma_rents_chunk(*a_args)
    same("arma_rents_chunk", c1, H.arma_rents_chunk_plain(*a_args),
         "Figs 23-25, 1 x 4,000: one row's FMA-chain dots")
    require(np.array_equal(arrivals.bernoulli(kx, 0.5, T, device=dev),
                           x1[0].cpu().numpy())
            and np.array_equal(rentcosts.aws_spot_like(kc, fig.C_MEAN, T,
                                                       device=dev),
                               c1[2][0].cpu().numpy()),
            "the array builders differ from their streams' kernels")

    # Fig 24's slab: the curve's interior points x 4 seeds, trace playback
    _, _, points, cmin, cmax, scenario_fn = fig.workload(T, 0, dev)
    grid24 = HostingGrid.from_costs(
        [HostingCosts.three_level(10.0, a, g, cmin, cmax)
         for a, g in points], device=dev)
    scen = sc.replicate_seeds(scenario_fn(grid24), N_SEEDS)
    _, slab = scen.chunk_fn(scen.params, scen.init_fn(scen.params), tids)
    sv = scen.params["svc"]
    m_args = (sv["key"], tids, slab.x, sv["g"], fig.MAX_PER_SLOT)
    svc = H.model2_service_chunk(*m_args)
    same("model2_service_chunk", svc, H.model2_service_chunk_plain(*m_args),
         f"Fig 24's slab, {svc.shape[0]} x {T}, K = 3, one request a slot")
    require(svc.shape[0] == 76 and torch.equal(svc, slab.svc),
            "Fig 24's slab: 76 rows, the scenario's service slab")

    # Fig 25's chunks at a curve point: 5 M x 4 seeds, chunks of 1,000
    a_mid, g_mid = points[len(points) // 2]
    grid25 = HostingGrid.from_costs(
        [HostingCosts.three_level(M, a_mid, g_mid, cmin, cmax)
         for M in (2.0, 5.0, 10.0, 20.0, 40.0)], device=dev)
    scen = sc.replicate_seeds(scenario_fn(grid25), N_SEEDS)
    rgrid = grid25.repeat_rows(N_SEEDS)
    R25 = rgrid.B
    T_len = torch.full((R25,), T, dtype=torch.int32, device=dev)
    state, lanes = scen.init_fn(scen.params), {}
    sv = scen.params["svc"]
    for t0 in range(0, T, FIG25_CHUNK):
        tt = sc.base.chunk_tids(t0, FIG25_CHUNK, dev)
        state, slab = scen.chunk_fn(scen.params, state, tt)
        for lbl, cols in (("alpha-RR", None),
                          ("RR", rgrid.endpoint_columns())):
            lanes.setdefault(lbl, svc_lane_args(
                rgrid, R25, T_len, 0, slab.c, slab.svc, cols, False, True))
        m_args = (sv["key"], tt, slab.x, sv["g"], fig.MAX_PER_SLOT)
        same("model2_service_chunk", H.model2_service_chunk(*m_args),
             H.model2_service_chunk_plain(*m_args),
             f"Fig 25's chunk at t0={t0}, {R25} x {FIG25_CHUNK}")
        for lbl, (d, s_) in lanes.items():
            d = (d[0], slab.c, slab.svc, *d[3:7], t0, *d[8:])
            s_ = (*s_[:4], t0, s_[5], slab.c, slab.svc, *s_[8:])
            kd, ks_ = H.dp_fwd_model2(*d), H.sim_chunk_alpha_rr_svc(*s_)
            same("dp_fwd_model2", kd, H.dp_fwd_model2_plain(*d),
                 f"Fig 25's chunk at t0={t0}, {lbl}")
            same("sim_chunk_alpha_rr_svc", ks_,
                 H.sim_chunk_alpha_rr_svc_plain(*s_),
                 f"Fig 25's chunk at t0={t0}, {lbl}")
            lanes[lbl] = [(kd[0],) + d[1:], s_[:5] + (ks_[0],) + s_[6:]]

    # the study's union slab: 31 levels, 4 seeds x 4,000 slots
    curve_pts, _, bk_lanes, ugrid, usc = bk.candidates(0, dev)
    scen = sc.replicate_seeds(usc, N_SEEDS)
    _, slab = scen.chunk_fn(scen.params, scen.init_fn(scen.params), tids)
    sv = scen.params["svc"]
    Kf = sv["g"].shape[1]
    require(Kf == 31 and len(bk_lanes) == 26,
            f"the study's union grid has {Kf} levels, {len(bk_lanes)} lanes")
    study_args = (sv["key"], tids, slab.x, sv["g"], bk.MAX_PER_SLOT)
    svc31 = H.model2_service_chunk(*study_args)
    same("model2_service_chunk wide", svc31,
         H.model2_service_chunk_plain(*study_args),
         f"the study's slab, {N_SEEDS} x {T}, K = {Kf}")
    require(torch.equal(svc31, slab.svc), "the study's service slab differs")
    T_len4 = torch.full((N_SEEDS,), T, dtype=torch.int32, device=dev)

    def lane_args(lane, c, svc, T_len, rows, cols=None):
        """S's arguments for ``lane`` (its grid and column map repeated
        over ``rows`` rows) on the slab ``c`` / ``svc``."""
        reps = rows // lane.grid.B
        g_l = lane.grid.repeat_rows(reps)
        if cols is None:
            cols = torch.as_tensor(np.repeat(lane.svc_cols, reps, axis=0),
                                   dtype=torch.int32, device=dev)
        pol = AlphaRR.batch(g_l)
        return (pol.params, g_l.levels, g_l.M, T_len, 0,
                (alpha_rr_init(pol.params), sim_acc0(rows, g_l.K, dev)), c,
                svc, cols, True, True)

    # the lanes of K = 2 (RR), 3 (a curve point) and 8 (the knapsack grid
    # of k = 6)
    study_lanes = {}
    for lane in (bk_lanes[len(curve_pts)], bk_lanes[0], bk_lanes[-2]):
        a = lane_args(lane, slab.c, slab.svc, T_len4, N_SEEDS)
        same("sim_chunk_alpha_rr_svc wide", H.sim_chunk_alpha_rr_svc(*a),
             H.sim_chunk_alpha_rr_svc_plain(*a),
             f"the study's slab, a lane of K = {lane.grid.K}")
        study_lanes[lane.grid.K] = a
    require(sorted(study_lanes) == [2, 3, 8], f"the study's lanes: "
                                              f"{sorted(study_lanes)}")
    log(f"g-curve kernels ok at the modules' own chunks: {n_cmp}")

    # slabs of 17 to 32 levels, aligned and ragged, both layouts
    gen = torch.Generator(device="cpu").manual_seed(29)
    rows, t0 = 256, T_MAIN - CHUNK
    keys = sc.split_keys(sc.prng_key(16, dev), rows)
    slabs = [("256 rows x 1,024 slots", rows, t0, 1024),
             ("253 rows, odd t0, 1,001 slots", rows - 3, t0 + 1, 1001)]
    for part in (True, False):
        lay = "partitionable" if part else "original"
        for label, n_rows, first, n in slabs:
            tt = sc.base.chunk_tids(first, n, dev)
            kk = keys[:n_rows].contiguous()
            x = torch.randint(-2, 30, (n_rows, n), generator=gen,
                              dtype=torch.int32).to(dev)
            c = (torch.rand((n_rows, n), generator=gen) * 3).to(dev)
            T_len = torch.randint(first, first + 2 * n, (n_rows,),
                                  generator=gen).to(torch.int32).to(dev)
            for Kw in BAND_KS + WIDE_KS:
                g = torch.rand((n_rows, Kw), generator=gen)
                g[::3, 0], g[1::4, Kw // 2] = 1.0, 0.0
                g = g.to(dev)
                for n_max in (M2_MAX, 1):
                    svc = H.model2_service_chunk(kk, tt, x, g, n_max, part)
                    same("model2_service_chunk"
                         + (" wide" if Kw > H.DPF_MAX_K else ""), svc,
                         H.model2_service_chunk_plain(kk, tt, x, g, n_max,
                                                      part),
                         f"{label}, K={Kw}, {n_max} requests, {lay}")
                if not part or Kw not in WIDE_KS:
                    continue       # S reads the slab, not the keys
                for K in (3, 8):
                    cols = torch.sort(torch.randint(
                        0, Kw, (n_rows, K), generator=gen), dim=1)[0]
                    cols[:, 0], cols[:, -1] = 0, Kw - 1
                    cols = cols.to(torch.int32).to(dev)
                    lane = HostingGrid.from_costs(
                        [HostingCosts(M=float(m), levels=tuple(
                            np.linspace(0.0, 1.0, K)), g=tuple(
                            np.linspace(1.0, 0.0, K)))
                         for m in np.geomspace(2, 50, n_rows)], device=dev)
                    pol = AlphaRR.batch(lane)
                    for flag in (True, False):
                        a = (pol.params, lane.levels, lane.M, T_len, first,
                             (alpha_rr_init(pol.params),
                              sim_acc0(n_rows, K, dev)), c, svc, cols, flag,
                             flag)
                        same("sim_chunk_alpha_rr_svc wide",
                             H.sim_chunk_alpha_rr_svc(*a),
                             H.sim_chunk_alpha_rr_svc_plain(*a),
                             f"{label}, K={K} of {Kw}, trace {flag}, {lay}")
                    stat = StaticPolicy.batch(lane, lane.top_index())
                    a = (*table_form(stat.step_fn, stat.params, K),
                         lane.levels, lane.M, T_len, first,
                         (stat.init_fn(stat.params),
                          sim_acc0(n_rows, K, dev)), x, c, None, svc, cols,
                         True, True)
                    same("sim_chunk_table_svc", H.sim_chunk_table_svc(*a),
                         H.sim_chunk_table_svc_plain(*a),
                         f"{label}, static, K={K} of {Kw}, {lay}")
        log(f"wide slabs ok (K = {WIDE_KS}; the service draws also at "
            f"{BAND_KS}), {lay} layout")
    log(f"g-curve and wide-slab kernels ok; compared {n_cmp}")

    # timed: the study's shape, and a fleet-width chunk of the union grid
    R, chunk = N_M * N_ALPHA * N_SEEDS, CHUNK
    alu_block = sass["slot_uniform"][0] / 2     # ALU-pipe ops a block

    def service_work(x, n_max, K):
        n_live = torch.clamp(x, 0, n_max)
        live = float(n_live.double().sum())
        slots = float((n_live > 0).double().sum())
        bound = (slots + live) * alu_block / (64 * n_sm * clock * 1e3)
        return live, slots, bound, 79 * (slots + live) + live * (
            M2_REQUEST_OPS + 2 * K)

    live, slots, int_bound, ops = service_work(slab.x, bk.MAX_PER_SLOT, Kf)
    plain_ms, _ = timed_once(lambda: H.model2_service_chunk_plain(
        *study_args))
    m2 = dict(
        replaces="src/repro/core/scenarios/streams.py:402",
        consumer="src/repro/core/scenarios/streams.py:403",
        ms=cuda_ms(lambda: H.model2_service_chunk(*study_args), reps=7,
                   batch=10),
        plain_ms=plain_ms, sm_clock_mhz=clock, max_abs_err=0.0,
        live_requests_per_slot=live / (N_SEEDS * T),
        int_pipe_bound_ms=int_bound, ops=ops,
        nbytes=nbytes(*study_args[:4], svc31))
    fk = sc.split_keys(sc.prng_key(33, dev), R)
    ftids = sc.base.chunk_tids(T_MAIN - chunk, chunk, dev)
    fx = H.poisson_chunk(fk, ftids, torch.from_numpy(np.resize(
        np.float32(M2_LAMS), R)).to(dev))
    fg = ugrid.g.expand(R, Kf).contiguous()
    f_args = (fk, ftids, fx, fg, M2_MAX)
    fout = H.model2_service_chunk(*f_args)
    fplain_ms, fp = timed_once(lambda: H.model2_service_chunk_plain(
        *sub_rows((fk,), SVC_ROWS), ftids, *sub_rows((fx, fg), SVC_ROWS),
        M2_MAX))
    same("model2_service_chunk wide", fout[:SVC_ROWS], fp,
         f"the fleet-width chunk, its first {SVC_ROWS} rows")
    _, _, f_int, f_ops = service_work(fx, M2_MAX, Kf)
    g3 = fleet_grid(N_M, N_ALPHA, dev).repeat_rows(N_SEEDS).g
    by_k = {}
    for K in SERVICE_SWEEP_KS:            # the same draws on K levels
        gk = torch.linspace(1.0, 0.0, K, device=dev).expand(R, K)
        gk = gk.contiguous()
        by_k[K] = cuda_ms(lambda: H.model2_service_chunk(
            fk, ftids, fx, gk, M2_MAX), reps=3, batch=3)
    m2.update(
        fleet_ms=cuda_ms(lambda: H.model2_service_chunk(*f_args), reps=5,
                         batch=3),
        fleet_k3_ms=cuda_ms(lambda: H.model2_service_chunk(
            fk, ftids, fx, g3, M2_MAX), reps=5, batch=3),
        fleet_ms_by_k=by_k,
        fleet_plain_ms=fplain_ms, fleet_plain_rows=SVC_ROWS,
        fleet_int_pipe_bound_ms=f_int,
        fleet_bound_ms=max(nbytes(*f_args[:4], fout) / PEAK_BYTES,
                           f_ops / PEAK_OPS) * 1e3,
        shape=f"R={N_SEEDS} chunk={T} K={Kf}, one request a slot at most "
              f"(beyond_knapsack_levels' slab), partitionable layout; "
              f"fleet_*: R={R} chunk={chunk} K={Kf}, {M2_MAX} requests a "
              f"slot at most (the Model-2 leg's arrivals), fleet_k3_ms the "
              f"same arrivals on K = 3; "
              f"{n_cmp['model2_service_chunk wide']} calls compared")
    # S: the study's K = 8 lane on its slab; at fleet width a K = 3 lane of
    # the 31-level slab.  Each also on its own columns gathered beforehand
    # into a [rows, slots, K] slab, which S stages by its bulk route: the
    # difference is what the gather route costs
    a8 = study_lanes[8]
    (st8, acc8), _ = H.sim_chunk_alpha_rr_svc(*a8)
    plain_ms, _ = timed_once(lambda: H.sim_chunk_alpha_rr_svc_plain(*a8))
    pre8 = a8[:7] + (H.gather_svc(a8[7], a8[8]), None) + a8[9:]
    same("sim_chunk_alpha_rr_svc", H.sim_chunk_alpha_rr_svc(*pre8),
         H.sim_chunk_alpha_rr_svc(*a8), "the study's K = 8 lane, its "
                                        "columns gathered beforehand")
    s_rec = dict(
        replaces="src/repro/core/simulator.py:147",
        ms=cuda_ms(lambda: H.sim_chunk_alpha_rr_svc(*a8), reps=10,
                   batch=10),
        bulk_ms=cuda_ms(lambda: H.sim_chunk_alpha_rr_svc(*pre8), reps=10,
                        batch=10),
        plain_ms=plain_ms, sm_clock_mhz=clock, max_abs_err=0.0, lane_k=8,
        chain_ops=sim_chain_ops(8),
        latency_bound_ms=T * sim_chain_ops(8) * FP32_LATENCY
        / (clock * 1e3),
        ops=N_SEEDS * T * (11 * 8 + 9),
        nbytes=nbytes(*a8[0].values(), a8[1], a8[2], a8[3],
                      *a8[5][0].values(), *a8[5][1].values(), a8[6],
                      H.gather_svc(a8[7], a8[8]), a8[8], *st8.values(),
                      *acc8.values()))
    # its parts at the same call: without the trace, on horizons that end
    # before the chunk (no step of the policy: the staging, the cook, the
    # accounting and the trace), the study's lanes of 2 and 3 levels
    before8 = a8[:3] + (torch.zeros_like(a8[3]),) + a8[4:]
    s_rec["parts_ms"] = {
        name: cuda_ms(lambda a=a: H.sim_chunk_alpha_rr_svc(*a), reps=10,
                      batch=10)
        for name, a in (("no_trace", a8[:10] + (False,)),
                        ("horizons_before_the_chunk", before8),
                        ("k2_lane", study_lanes[2]),
                        ("k3_lane", study_lanes[3]))}
    gather_edges(dev, n_sm)
    del slab, svc31
    fslab_c = (torch.rand((R, chunk), generator=gen) * 3).to(dev)
    T_lenR = torch.full((R,), T_MAIN, dtype=torch.int32, device=dev)
    lane3 = bk_lanes[0]
    cols3 = torch.as_tensor(np.repeat(lane3.svc_cols, R, axis=0),
                            dtype=torch.int32, device=dev)
    fa = lane_args(lane3, fslab_c, fout, T_lenR, R, cols3)
    fa = fa[:9] + (True, False)
    k = H.sim_chunk_alpha_rr_svc(*fa)
    fplain_ms, p = timed_once(lambda: H.sim_chunk_alpha_rr_svc_plain(*fa))
    same("sim_chunk_alpha_rr_svc wide", k, p,
         f"the fleet-width chunk, a lane of K = 3 of {Kf}")
    (stf, accf), _ = k
    pre3 = fa[:7] + (H.gather_svc(fa[7], fa[8]), None) + fa[9:]
    same("sim_chunk_alpha_rr_svc", H.sim_chunk_alpha_rr_svc(*pre3), k,
         "the fleet-width K = 3 lane, its columns gathered beforehand")
    # the gather route's 4-byte reads each move a 32-byte sector: the
    # distinct sectors of a (row, slot)'s K columns, over the chunk
    sec = torch.sort((((torch.arange(R * chunk, device=dev, dtype=torch.int64)
                        .view(R, chunk, 1) * Kf + cols3[:, None, :]) * 4)
                      >> 5), dim=2)[0]
    sectors = float(R * chunk + (sec.diff(dim=2) != 0).sum().item())
    del sec
    s_rec.update(
        fleet_ms=cuda_ms(lambda: H.sim_chunk_alpha_rr_svc(*fa), reps=10,
                         batch=10),
        fleet_bulk_ms=cuda_ms(lambda: H.sim_chunk_alpha_rr_svc(*pre3),
                              reps=10, batch=10),
        fleet_sectors_per_slot=sectors / (R * chunk),
        fleet_sector_bound_ms=(sectors * 32 + nbytes(
            fslab_c, *stf.values(), *accf.values())) / PEAK_BYTES * 1e3,
        fleet_plain_ms=fplain_ms,
        fleet_bound_ms=max(nbytes(
            *fa[0].values(), fa[1], fa[2], fa[3], *fa[5][0].values(),
            *fa[5][1].values(), fa[6], H.gather_svc(fa[7], fa[8]), fa[8],
            *stf.values(), *accf.values()) / PEAK_BYTES,
            R * chunk * (11 * 3 + 9) / PEAK_OPS) * 1e3,
        shape=f"R={N_SEEDS} chunk={T}, a lane of K = 8 gathering its "
              f"columns of the study's {Kf}-level slab, with its trace (the "
              f"study's call); fleet_*: R={R} chunk={chunk}, a lane of K = "
              f"3 of {Kf}, no trace; bytes count the gathered columns; "
              f"{n_cmp['sim_chunk_alpha_rr_svc wide']} calls compared")
    log(f"sim_chunk_alpha_rr_svc wide at the study's call: "
        f"{PREV_MS['sim_chunk_alpha_rr_svc wide']:.4f} -> {s_rec['ms']:.4f} "
        f"ms ({s_rec['ms'] * 1e-3 * clock * 1e6 / T:.1f} cycles a slot); "
        f"its parts " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                  s_rec["parts_ms"].items()))
    for name, r in (("model2_service_chunk wide", m2),
                    ("sim_chunk_alpha_rr_svc wide", s_rec)):
        log(f"{name} timed: {r['ms']:.4f} ms at the study's shape (plain "
            f"{r['plain_ms']:.1f} ms), {r['fleet_ms']:.4f} ms at fleet "
            f"width (bound {r['fleet_bound_ms']:.4f} ms"
            + (f", integer pipe {r['fleet_int_pipe_bound_ms']:.4f}, K = 3 "
               f"{r['fleet_k3_ms']:.4f} ms" if "fleet_k3_ms" in r else "")
            + f"; plain {r['fleet_plain_ms']:.1f} ms)"
            + (f"; at fleet width by K: "
               f"{ {k: round(v, 4) for k, v in r['fleet_ms_by_k'].items()} }"
               if "fleet_ms_by_k" in r else "")
            + (f"; on the lane's columns gathered beforehand (the bulk "
               f"route) {r['bulk_ms']:.4f} / {r['fleet_bulk_ms']:.4f} ms; "
               f"the policy's chain {r['chain_ops']} ops a slot: latency "
               f"bound {r['latency_bound_ms']:.4f} ms at the study's shape; "
               f"{r['fleet_sectors_per_slot']:.3f} 32-byte sectors a slot "
               f"at fleet width: {r['fleet_sector_bound_ms']:.4f} ms"
               if "bulk_ms" in r else ""))
    return {"model2_service_chunk wide": m2,
            "sim_chunk_alpha_rr_svc wide": s_rec}


def gather_edges(dev, n_sm):
    """alpha-RR's S on a 31-level slab (the gather route) == its plain
    version, bit for bit, on few rows: 1, 4, 5 and 31 rows (its few-rows
    instances from 4 levels) and a row either side of that route's one
    wave at K = 8; lanes of 2, 3 and 8 levels gathering their columns, the
    trace on and off, the final fetch kept and dropped, ragged chunks from
    an odd t0, horizons inside the chunk, from a carry in mid-run, half the
    cases on a grid of values (ties between margins)."""
    Kf, t0 = 31, 4001
    cases = [(R, K, trace, (1, 17, 333, 1001)[(ri + ki) % 4])
             for ri, R in enumerate((1, 4, 5, 31))
             for ki, K in enumerate((2, 3, 8)) for trace in (True, False)]
    cases += [(4 * n_sm, 8, True, 333), (4 * n_sm + 1, 8, False, 333)]
    for i, (R, K, trace, chunk) in enumerate(cases):
        gen = torch.Generator(device="cpu").manual_seed(i)

        def rand(*shape, scale=1.0, shift=0.0):
            """uniform draws, or (odd cases) on a grid: ties in the
            margins, where the first index must win"""
            if i % 2:
                return (torch.randint(0, 9, shape, generator=gen) / 8 * scale
                        + shift)
            return torch.rand(shape, generator=gen) * scale + shift

        lv = torch.sort(rand(R, K), dim=1)[0]
        lv[:, 0], lv[:, -1] = 0.0, 1.0
        mid = torch.argsort(torch.rand((R, Kf - 2), generator=gen),
                            dim=1)[:, :K - 2] + 1
        cols = torch.sort(torch.cat([torch.zeros((R, 1), dtype=torch.int64),
                                     mid, torch.full((R, 1), Kf - 1)], 1),
                          dim=1)[0].to(torch.int32)
        S = torch.where(torch.rand((R, K), generator=gen) < 0.3,
                        torch.tensor(3.4e38), rand(R, K, scale=4, shift=-2))
        t = (lv, rand(R, scale=20, shift=0.5),
             torch.randint(t0 - 3, t0 + chunk + 3, (R,), generator=gen,
                           dtype=torch.int32),
             torch.randint(0, K, (R,), generator=gen, dtype=torch.int32), S,
             torch.randint(0, 4, (R,), generator=gen, dtype=torch.int32),
             torch.rand((R, 3), generator=gen) * 100,
             torch.randint(0, 50, (R, K), generator=gen, dtype=torch.int32),
             rand(R, chunk, scale=1.5), rand(R, chunk, Kf, scale=3), cols)
        lv, M, T_len, r, S, age, sums, counts, c, slab, cols = (
            a.to(dev) for a in t)
        params = {"levels": lv, "mask": torch.ones_like(lv, dtype=torch.bool),
                  "M": M}
        args = (params, lv, M, T_len, t0,
                ({"r": r, "S": S, "age": age},
                 {"sums": sums, "counts": counts}), c, slab, cols,
                i % 2 == 0, trace)
        require(tree_equal(H.sim_chunk_alpha_rr_svc(*args),
                           H.sim_chunk_alpha_rr_svc_plain(*args)),
                f"S's gather route differs from its plain version at R={R} "
                f"K={K} chunk={chunk} trace={trace}")
    log(f"S's gather route ok on few rows: {len(cases)} calls compared")


# ----------------------------------------------------------------------
# Phase 11: kernels F and M against their plain versions.
# ----------------------------------------------------------------------

# Tolerances.  fp32 outputs, normwise: max |kernel - plain| <= tol *
# max(1, max |plain|), where tol is TOL_F32 for F (the same sums in another
# order, 64-key tiles and per-thread partial dot products, and the card's
# expf against torch.exp) and TOL_STATE for M's fp32 state (128-term sums
# per chunk, compounded over 16 chunks).  bf16 outputs, element by element:
# both versions round an fp32 value to bf16, and fp32 values that differ in
# their last bits can round to neighbouring bf16 values, one ulp apart, at
# most 2**-7 of the element itself; so |kernel - plain| <= 2**-7 * |plain|
# + TOL_F32 * max(1, max |plain|), the second term bounding the fp32
# difference before the rounding (about 4e-5 for F, 3e-3 for M's y, whose
# largest |y| is about 300 against a typical 4).
TOL_F32 = 1e-5
TOL_STATE = 1e-4
RTOL_BF16 = 2.0 ** -7


def normwise_errors(k, p):
    """(max_abs_err, that over max(1, max |plain|))."""
    d = float((k.double() - p.double()).abs().max())
    return d, d / max(1.0, float(p.double().abs().max()))


def check_close(label, k, p, tol, errs):
    """Hold ``k`` to ``p`` by the rule above (bf16 outputs element by
    element); ``errs`` gains (max_abs_err, max_rel_err), the relative error
    taken per element over |plain| + the absolute term."""
    kd, pd = k.double(), p.double()
    d, mag = (kd - pd).abs(), pd.abs()
    atol = tol * max(1.0, float(mag.max()))
    rtol = RTOL_BF16 if k.dtype == torch.bfloat16 else 0.0
    share = float((d / (rtol * mag + atol)).max())
    a, r = float(d.max()), float((d / (mag + atol)).max())
    log(f"  {label}: max_abs_err {a:.3e} max_rel_err {r:.3e} (limit "
        f"{rtol:.2e} * |plain| + {atol:.2e}; worst element at {share:.3f} "
        f"of it)")
    require(share <= 1.0, f"{label}: kernel differs from its plain version "
                          f"({share:.3f} of the limit)")
    errs.append((a, r))


def ssd_ops(b, s, nh, dh, ds, Q):
    """FLOP of the SSD over this input: per (batch, head) and chunk of n
    rows, the causal half of C B^T and of the decay matrix times u, the
    inter-chunk C h^T and the state update (a multiply-add is 2)."""
    total = 0
    for c0 in range(0, s, Q):
        n = min(Q, s - c0)
        pairs = n * (n + 1) // 2
        total += 2 * (pairs * ds + pairs * dh + 2 * n * dh * ds)
    return b * nh * total


def lm_kernel_checks(dev):
    """F's and M's kernels at the serving path's shapes and the variants
    that reach the edges of the dispatch; returns {kernel name: record}.
    Each variant asserts which kernel the dispatch launched."""
    cfg = get_arch("zamba2-1.2b").model
    B, S = SERVE_B, SERVE_S
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nh, dh, ds, ng = (cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_n_groups)
    Q = cfg.ssm_chunk
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def dispatched(fn, kernels, want):
        """``fn()`` through the public wrapper, requiring that exactly the
        kernel ``want`` of ``kernels`` launched."""
        before = {k.__name__: k.launches for k in kernels}
        out = fn()
        got = {k.__name__: k.launches - before[k.__name__] for k in kernels}
        require(got == {k.__name__: int(k.__name__ == want)
                        for k in kernels},
                f"dispatch launched {got}, expected {want}")
        return out

    rec = {}
    # F: (label, q, k, v, causal, q_offset, kernel)
    log("F against its plain version:")
    f_kernels = (FA.flash_attention_wgmma, FA.flash_attention_fma)
    errs = {k.__name__: [] for k in f_kernels}
    q, k, v = (randn(B, S, Hq, hd) for _ in range(3))
    qf, kf, vf = (t.float() for t in (q, k, v))
    cases = [
        (f"bf16 causal B={B} S={S}", q, k, v, True, 0, "wgmma"),
        (f"fp32 causal B={B} S={S}", qf, kf, vf, True, 0, "fma"),
        (f"bf16 decode Sq=1 q_offset={S - 548} Skv={S}", randn(B, 1, Hq, hd),
         k, v, True, S - 548, "wgmma"),
        (f"bf16 decode Sq=1 q_offset={S - 1} Skv={S}", randn(B, 1, Hq, hd),
         k, v, True, S - 1, "wgmma"),
        ("bf16 causal Sq=200 (a ragged 128-row q tile)",
         randn(2, 200, 4, 64), randn(2, 200, 4, 64), randn(2, 200, 4, 64),
         True, 0, "wgmma"),
        ("bf16 causal Sq=100 Skv=333 q_offset=233 (a ragged key tile)",
         randn(1, 100, 2, 64), randn(1, 333, 2, 64), randn(1, 333, 2, 64),
         True, 233, "wgmma"),
        ("bf16 non-causal Sq=77 Skv=1000", randn(2, 77, 4, 64),
         randn(2, 1000, 4, 64), randn(2, 1000, 4, 64), False, 0, "wgmma"),
        ("bf16 causal GQA 8/2 heads hd=128 S=300", randn(2, 300, 8, 128),
         randn(2, 300, 2, 128), randn(2, 300, 2, 128), True, 0, "wgmma"),
        ("bf16 causal hd=32 S=130", randn(2, 130, 4, 32),
         randn(2, 130, 4, 32), randn(2, 130, 4, 32), True, 0, "fma"),
        ("fp32 non-causal Sq=100 Skv=1000",
         randn(2, 100, 4, 64, dtype=torch.float32),
         randn(2, 1000, 4, 64, dtype=torch.float32),
         randn(2, 1000, 4, 64, dtype=torch.float32), False, 0, "fma"),
    ]
    for label, qq, kk, vv, causal, off, kern in cases:
        name = f"flash_attention_{kern}"
        out = dispatched(lambda: FA.flash_attention(qq, kk, vv, causal, off),
                         f_kernels, name)
        check_close(f"{label} [{kern}]", out,
                    FA.flash_attention_plain(qq, kk, vv, causal, off),
                    TOL_F32, errs[name])
    # the fma kernel on the main bf16 input too: its time is taken there
    out_fma = FA.flash_attention_fma(q, k, v, True, 0)
    check_close(f"bf16 causal B={B} S={S} [fma]", out_fma,
                FA.flash_attention_plain(q, k, v, True, 0), TOL_F32,
                errs["flash_attention_fma"])
    del qf, kf, vf, cases, out_fma
    torch.cuda.synchronize()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    plain_ms = cuda_ms(lambda: FA.flash_attention_plain(q, k, v, True, 0),
                       reps=3)
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), batch=10)
    f_ops = 4 * B * Hq * hd * (S * (S + 1) // 2)
    shape = f"q/k/v [{B}, {S}, {Hq}, {hd}] bf16 causal"
    for fn, note in (
            (FA.flash_attention_wgmma, "bf16 at hd 64 / 128"),
            (FA.flash_attention_fma, "fp32, and bf16 at hd 16 / 32; off the "
                                     "serving path")):
        name = fn.__name__
        rec[name] = dict(
            source=CSRC + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:71",
            ms=cuda_ms(lambda: fn(q, k, v, True, 0),
                       reps=10 if fn is FA.flash_attention_wgmma else 3,
                       batch=10),
            plain_ms=plain_ms, library_ms=sdpa_ms,
            max_abs_err=max(e[0] for e in errs[name]),
            max_rel_err=max(e[1] for e in errs[name]),
            nbytes=nbytes(q, k, v, q), ops=f_ops, peak_ops=PEAK_BF16,
            shape=f"{shape}; takes {note} ({len(errs[name])} variants "
                  f"compared)")
        log(f"F {name} timed: {rec[name]['ms']:.4f} ms, plain "
            f"{plain_ms:.3f} ms, SDPA {sdpa_ms:.4f} ms")
    del q, k, v, qt, kt, vt

    # M: (label, s, chunk, h0, dtype, ds, kernel)
    log("M against its plain version:")
    m_kernels = (SSD.ssd_scan_mma, SSD.ssd_scan_fma)
    errs = {k.__name__: [] for k in m_kernels}

    def ssd_inputs(b, s, ds_=ds, dtype=torch.bfloat16, nh_=nh):
        x = randn(b, s, nh_, dh, dtype=dtype)
        dt = torch.nn.functional.softplus(
            randn(b, s, nh_, dtype=torch.float32))
        A = -torch.exp(randn(nh_, dtype=torch.float32) * 0.5)
        return (x, dt, A, randn(b, s, ng, ds_, dtype=dtype),
                randn(b, s, ng, ds_, dtype=dtype))

    main = ssd_inputs(B, S)
    cases = [
        (f"bf16 S={S}", main, None, Q, "mma"),
        (f"bf16 h0 given, ragged S={S - 45}", ssd_inputs(B, S - 45),
         torch.randn((B, nh, dh, ds), generator=g, device=dev), Q, "mma"),
        ("bf16 chunk 8, S=8 (the scheduler's prompts)", ssd_inputs(B, 8),
         None, 8, "mma"),
        ("bf16 ds=128 h0 given S=300", ssd_inputs(2, 300, 128, nh_=8),
         torch.randn((2, 8, dh, 128), generator=g, device=dev), Q, "mma"),
        ("bf16 chunk 256 S=300", ssd_inputs(2, 300, nh_=8), None, 256,
         "fma"),
        ("fp32 h0 given S=300", ssd_inputs(2, 300, dtype=torch.float32,
                                           nh_=8),
         torch.randn((2, 8, dh, ds), generator=g, device=dev), Q, "fma"),
    ]
    for label, args, h0, chunk, kern in cases:
        name = f"ssd_scan_{kern}"
        y, hT = dispatched(lambda: SSD.ssd_scan(*args, h0, chunk), m_kernels,
                           name)
        yp, hp = SSD.ssd_scan_plain(*args, h0, chunk)
        # fp32 y sums up to 2 * chunk terms per output: 10x the fp32 tol
        check_close(f"y, {label} [{kern}]", y, yp,
                    TOL_F32 * (10 if y.dtype == torch.float32 else 1),
                    errs[name])
        check_close(f"hT, {label} [{kern}]", hT, hp, TOL_STATE, errs[name])
    y, hT = SSD.ssd_scan_fma(*main, None, Q)
    yp, hp = SSD.ssd_scan_plain(*main, None, Q)
    check_close(f"y, bf16 S={S} [fma]", y, yp, TOL_F32,
                errs["ssd_scan_fma"])
    check_close(f"hT, bf16 S={S} [fma]", hT, hp, TOL_STATE,
                errs["ssd_scan_fma"])
    del cases, yp, hp
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: SSD.ssd_scan_plain(*main, None, Q), reps=3)
    x, dt, A, Bm, Cm = main
    for fn, note in (
            (SSD.ssd_scan_mma, "bf16, dh / ds multiples of 16 up to 128, "
                               "chunk <= 128"),
            (SSD.ssd_scan_fma, "fp32 and every other width or chunk; off "
                               "the serving path")):
        name = fn.__name__
        rec[name] = dict(
            source=CSRC + "ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:68",
            ms=cuda_ms(lambda: fn(*main, None, Q),
                       reps=10 if fn is SSD.ssd_scan_mma else 3, batch=10),
            plain_ms=plain_ms, library_ms=None,
            max_abs_err=max(e[0] for e in errs[name]),
            max_rel_err=max(e[1] for e in errs[name]),
            nbytes=nbytes(x, dt, A, Bm, Cm, y, hT),
            ops=ssd_ops(B, S, nh, dh, ds, Q), peak_ops=PEAK_BF16,
            shape=f"x [{B}, {S}, {nh}, {dh}] bf16, B/C [{B}, {S}, {ng}, "
                  f"{ds}], chunk {Q}; takes {note} ({len(errs[name]) // 2} "
                  f"variants, y and hT each, compared)")
        log(f"M {name} timed: {rec[name]['ms']:.4f} ms, plain "
            f"{plain_ms:.3f} ms")
    return rec


# ----------------------------------------------------------------------
# Phases 6 to 10: the policy fan-out, the figures, the fan-out legs.
# ----------------------------------------------------------------------

FIG_KERNELS = {
    # each figure's kernels: P's streams, S for every lane, D for the OPT
    # frontiers (Figs 1-6; Figs 7-8 run no OPT)
    "fig01_02": ("bernoulli_arrivals_chunk", "normal_chunk",
                 "arma_rents_chunk", "sim_chunk_alpha_rr", "dp_fwd_model1"),
    "fig03_06": ("bernoulli_arrivals_chunk", "normal_chunk",
                 "arma_rents_chunk", "sim_chunk_alpha_rr", "dp_fwd_model1"),
    "fig07_08": ("ge_bernoulli_chunk", "slot_uniform", "normal_chunk",
                 "arma_rents_chunk", "sim_chunk_alpha_rr"),
    # the bursty arrivals: the GE chain (its initial draw on the uniforms)
    # and its Poisson emissions
    "fig10_11": ("ge_bernoulli_chunk", "slot_uniform", "poisson_chunk",
                 "normal_chunk", "arma_rents_chunk", "sim_chunk_alpha_rr",
                 "dp_fwd_model1"),
    # Model 2: Poisson arrivals, the service draws, S on the slab (no DP)
    "fig12_15": ("poisson_chunk", "model2_service_chunk", "normal_chunk",
                 "arma_rents_chunk", "sim_chunk_alpha_rr_svc"),
    # GE-Poisson at 200 / 10 (the rejection branch), Model-2 service, S
    # for alpha-RR / RR and S's table variant for MDP and ABC (no DP)
    "fig17_22": ("ge_bernoulli_chunk", "slot_uniform", "poisson_chunk",
                 "model2_service_chunk", "normal_chunk", "arma_rents_chunk",
                 "sim_chunk_alpha_rr_svc", "sim_chunk_table_svc"),
    # the recorded path (Bernoulli, spot rents on one row), its playback
    # with the service draws at one request a slot, S on the slab, D for
    # Fig 25's OPT frontiers
    "fig23_25": ("bernoulli_arrivals_chunk", "normal_chunk",
                 "arma_rents_chunk", "model2_service_chunk",
                 "sim_chunk_alpha_rr_svc", "dp_fwd_model2"),
    # the service draws on the 31-level union slab, S for its 26 lanes
    "beyond_knapsack": ("bernoulli_arrivals_chunk", "normal_chunk",
                        "arma_rents_chunk", "model2_service_chunk",
                        "model2_service_chunk wide", "sim_chunk_alpha_rr_svc",
                        "sim_chunk_alpha_rr_svc wide"),
}
# (module, fleet rows at the defaults: grid points x 4 seeds, T)
FIGURES = {"fig01_02": (fig01_02_alpha_sweep, 40, 10000),
           "fig03_06": (fig03_06_m_p_sweeps, 88, 8000),
           "fig07_08": (fig07_08_multiple_rr, 20, 8000),
           "fig10_11": (fig10_11_trace, 40, 8000),
           "fig12_15": (fig12_15_poisson_model2, 76, 6000),
           "fig17_22": (fig17_22_markov_mdp, 84, 3000),
           "fig23_25": (fig23_25_geolife, 76, GCURVE_T),
           "beyond_knapsack": (beyond_knapsack_levels, 4, GCURVE_T)}
# the rows a module returns where they are not its fleet rows over the
# seeds: Figs 23-25's 20 curve points, 19 Fig 24 points and 5 Fig 25
# points; the study's 8 grids
FIG_RESULT_ROWS = {"fig23_25": 44, "beyond_knapsack": 8}
# the modules whose slabs hold more than 16 levels
FIG_WIDE = ("beyond_knapsack",)


def fanout_results_equal(a, b, fields=("total", "rent", "service", "fetch",
                                       "level_slots", "r_hist",
                                       "opt_cost")):
    return all((getattr(a, f) is None and getattr(b, f) is None)
               or np.array_equal(getattr(a, f), getattr(b, f))
               for f in fields)


def fanout_checks(dev):
    """The fan-out on the card, bit for bit: alpha-RR on the fleet grid
    and RR on its endpoints as two lanes over Bernoulli arrivals and spot
    rents, with the OPT frontiers, 64 instances x 4 seeds, T = 4,096 in
    chunks of 1,024; each lane equals its standalone run and its
    ``opt_cost`` ``offline_opt_fleet`` on its fleet.  Then card == CPU on
    the same fan-out at 16 instances x 4 seeds, T = 2,048."""
    fleet = FleetBatch.for_scenario(fleet_grid(2, N_ALPHA, dev), 4096)
    kw = dict(scenario=bernoulli_spot(fleet.B, dev), chunk_size=1024,
              n_seeds=N_SEEDS, device=dev)
    lanes = [AlphaRR.fleet_lane(fleet), RetroRenting.fleet_lane(fleet)]
    fan = run_fleet(lanes, fleet, with_opt_forward=True, **kw)
    ends = fleet.restrict_to_endpoints()
    for p, (f, pol) in enumerate(((fleet, AlphaRR.fleet(fleet)),
                                  (ends, RetroRenting.fleet(fleet)))):
        alone = run_fleet(pol, f, **kw)
        opt = offline_opt_fleet(f, checkpointed=True, collect_schedule=False,
                                **kw)
        K = alone.level_slots.shape[1]
        view = fan.policy_view
        require(np.array_equal(view(fan.total)[p], alone.total)
                and np.array_equal(view(fan.r_hist)[p], alone.r_hist)
                and np.array_equal(view(fan.level_slots)[p][:, :K],
                                   alone.level_slots)
                and np.array_equal(view(fan.opt_cost)[p], opt.cost),
                f"fan-out lane {p} differs from its standalone run")
    log(f"fan-out on the card: both lanes == their standalone runs, "
        f"opt_cost == offline_opt_fleet ({fan.B} rows, T=4096)")
    outs = []
    for d in (dev, "cpu"):
        f = FleetBatch.for_scenario(fleet_grid(1, SMALL_INSTANCES, d), 2048)
        t = time.perf_counter()
        outs.append(run_fleet(
            [AlphaRR.fleet_lane(f), RetroRenting.fleet_lane(f)], f,
            scenario=bernoulli_spot(SMALL_INSTANCES, d), chunk_size=512,
            n_seeds=N_SEEDS, with_opt_forward=True, device=d))
        wall = time.perf_counter() - t
    require(fanout_results_equal(*outs), "card != CPU: the spot fan-out")
    log(f"card == CPU: fan-out with spot rents, {outs[0].B} rows, T=2048 "
        f"({wall:.1f} s on the CPU)")


def figures(dev, timings):
    """The paper's Figs 1-22 at the reference's default sizes on the card:
    ``run()`` REPEATS times (launches counted over the first), the rows'
    shape, finite values and the port's ``check(rows)``.  Returns the
    launch counts of each figure's first run."""
    counts = []
    for name, (mod, n_rows, T) in FIGURES.items():
        ops.reset_launches()
        out, (launched, plain) = timed_passes(
            {"run": lambda: mod.run(device=dev)}, dev, f"figure/{name}",
            timings, counted=True)
        rows = out["run"]
        try:
            mod.check(rows)
        except AssertionError as e:
            raise RuntimeError(f"{name}: check(rows) failed: {e}") from e
        require(len(rows) == FIG_RESULT_ROWS.get(name, n_rows // N_SEEDS)
                and all(np.isfinite(v).all() for r in rows
                        for v in r.values() if not isinstance(v, str)),
                f"{name}: rows not finite / wrong count")
        for k in FIG_KERNELS[name]:
            require(launched[k] > 0, f"{name}: {k} never launched")
        wide = [k for k, v in launched.items() if k.endswith(" wide") and v]
        require(bool(wide) == (name in FIG_WIDE),
                f"{name}: launches on slabs of more than {H.DPF_MAX_K} "
                f"levels: {wide}")
        require(launched["dp_minplus"] == 0 and not any(plain.values()),
                f"{name}: D on a finished w or plain code ran: {plain}")
        log(f"{name}: {len(rows)} rows ({n_rows} fleet rows, T={T}), "
            f"{median_us(timings, f'figure/{name}/run'):.1f} us a run "
            f"(median of {REPEATS}; a run is the warm-up and the timed "
            f"fan-out), check(rows) passed; launches "
            f"{ {k: v for k, v in launched.items() if v} }")
        counts.append(launched)
    return counts


def gcurve_card_vs_cpu(dev):
    """Card == CPU for the g-curve modules at ``run(T=400, n_seeds=2)``:
    every column of every row but the wall clock (``_us_per_slot``)."""
    for mod in (fig23_25_geolife, beyond_knapsack_levels):
        rows = mod.run(T=400, n_seeds=2, device=dev)
        t = time.perf_counter()
        want = mod.run(T=400, n_seeds=2, device="cpu")
        wall = time.perf_counter() - t
        require(len(rows) == len(want) and all(
            set(r) == set(w) and all(r[k] == w[k] for k in w
                                     if k != "_us_per_slot")
            for r, w in zip(rows, want)),
            f"card != CPU: {mod.__name__.rsplit('.', 1)[-1]}")
        log(f"card == CPU: {mod.__name__.rsplit('.', 1)[-1]}, {len(rows)} "
            f"rows at T=400, 2 seeds ({wall:.1f} s on the CPU)")


def fanout_leg(dev, timings):
    """The figures' path at the fleet leg's width: 1,024 instances x 4
    seeds = 4,096 rows, T = 65,536 in chunks of 4,096, Bernoulli(0.35)
    arrivals and spot rents at mean 0.35, alpha-RR and RR lanes with the
    OPT frontiers.  Returns the launch counts of its first run."""
    fleet = FleetBatch.for_scenario(fleet_grid(N_M, N_ALPHA, dev), T_MAIN)
    lanes = [AlphaRR.fleet_lane(fleet), RetroRenting.fleet_lane(fleet)]
    kw = dict(scenario=bernoulli_spot(fleet.B, dev), chunk_size=CHUNK,
              n_seeds=N_SEEDS, with_opt_forward=True, collect_trace=False,
              device=dev)
    ops.reset_launches()
    out, (launched, plain) = timed_passes(
        {"run": lambda: run_fleet(lanes, fleet, **kw)}, dev, "fanout",
        timings, counted=True)
    res = out["run"]
    n = T_MAIN // CHUNK
    want = {"bernoulli_arrivals_chunk": n, "arma_rents_chunk": n,
            "normal_chunk": 1, "sim_chunk_alpha_rr": 2 * n,
            "dp_fwd_model1": 2 * n}
    got = {k: v for k, v in launched.items() if v}
    require(got == want and not any(plain.values()),
            f"fan-out leg launched {got}, expected {want}; plain {plain}")
    tot, opt = (res.policy_view(a) for a in (res.total, res.opt_cost))
    tol = 1e-3 * T_MAIN
    require(np.isfinite(tot).all() and np.isfinite(opt).all()
            and (tot >= opt - tol).all() and (opt[0] <= opt[1] + tol).all()
            and (res.level_slots.sum(1) == T_MAIN).all(),
            "fan-out leg: results not finite or out of order")
    log(f"fan-out leg: {res.B // 2} rows x 2 lanes, T={T_MAIN}: "
        f"{median_us(timings, 'fanout/run'):.1f} us a run (median of "
        f"{REPEATS}); launches P {launched['bernoulli_arrivals_chunk']} "
        f"Bernoulli + {launched['arma_rents_chunk']} ARMA + "
        f"{launched['normal_chunk']} normal, S "
        f"{launched['sim_chunk_alpha_rr']}, D {launched['dp_fwd_model1']}; "
        f"per-slot means alpha-RR / RR / alpha-OPT / OPT "
        f"{[round(float(a.mean()) / T_MAIN, 6) for a in (*tot, *opt)]}")
    return launched


def model2_fanout_leg(dev, timings):
    """Model 2 at the fleet leg's width: 1,024 instances x 4 seeds = 4,096
    rows, T = 65,536 in chunks of 4,096, Poisson arrivals at rates cycled
    over {2, 4, 8}, spot rents at mean 4.5, Model-2 service (24 requests a
    slot at most) on the fleet grid's g; alpha-RR and RR (gathering its
    endpoint columns) lanes with the OPT frontiers.  Each lane equals its
    standalone run (RR's on a service stream drawn on the endpoint grid)
    and ``opt_cost`` ``offline_opt_fleet`` on the lane's fleet, bit for
    bit; then card == CPU on the same fan-out at 16 instances x 4 seeds,
    T = 1,024.  Returns the launch counts of its first run."""
    fleet = FleetBatch.for_scenario(fleet_grid(N_M, N_ALPHA, dev), T_MAIN)
    ends = fleet.restrict_to_endpoints()
    lanes = [AlphaRR.fleet_lane(fleet, with_svc=True),
             RetroRenting.fleet_lane(fleet, with_svc=True)]
    kw = dict(chunk_size=CHUNK, n_seeds=N_SEEDS, device=dev)
    scen, scen_e = model2_scenario(fleet.grid, dev), model2_scenario(
        ends.grid, dev)
    ops.reset_launches()
    out, (launched, plain) = timed_passes(
        {"run": lambda: run_fleet(lanes, fleet, scenario=scen,
                                  with_opt_forward=True, collect_trace=False,
                                  **kw)}, dev, "model2", timings,
        counted=True)
    res = out["run"]
    n = T_MAIN // CHUNK
    want = {"poisson_chunk": n, "model2_service_chunk": n,
            "arma_rents_chunk": n, "normal_chunk": 1,
            "sim_chunk_alpha_rr_svc": 2 * n, "dp_fwd_model2": 2 * n}
    got = {k: v for k, v in launched.items() if v}
    require(got == want and not any(plain.values()),
            f"Model-2 leg launched {got}, expected {want}; plain {plain}")
    alone = [run_fleet(AlphaRR.fleet(fleet), fleet, scenario=scen,
                       collect_trace=False, **kw),
             run_fleet(RetroRenting.fleet(fleet), ends, scenario=scen_e,
                       collect_trace=False, **kw)]
    opts = [offline_opt_fleet(f, scenario=sc_, checkpointed=True,
                              collect_schedule=False, **kw)
            for f, sc_ in ((fleet, scen), (ends, scen_e))]
    view = res.policy_view
    for p in range(2):
        K = alone[p].level_slots.shape[1]
        require(np.array_equal(view(res.total)[p], alone[p].total)
                and np.array_equal(view(res.service)[p], alone[p].service)
                and np.array_equal(view(res.level_slots)[p][:, :K],
                                   alone[p].level_slots)
                and np.array_equal(view(res.opt_cost)[p], opts[p].cost),
                f"Model-2 lane {p} differs from its standalone run or "
                f"offline_opt_fleet")
    tot, opt = view(res.total), view(res.opt_cost)
    tol = 1e-3 * T_MAIN
    require(np.isfinite(tot).all() and np.isfinite(opt).all()
            and (tot >= opt - tol).all() and (opt[0] <= opt[1] + tol).all()
            and (res.level_slots.sum(1) == T_MAIN).all()
            and (res.service > 0).all(),
            "Model-2 leg: results not finite or out of order")
    log(f"Model-2 leg: {res.B // 2} rows x 2 lanes, T={T_MAIN}: "
        f"{median_us(timings, 'model2/run'):.1f} us a run (median of "
        f"{REPEATS}); launches P {launched['poisson_chunk']} Poisson + "
        f"{launched['model2_service_chunk']} service + "
        f"{launched['arma_rents_chunk']} ARMA + {launched['normal_chunk']} "
        f"normal, S {launched['sim_chunk_alpha_rr_svc']}, D "
        f"{launched['dp_fwd_model2']}; both lanes == their standalone runs, "
        f"opt_cost == offline_opt_fleet; per-slot means alpha-RR / RR / "
        f"alpha-OPT / OPT "
        f"{[round(float(a.mean()) / T_MAIN, 6) for a in (*tot, *opt)]}")
    outs = []
    for d in (dev, "cpu"):
        f = FleetBatch.for_scenario(fleet_grid(1, SMALL_INSTANCES, d), 1024)
        t = time.perf_counter()
        outs.append(run_fleet(
            [AlphaRR.fleet_lane(f), RetroRenting.fleet_lane(f, with_svc=True)],
            f, scenario=model2_scenario(f.grid, d), chunk_size=256,
            n_seeds=N_SEEDS, with_opt_forward=True, device=d))
        wall = time.perf_counter() - t
    require(fanout_results_equal(*outs), "card != CPU: the Model-2 fan-out")
    log(f"card == CPU: Model-2 fan-out, {outs[0].B} rows, T=1024 "
        f"({wall:.1f} s on the CPU)")
    return launched


def markov_fanout_leg(dev, timings):
    """Figs 17-22's path at the fleet leg's width: 1,024 instances x 4
    seeds = 4,096 rows, T = 65,536 in chunks of 4,096; the three regimes
    cycled over the instances (GE-Poisson at 200 / 10), alpha 0.16, g
    0.76, the figure's (M, c) sweep cycled, spot rents, Model-2 service
    of up to 260 requests a slot; alpha-RR and RR (its endpoint columns)
    as one fan-out, MDP and ABC each their own ``run_fleet``, as the
    figure runs them.  Each fan-out lane equals its standalone run (RR's
    on a service stream drawn on the endpoint grid); then card == CPU on
    the same runs at 16 instances x 4 seeds, T = 1,024.  Returns the
    launch counts of its first run."""
    costs, ges, cms = markov_instances(N_M * N_ALPHA)
    grid = HostingGrid.from_costs(costs, device=dev)
    fleet = FleetBatch.for_scenario(grid, T_MAIN)
    ends = fleet.restrict_to_endpoints()
    scen = markov_scenario(grid, ges, cms, dev)
    kw = dict(scenario=scen, chunk_size=CHUNK, n_seeds=N_SEEDS,
              collect_trace=False, device=dev)
    lanes = [AlphaRR.fleet_lane(fleet, with_svc=True),
             RetroRenting.fleet_lane(fleet, with_svc=True)]
    mdp = MDPPolicy.fleet(fleet, costs, ges, cms)
    abc = ABCPolicy.fleet(fleet, costs, ges, cms)

    def run():
        return (run_fleet(lanes, fleet, **kw), run_fleet(mdp, fleet, **kw),
                run_fleet(abc, fleet, **kw))

    ops.reset_launches()
    out, (launched, plain) = timed_passes({"run": run}, dev, "markov",
                                          timings, counted=True)
    fan, rm, ra = out["run"]
    n = T_MAIN // CHUNK
    want = {"ge_bernoulli_chunk": 3 * n, "slot_uniform": 3,
            "poisson_chunk": 3 * n, "poisson_chunk rejection": 3 * n,
            "model2_service_chunk": 3 * n,
            "arma_rents_chunk": 3 * n, "normal_chunk": 3,
            "sim_chunk_alpha_rr_svc": 2 * n, "sim_chunk_table_svc": 2 * n}
    got = {k: v for k, v in launched.items() if v}
    require(got == want and not any(plain.values()),
            f"Markov leg launched {got}, expected {want}; plain {plain}")
    alone = [run_fleet(AlphaRR.fleet(fleet), fleet, **kw),
             run_fleet(RetroRenting.fleet(fleet), ends, **{
                 **kw, "scenario": markov_scenario(ends.grid, ges, cms,
                                                   dev)})]
    view = fan.policy_view
    for p in range(2):
        K = alone[p].level_slots.shape[1]
        require(np.array_equal(view(fan.total)[p], alone[p].total)
                and np.array_equal(view(fan.service)[p], alone[p].service)
                and np.array_equal(view(fan.level_slots)[p][:, :K],
                                   alone[p].level_slots),
                f"Markov fan-out lane {p} differs from its standalone run")
    tot = [view(fan.total)[0], view(fan.total)[1], rm.total, ra.total]
    require(all(np.isfinite(t).all() and (t > 0).all() for t in tot)
            and all((r.level_slots.sum(1) == T_MAIN).all()
                    for r in (fan, rm, ra)),
            "Markov leg: results not finite or out of order")
    log(f"Markov leg: {fan.B // 2} rows x 2 lanes + MDP + ABC, T={T_MAIN}: "
        f"{median_us(timings, 'markov/run'):.1f} us a run (median of "
        f"{REPEATS}); launches {got}; both lanes == their standalone runs; "
        f"per-slot means alpha-RR / RR / MDP / ABC "
        f"{[round(float(t.mean()) / T_MAIN, 6) for t in tot]}")
    outs = []
    for d in (dev, "cpu"):
        c_, g_, m_ = markov_instances(SMALL_INSTANCES)
        gr = HostingGrid.from_costs(c_, device=d)
        f = FleetBatch.for_scenario(gr, 1024)
        k_ = dict(scenario=markov_scenario(gr, g_, m_, d), chunk_size=256,
                  n_seeds=N_SEEDS, device=d)
        t = time.perf_counter()
        outs.append((
            run_fleet([AlphaRR.fleet_lane(f, with_svc=True),
                       RetroRenting.fleet_lane(f, with_svc=True)], f, **k_),
            run_fleet(MDPPolicy.fleet(f, c_, g_, m_), f, **k_),
            run_fleet(ABCPolicy.fleet(f, c_, g_, m_), f, **k_)))
        wall = time.perf_counter() - t
    require(all(fanout_results_equal(a, b) for a, b in zip(*outs)),
            "card != CPU: the Markov leg")
    log(f"card == CPU: Markov leg, {outs[0][1].B} rows, T=1024, fan-out, "
        f"MDP and ABC ({wall:.1f} s on the CPU)")
    return launched


# ----------------------------------------------------------------------
# Phases 12 and 13: the LM serving path.
# ----------------------------------------------------------------------

# the obs leg: the fleet leg's instances and seeds at this horizon
T_OBS = 16384
# the reduced Model-2 obs leg: instances (x 4 seeds = 256 rows), horizon,
# chunk
M2_OBS_INSTANCES, T_M2_OBS, M2_OBS_CHUNK = 64, 2048, 1024


def same_sim(a, b):
    """The sums and the level counts of two results, bit for bit."""
    return fanout_results_equal(a, b, ("total", "rent", "service", "fetch",
                                       "level_slots"))


def obs_leg(dev, timings):
    """Obs-backed fleets at the fleet leg's width: 1,024 instances x 4
    seeds = 4,096 rows, T = 16,384 in chunks of 4,096, Bernoulli(0.35)
    arrivals and U[0.15, 0.55] rents; the seed-replicated scenario
    materialised on the card (``replicate_seeds``, ``materialize``: 0.54 GB
    of host observations) into ``FleetBatch.from_dense`` on the
    ``repeat_rows(4)`` grid.  Counted, each REPEATS times: alpha-RR and RR
    ``run_fleet``; ``offline_opt_fleet`` on four routes (cost only,
    materialised, checkpointed with the schedule, ``stream=True``).  The
    obs runs equal the scenario-fused ones bit for bit (``run_fleet(n_seeds
    =4)``, the fused cost), the three schedules are one, and their priced
    schedule is ``evaluate_schedule_fleet(scenario=)``'s.  Then
    ``offline_opt_batch`` (D on a finished w, B, E) on the first 2,048
    slots, == its CPU run on 64 rows.  Returns the launch counts of the
    counted runs' first pass."""
    B = N_M * N_ALPHA
    grid = fleet_grid(N_M, N_ALPHA, dev)
    scen = bernoulli_uniform(B, dev)
    fused = FleetBatch.for_scenario(grid, T_OBS)
    t = time.perf_counter()
    x, c, _, _ = sc.materialize(sc.replicate_seeds(scen, N_SEEDS), T_OBS,
                                CHUNK)
    obs = FleetBatch.from_dense(grid.repeat_rows(N_SEEDS), x, c)
    log(f"obs leg: {x.shape[0]} x {x.shape[1]} observations materialised "
        f"({(x.nbytes + c.nbytes) / 1e9:.2f} GB on the host) in "
        f"{time.perf_counter() - t:.1f} s")
    ends = obs.restrict_to_endpoints()
    kw = dict(chunk_size=CHUNK, device=dev)
    runs = {
        "alpha-RR": lambda: run_fleet(AlphaRR.fleet(obs), obs,
                                      collect_trace=False, **kw),
        "RR": lambda: run_fleet(RetroRenting.fleet(obs), ends,
                                collect_trace=False, **kw),
        "OPT cost": lambda: offline_opt_fleet(
            obs, checkpointed=True, collect_schedule=False, **kw),
        "OPT materialised": lambda: offline_opt_fleet(obs, **kw),
        "OPT checkpointed": lambda: offline_opt_fleet(obs, checkpointed=True,
                                                      **kw),
        "OPT stream": lambda: offline_opt_fleet(obs, checkpointed=True,
                                                stream=True, **kw)}
    ops.reset_launches()
    out, (launched, plain) = timed_passes(runs, dev, "obs", timings,
                                          counted=True)
    n = T_OBS // CHUNK
    want = {"sim_chunk_alpha_rr": 2 * n, "dp_fwd_model1": 6 * n,
            "dp_fwd_model1 args": 3 * n, "dp_backtrack": 3 * n,
            "schedule_chunk": 3 * n}
    got = {k_: v for k_, v in launched.items() if v}
    require(got == want and not any(plain.values()),
            f"obs leg launched {got}, expected {want}; plain {plain}")
    fkw = dict(scenario=scen, n_seeds=N_SEEDS, **kw)
    a_rr = run_fleet(AlphaRR.fleet(fused), fused, collect_trace=False, **fkw)
    rr = run_fleet(RetroRenting.fleet(fused), fused.restrict_to_endpoints(),
                   collect_trace=False, **fkw)
    cost = offline_opt_fleet(fused, checkpointed=True,
                             collect_schedule=False, **fkw).cost
    require(same_sim(out["alpha-RR"], a_rr) and same_sim(out["RR"], rr),
            "obs-backed alpha-RR / RR differ from the scenario-fused runs")
    opts = [out[k_] for k_ in ("OPT materialised", "OPT checkpointed",
                               "OPT stream")]
    for name in ("OPT cost", "OPT materialised", "OPT checkpointed",
                 "OPT stream"):
        require(np.array_equal(out[name].cost, cost),
                f"obs {name} differs from the scenario-fused cost")
    require(all(np.array_equal(o.r_hist, opts[0].r_hist) for o in opts)
            and all(same_sim(o.sim, opts[0].sim) for o in opts),
            "the three schedule routes differ")
    sim = evaluate_schedule_fleet(fused, opts[0].r_hist, **fkw)
    require(same_sim(opts[0].sim, sim),
            "the schedule's price differs from evaluate_schedule_fleet("
            "scenario=)")
    tol = 1e-3 * T_OBS
    require(np.isfinite(cost).all() and (a_rr.total >= cost - tol).all()
            and (opts[0].sim.total >= cost - tol).all()
            and (opts[0].r_hist.shape == (B * N_SEEDS, T_OBS)),
            "obs leg: results not finite or out of order")
    log(f"obs leg: {B * N_SEEDS} rows, T={T_OBS}: == the fused runs on "
        f"every route; us a run (median of {REPEATS}): " + ", ".join(
            f"{k_} {median_us(timings, 'obs/' + k_):.1f}" for k_ in runs)
        + f"; launches {got}")
    # offline_opt_batch: w with two roundings, D on a finished w, B, E
    Tb = 2048
    rows = grid.repeat_rows(N_SEEDS)
    ops.reset_launches()
    batch = offline_opt_batch(rows, x[:, :Tb], c[:, :Tb])
    torch.cuda.synchronize()
    batch_counts = launch_counts()
    require(batch_counts["dp_minplus"] == 1
            and batch_counts["dp_backtrack"] == 1
            and batch_counts["schedule_chunk"] == 1
            and not any(card_calls().values()),
            f"offline_opt_batch launched {batch_counts}")
    # the first 64 rows: the first 16 instances x 4 seeds
    small = offline_opt_batch(fleet_grid(1, 16, "cpu").repeat_rows(N_SEEDS),
                              x[:64, :Tb], c[:64, :Tb])
    require(np.array_equal(batch.cost[:64], small.cost)
            and np.array_equal(batch.r_hist[:64], small.r_hist)
            and all(np.array_equal(getattr(batch.sim, f)[:64],
                                   getattr(small.sim, f))
                    for f in ("total", "rent", "service", "fetch",
                              "level_slots"))
            and np.isfinite(batch.cost).all(),
            "offline_opt_batch: card != CPU")
    log(f"offline_opt_batch: {batch.cost.shape[0]} rows x {Tb} slots on "
        f"D (a finished w), B and E; == the CPU on 64 rows")
    for k_ in launched:
        launched[k_] += batch_counts[k_]
    return launched


def model2_obs_leg(dev):
    """The Model-2 leg's scenario (Poisson rates {2, 4, 8}, spot rents,
    Model-2 service) on 64 instances x 4 seeds = 256 rows, T = 2,048 in
    chunks of 1,024, materialised into an obs-backed fleet with ``svc``:
    alpha-RR, RR on ``restrict_to_endpoints()`` (the slab's endpoint
    columns gathered on the host) and OPT (materialised, with the schedule)
    equal the scenario-fused runs bit for bit (RR's on a service stream
    drawn on the endpoint grid, the fused cost).  Returns the launch
    counts of the obs runs."""
    grid = fleet_grid(2, M2_OBS_INSTANCES // 2, dev)
    fused = FleetBatch.for_scenario(grid, T_M2_OBS)
    ends = fused.restrict_to_endpoints()
    scen, scen_e = model2_scenario(grid, dev), model2_scenario(ends.grid, dev)
    x, c, svc, _ = sc.materialize(sc.replicate_seeds(scen, N_SEEDS),
                                  T_M2_OBS, M2_OBS_CHUNK)
    obs = FleetBatch.from_dense(grid.repeat_rows(N_SEEDS), x, c, svc=svc)
    kw = dict(chunk_size=M2_OBS_CHUNK, device=dev)
    ops.reset_launches()
    got = [run_fleet(AlphaRR.fleet(obs), obs, **kw),
           run_fleet(RetroRenting.fleet(obs), obs.restrict_to_endpoints(),
                     **kw),
           offline_opt_fleet(obs, **kw)]
    torch.cuda.synchronize()
    launched, plain = launch_counts(), card_calls()
    require(not any(plain.values()) and launched["dp_fwd_model2 args"] > 0
            and launched["sim_chunk_alpha_rr_svc"] > 0,
            f"Model-2 obs leg launched {launched}; plain {plain}")
    want = [run_fleet(AlphaRR.fleet(fused), fused, scenario=scen,
                      n_seeds=N_SEEDS, **kw),
            run_fleet(RetroRenting.fleet(fused), ends, scenario=scen_e,
                      n_seeds=N_SEEDS, **kw),
            offline_opt_fleet(fused, scenario=scen, n_seeds=N_SEEDS,
                              checkpointed=True, collect_schedule=False,
                              **kw)]
    require(same_sim(got[0], want[0]) and same_sim(got[1], want[1])
            and np.array_equal(got[0].r_hist, want[0].r_hist)
            and np.array_equal(got[1].r_hist, want[1].r_hist)
            and np.array_equal(got[2].cost, want[2].cost),
            "Model-2 obs leg differs from the scenario-fused runs")
    log(f"Model-2 obs leg: {obs.B} rows, T={T_M2_OBS}: alpha-RR, RR on the "
        f"endpoint columns and OPT == the fused runs")
    return launched


def theorems_card_vs_cpu(dev, timings):
    """``figures.theorems.run()`` on the card (REPEATS times, counted over
    the first) == on the CPU, row for row, and its ``check`` passes.
    Returns the launch counts of the card's first run."""
    ops.reset_launches()
    out, (launched, plain) = timed_passes(
        {"run": lambda: theorems.run(device=dev)}, dev, "theorems", timings,
        counted=True)
    rows = out["run"]
    t = time.perf_counter()
    want = theorems.run(device="cpu")
    wall = time.perf_counter() - t
    require(rows == want, f"card != CPU: theorems ({rows} vs {want})")
    try:
        theorems.check(rows)
    except AssertionError as e:
        raise RuntimeError(f"theorems: check(rows) failed: {e}") from e
    require(not any(plain.values()) and launched["dp_backtrack"] > 0
            and launched["schedule_chunk"] > 0,
            f"theorems launched {launched}; plain {plain}")
    d = {r["check"]: r["value"] for r in rows}
    log(f"theorems: card == CPU ({wall:.1f} s on the CPU), check passed, "
        f"{median_us(timings, 'theorems/run'):.1f} us a run; "
        f"{json.dumps(d)}")
    return launched


def composed_runs(grid, scen, T, chunk, dev):
    """The composed leg's runs on ``grid``: the alpha-RR / RR fan-out and
    the OPT with the backtracked schedule, 4 antithetic seed replicas."""
    fleet = FleetBatch.for_scenario(grid, T)
    lanes = [AlphaRR.fleet_lane(fleet), RetroRenting.fleet_lane(fleet)]
    kw = dict(scenario=scen, chunk_size=chunk, n_seeds=N_SEEDS,
              antithetic=True, device=dev)
    return {"fan-out": lambda: run_fleet(lanes, fleet, collect_trace=False,
                                         **kw),
            "OPT": lambda: offline_opt_fleet(fleet, **kw)}


def composed_leg(dev, timings):
    """A composed scenario at the fleet leg's width: 1,024 instances (the
    K = 3 grid) x 4 antithetic seed replicas = 4,096 rows, T = 16,384 in
    chunks of 4,096; arrivals ``mixture_from_weights`` of Bernoulli,
    Poisson and GE-Bernoulli, rents a ``regime_switch`` from uniform to
    ARMA(2, 1) rents at slot 6,000 (``composed_scenario``).  Counted from
    the scenario's construction (the mixture's choice: one shaped-uniform
    launch) through the first pass of the alpha-RR / RR fan-out and the
    OPT with the backtracked schedule, each run REPEATS times.  Then: the
    seed-replicated scenario materialised and replayed through
    ``trace_scenario`` gives the fan-out's bits; ``with_prng_backend(
    "pallas")`` draws the slot uniforms (Bernoulli rows' arrivals, the
    uniform regime's rents) as the original layout does and the rest (the
    Poisson rows, the ARMA regime) as the default one; card == CPU on 3
    instances (one of each component) x 4 seeds, T = 6,144 in chunks of
    2,048.  Returns the launch counts of the counted pass."""
    B, T = COMPOSED_B, COMPOSED_T
    grid = fleet_grid(N_M, N_ALPHA, dev)
    ops.reset_launches()
    scen = composed_scenario(B, dev)
    out, (launched, plain) = timed_passes(
        composed_runs(grid, scen, T, CHUNK, dev), dev, "composed", timings,
        counted=True)
    n = T // CHUNK
    # the fan-out, OPT's forward pass and its schedule's pricing each draw
    # the scenario: every stream once a chunk, the GE chain's initial draw
    # and the ARMA's initial innovation once a run
    want = {"shaped_uniform": 1, "slot_uniform": 3, "normal_chunk": 3,
            "bernoulli_arrivals_chunk": 3 * n, "poisson_chunk": 3 * n,
            "ge_bernoulli_chunk": 3 * n, "uniform_rents_chunk": 3 * n,
            "arma_rents_chunk": 3 * n, "arma_rents_chunk ma1": 3 * n,
            "sim_chunk_alpha_rr": 2 * n, "dp_fwd_model1": n,
            "dp_fwd_model1 args": n, "dp_backtrack": n, "schedule_chunk": n}
    got = {k: v for k, v in launched.items() if v}
    require(got == want and not any(plain.values()),
            f"composed leg launched {got}, expected {want}; plain {plain}")
    fan, opt = out["fan-out"], out["OPT"]
    comp = scen.params["arr"]["component"].cpu().numpy()
    tot = fan.policy_view(fan.total)
    tol = 1e-3 * T
    require(np.isfinite(tot).all() and np.isfinite(opt.cost).all()
            and (tot >= opt.cost - tol).all()
            and (fan.level_slots.sum(1) == T).all()
            and np.array_equal(opt.sim.total.shape, opt.cost.shape)
            and (np.abs(opt.sim.total - opt.cost) <= tol).all(),
            "composed leg: results not finite or out of order")
    log(f"composed leg: {fan.B // 2} rows x 2 lanes and OPT with the "
        f"schedule, T={T}, components {np.bincount(comp, minlength=3)}: "
        f"fan-out {median_us(timings, 'composed/fan-out'):.1f} us, OPT "
        f"{median_us(timings, 'composed/OPT'):.1f} us a run (median of "
        f"{REPEATS}); launches {got}; per-slot means alpha-RR / RR / OPT "
        f"{[round(float(a.mean()) / T, 6) for a in (*tot, opt.cost)]}")

    # the observations materialised and replayed through trace_scenario
    rep = sc.replicate_seeds(scen, N_SEEDS, antithetic=True)
    x, c, _, side = sc.materialize(rep, T, CHUNK)
    trace = sc.trace_scenario(x, c, side=side, device=dev)
    rfleet = FleetBatch.for_scenario(grid.repeat_rows(N_SEEDS), T)
    replay = run_fleet([AlphaRR.fleet_lane(rfleet),
                        RetroRenting.fleet_lane(rfleet)], rfleet,
                       scenario=trace, chunk_size=CHUNK, collect_trace=False,
                       device=dev)
    for f in ("total", "rent", "service", "fetch", "level_slots"):
        require(np.array_equal(getattr(fan, f), getattr(replay, f)),
                f"composed leg: the trace replay's {f} differs")
    log(f"composed leg: its {x.shape[0]} x {x.shape[1]} observations "
        f"replayed through trace_scenario == the fused fan-out, bit for bit")

    # the PRNG backend switch: "pallas" draws the slot uniforms in the
    # original layout and the rest in the active one
    pal = sc.materialize(sc.with_prng_backend(rep, "pallas"), T, CHUNK)
    with H.threefry_partitionable(False):
        orig = sc.materialize(rep, T, CHUNK)
    rows = np.repeat(comp, N_SEEDS)
    sw = COMPOSED_SWITCH
    for label, a, b in (
            ("Bernoulli rows' arrivals == original layout",
             pal[0][rows == 0], orig[0][rows == 0]),
            ("Poisson rows' arrivals == default layout",
             pal[0][rows == 1], x[rows == 1]),
            ("uniform regime's rents == original layout",
             pal[1][:, :sw], orig[1][:, :sw]),
            ("ARMA regime's rents == default layout",
             pal[1][:, sw:], c[:, sw:])):
        require(np.array_equal(a, b), f"composed leg, prng_backend: {label}")
    require(not np.array_equal(pal[1][:, :sw], c[:, :sw]),
            "composed leg: the pallas backend drew the default layout")
    log("composed leg: with_prng_backend(\"pallas\") draws the slot "
        "uniforms as the original layout, the Poisson and ARMA draws as "
        "the default one")

    # card == CPU on a row subset: the first instance of each component
    idx = torch.as_tensor([int(np.flatnonzero(comp == i)[0])
                           for i in range(3)])
    res = []
    for d in (dev, "cpu"):
        sub = scen._replace(params=sc.base.tree_map(
            lambda a: a[idx.to(a.device)].to(d), scen.params))
        t0 = time.perf_counter()
        res.append({k: f() for k, f in composed_runs(
            fleet_instances(idx.tolist(), d), sub, COMPOSED_SUB_T,
            COMPOSED_SUB_CHUNK, d).items()})
        if d == "cpu":
            log(f"composed leg on the CPU: {len(idx) * N_SEEDS} rows, "
                f"T={COMPOSED_SUB_T}: {time.perf_counter() - t0:.1f} s")
    a, b = res
    for f in ("total", "rent", "service", "fetch", "level_slots"):
        require(np.array_equal(getattr(a["fan-out"], f),
                               getattr(b["fan-out"], f)),
                f"composed leg: card != CPU, fan-out {f}")
        require(np.array_equal(getattr(a["OPT"].sim, f),
                               getattr(b["OPT"].sim, f)),
                f"composed leg: card != CPU, the schedule's {f}")
    require(np.array_equal(a["OPT"].cost, b["OPT"].cost)
            and np.array_equal(a["OPT"].r_hist, b["OPT"].r_hist),
            "composed leg: card != CPU, OPT")
    log(f"composed leg: card == CPU on {len(idx) * N_SEEDS} rows, "
        f"T={COMPOSED_SUB_T}")
    return launched


# ----------------------------------------------------------------------
# Phase 14: the service axis (core/services.py): N services sharing one
# edge's storage; kernel G, E's matrix route, D on joint grids.
# ----------------------------------------------------------------------

# benchmarks/kernel_bench.py:multi_service's sets and scenario at the width
# users run: instance i's N services three_level(4 + i + n, 0.3, 0.4) at
# capacity 1.0 (J = 6 at N = 2, 19 at N = 4); GE-Poisson arrivals (0.3,
# 0.2, 2.0, 0.2), spot rents at mean 0.5, Model-2 service of up to 6
# requests a slot
SVC_B, SVC_N, SVC_T = 2048, 2, 16384
SVC_WIDE_B, SVC_WIDE_N, SVC_WIDE_T, SVC_WIDE_CHUNK = 1024, 4, 4096, 2048
SVC_MAX = 6
# card == CPU: each leg's first instances, at this horizon and chunk
SVC_SUB_B, SVC_SUB_T, SVC_SUB_CHUNK = 2, 1024, 512
# G's cases past the legs' own slabs: (instances, N, chunk, sub-slab
# levels, J, side channel): one slot, J = 16 and 17 (the fused D's edge),
# 19, 27, 32 (D on a finished w's), ragged rows and chunks
G_CASES = ((1, 1, 1, 2, 1, True), (255, 2, 1001, 4, 16, False),
           (253, 2, 999, 5, 17, True), (1021, 4, 2047, 3, 19, True),
           (31, 3, 333, 3, 27, False), (33, 4, 97, 3, 32, True),
           (7, 1, 4097, 32, 32, True))


def service_sets(B, N):
    """kernel_bench.multi_service's sets: B instances of N three-level
    services at capacity 1.0."""
    return [ServiceSet(tuple(HostingCosts.three_level(4.0 + i + n, 0.3, 0.4)
                             for n in range(N)), capacity=1.0)
            for i in range(B)]


def joint_sets(J):
    """A one-instance set with J joint states: two four-level services
    (16), two five-level ones at capacity 1 (17), four three-level ones at
    capacity 1.5 (32), or ``service_sets``' (6 and 19)."""
    k4 = dict(levels=(0.0, 0.2, 0.45, 1.0), g=(1.0, 0.61, 0.33, 0.0))
    k5 = dict(levels=(0.0, 0.1, 0.3, 0.55, 1.0), g=(1.0, 0.8, 0.5, 0.21, 0.0))
    ss = {6: lambda: service_sets(1, 2)[0],
          16: lambda: ServiceSet((HostingCosts(M=5.0, **k4),
                                  HostingCosts(M=6.0, **k4))),
          17: lambda: ServiceSet((HostingCosts(M=5.0, **k5),
                                  HostingCosts(M=7.0, **k5)), capacity=1.0),
          19: lambda: service_sets(1, 4)[0],
          32: lambda: ServiceSet(service_sets(1, 4)[0].services,
                                 capacity=1.5)}[J]()
    require(ss.J == J, f"the set of {J} joint states has {ss.J}")
    return ss


def service_scenario_of(sf, device, seed=40):
    """The [B]-row scenario of a ``ServiceFleet``: the drivers tile it over
    the services (``tile_services``: each service's arrival and service
    keys salted, the rent shared)."""
    B = sf.B
    g = sf.lane_grid(device).g[::sf.N].contiguous()
    return sc.combine(
        sc.ge_arrivals(sc.split_keys(sc.prng_key(seed, device), B), 0.3,
                       0.2, 2.0, 0.2, B, device=device),
        sc.spot_rents(sc.prng_key(seed + 1, device), 0.5, B, device=device),
        svc=sc.model2_service(sc.prng_key(seed + 2, device), g, B, SVC_MAX,
                              device=device))


def joint_case(dev, B, N, chunk, K, J, model2, side, seed):
    """G's inputs: x (0 .. 9), rents, a side channel (-1 .. 2) or None,
    idx levels in [0, K); a Model-2 sub-slab on a half-integer grid, or
    Model 1's g_lane."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    BN = B * N
    x = t(rng.integers(0, 10, (BN, chunk)).astype(np.int32))
    c = t(rng.random((BN, chunk)).astype(np.float32))
    sd = (t(rng.integers(-1, 3, (BN, chunk)).astype(np.int32)) if side
          else None)
    idx = t(rng.integers(0, K, (B, N, J)).astype(np.int32))
    if model2:
        return (x, c, sd, t((rng.integers(0, 13, (BN, chunk, K)) / 2)
                            .astype(np.float32)), None, idx)
    return x, c, sd, None, t(rng.random((B, N, J)).astype(np.float32)), idx


def joint_dp_case(dev, J, R, chunk, t0, seed):
    """D's chunk on R rows of the joint grid of J states: rents and a
    joint slab on a half-integer grid (ties between the states that share
    a total level), horizons inside the chunk, every other row's frontier
    +inf past state 0."""
    grid = joint_hosting_grid([joint_sets(J)] * R, device=dev)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    c = t((rng.integers(0, 5, (R, chunk)) / 2).astype(np.float32))
    svc = t((rng.integers(0, 9, (R, chunk, J)) / 2).astype(np.float32))
    T_len = t(rng.integers(t0 - 3, t0 + chunk + 3, R).astype(np.int32))
    J0 = torch.zeros((R, J), dtype=torch.float32, device=dev)
    J0[1::2, 1:] = float("inf")
    return (J0, c, svc, grid.levels, grid.mask, grid.M, T_len, t0)


def d_joint_check(args, label):
    """D on a joint slab == its plain version, with and without the argmin
    table."""
    for with_args in (False, True):
        kd = H.dp_fwd_model2(*args, with_args=with_args)
        torch.cuda.synchronize()
        pd = H.dp_fwd_model2_plain(*args, with_args=with_args)
        require(tree_equal(kd, pd), f"D on a joint grid differs from its "
                                    f"plain version ({label}, args "
                                    f"{with_args})")


def service_kernel_checks(dev):
    """Kernel G, D on joint grids and E's matrix route against their plain
    versions, bit for bit.  G (``joint_slab``) on the service leg's own
    tiled slab (2,048 instances x 2 services, 4,096 slots, J = 6) under
    Model 2 and Model 1, on the wide leg's (1,024 x 4 services, J = 19),
    and on ``G_CASES`` under both; G's w route (``slab_w``) on the wide
    leg's joint slab and at 17 to 32 levels with and without a column map.
    D on the leg's joint slab (the fused D, J = 6, with and without the
    argmin table: joint fetch matrices are not monotone in the level and
    tie), on half-integer slabs at J = 1 .. 32 (the fused D to 16, G's w
    and D on a finished w from 17); J = 33 raises ``ValueError`` on the
    card.  E's matrix route on the joint schedule D and B give for the
    leg's chunk (bulk and 4-byte routes), at its tile and ring edges, under
    Model 1, at J = 16, 17 and 32 with levels out of range, each with the
    rent's product fused and not.  Returns the records of G, G's w route,
    the fused D on the joint slab, the wide route and E's matrix route,
    each timed at its leg's shape."""
    rec = {}
    lib = _build.library("hosting")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa

    # G on random cases
    for case in G_CASES:
        for model2 in (True, False):
            a = joint_case(dev, *case[:5], model2, case[5], sum(case[:5]))
            kg = H.joint_slab(*a)
            torch.cuda.synchronize()
            require(tree_equal(kg, H.joint_slab_plain(*a)),
                    f"G differs from its plain version ({case}, Model "
                    f"{2 if model2 else 1})")
    log(f"G ok: {len(G_CASES)} cases (J = 1 .. 32, ragged), Model 1 and 2")

    # G on the service leg's own slab
    sf = SV.service_fleet(service_sets(SVC_B, SVC_N), SVC_T)
    scen = service_scenario_of(sf, dev)
    tiled, jsc = SV.service_scenario(sf, scen), SV.joint_scenario(sf, scen)
    t0 = SVC_T - CHUNK
    _, slab = tiled.chunk_fn(tiled.params, tiled.init_fn(tiled.params),
                             sc.base.chunk_tids(t0, CHUNK, dev))
    idx, g_lane = jsc.params["idx"], jsc.params["g_lane"]
    g2 = (slab.x, slab.c, slab.side, slab.svc, None, idx)
    g1 = (slab.x, slab.c, slab.side, None, g_lane, idx)
    for label, a in (("Model 2", g2), ("Model 1", g1)):
        kg = H.joint_slab(*a)
        torch.cuda.synchronize()
        require(tree_equal(kg, H.joint_slab_plain(*a)),
                f"G differs from its plain version (the service leg's slab, "
                f"{label})")
    ms = cuda_ms(lambda: H.joint_slab(*g2), reps=10, batch=10)
    m1_ms = cuda_ms(lambda: H.joint_slab(*g1), reps=10, batch=10)
    plain_ms, _ = timed_once(lambda: H.joint_slab_plain(*g2))
    x_j, c_j, side_j, svc_j = H.joint_slab(*g2)
    B, N, J = idx.shape
    rec["joint_slab"] = dict(
        replaces="src/repro/core/services.py:251-270 (no TPU kernel: the "
                 "XLA reduction of _joint_fns' chunk_fn)",
        ms=ms, plain_ms=plain_ms, model1_ms=m1_ms, max_abs_err=0.0,
        ops=B * CHUNK * (N * J + N), nbytes=nbytes(*g2[:4], idx, x_j, c_j,
                                                   side_j, svc_j),
        shape=f"B={B} N={N} chunk={CHUNK} sub-slab K={slab.svc.shape[2]} "
              f"J={J}: the service leg's tiled slab, Model 2 (model1_ms: "
              f"Model 1's g_lane)")
    log(f"G timed: {ms:.4f} ms (Model 1 {m1_ms:.4f}), byte bound "
        f"{rec['joint_slab']['nbytes'] / PEAK_BYTES * 1e3:.4f} ms; plain "
        f"{plain_ms:.1f} ms")

    # the fused D on the leg's joint slab, B on its table, E's matrix route
    jg = sf.joint_grid(dev)
    T_len = torch.full((B,), SVC_T, dtype=torch.int32, device=dev)
    T_len[::7] = t0 + 1000                      # horizons inside the chunk
    dargs = (dp_frontier0(B, J, dev), c_j, svc_j, jg.levels, jg.mask, jg.M,
             T_len, t0)
    d_joint_check(dargs, f"the service leg's slab, J = {J}")
    ms = cuda_ms(lambda: H.dp_fwd_model2(*dargs), reps=10, batch=10)
    args_ms = cuda_ms(lambda: H.dp_fwd_model2(*dargs, with_args=True),
                      reps=10, batch=10)
    plain_ms, _ = timed_once(lambda: H.dp_fwd_model2_plain(*dargs))
    Jk, targs = H.dp_fwd_model2(*dargs, with_args=True)
    rec["dp_fwd_model2 joint"] = dict(
        replaces="src/repro/kernels/hosting.py:116 (pallas_call :138): "
                 "dp_minplus_kc with an explicit joint fetch matrix",
        ms=ms, args_ms=args_ms, plain_ms=plain_ms, max_abs_err=0.0,
        ops=minplus_ops(B, CHUNK, J) + 2 * B * CHUNK * J,
        nbytes=nbytes(*dargs[:7], Jk),
        shape=f"R={B} chunk={CHUNK} J={J}: the service leg's joint slab "
              f"and fetch matrices (args_ms: the argmin table written)")
    log(f"D on the joint slab timed: {ms:.4f} ms, with the argmin table "
        f"{args_ms:.4f}; byte bound "
        f"{rec['dp_fwd_model2 joint']['nbytes'] / PEAK_BYTES * 1e3:.4f} ms; "
        f"plain {plain_ms:.1f} ms")
    for JJ, R, n in ((1, 5, 3), (6, 1021, 1001), (16, 1021, 1001),
                     (17, 253, 999), (19, 1024, 4096), (32, 33, 97)):
        if JJ == 1:
            a = joint_dp_case(dev, 16, R, n, 4096, JJ + R)
            a = (a[0][:, :1].contiguous(), a[1], a[2][:, :, :1].contiguous(),
                 a[3][:, :1].contiguous(), a[4][:, :1].contiguous(),
                 a[5][:, :1, :1].contiguous(), *a[6:])
        else:
            a = joint_dp_case(dev, JJ, R, n, 4096, JJ + R)
        d_joint_check(a, f"J = {JJ}, {R} x {n}, half-integer ties")
    log("D ok on joint grids: the fused D at J = 1, 6 and 16, G's w and D "
        "on a finished w at 17, 19 and 32, with and without the argmin "
        "table")
    big = joint_hosting_grid([joint_sets(19)], J=33, device=dev)
    for fn in (lambda: H.dp_fwd_model2(
            torch.zeros((1, 33), device=dev), c_j[:1].contiguous(),
            torch.zeros((1, CHUNK, 33), device=dev), big.levels, big.mask,
            big.M, T_len[:1].contiguous(), t0),
            lambda: H.joint_slab(slab.x[:4].contiguous(),
                                 slab.c[:4].contiguous(), None,
                                 slab.svc[:4].contiguous(), None,
                                 torch.zeros((1, 4, 33), dtype=torch.int32,
                                             device=dev))):
        try:
            fn()
        except ValueError:
            continue
        raise RuntimeError("33 joint states did not raise ValueError")
    log("J = 33: D and G raise ValueError on the card")

    k = torch.argmin(Jk, dim=1).to(torch.int32)
    _, r = H.dp_backtrack(k, targs)
    rng = np.random.default_rng(28)
    carry = (t(rng.integers(0, J, B).astype(np.int32)),
             {"sums": t((rng.random((B, 3)) * 100).astype(np.float32)),
              "counts": t(rng.integers(0, 50, (B, J)).astype(np.int32))})
    et = lib.be_tile_slots(2 + J, CHUNK, J)
    ering = lib.be_ring_stages() * et
    r_odd = t(rng.integers(-1, J + 1, (B, 1001)).astype(np.int32))

    def e_case(rows, n, rr, tt0=t0, model1=False):
        a_ = (jg.levels[:rows].contiguous(), jg.M[:rows].contiguous(),
              T_len[:rows].contiguous(), tt0,
              (carry[0][:rows].contiguous(),
               {k_: v[:rows].contiguous() for k_, v in carry[1].items()}),
              rr[:rows, :n].contiguous(), c_j[:rows, :n].contiguous())
        if model1:
            return a_, dict(x=x_j[:rows, :n].contiguous(),
                            g=jg.g[:rows].contiguous())
        return a_, dict(svc=svc_j[:rows, :n].contiguous())

    def e_wide(JJ, R, n, seed):
        a = joint_dp_case(dev, JJ, R, n, 4096, seed)
        rg = np.random.default_rng(seed)
        cr = (t(rg.integers(0, JJ, R).astype(np.int32)),
              {"sums": t((rg.random((R, 3)) * 100).astype(np.float32)),
               "counts": t(rg.integers(0, 9, (R, JJ)).astype(np.int32))})
        return ((a[3], a[5], a[6], 4096, cr, t(rg.integers(
            -1, JJ + 1, (R, n)).astype(np.int32)), a[1]), dict(svc=a[2]))

    leg = ((jg.levels, jg.M, T_len, t0, carry, r, c_j), dict(svc=svc_j))
    ecases = [
        ("the service leg's joint schedule",) + leg,
        ("the same, 4-byte route", leg[0][:5] + (H.misaligned(r), c_j),
         leg[1]),
        ("R - 3 rows, 1,001 slots, odd t0, levels out of range",
         *e_case(B - 3, 1001, r_odd, t0 + 1)),
        (f"a tile - 1 ({et - 1} slots)", *e_case(B - 3, et - 1, r)),
        (f"a tile + 1 ({et + 1})", *e_case(B - 3, et + 1, r)),
        (f"the ring - 1 ({ering - 1}), 300 rows",
         *e_case(300, ering - 1, r)),
        (f"the ring + 1 ({ering + 1}), 300 rows",
         *e_case(300, ering + 1, r)),
        (f"33 rows, the ring + 4 ({ering + 4}): bulk",
         *e_case(33, ering + 4, r)),
        ("Model 1, 1,001 slots", *e_case(B, 1001, r_odd, model1=True)),
        ("J = 16, 1,021 rows x 1,001", *e_wide(16, 1021, 1001, 16)),
        ("J = 17, 253 rows x 999", *e_wide(17, 253, 999, 17)),
        ("J = 32, 300 rows x 777", *e_wide(32, 300, 777, 32))]
    for name, a, kw in ecases:
        for fma in (False, True):
            before = H.schedule_chunk.matrix_launches
            ke = H.schedule_chunk(*a, **kw, acc_fma=fma)
            torch.cuda.synchronize()
            require(H.schedule_chunk.matrix_launches == before + 1,
                    f"E's matrix route did not launch ({name})")
            require(tree_equal(ke, H.schedule_chunk_plain(*a, **kw,
                                                          acc_fma=fma)),
                    f"E's matrix route differs from its plain version "
                    f"({name}, the rent fused {fma})")
        log(f"E's matrix route ok: {name}, the rent fused and not")
    a, kw = ecases[0][1], ecases[0][2]
    ms = cuda_ms(lambda: H.schedule_chunk(*a, **kw), reps=10, batch=10)
    a_n, kw_n = ecases[1][1], ecases[1][2]
    narrow_ms = cuda_ms(lambda: H.schedule_chunk(*a_n, **kw_n), reps=10,
                        batch=10)
    plain_ms, _ = timed_once(lambda: H.schedule_chunk_plain(*a, **kw))
    out = H.schedule_chunk(*a, **kw)
    rec["schedule_chunk matrix"] = dict(
        replaces="src/repro/core/simulator.py:390 (no TPU kernel: the "
                 "lax.scan of schedule_chunk_core, _fetch_between on a "
                 "matrix M, :131)",
        ms=ms, narrow_ms=narrow_ms, plain_ms=plain_ms, max_abs_err=0.0,
        ops=B * CHUNK * 8,
        nbytes=nbytes(jg.levels, jg.M, T_len, carry[0], *carry[1].values(),
                      r, c_j, svc_j, out[0], *out[1].values()),
        shape=f"R={B} chunk={CHUNK} J={J}: the joint OPT's schedule priced "
              f"on its joint slab (bulk route; narrow_ms: the 4-byte "
              f"route)")
    log(f"E's matrix route timed: {ms:.4f} ms, the 4-byte route "
        f"{narrow_ms:.4f}; byte bound "
        f"{rec['schedule_chunk matrix']['nbytes'] / PEAK_BYTES * 1e3:.4f} "
        f"ms; plain {plain_ms:.1f} ms")

    # the wide leg's joint slab: G (N = 4, J = 19), its w route, the wide D
    wsf = SV.service_fleet(service_sets(SVC_WIDE_B, SVC_WIDE_N), SVC_WIDE_T)
    wscen = service_scenario_of(wsf, dev, seed=50)
    wjs, wtiled = (SV.joint_scenario(wsf, wscen),
                   SV.service_scenario(wsf, wscen))
    wt0 = SVC_WIDE_T - SVC_WIDE_CHUNK
    _, wsub = wtiled.chunk_fn(wtiled.params, wtiled.init_fn(wtiled.params),
                              sc.base.chunk_tids(wt0, SVC_WIDE_CHUNK, dev))
    for model2 in (True, False):
        a = (wsub.x, wsub.c, wsub.side, wsub.svc if model2 else None,
             None if model2 else wjs.params["g_lane"], wjs.params["idx"])
        kg = H.joint_slab(*a)
        torch.cuda.synchronize()
        require(tree_equal(kg, H.joint_slab_plain(*a)),
                f"G differs from its plain version (the wide leg's slab, "
                f"Model {2 if model2 else 1})")
    wx, wc, _, wsvc = H.joint_slab(wsub.x, wsub.c, wsub.side, wsub.svc, None,
                                   wjs.params["idx"])
    wg = wsf.joint_grid(dev)
    WB, WJ = wg.B, wg.K
    wT = torch.full((WB,), SVC_WIDE_T, dtype=torch.int32, device=dev)
    wT[::7] = wt0 + 1000
    wargs = (dp_frontier0(WB, WJ, dev), wc, wsvc, wg.levels, wg.mask, wg.M,
             wT, wt0)
    d_joint_check(wargs, f"the wide leg's slab, J = {WJ}")
    sw = (wc, wsvc, wg.levels, wg.mask)
    ok = tree_equal(H.slab_w(*sw), H.slab_w_plain(*sw))
    for R, n, K, Kf, cols in ((300, 333, 32, 32, False),
                              (257, 97, 17, 31, True), (1, 1, 32, 32, False)):
        rg = np.random.default_rng(R + K)
        a = (t(rg.random((R, n)).astype(np.float32)),
             t((rg.integers(0, 13, (R, n, Kf)) / 2).astype(np.float32)),
             t(np.sort(rg.random((R, K)), axis=1).astype(np.float32)),
             t(rg.random((R, K)) < 0.9),
             t(np.sort(rg.integers(0, Kf, (R, K)), axis=1)
               .astype(np.int32)) if cols else None)
        ok = ok and tree_equal(H.slab_w(*a), H.slab_w_plain(*a))
    torch.cuda.synchronize()
    require(ok, "G's w route differs from its plain version")
    log("G's w route ok: the wide leg's slab, 17 to 32 levels, a column map")
    ms = cuda_ms(lambda: H.slab_w(*sw), reps=10, batch=10)
    plain_ms, _ = timed_once(lambda: H.slab_w_plain(*sw))
    w = H.slab_w(*sw)
    rec["joint_slab w"] = dict(
        replaces="src/repro/core/policies/offline_opt.py:138 (no TPU "
                 "kernel: the w assembly before dp_minplus_kc, on a slab "
                 "of more than 16 states)",
        ms=ms, plain_ms=plain_ms, max_abs_err=0.0, ops=2 * WB *
        SVC_WIDE_CHUNK * WJ, nbytes=nbytes(*sw, w),
        shape=f"R={WB} chunk={SVC_WIDE_CHUNK} K={WJ}: the wide leg's joint "
              f"slab")
    # the wide route's D: D on G's finished w, the wide leg's valid slots
    tids = torch.arange(wt0, wt0 + SVC_WIDE_CHUNK, dtype=torch.int32,
                        device=dev)
    dm = (wargs[0], w, wg.M, tids[None, :] < wT[:, None])
    k, p = H.dp_minplus(*dm), H.dp_minplus_plain(*dm)
    torch.cuda.synchronize()
    require(tree_equal(k, p), "D on the wide leg's finished w differs from "
                              "its plain version")
    ms = cuda_ms(lambda: H.dp_minplus(*dm), reps=10, batch=10)
    plain_ms, _ = timed_once(lambda: H.dp_minplus_plain(*dm))
    rec["dp_minplus joint"] = dict(
        replaces="src/repro/kernels/hosting.py:116 (pallas_call :138): "
                 "dp_minplus_kc at 17 to 32 joint states",
        ms=ms, plain_ms=plain_ms, max_abs_err=0.0,
        ops=minplus_ops(WB, SVC_WIDE_CHUNK, WJ), nbytes=nbytes(*dm, *k),
        shape=f"R={WB} chunk={SVC_WIDE_CHUNK} K={WJ}: the wide leg's joint "
              f"fetch matrices on G's finished w (the argmin table written)")
    for name in ("joint_slab w", "dp_minplus joint"):
        e = rec[name]
        log(f"{name} timed: {e['ms']:.4f} ms, byte bound "
            f"{e['nbytes'] / PEAK_BYTES * 1e3:.4f} ms; plain "
            f"{e['plain_ms']:.1f} ms")
    return rec


def service_runs(sf, scen, T, chunk, dev, wide=False):
    """The service axis' runs: the joint OPT materialised with its
    schedule and (not ``wide``) checkpointed cost only, alpha-RR on every
    service's lane (its schedules kept) and the per-service OPT with its
    schedule."""
    kw = dict(scenario=scen, chunk_size=chunk, device=dev)
    runs = {"joint OPT": lambda: SV.offline_opt_services(sf, **kw)}
    if wide:
        return runs
    pol = SV.alpha_rr_per_service(sf, dev)
    runs.update({
        "joint OPT checkpointed": lambda: SV.offline_opt_services(
            sf, checkpointed=True, collect_schedule=False, **kw),
        "alpha-RR lanes": lambda: SV.run_fleet_services(pol, sf, **kw),
        "OPT lanes": lambda: SV.offline_opt_per_service(sf, **kw)})
    return runs


def check_service_runs(out, sf, T, label):
    """Finite results of the expected shape, the joint OPT's schedules
    within the capacity and priced at its cost, checkpointed == its cost,
    the per-service OPT below alpha-RR and its sum over the services below
    the joint OPT.  Returns the share of alpha-RR's slots over the
    capacity."""
    tol = 1e-3 * T
    jo = out["joint OPT"]
    sched = jo.service_schedules()
    require(jo.cost.shape == (sf.B,) and np.isfinite(jo.cost).all()
            and sched.shape == (sf.B, sf.N, T)
            and (np.abs(jo.joint.sim.total - jo.cost) <= tol).all(),
            f"{label}: the joint OPT not finite / wrong shape / mispriced")
    require(not SV.capacity_overflow(sf, sched).any(),
            f"{label}: the joint OPT's schedules exceed the capacity")
    if "alpha-RR lanes" not in out:
        return None
    require(np.array_equal(out["joint OPT checkpointed"].cost, jo.cost),
            f"{label}: checkpointed joint OPT != materialised")
    lanes, opt = out["alpha-RR lanes"], out["OPT lanes"]
    tot = lanes.fleet.total
    require(tot.shape == (sf.B * sf.N,) and np.isfinite(tot).all()
            and np.isfinite(opt.cost).all()
            and (tot >= opt.cost - tol).all()
            and (lanes.fleet.level_slots.sum(1) == T).all(),
            f"{label}: lanes not finite / out of order")
    require((opt.cost.reshape(sf.B, sf.N).sum(1) <= jo.cost + tol).all(),
            f"{label}: the per-service OPT's sum above the joint OPT")
    over = SV.capacity_overflow(sf, lanes.fleet.r_hist)
    require(over.shape == (sf.B, T) and (over >= 0).all(),
            f"{label}: capacity_overflow shape / sign")
    return float((over > 0).mean())


def same_service_runs(a, b, label):
    """``service_runs``' results ``a`` and ``b`` equal bit for bit: the
    lanes' sums and schedules, each OPT's cost, schedule and its price."""
    sim_fields = ("total", "rent", "service", "fetch", "level_slots")
    for k in a:
        ra, rb = a[k], b[k]
        if k == "alpha-RR lanes":
            ra, rb = ra.fleet, rb.fleet
            fields = sim_fields + ("r_hist",)
        else:
            if k != "OPT lanes":
                ra, rb = ra.joint, rb.joint
            fields = ("cost", "r_hist")
            require((ra.sim is None) == (rb.sim is None), f"{label}: {k}")
            for f in sim_fields if ra.sim is not None else ():
                require(np.array_equal(getattr(ra.sim, f),
                                       getattr(rb.sim, f)),
                        f"{label}: {k} sim {f}")
        for f in fields:
            va, vb = getattr(ra, f), getattr(rb, f)
            require((va is None and vb is None) or np.array_equal(va, vb),
                    f"{label}: {k} {f}")


def service_leg(dev, timings):
    """The service axis at the width users run (``kernel_bench.
    multi_service``'s sets and scenario): 2,048 instances x 2 services =
    4,096 lanes, T = 16,384 in chunks of 4,096: alpha-RR per service (its
    schedules' ``capacity_overflow``), ``offline_opt_per_service`` with its
    schedule, the joint OPT (J = 6) materialised with its schedule and
    checkpointed cost only; then the wide joint OPT, 1,024 instances x 4
    services (J = 19), T = 4,096 in chunks of 2,048, through G's w, D on a
    finished w, B and E's matrix route.  Each run three times, counted over
    the first pass; card == CPU on each leg's first 2 instances, T = 1,024
    in chunks of 512.  Returns the launch counts of the counted passes and
    those of the joint rows: the fused D's launches on the J = 6 slab, D's
    on the wide leg's finished w."""
    sf = SV.service_fleet(service_sets(SVC_B, SVC_N), SVC_T)
    wsf = SV.service_fleet(service_sets(SVC_WIDE_B, SVC_WIDE_N), SVC_WIDE_T)
    ops.reset_launches()
    scen = service_scenario_of(sf, dev)
    out, (launched, plain) = timed_passes(
        service_runs(sf, scen, SVC_T, CHUNK, dev), dev, "service", timings,
        counted=True)
    n = SVC_T // CHUNK
    # every run draws the 4 streams a chunk (GE's chain and its Poisson
    # emissions, ARMA rents, service); G reduces them for the joint runs;
    # the materialised runs draw again to price the schedule
    want = {"joint_slab": 3 * n, "dp_fwd_model2": 3 * n,
            "dp_fwd_model2 args": 2 * n, "dp_backtrack": 2 * n,
            "schedule_chunk": 2 * n, "schedule_chunk matrix": n,
            "sim_chunk_alpha_rr_svc": n, "model2_service_chunk": 6 * n,
            "ge_bernoulli_chunk": 6 * n, "poisson_chunk": 6 * n,
            "arma_rents_chunk": 6 * n, "joint_slab w": 0, "dp_minplus": 0}
    got = {k: launched[k] for k in want}
    require(got == want and not any(plain.values()),
            f"service leg launched {got}, expected {want}; plain {plain}")
    over = check_service_runs(out, sf, SVC_T, "service leg")
    joint_d = launched["dp_fwd_model2"] - n       # the lanes' OPT: n
    log(f"service leg: {sf.B} instances x {sf.N} services, J = "
        f"{sf.joint_grid('cpu').K}, T={SVC_T}: " + ", ".join(
            f"{k} {median_us(timings, 'service/' + k):.1f} us"
            for k in out) + f" a run (median of {REPEATS}); alpha-RR's "
        f"slots over the capacity {over:.4f}; per-slot means joint OPT / "
        f"the per-service OPT's sum / alpha-RR's sum "
        f"{float(out['joint OPT'].cost.mean()) / SVC_T:.6f} / "
        f"{float(out['OPT lanes'].cost.mean()) * SVC_N / SVC_T:.6f} / "
        f"{float(out['alpha-RR lanes'].fleet.total.mean()) * SVC_N / SVC_T:.6f}"
        f"; launches {launched}")

    before = launch_counts()
    wscen = service_scenario_of(wsf, dev, seed=50)
    wout, (wl, wplain) = timed_passes(
        service_runs(wsf, wscen, SVC_WIDE_T, SVC_WIDE_CHUNK, dev, wide=True),
        dev, "service wide", timings, counted=True)
    wl = {k: wl[k] - before[k] for k in wl}
    wn = SVC_WIDE_T // SVC_WIDE_CHUNK
    wwant = {"joint_slab": 3 * wn, "joint_slab w": wn, "dp_minplus": wn,
             "dp_fwd_model2": 0, "dp_backtrack": wn,
             "schedule_chunk matrix": wn}
    wgot = {k: wl[k] for k in wwant}
    require(wgot == wwant and not any(wplain.values()),
            f"wide service leg launched {wgot}, expected {wwant}; plain "
            f"{wplain}")
    check_service_runs(wout, wsf, SVC_WIDE_T, "wide service leg")
    log(f"wide service leg: {wsf.B} instances x {wsf.N} services, J = "
        f"{wsf.joint_grid('cpu').K}, T={SVC_WIDE_T}: joint OPT "
        f"{median_us(timings, 'service wide/joint OPT'):.1f} us a run; "
        f"per-slot mean {float(wout['joint OPT'].cost.mean()) / SVC_WIDE_T:.6f}"
        f"; launches {wgot}")
    launched = {k: launched[k] + wl[k] for k in launched}

    # card == CPU on each leg's first instances
    for lsf, lscen, label, wide in ((sf, scen, "service", False),
                                    (wsf, wscen, "wide service", True)):
        res = []
        for d in (dev, "cpu"):
            sub_sf = SV.service_fleet(lsf.sets[:SVC_SUB_B], SVC_SUB_T)
            sub = lscen._replace(params=sc.base.tree_map(
                lambda a: a[:SVC_SUB_B].to(d), lscen.params))
            t0 = time.perf_counter()
            res.append({k: f() for k, f in service_runs(
                sub_sf, sub, SVC_SUB_T, SVC_SUB_CHUNK, d, wide).items()})
            if d == "cpu":
                log(f"{label} leg on the CPU: {SVC_SUB_B} instances, "
                    f"T={SVC_SUB_T}: {time.perf_counter() - t0:.1f} s")
        same_service_runs(*res, f"{label} leg: card != CPU")
        log(f"{label} leg: card == CPU on {SVC_SUB_B} instances, "
            f"T={SVC_SUB_T}")
    return launched, {"dp_fwd_model2 joint": joint_d,
                      "dp_minplus joint": wl["dp_minplus"]}


def launch_counts():
    """Every kernel's launches, (``poisson_chunk rejection``) the Poisson
    launches in which the kernel drew an item on Hormann's branch, as the
    kernel counts them, (``... wide``) the launches on a Model-2 slab of
    more than ``H.DPF_MAX_K`` levels, (``... args``) D's launches that
    write the argmin table, (``... ma1``) the ARMA launches at q = 1,
    (``... matrix``) E's launches on a matrix-M grid and (``... w``) G's
    launches that write only a DP's w."""
    return {**{k.__name__: k.launches for k in ops.KERNELS},
            "poisson_chunk rejection": H.poisson_rejection_launches(),
            **{f"{k.__name__} wide": k.wide_launches for k in ops.WIDE},
            **{f"{k.__name__} args": k.args_launches for k in ops.ARGS},
            **{f"{k.__name__} ma1": k.ma1_launches for k in ops.MA1},
            **{f"{k.__name__} matrix": k.matrix_launches
               for k in ops.MATRIX},
            **{f"{k.__name__} w": k.w_launches for k in ops.W}}


def card_calls():
    """The calls on the card of the plain code the kernels replace."""
    return {f.__name__: f.card_calls for f in ops.PLAIN_ON_CARD}


def serving_path(dev, timings):
    """zamba2-1.2b at full width and depth in bf16: serve_slot under each
    plan, then the scheduler.  Returns the launch counts of the run."""
    spec = get_arch("zamba2-1.2b")
    t0 = time.perf_counter()
    eng = ServingEngine(spec, generator=torch.Generator(dev).manual_seed(0),
                        use_tiny=False, device=dev)
    torch.cuda.synchronize()
    leaves = _leaves(eng.params)
    n_params = sum(t.numel() for t in leaves)
    require(n_params == spec.param_count(), "parameter count differs")
    require(all(t.dtype in (torch.bfloat16, torch.float32) for t in leaves)
            and eng.params["embed"].dtype == torch.bfloat16,
            "the full config must hold bf16 weights")
    cfg = eng.cfg
    require(sum(n for k, n in cfg.segments if k == "ssm") == 38
            and sum(1 for k, _ in cfg.segments if k == "shared_ref") == 6,
            "zamba2-1.2b must run all 38 Mamba2 layers and 6 shared blocks")
    log(f"zamba2-1.2b: {n_params:,} parameters, init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    plans, _ = make_plans(spec, model_cfg=cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (SERVE_B, SERVE_S))
    rng = np.random.default_rng(1)
    eng.serve_slot(prompts, plans[1.0], rng)        # warm-up, not counted
    eng.serve_slot(prompts, plans[0.4], rng)
    torch.cuda.synchronize()

    # bf16 at zamba2's widths: every F launch is the wgmma kernel, every M
    # launch the mma kernel, and the fma kernels never run
    f_kern, m_kern = "flash_attention_wgmma", "ssd_scan_mma"
    expect = {0.0: (0, 0), 0.4: (3, 12), 1.0: (6, 38)}
    ops.reset_launches()                            # the serving path
    torch.cuda.reset_peak_memory_stats()
    for level, plan in sorted(plans.items()):
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.serve_slot(prompts, plan, rng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        after = launch_counts()
        got = (after[f_kern] - before[f_kern], after[m_kern] - before[m_kern])
        require(got == expect[level], f"plan {plan.kind}: F and M launched "
                                      f"{got} times, expected "
                                      f"{expect[level]}")
        n = SERVE_B
        acct = {"none": (0, 0, n, float(n)),
                "layer_prefix": (0, n, 0, plan.g_value * n),
                "full": (n, 0, 0, 0.0)}[plan.kind]
        require((res.served_edge, res.served_partial, res.forwarded,
                 res.service_cost) == acct and res.n_requests == n,
                f"plan {plan.kind}: accounting {res}")
        if plan.kind != "none":
            lg = eng.last_logits
            require(lg.shape == (n, cfg.vocab_size)
                    and bool(torch.isfinite(lg).all())
                    and res.edge_tokens.shape == (n,),
                    f"plan {plan.kind}: logits not finite / wrong shape")
            timings[f"serve/{plan.kind}"] = [wall]
            log(f"serve_slot {plan.kind} ({plan.n_segments or 13} "
                f"segments): {wall:.3f} s, {n * SERVE_S / wall:,.0f} prefill "
                f"tokens/s; F {got[0]}, M {got[1]} launches; tokens "
                f"{res.edge_tokens.tolist()}")
    log(f"peak device memory while serving: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    data = np.random.default_rng(2)
    arrivals = data.integers(0, 5, SERVE_SLOTS)
    rents = data.uniform(0.5, 2.5, SERVE_SLOTS)
    before = launch_counts()
    t = time.perf_counter()
    rep = EdgeServingScheduler(spec, M=5.0, engine=eng, seed=0).run(
        arrivals, rents)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    after = launch_counts()
    require(rep.served_edge + rep.served_partial + rep.forwarded
            == rep.n_requests == int(arrivals.sum()),
            f"scheduler accounting: {rep.summary()}")
    require(np.isfinite(rep.total_cost) and rep.n_slots == SERVE_SLOTS,
            "scheduler cost not finite")
    for name in (f_kern, m_kern):
        require(after[name] > before[name],
                f"the scheduler never launched {name}")
    counts = launch_counts()
    for name in ("flash_attention_fma", "ssd_scan_fma"):
        require(counts[name] == 0, f"{name} ran on the bf16 serving path")
    timings["scheduler"] = [wall]
    log(f"scheduler, {SERVE_SLOTS} slots: {rep.summary()}")
    log(f"scheduler wall {wall:.2f} s, {wall / SERVE_SLOTS * 1e3:.1f} ms per "
        f"slot (8-token prompts, as the reference draws them)")
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def serving_card_vs_cpu(dev):
    """zamba2's tiny fp32 config, one set of weights on both: logits
    within 1e-4 (normwise; fp32 sums in another order through 4 segments),
    argmax tokens equal where the CPU's top-2 margin is wider."""
    spec = get_arch("zamba2-1.2b")
    params = init_params(spec.tiny, torch.Generator().manual_seed(1), "cpu")
    engines = {"cpu": ServingEngine(spec, params=params, device="cpu"),
               dev: ServingEngine(spec, params=_to(params, dev), device=dev)}
    plans, _ = make_plans(spec, model_cfg=spec.tiny)
    # 45 tokens: ragged against the SSD chunk (8) and the key tile (64)
    prompts = np.random.default_rng(3).integers(0, spec.tiny.vocab_size,
                                                (4, 45))
    tol = 1e-4
    for level in (0.4, 1.0):
        out = {d: (e.serve_slot(prompts, plans[level],
                                np.random.default_rng(0)),
                   e.last_logits.cpu()) for d, e in engines.items()}
        (rc, lc), (rd, ld) = out["cpu"], out[dev]
        a, r = normwise_errors(ld, lc)
        require(r <= tol, f"card != CPU logits (plan {level}): {r:.3e}")
        top2 = torch.topk(lc, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]).numpy() > 2 * tol * max(
            1.0, float(lc.abs().max()))
        require(np.array_equal(rd.edge_tokens[clear], rc.edge_tokens[clear]),
                f"card != CPU tokens (plan {level})")
        log(f"card == CPU, tiny serving plan {level}: logits max_abs_err "
            f"{a:.3e}, tokens equal on {int(clear.sum())}/4 clear rows")


# ----------------------------------------------------------------------

DEVICE = "cuda"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_s, t_phase = {}, [t_start]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = round(now - t_phase[0], 1)
        t_phase[0] = now
        log(f"phase {name}: {phase_s[name]:.1f} s")

    dev = DEVICE
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t = time.perf_counter()
    _build.build_all()
    log(f"kernel build: {time.perf_counter() - t:.1f} s (nvcc seconds per "
        f"library, run together: {_build.BUILD_SECONDS}; the hosting "
        f"library's parts: {_build.BUILD_PART_SECONDS})")
    phase_done("1 build")

    # phase 2
    rec = kernel_checks(dev)
    rec.update(schedule_kernel_checks(dev))
    table_and_args_edges(dev)
    rec.update(service_kernel_checks(dev))
    log("kernels == plain versions on the card")
    phase_done("2 kernels")

    # phase 3: the fleet path at full width; counters read around it only
    timings = {}
    B = N_M * N_ALPHA
    grid = fleet_grid(N_M, N_ALPHA, dev)
    ops.reset_launches()
    main_res, (main_launches, main_plain) = run_leg(
        grid, bernoulli_uniform(B, dev), T_MAIN, False, dev, "main", timings,
        counted=True)
    log(f"fleet path launches, main leg: {main_launches}; plain code on "
        f"the card: {main_plain}")
    for k in (H.bernoulli_arrivals_chunk, H.uniform_rents_chunk,
              H.dp_fwd_model1, H.sim_chunk_alpha_rr):
        require(main_launches[k.__name__] > 0,
                f"kernel {k.__name__} never launched on the fleet path")
    for name in ("dp_minplus", "slot_uniform", "na_rents_chunk",
                 "ge_bernoulli_chunk", "normal_chunk", "arma_rents_chunk",
                 "poisson_chunk", "model2_service_chunk", "dp_fwd_model2",
                 "sim_chunk_alpha_rr_svc", "sim_chunk_table",
                 "sim_chunk_table_svc"):
        require(main_launches[name] == 0,
                f"{name} ran on the Bernoulli leg of the fleet path")
    require(not any(main_plain.values()),
            f"plain code ran on the card: {main_plain}")
    summ = check_leg(main_res, T_MAIN, "main")
    for name, s in summ.items():
        key = "total_mean" if "total_mean" in s else "cost_mean"
        log(f"main {name}: {median_us(timings, 'main/' + name):.1f} us "
            f"(median of {REPEATS}); per-slot seed means of instances 0..3: "
            f"{np.round(s[key][:4] / T_MAIN, 6).tolist()}")
    phase_done("3 fleet")

    # phase 4: GE arrivals, NA rents, antithetic seeds; counters read
    # around it only: per run and chunk one GE and one NA launch, per run
    # one uniform launch (the GE chain's initial draw), no plain code
    ops.reset_launches()
    ge_res, (ge_launches, ge_plain) = run_leg(
        grid, ge_na(B, dev), T_GE, True, dev, "ge", timings, counted=True)
    log(f"fleet path launches, GE leg: {ge_launches}; plain code on the "
        f"card: {ge_plain}")
    runs, n_chunks = 4, -(-T_GE // CHUNK)
    want = {"ge_bernoulli_chunk": runs * n_chunks,
            "na_rents_chunk": runs * n_chunks, "slot_uniform": runs,
            "bernoulli_arrivals_chunk": 0, "uniform_rents_chunk": 0,
            "dp_minplus": 0, "normal_chunk": 0, "arma_rents_chunk": 0,
            "poisson_chunk": 0, "model2_service_chunk": 0,
            "dp_fwd_model2": 0, "sim_chunk_alpha_rr_svc": 0,
            "sim_chunk_table": 0, "sim_chunk_table_svc": 0}
    for name, n in want.items():
        require(ge_launches[name] == n, f"{name} launched "
                                        f"{ge_launches[name]} times on the "
                                        f"GE leg, expected {n}")
    require(not any(ge_plain.values()),
            f"plain code ran on the card: {ge_plain}")
    summ = check_leg(ge_res, T_GE, "ge")
    for name, s in summ.items():
        key = "total_mean" if "total_mean" in s else "cost_mean"
        log(f"ge {name}: {median_us(timings, 'ge/' + name):.1f} us (median "
            f"of {REPEATS}); per-slot seed means of instances 0..3: "
            f"{np.round(s[key][:4] / T_GE, 6).tolist()}")
    # the fleet path's launches: both legs
    launches = {k: main_launches[k] + ge_launches[k] for k in main_launches}
    phase_done("4 GE leg")

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
            f"T={T_SMALL} ({timings[f'small-{label}-cpu/alpha-RR'][0]:.1f} "
            f"s alpha-RR on the CPU)")
    phase_done("5 card == CPU")

    # phases 6 to 10: the policy fan-out on the card, the paper's Figs
    # 1-8, 10-15 and 17-22, the fan-out at the fleet leg's width, the
    # Model-2 fan-out and the Markov fan-out at that width; each counted
    # path adds its launches
    fanout_checks(dev)
    phase_done("6 fan-out")
    fig_counts = figures(dev, timings)
    gcurve_card_vs_cpu(dev)
    phase_done("7 figures")
    legs = [fanout_leg(dev, timings), model2_fanout_leg(dev, timings),
            markov_fanout_leg(dev, timings)]
    phase_done("8-10 fan-out legs")
    for counts in fig_counts + legs:
        for k in launches:
            launches[k] += counts[k]
    # Hormann's branch ran in Figs 17-22 and the Markov leg (rates 200 /
    # 10), and nowhere else (every other Poisson rate is below 10)
    rej = "poisson_chunk rejection"
    for name, counts in zip(list(FIGURES) + ["fan-out", "Model-2", "Markov"],
                            fig_counts + legs):
        on = name in ("fig17_22", "Markov")
        require((counts[rej] > 0) == on and counts[rej] <= counts[
            "poisson_chunk"], f"{name}: {counts[rej]} Poisson launches on "
                              f"Hormann's branch of {counts['poisson_chunk']}")
    for name in ("normal_chunk", "arma_rents_chunk", "poisson_chunk",
                 "model2_service_chunk", "dp_fwd_model2",
                 "sim_chunk_alpha_rr_svc", "sim_chunk_table_svc",
                 "model2_service_chunk wide", "sim_chunk_alpha_rr_svc wide"):
        require(launches[name] > 0, f"{name} never launched")
    # phases 11-12: the obs-backed fleets, the backtracked schedule and
    # theorems; no earlier path launched B, E, D's ARGS route or D on a
    # finished w
    for name in ("dp_backtrack", "schedule_chunk", "dp_minplus",
                 "dp_fwd_model1 args", "dp_fwd_model2 args"):
        require(launches[name] == 0, f"{name} ran before the obs phase")
    for counts in (obs_leg(dev, timings), model2_obs_leg(dev),
                   theorems_card_vs_cpu(dev, timings)):
        for k in launches:
            launches[k] += counts[k]
    for name in ("dp_backtrack", "schedule_chunk", "dp_minplus",
                 "dp_fwd_model1 args"):
        require(launches[name] > 0, f"{name} never launched")
    phase_done("11-12 obs legs")
    # phase 13: the composed scenario at the fleet leg's width; no earlier
    # path drew a shaped uniform or ARMA rents at q = 1
    for name in ("shaped_uniform", "arma_rents_chunk ma1"):
        require(launches[name] == 0, f"{name} ran before the composed leg")
    counts = composed_leg(dev, timings)
    for k in launches:
        launches[k] += counts[k]
    phase_done("13 composed")

    # phase 14: the service axis; no earlier path launched G, E's matrix
    # route or the wide route's D, and no plain code runs on the card
    # there (fma32 among it)
    for name in ("joint_slab", "joint_slab w", "schedule_chunk matrix"):
        require(launches[name] == 0, f"{name} ran before the service leg")
    counts, joint = service_leg(dev, timings)
    for k in counts:
        launches[k] += counts[k]
    launches.update(joint)
    for name in ("joint_slab", "joint_slab w", "schedule_chunk matrix",
                 "dp_minplus joint", "dp_fwd_model2 joint"):
        require(launches[name] > 0, f"{name} never launched")
    phase_done("14 service")

    # phase 15: F and M against their plain versions
    rec.update(lm_kernel_checks(dev))
    phase_done("15 F and M")

    # phase 16: the LM serving path at full width and depth
    serve_launches = serving_path(dev, timings)
    log(f"serving path launches: {serve_launches}")
    for k in (FA.flash_attention_wgmma, FA.flash_attention_fma,
              SSD.ssd_scan_mma, SSD.ssd_scan_fma):
        launches[k.__name__] = serve_launches[k.__name__]

    phase_done("16 serving")

    # phase 17: card == CPU for the serving path
    serving_card_vs_cpu(dev)
    phase_done("17 serving card == CPU")
    log(f"timings (us; a card run the median of {REPEATS} passes, a CPU "
        f"run and the serving path one): " + json.dumps(
            {k: round(median_us(timings, k), 1) for k in timings}))

    kernels = []
    for name, r in rec.items():
        t_bytes = r["nbytes"] / PEAK_BYTES * 1e3
        t_ops = r["ops"] / r.get("peak_ops", PEAK_OPS) * 1e3
        entry = {
            "name": name, "route": "cuda",
            "source": r.get("source", CSRC + "hosting.cu"),
            "kernel": KERNEL_SYMBOLS[name],
            "replaces": r["replaces"], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r.get("library_ms"), "shape": r["shape"]}
        for key in ("max_rel_err", "old_route_ms", "args_ms",
                    "trace_ms",
                    "cols_ms", "cols_plain_ms", "mean_rounds",
                    "alu_ops_per_block",
                    "live_requests_per_slot", "live_slots_share",
                    "pass_fill", "lgamma_share", "alu_pipe_bound_ms",
                    "fma_pipe_bound_ms", "xu_pipe_bound_ms",
                    "pipe_bound_ms", "bound_pipe", "hash_pipe_ops",
                    "round_pipe_ops", "slow_pipe_ops", "five_blocks_ratio",
                    "abc_ms", "parts_ms", "fleet_ms", "model1_ms",
                    "fleet_plain_ms", "fleet_plain_rows", "fleet_bound_ms",
                    "fleet_int_pipe_bound_ms", "fleet_k3_ms",
                    "fleet_ms_by_k", "lane_k",
                    "markov_ms", "markov_plain_ms", "markov_plain_rows",
                    "markov_live_requests_per_slot",
                    "markov_int_pipe_bound_ms",
                    "sm_clock_mhz", "cycles_per_slot", "consumer",
                    "alu_ops_per_slot", "ops_per_slot", "int_pipe_bound_ms",
                    "issue_bound_ms", "salt_ms", "salt_alu_ops_per_slot",
                    "salt_ops_per_slot", "salt_int_pipe_bound_ms",
                    "salt_issue_bound_ms", "latency_bound_ms", "chain_ops",
                    "bulk_ms", "fleet_bulk_ms", "fleet_sectors_per_slot",
                    "fleet_sector_bound_ms", "narrow_ms", "one_block_ms",
                    "by_k", "model2_ms", "model2_plain_ms", "model2_n",
                    "model2_bound_ms",
                    "one_block_cycles_per_slot"):
            if key in r:
                entry[key] = r[key]
        kernels.append(entry)
    log(f"phase seconds: {json.dumps(phase_s)}")
    log(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The per-slot simulator's plain path (``sim_chunk_core`` stepping
``alpha_rr_step``, kernel S's plain version) against the JAX package's
``run_policy_batch`` on materialized observations, and against the literal
Algorithm 1 oracle.  Exact equality."""
import numpy as np
import pytest
import torch

from repro.core.costs import HostingCosts as JCosts, HostingGrid as JGrid
from repro.core.policies import AlphaRR as JAlphaRR
from repro.core.policies import RetroRenting as JRR
from repro.core.policies import StaticPolicy as JStatic
from repro.core.simulator import run_policy_batch
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.policies import (AlphaRR, RetroRenting, StaticPolicy,
                                       alpha_rr_literal)
from repro_torch.core.scenarios.base import ObsSlab
from repro_torch.core.simulator import sim_acc0, sim_chunk
from repro_torch.kernels import hosting as phost

CPU = "cpu"


def _spec(rng, B):
    out = []
    for i in range(B):
        M = float(rng.uniform(1.5, 15))
        if i % 4 == 3:
            out.append((M, (0.0, 0.2, 0.45, 0.7, 1.0), (1.0, 0.75, 0.5, 0.2,
                                                        0.0)))
        else:
            a = float(rng.uniform(0.1, 0.7))
            out.append((M, (0.0, a, 1.0), (1.0, max(0.9 - a, 0.0), 0.0)))
    return out


def _grids(spec):
    return (JGrid.from_costs([JCosts(M=m, levels=lv, g=g)
                              for m, lv, g in spec]),
            HostingGrid.from_costs([HostingCosts(M=m, levels=lv, g=g)
                                    for m, lv, g in spec], device=CPU))


def _obs(rng, B, T):
    x = (rng.random((B, T)) < 0.4).astype(np.int32) \
        * rng.integers(1, 3, (B, T)).astype(np.int32)
    c = (rng.random((B, T)) * 1.3).astype(np.float32)
    return x, c


def _port_run(policy, grid, x, c, chunk, include_final_fetch=True):
    B, T = x.shape
    T_len = torch.full((B,), T, dtype=torch.int32)
    carry = (policy.init_fn(policy.params), sim_acc0(B, grid.K, CPU))
    rs = []
    for t0 in range(0, T, chunk):
        slab = ObsSlab(torch.from_numpy(x[:, t0:t0 + chunk]).contiguous(),
                       torch.from_numpy(c[:, t0:t0 + chunk]).contiguous())
        carry, r = sim_chunk(policy, include_final_fetch, grid.levels, grid.g,
                             grid.M, T_len, t0, carry, slab)
        rs.append(r)
    acc = carry[1]
    return (torch.cat(rs, 1).numpy(),
            acc["sums"].numpy().astype(np.float64),
            acc["counts"].numpy().astype(np.int64))


def _check(ref, got):
    r_hist, sums, counts = got
    np.testing.assert_array_equal(ref.r_hist, r_hist)
    np.testing.assert_array_equal(ref.rent, sums[:, 0])
    np.testing.assert_array_equal(ref.service, sums[:, 1])
    np.testing.assert_array_equal(ref.fetch, sums[:, 2])
    np.testing.assert_array_equal(ref.total, sums.sum(axis=1))
    np.testing.assert_array_equal(ref.level_slots, counts)


@pytest.mark.parametrize("include_final_fetch", [True, False])
def test_alpha_rr_and_rr_match_run_policy_batch(include_final_fetch):
    rng = np.random.default_rng(0)
    B, T = 8, 400
    jg, pg = _grids(_spec(rng, B))
    x, c = _obs(rng, B, T)
    ref = run_policy_batch(JAlphaRR.batch(jg), jg, x, c,
                           include_final_fetch=include_final_fetch)
    for chunk in (T, 128):
        _check(ref, _port_run(AlphaRR.batch(pg), pg, x, c, chunk,
                              include_final_fetch))
    jg2 = jg.restrict_to_endpoints()
    ref = run_policy_batch(JRR.batch(jg), jg2, x, c,
                           include_final_fetch=include_final_fetch)
    _check(ref, _port_run(RetroRenting.batch(pg), pg.restrict_to_endpoints(),
                          x, c, 128, include_final_fetch))


def test_static_matches_run_policy_batch():
    rng = np.random.default_rng(1)
    B, T = 6, 200
    jg, pg = _grids(_spec(rng, B))
    x, c = _obs(rng, B, T)
    ref = run_policy_batch(JStatic.batch(jg, jg.top_index()), jg, x, c)
    _check(ref, _port_run(StaticPolicy.batch(pg, pg.top_index()), pg, x, c,
                          64))


def test_alpha_rr_matches_literal_algorithm():
    rng = np.random.default_rng(2)
    for trial in range(6):
        a = float(rng.uniform(0.15, 0.6))
        costs = HostingCosts.three_level(float(rng.uniform(1.5, 6)), a,
                                         max(0.85 - a, 0.0))
        T = 60
        x = rng.integers(0, 3, T).astype(np.int32)
        c = (rng.random(T) * 1.5).astype(np.float32)
        grid = HostingGrid.from_costs([costs], device=CPU)
        r_hist, _, _ = _port_run(AlphaRR.batch(grid), grid, x[None], c[None],
                                 T)
        np.testing.assert_array_equal(r_hist[0],
                                      alpha_rr_literal(costs, x, c))


def test_kernel_s_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    B, T = 4, 50
    _, pg = _grids(_spec(rng, B))
    x, c = _obs(rng, B, T)
    pol = AlphaRR.batch(pg)
    T_len = torch.tensor([50, 20, 0, 49], dtype=torch.int32)
    carry = (pol.init_fn(pol.params), sim_acc0(B, pg.K, CPU))
    before = phost.sim_chunk_alpha_rr.launches
    args = (pol.params, pg.levels, pg.g, pg.M, T_len, 0, carry,
            torch.from_numpy(x), torch.from_numpy(c), False)
    (s1, a1), r1 = phost.sim_chunk_alpha_rr(*args, collect_trace=True)
    (s2, a2), r2 = phost.sim_chunk_alpha_rr_plain(*args, collect_trace=True)
    assert phost.sim_chunk_alpha_rr.launches == before
    assert torch.equal(r1, r2)
    for k in s1:
        assert torch.equal(s1[k], s2[k])
    for k in a1:
        assert torch.equal(a1[k], a2[k])
    # a row with T_len = 0 accrues nothing and never moves
    assert a1["sums"][2].abs().sum() == 0 and (r1[2] == 0).all()
    assert a1["counts"].sum(1).tolist() == [50, 20, 0, 49]
    _, r3 = phost.sim_chunk_alpha_rr(*args, collect_trace=False)
    assert r3 is None

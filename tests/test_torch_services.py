"""The port's service axis (``repro_torch.core.services``, ``ServiceSet``
and matrix-``M`` grids, the joint OPT) against the JAX package's, bit for
bit (``np.array_equal``, and exact float equality against the oracles),
in both threefry layouts where they draw: the N = 1 identities,
``offline_opt_joint`` == ``brute_force_joint_opt`` == the reference's,
the fleet path == the helper, the hypothesis walk, the capacity
boundaries, ``capacity_overflow``, shared-rent tiling, trace playback,
alpha-RR's refusal of joint grids, ``offline_opt_batch`` on joint grids
and the wide DP route's plain form.  With ``test_torch_joint_dp.py``,
``test_torch_joint_states.py``, ``test_torch_joint_edges.py`` and
``test_torch_joint_pricing.py`` it mirrors every check of
``tests/test_multi_service.py`` that runs on this jax (the stepper waits
for ROADMAP.md Queue 1 item 10; the mesh and multi-process legs for item
15)."""
import numpy as np
import jax
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import scenarios as js
from repro.core import services as JSV
from repro.core.costs import HostingCosts as JCosts
from repro.core.costs import ServiceSet as JSet
from repro.core.costs import joint_hosting_grid as jjoint_grid
from repro.core.policies.offline_opt import offline_opt_batch as jopt_batch
from repro.core.policies.offline_opt import offline_opt_joint as jopt_joint
from repro_torch.convert import grid_from_jax, service_set_from_jax
from repro_torch.core import scenarios as ps
from repro_torch.core import services as SV
from repro_torch.core.costs import (CAPACITY_EPS, HostingCosts, HostingGrid,
                                    ServiceSet, joint_hosting_grid)
from repro_torch.core.fleet import (FleetBatch, evaluate_schedule_fleet,
                                    offline_opt_fleet, run_fleet)
from repro_torch.core.policies import (AlphaRR, RetroRenting, StaticPolicy,
                                       offline_opt_batch)
from repro_torch.core.policies.offline_opt import (brute_force_joint_opt,
                                                   dp_fetch_matrix,
                                                   offline_opt_joint)
from repro_torch.core.scenarios.base import materialize

import _joint_cases as JC
from _service_ref import (B, CPU, FIELDS, HORIZONS, LAYOUTS, T, _both, _costs,
                          _env, _equal_fields, _pk, _same_opt, _scenarios)


# ----------------------------------------------------------------------
# N = 1 identities, per driver; each also == the reference's own call.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("chunk,stream", [(None, False), (16, False),
                                          (20, False), (16, True)])
def test_n1_lane_identity(chunk, stream, partitionable):
    with _both(partitionable):
        e = _env()
        kw = dict(chunk_size=chunk, stream=stream)
        one = run_fleet(AlphaRR.fleet(e["pfleet"]), e["pfleet"],
                        scenario=e["psc"], device=CPU, **kw)
        got = SV.run_fleet_services(SV.alpha_rr_per_service(e["psf1"], CPU),
                                    e["psf1"], scenario=e["psc"], device=CPU,
                                    **kw)
        want = JSV.run_fleet_services(JSV.alpha_rr_per_service(e["jsf1"]),
                                      e["jsf1"], scenario=e["jsc"], **kw)
    _equal_fields(got.fleet, one, "port N=1")
    _equal_fields(got.fleet, want.fleet, "reference")
    assert got.total.shape == (1, B, 1, 1)
    np.testing.assert_array_equal(got.edge_total[0, :, 0], one.total)


def test_n1_lane_identity_n_seeds():
    e = _env()
    one = run_fleet(AlphaRR.fleet(e["pfleet"]), e["pfleet"],
                    scenario=e["psc"], chunk_size=16, n_seeds=2, device=CPU)
    got = SV.run_fleet_services(SV.alpha_rr_per_service(e["psf1"], CPU),
                                e["psf1"], scenario=e["psc"], chunk_size=16,
                                n_seeds=2, device=CPU)
    want = JSV.run_fleet_services(JSV.alpha_rr_per_service(e["jsf1"]),
                                  e["jsf1"], scenario=e["jsc"],
                                  chunk_size=16, n_seeds=2)
    _equal_fields(got.fleet, one, "n_seeds=2")
    _equal_fields(got.fleet, want.fleet, "reference")
    assert got.total.shape == (1, B, 1, 2)


def test_n1_fanout_lanes_identity():
    """The policy fan-out on the N = 1 lane fleet: each lane == its
    standalone single-service run (RR on its endpoint grid's own
    scenario), and == the reference's fan-out."""
    e = _env()
    lf = e["psf1"].lane_fleet(CPU)
    lanes = [AlphaRR.fleet_lane(lf),
             RetroRenting.fleet_lane(lf, with_svc=True)]
    got = SV.run_fleet_services(lanes, e["psf1"], scenario=e["psc"],
                                chunk_size=16, device=CPU)
    egrid = e["pfleet"].grid.restrict_to_endpoints()
    efleet = FleetBatch.for_scenario(egrid, HORIZONS)
    _, esc = _scenarios(np.zeros((B, 2), np.float32), egrid.g, B)
    refs = [run_fleet(AlphaRR.fleet(e["pfleet"]), e["pfleet"],
                      scenario=e["psc"], chunk_size=16, device=CPU),
            run_fleet(RetroRenting.fleet(efleet), efleet, scenario=esc,
                      chunk_size=16, device=CPU)]
    for p, ref in enumerate(refs):
        for f in FIELDS + ["r_hist"]:
            np.testing.assert_array_equal(
                got.fleet.policy_view(getattr(got.fleet, f))[p],
                getattr(ref, f), err_msg=f"{p} {f}")
    jl = e["jsf1"].lane_fleet()
    from repro.core.policies import AlphaRR as JA, RetroRenting as JR
    want = JSV.run_fleet_services(
        [JA.fleet_lane(jl), JR.fleet_lane(jl, with_svc=True)], e["jsf1"],
        scenario=e["jsc"], chunk_size=16)
    _equal_fields(got.fleet, want.fleet, "reference fan-out")
    assert got.total.shape == (2, B, 1, 1)


@pytest.mark.parametrize("checkpointed,stream,n_seeds",
                         [(False, False, None), (True, False, None),
                          (True, True, 2)])
def test_n1_offline_opt_identity(checkpointed, stream, n_seeds):
    e = _env()
    kw = dict(chunk_size=16, checkpointed=checkpointed, stream=stream,
              n_seeds=n_seeds)
    one = offline_opt_fleet(e["pfleet"], scenario=e["psc"], device=CPU, **kw)
    got = SV.offline_opt_services(e["psf1"], scenario=e["psc"], device=CPU,
                                  **kw)
    np.testing.assert_array_equal(got.cost, one.cost)
    np.testing.assert_array_equal(got.service_schedules()[:, 0, :],
                                  one.r_hist)
    lane = SV.offline_opt_per_service(e["psf1"], scenario=e["psc"],
                                      device=CPU, **kw)
    np.testing.assert_array_equal(lane.cost, one.cost)
    want = JSV.offline_opt_services(e["jsf1"], scenario=e["jsc"], **kw)
    np.testing.assert_array_equal(got.cost, np.asarray(want.cost))
    np.testing.assert_array_equal(got.joint.r_hist, want.joint.r_hist)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got.joint.sim, f),
                                      np.asarray(getattr(want.joint.sim, f)))


def test_n1_schedule_eval_identity():
    e = _env()
    opt = offline_opt_fleet(e["pfleet"], scenario=e["psc"], chunk_size=16,
                            device=CPU)
    r = opt.r_hist
    one = evaluate_schedule_fleet(e["pfleet"], r, scenario=e["psc"],
                                  chunk_size=16, device=CPU)
    got = SV.evaluate_schedule_services(e["psf1"], r[:, None, :],
                                        scenario=e["psc"], chunk_size=16,
                                        device=CPU)
    want = JSV.evaluate_schedule_services(e["jsf1"], r[:, None, :],
                                          scenario=e["jsc"], chunk_size=16)
    _equal_fields(got.fleet, one, "schedule-eval")
    _equal_fields(got.fleet, want.fleet, "reference")


def test_n1_stepper_waits_for_its_item():
    e = _env()
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        SV.fleet_stepper_services(SV.alpha_rr_per_service(e["psf1"], CPU),
                                  e["psf1"], scenario=e["psc"],
                                  chunk_size=16)


def test_n1_tile_services_is_identity():
    e = _env()
    assert SV.service_scenario(e["psf1"], e["psc"]) is e["psc"]
    assert ps.tile_services(e["psc"], 1) is e["psc"]


def test_n1_joint_fetch_matrix_is_the_rank_one_matrix():
    """At N = 1 the joint fetch matrix, levels and g are bitwise the
    single-service DP's (``dp_fetch_matrix``) and grid's."""
    for cc in _costs(HostingCosts):
        ss = ServiceSet((cc,))
        grid = HostingGrid.from_costs([cc], device=CPU)
        jg = ss.joint_grid(CPU)
        np.testing.assert_array_equal(
            jg.M.numpy(), dp_fetch_matrix(grid.M, grid.levels).numpy())
        np.testing.assert_array_equal(jg.levels.numpy(), grid.levels.numpy())
        np.testing.assert_array_equal(jg.g.numpy(), grid.g.numpy())

def _oracle_case(sset, T_len, seed):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 4, (sset.N, T_len))
    c = (rng.integers(1, 16, T_len) / 8.0).astype(np.float32)
    return xs, c


def _oracle_sets(C, SS):
    cc = _costs(C)
    return [SS((cc[0], cc[1]), capacity=1.0),
            SS((C.two_level(2.0), C.two_level(3.0), C.two_level(2.5)),
               capacity=1.0),
            SS((cc[1], cc[1]))]


@pytest.mark.parametrize("i,T_len", [(0, 4), (1, 3), (2, 4)])
def test_joint_dp_matches_oracle(i, T_len):
    sset = _oracle_sets(HostingCosts, ServiceSet)[i]
    xs, c = _oracle_case(sset, T_len, seed=5)
    got = offline_opt_joint(sset, xs, c, device=CPU)
    want = brute_force_joint_opt(sset, xs, c)
    ref = jopt_joint(_oracle_sets(JCosts, JSet)[i], xs, c)
    assert float(got.cost) == float(want.cost) == float(ref.cost)
    np.testing.assert_array_equal(got.r_hist, want.r_hist)
    np.testing.assert_array_equal(got.r_hist, ref.r_hist)
    np.testing.assert_array_equal(got.states, ref.states)
    lv = [np.asarray(cc.levels, np.float64) for cc in sset.services]
    tot = sum(lv[n][got.r_hist[n]] for n in range(sset.N))
    assert np.all(tot <= sset.cap + CAPACITY_EPS)


def test_joint_fleet_path_matches_helper():
    """The fleet path (matrix-M grid through ``offline_opt_fleet``) ==
    the joint helper == the oracle on the same materialised observations,
    materialised and checkpointed-streamed."""
    T2 = 5
    ss = ServiceSet((HostingCosts.three_level(3.0, 0.5, 0.4),
                     HostingCosts.two_level(2.5)), capacity=1.0)
    sf = SV.service_fleet([ss], T2)
    g = sf.lane_grid(CPU).g
    _, sc = _scenarios(g.numpy(), g, 2, seed=3)
    res = SV.offline_opt_services(sf, scenario=sc, device=CPU)
    ck = SV.offline_opt_services(sf, scenario=sc, checkpointed=True,
                                 stream=True, chunk_size=2, device=CPU)
    x, c, svc, _ = materialize(sc, T2, chunk_size=T2)
    svcs = [svc[n][:, :ss.services[n].K] for n in range(2)]
    ref = offline_opt_joint(ss, x[:2], c[0], svcs=svcs, device=CPU)
    oracle = brute_force_joint_opt(ss, x[:2], c[0], svcs=svcs)
    assert float(res.cost[0]) == float(ref.cost) == float(oracle.cost)
    np.testing.assert_array_equal(res.service_schedules()[0], ref.r_hist)
    np.testing.assert_array_equal(ck.cost, res.cost)
    np.testing.assert_array_equal(ck.joint.r_hist, res.joint.r_hist)
    assert np.all(SV.capacity_overflow(sf, res.service_schedules()[0][None])
                  == 0.0)


@st.composite
def joint_configs(draw):
    N = draw(st.integers(1, 2))
    Ks = [draw(st.sampled_from([2, 3])) for _ in range(N)]
    cap = draw(st.sampled_from([None, 1.0, 0.75]))
    specs = []
    for K in Ks:
        M = draw(st.integers(2, 8))
        if K == 2:
            specs.append((float(M),))
        else:
            specs.append((float(M), draw(st.sampled_from([0.25, 0.5, 0.75])),
                          draw(st.sampled_from([0.1, 0.4, 0.6]))))
    seed = draw(st.integers(0, 10 ** 6))
    return specs, cap, seed


def _from_specs(C, specs):
    return tuple(C.two_level(*s) if len(s) == 1 else C.three_level(*s)
                 for s in specs)


@settings(max_examples=8, deadline=None)
@given(joint_configs())
def test_joint_dp_oracle_walk(cfg):
    specs, cap, seed = cfg
    try:
        sset = ServiceSet(_from_specs(HostingCosts, specs), capacity=cap)
    except ValueError:
        assert cap is not None        # only the all-off-infeasible reject
        with pytest.raises(ValueError):
            JSet(_from_specs(JCosts, specs), capacity=cap)
        return
    xs, c = _oracle_case(sset, 3, seed)
    got = offline_opt_joint(sset, xs, c, device=CPU)
    want = brute_force_joint_opt(sset, xs, c)
    ref = jopt_joint(JSet(_from_specs(JCosts, specs), capacity=cap), xs, c)
    assert float(got.cost) == float(want.cost) == float(ref.cost), cfg
    np.testing.assert_array_equal(got.r_hist, want.r_hist)
    np.testing.assert_array_equal(got.r_hist, ref.r_hist)


# ----------------------------------------------------------------------
# Capacity boundaries.
# ----------------------------------------------------------------------

def test_capacity_boundary_exact_and_just_over():
    svc3 = HostingCosts.three_level(2.0, 0.5, 0.4)
    at = ServiceSet((svc3, svc3), capacity=1.0)
    states = {tuple(s) for s in at.joint_states()}
    assert (1, 1) in states            # 0.5 + 0.5 == capacity: feasible
    assert (2, 1) not in states        # 1.0 + 0.5: over
    just_under = ServiceSet((svc3, svc3), capacity=0.99)
    assert (1, 1) not in {tuple(s) for s in just_under.joint_states()}
    assert at.J == len(states) == 6
    ref = JSet((JCosts.three_level(2.0, 0.5, 0.4),) * 2, capacity=1.0)
    np.testing.assert_array_equal(at.joint_states(), ref.joint_states())


def test_capacity_eps_absorbs_float_noise():
    assert 0.1 + 0.2 > 0.3
    assert CAPACITY_EPS == 1e-9
    svcs = (HostingCosts.three_level(2.0, 0.1, 0.3),
            HostingCosts.three_level(2.0, 0.2, 0.3))
    states = {tuple(s) for s in
              ServiceSet(svcs, capacity=0.3).joint_states()}
    assert (1, 1) in states
    assert (2, 0) not in states


def test_all_off_must_be_feasible():
    with pytest.raises(ValueError):
        ServiceSet((_costs(HostingCosts)[0],), capacity=-1.0)
    with pytest.raises(ValueError, match="at least one service"):
        ServiceSet(())


def test_joint_grids_match_the_reference():
    """``joint_hosting_grid`` of mixed state counts (padded with the last
    state, masked, zero fetch rows and columns), its levels, g and fetch
    matrix == the reference's; a ``ServiceSet`` and a matrix grid carried
    across from the reference (``convert``) equal the port's own."""
    Js = [1, 6, 19, 17]
    jsets = [JC.joint_set(JCosts, JSet, J) for J in Js]
    psets = [JC.joint_set(HostingCosts, ServiceSet, J) for J in Js]
    jg = jjoint_grid(jsets)
    pg = joint_hosting_grid(psets, device=CPU)
    for f in ("M", "levels", "g", "mask"):
        np.testing.assert_array_equal(getattr(pg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert pg.matrix_m and pg.K == 19
    carried = grid_from_jax(jg, CPU)
    for f in ("M", "levels", "g", "mask"):
        assert torch_equal(getattr(carried, f), getattr(pg, f)), f
    for js_, ps_ in zip(jsets, psets):
        back = service_set_from_jax(js_)
        assert back == ps_
        for f in ("joint_states", "joint_levels", "joint_g",
                  "joint_fetch_matrix"):
            np.testing.assert_array_equal(getattr(ps_, f)(),
                                          getattr(js_, f)(), err_msg=f)
    with pytest.raises(ValueError, match="J=3 < max set J 19"):
        joint_hosting_grid(psets, J=3, device=CPU)


def torch_equal(a, b):
    import torch
    return a.dtype == b.dtype and torch.equal(a, b)


def test_capacity_overflow_flags_oblivious_lanes():
    """Independent lanes under heavy arrivals both host fully; the
    diagnostic reports the excess, the joint OPT never exceeds, and the
    per-service OPT bounds it from below; each == the reference."""
    sfs = [m.service_fleet([S((C.two_level(2.0, c_min=0.05, c_max=0.1),) * 2,
                              capacity=1.0)], 24)
           for m, S, C in ((SV, ServiceSet, HostingCosts),
                           (JSV, JSet, JCosts))]
    k = jax.random.split(jax.random.PRNGKey(0), 2)
    psc = ps.combine(ps.bernoulli_arrivals(_pk(k), 0.95, 2, device=CPU),
                     ps.constant_rents(0.05, 2, device=CPU))
    jsc = js.combine(js.bernoulli_arrivals(k, 0.95, 2),
                     js.constant_rents(0.05, 2))
    sf, jsf = sfs
    res = SV.run_fleet_services(SV.alpha_rr_per_service(sf, CPU), sf,
                                scenario=psc, device=CPU)
    r = res.service_view(res.fleet.r_hist)[0, :, :, 0]
    ov = SV.capacity_overflow(sf, r)
    assert ov.max() > 0.0
    np.testing.assert_array_equal(ov, JSV.capacity_overflow(jsf, r))
    np.testing.assert_array_equal(SV.hosted_fractions(sf, r),
                                  JSV.hosted_fractions(jsf, r))
    opt = SV.offline_opt_services(sf, scenario=psc, device=CPU)
    assert np.all(SV.capacity_overflow(sf, opt.service_schedules()[0][None])
                  == 0.0)
    lane = SV.offline_opt_per_service(sf, scenario=psc, device=CPU)
    assert lane.cost.sum() <= float(opt.cost[0]) + 1e-6
    jopt = JSV.offline_opt_services(jsf, scenario=jsc)
    jlane = JSV.offline_opt_per_service(jsf, scenario=jsc)
    np.testing.assert_array_equal(opt.cost, np.asarray(jopt.cost))
    np.testing.assert_array_equal(lane.cost, np.asarray(jlane.cost))
    with pytest.raises(ValueError, match="expected B\\*N=2"):
        SV.hosted_fractions(sf, np.zeros((3, 24), np.int64))


# ----------------------------------------------------------------------
# Shared-rent tiling, trace playback, the refusals.
# ----------------------------------------------------------------------

def test_tile_services_shared_rent():
    e = _env()
    tiled = ps.tile_services(e["psc"], 2)
    x, c, _, _ = materialize(tiled, T, chunk_size=16)
    for b in range(B):
        np.testing.assert_array_equal(c[2 * b], c[2 * b + 1])
    assert any(not np.array_equal(x[2 * b], x[2 * b + 1]) for b in range(B))
    _, c1, _, _ = materialize(e["psc"], T, chunk_size=16)
    np.testing.assert_array_equal(c[0::2], c1)


def test_trace_playback_multi_service():
    rng = np.random.default_rng(9)
    T2, N = 8, 2
    pc, jc = _costs(HostingCosts), _costs(JCosts)
    ss = ServiceSet((pc[0], pc[1]), capacity=1.0)
    sf = SV.service_fleet([ss], T2)
    xs = rng.integers(0, 4, (N, T2))
    c = (rng.integers(1, 16, T2) / 8.0).astype(np.float32)
    sc = ps.trace_scenario(xs.astype(np.int32),
                           np.broadcast_to(c, (N, T2)).copy(), device=CPU)
    res = SV.offline_opt_services(sf, scenario=sc, device=CPU)
    ref = offline_opt_joint(ss, xs, c, device=CPU)
    oracle = brute_force_joint_opt(ss, xs, c)
    assert float(res.cost[0]) == float(ref.cost) == float(oracle.cost)
    np.testing.assert_array_equal(res.service_schedules()[0], ref.r_hist)
    on = SV.run_fleet_services(SV.alpha_rr_per_service(sf, CPU), sf,
                               scenario=sc, device=CPU)
    assert on.fleet.total.sum() >= float(res.cost[0])
    jsf = JSV.service_fleet([JSet((jc[0], jc[1]), capacity=1.0)], T2)
    jsc = js.trace_scenario(xs.astype(np.int32),
                            np.broadcast_to(c, (N, T2)).copy())
    want = JSV.offline_opt_services(jsf, scenario=jsc)
    _same_opt(res, want)


def test_alpha_rr_rejects_joint_grid():
    """alpha-RR and RR refuse a joint grid with the reference's message;
    the table policies' S on one waits for its ROADMAP item."""
    e = _env()
    jf = e["psf2"].joint_fleet(CPU)
    with pytest.raises(ValueError, match="fleet lane"):
        AlphaRR.fleet(jf)
    with pytest.raises(ValueError, match="fleet lane"):
        RetroRenting.batch(jf.grid)
    jsc = SV.joint_scenario(e["psf2"], e["psc2"])
    for pol in (StaticPolicy.fleet(jf, 0),
                StaticPolicy.fleet(jf, jf.grid.top_index())):
        with pytest.raises(NotImplementedError, match="Queue 1 item 19"):
            run_fleet(pol, jf, scenario=jsc, device=CPU)


def test_n2_lane_driver_invariance():
    """N = 2 lanes: chunked == streamed, == the reference's."""
    e = _env()
    pol = SV.alpha_rr_per_service(e["psf2"], CPU)
    a = SV.run_fleet_services(pol, e["psf2"], scenario=e["psc2"],
                              chunk_size=16, device=CPU)
    b = SV.run_fleet_services(pol, e["psf2"], scenario=e["psc2"],
                              chunk_size=12, stream=True, device=CPU)
    _equal_fields(b.fleet, a.fleet, "n2 chunk/stream")
    want = JSV.run_fleet_services(JSV.alpha_rr_per_service(e["jsf2"]),
                                  e["jsf2"], scenario=e["jsc2"],
                                  chunk_size=16)
    _equal_fields(a.fleet, want.fleet, "reference")
    np.testing.assert_array_equal(a.edge_total, want.edge_total)

@pytest.mark.parametrize("J", [6, 17, 32])
def test_offline_opt_batch_on_joint_grids(J):
    """``offline_opt_batch`` (D on a finished w, B, E's matrix route) on a
    joint grid == the reference's."""
    jsets = [JC.joint_set(JCosts, JSet, J)] * 3
    psets = [JC.joint_set(HostingCosts, ServiceSet, J)] * 3
    rng = np.random.default_rng(J)
    x = rng.integers(0, 6, (3, 60))
    c = rng.uniform(0.1, 0.9, (3, 60)).astype(np.float32)
    want = jopt_batch(jjoint_grid(jsets), x, c)
    got = offline_opt_batch(joint_hosting_grid(psets, device=CPU), x, c)
    np.testing.assert_array_equal(got.cost, np.asarray(want.cost))
    np.testing.assert_array_equal(got.r_hist, np.asarray(want.r_hist))
    for f in FIELDS + ["level_slots"]:
        np.testing.assert_array_equal(getattr(got.sim, f),
                                      np.asarray(getattr(want.sim, f)))


def test_joint_dp_wide_route_is_the_fused_plain_version():
    """On the CPU the DP chunk past 16 states is ``dp_fwd_model2_plain``
    itself; G's w and D on a finished w (the card's wide route, run here
    through their plain versions) give the same J and table at J = 16, 17
    and 32."""
    import torch
    from repro_torch.kernels.hosting import (dp_fwd_model2_plain,
                                             dp_minplus_plain, slab_w_plain)
    for J in (16, 17, 32):
        g = joint_hosting_grid([JC.joint_set(HostingCosts, ServiceSet, J)]
                               * 4, device=CPU)
        rng = np.random.default_rng(J)
        c = torch.from_numpy((rng.integers(0, 5, (4, 40)) / 2)
                             .astype(np.float32))
        svc = torch.from_numpy((rng.integers(0, 9, (4, 40, J)) / 2)
                               .astype(np.float32))
        T_len = torch.tensor([40, 35, 3, 0], dtype=torch.int32)
        J0 = torch.zeros((4, J))
        Jf, af = dp_fwd_model2_plain(J0, c, svc, g.levels, g.mask, g.M,
                                     T_len, 0, with_args=True)
        w = slab_w_plain(c, svc, g.levels, g.mask)
        valid = torch.arange(40, dtype=torch.int32)[None] < T_len[:, None]
        Jw, aw = dp_minplus_plain(J0, w, g.M, valid)
        assert torch.equal(Jf, Jw) and torch.equal(af, aw), J

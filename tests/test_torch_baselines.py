"""The MDP, ABC and static baselines on the port against the JAX package,
bit for bit, in both threefry layouts: the decision tables (the port's own
numpy solvers, and the reference's tables carried across with
``tree_from_numpy``), the one-instance policies' params, the table steps,
and ``run_fleet`` with MDP, ABC and static on a GE-Poisson + spot +
Model-2 scenario and on a Model-1 one (every result field, the trace
included, at a ragged chunking and mixed horizons) against the
reference's scenario-fused ``run_fleet``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import scenarios as js
from repro.core.arrivals import GilbertElliot as JGE
from repro.core.costs import HostingCosts as JCosts, HostingGrid as JGrid
from repro.core.fleet import FleetBatch as JFleet
from repro.core.fleet import run_fleet as jrun_fleet
from repro.core.policies import ABCPolicy as JABC, MDPPolicy as JMDP
from repro.core.policies import StaticPolicy as JStatic
from repro.core.policies import baselines as jb
from repro.core.policies.base import SlotObs as JObs
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.core.arrivals import GilbertElliot
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.fleet import FleetBatch, run_fleet
from repro_torch.core.policies import (ABCPolicy, MDPPolicy, SlotObs,
                                       StaticPolicy, abc_step, mdp_step,
                                       solve_abc, solve_mdp, static_step,
                                       table_init)
from repro_torch.core.policies.baselines import table_form
from repro_torch.kernels.hosting import table_step, threefry_partitionable

LAYOUTS = [True, False]
CPU = "cpu"
REGIMES = [dict(p_hl=0.4, p_lh=0.4, rate_h=200.0, rate_l=10.0),
           dict(p_hl=0.2, p_lh=0.1, rate_h=200.0, rate_l=10.0),
           dict(p_hl=0.8, p_lh=0.1, rate_h=12.0, rate_l=3.0)]
POINTS = [(50.0, 5.0), (50.0, 80.0), (10.0, 20.0), (150.0, 20.0)]
T = np.array([180, 200, 200, 133, 200, 91, 200, 200, 160, 200, 200, 200],
             np.int32)                                   # mixed horizons
N_MAX = 260


def _instances(mod_costs, mod_ge):
    """fig17_22's grid points over three regimes (the third at rates on
    both sides of 10), a K = 4 instance among them (ragged K)."""
    costs, ges, cms = [], [], []
    for kw in REGIMES:
        for i, (M, cm) in enumerate(POINTS):
            costs.append(
                mod_costs(M, (0.0, 0.16, 0.5, 1.0), (1.0, 0.76, 0.4, 0.0))
                if i == 3 else mod_costs.three_level(M, 0.16, 0.76))
            ges.append(mod_ge(emission="poisson", **kw))
            cms.append(cm)
    return costs, ges, cms


def _pk(key):
    return tree_from_numpy(np.asarray(key), CPU)


def test_tables_match_the_reference():
    """``solve_mdp`` / ``solve_abc`` == the reference's on every instance;
    the reference's batched params, carried across, == the port's; the
    one-instance policies' params."""
    jc, jg, cms = _instances(JCosts, JGE)
    pc, pg, _ = _instances(HostingCosts, GilbertElliot)
    for a, b, ga, gb, cm in zip(jc, pc, jg, pg, cms):
        assert np.array_equal(solve_mdp(b, gb, cm), jb.solve_mdp(a, ga, cm))
        assert np.array_equal(solve_abc(b, gb, cm), jb.solve_abc(a, ga, cm))
    jgrid, pgrid = JGrid.from_costs(jc), HostingGrid.from_costs(pc,
                                                                device=CPU)
    for J, P in ((JMDP, MDPPolicy), (JABC, ABCPolicy)):
        want = tree_from_numpy(jax.tree_util.tree_map(
            np.asarray, J.batch(jgrid, jc, jg, cms).params), CPU)
        got = P.batch(pgrid, pc, pg, cms).params
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k
        one = P(pc[3], pg[3], cms[3]).params_on(CPU)
        ref = J(jc[3], jg[3], cms[3]).params
        assert torch.equal(one["pi"][0], torch.from_numpy(
            np.asarray(ref["pi"])))
        if "x_threshold" in ref:
            assert one["x_threshold"].item() == float(ref["x_threshold"])


@pytest.mark.parametrize("step", ["mdp", "abc", "static"])
def test_table_steps_match_the_reference(step):
    """One step on random states and observations (side channels out of
    range are clipped, arrivals on both sides of the threshold), and
    ``table_step`` on its ``table_form`` (what kernel S's table variant
    runs) gives the same levels."""
    rng = np.random.default_rng(5)
    R, K = 64, 4
    pi = rng.integers(0, K, (R, 2, K)).astype(np.int32)
    thr = rng.choice(np.float32([6.5, 105.0, 20.0]), R)
    r = rng.integers(0, K, R).astype(np.int32)
    x = rng.integers(0, 220, R).astype(np.int32)
    side = rng.integers(-1, 4, R).astype(np.int32)
    lvl = rng.integers(0, K, R).astype(np.int32)
    jstep, pstep, params = {
        "mdp": (jb.mdp_step, mdp_step, {"pi": pi}),
        "abc": (jb.abc_step, abc_step, {"pi": pi, "x_threshold": thr}),
        "static": (jb.static_step, static_step, {"level_idx": lvl})}[step]
    want = np.asarray(jax.vmap(lambda p, s, x_, sd: jstep(
        p, {"r": s}, JObs(x_, jnp.float32(0), jnp.zeros(K), sd))["r"])(
            params, r, x, side))
    pp = tree_from_numpy(params, CPU)
    obs = SlotObs(torch.tensor(x), torch.zeros(R), torch.zeros(R, K),
                  torch.tensor(side))
    got = pstep(pp, {"r": torch.tensor(r)}, obs)["r"]
    assert np.array_equal(got.numpy(), want)
    tab, kind, th = table_form(pstep, pp, K)
    got = table_step({"pi": tab, "obs": kind, "x_threshold": th},
                     {"r": torch.tensor(r)}, obs)["r"]
    assert np.array_equal(got.numpy(), want)
    assert table_init({"pi": tab})["r"].shape == (R,)


def _scenarios(model2, grids):
    """(reference, port) scenario: GE-Poisson arrivals (per-instance
    regimes), spot rents, and Model-2 service of up to 260 requests a slot
    on the grid's g (``model2``), or Bernoulli-GE arrivals and uniform
    rents (Model 1)."""
    (jgrid, jges, cms), (pgrid, pges, _) = grids
    out = []
    for mod, grid, ges, dev in ((js, jgrid, jges, None),
                                (ps, pgrid, pges, CPU)):
        kw = {} if dev is None else {"device": dev}
        key = jax.random.PRNGKey(31)
        kx, kc, ks = jax.random.split(key, 3)
        if dev is not None:
            kx, kc, ks = _pk(kx), _pk(kc), _pk(ks)
        B = grid.B
        f32 = np.float32
        arr = lambda a: np.asarray(a, f32)              # noqa: E731
        if model2:
            sc = mod.combine(
                mod.ge_arrivals(mod.shared_keys(kx, B),
                                arr([g.p_hl for g in ges]),
                                arr([g.p_lh for g in ges]),
                                arr([g.rate_h for g in ges]),
                                arr([g.rate_l for g in ges]), B, **kw),
                mod.spot_rents(mod.shared_keys(kc, B), arr(cms), B, **kw),
                svc=mod.model2_service(mod.shared_keys(ks, B), grid.g, B,
                                       N_MAX, **kw))
        else:
            sc = mod.combine(
                mod.ge_arrivals(kx, 0.3, 0.2, 0.9, 0.2, B,
                                emission="bernoulli", **kw),
                mod.uniform_rents(kc, 0.35, 0.2, B, **kw))
        out.append(sc)
    return out


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("model2", [True, False], ids=["model2", "model1"])
def test_table_fleets_match_the_reference(model2, partitionable):
    """MDP, ABC and static (level 1, and the top level) through
    ``run_fleet`` with two seeds, chunks of 37 (so every chunk but the
    first starts on an odd slot), mixed horizons and the trace: every
    field == the reference's."""
    jc, jg, cms = _instances(JCosts, JGE)
    pc, pg, _ = _instances(HostingCosts, GilbertElliot)
    if not model2:             # Model 1 prices g * x: Bernoulli-rate GEs
        cms = [0.35 * (i % 3 + 1) for i in range(len(cms))]
    jgrid, pgrid = JGrid.from_costs(jc), HostingGrid.from_costs(pc,
                                                                device=CPU)
    jf, pf = JFleet.for_scenario(jgrid, T), FleetBatch.for_scenario(pgrid, T)
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        jsc, psc = _scenarios(model2, ((jgrid, jg, cms), (pgrid, pg, cms)))
        pols = [(JMDP.fleet(jf, jc, jg, cms), MDPPolicy.fleet(pf, pc, pg,
                                                              cms)),
                (JABC.fleet(jf, jc, jg, cms), ABCPolicy.fleet(pf, pc, pg,
                                                              cms)),
                (JStatic.fleet(jf, 1), StaticPolicy.fleet(pf, 1)),
                (JStatic.fleet(jf, jgrid.top_index()),
                 StaticPolicy.fleet(pf, pgrid.top_index()))]
        for jp, pp in pols:
            kw = dict(chunk_size=37, n_seeds=2)
            want = jrun_fleet(jp, jf, scenario=jsc, **kw)
            got = run_fleet(pp, pf, scenario=psc, device=CPU, **kw)
            for f in ("total", "rent", "service", "fetch", "r_hist",
                      "level_slots"):
                assert np.array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f))), \
                    (pp.name, f)

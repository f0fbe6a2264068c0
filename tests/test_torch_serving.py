"""The port's LM serving path against the JAX package: partial-hosting
plans, the serving engine at zamba2's tiny config (weights carried by
``params_from_jax``), the hosting controller and the edge scheduler.

The controller's and the scheduler's accounting is held bitwise (==): the
same decisions, and the same float64 sums in the same order.  Engine
logits are held to 1e-4 (fp32, the same functions summed in another
order), and argmax tokens must be equal wherever the reference's top-2
margin exceeds that tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.core import gcurve as jgc
from repro.core.costs import HostingCosts as JCosts
from repro.core.hosting_controller import HostingController as JController
from repro.core.policies import AlphaRR as JAlphaRR
from repro.core.policies import RetroRenting as JRetroRenting
from repro.models import transformer as jtf
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.partial import make_plans as jmake_plans
from repro.serve.scheduler import EdgeServingScheduler as JScheduler
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import gcurve as pgc
from repro_torch.core.costs import HostingCosts
from repro_torch.core.hosting_controller import HostingController
from repro_torch.core.policies import AlphaRR, RetroRenting
from repro_torch.core.policies.alpha_rr import alpha_rr_step
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.partial import make_plans
from repro_torch.serve.scheduler import EdgeServingScheduler

ARCH = "zamba2-1.2b"
TOL = 1e-4


@pytest.fixture(scope="module")
def engines():
    jspec = jget_arch(ARCH)
    jparams = jax.jit(jtf.init_params, static_argnums=0)(
        jspec.tiny, jax.random.PRNGKey(0))
    jeng = JEngine(jspec, params=jparams)
    peng = ServingEngine(get_arch(ARCH), device="cpu",
                         params=params_from_jax(jax.tree.map(np.asarray,
                                                             jparams),
                                         device="cpu"))
    return jeng, peng


@pytest.mark.parametrize("arch_id", ["zamba2-1.2b", "mamba2-130m",
                                     "llama3.2-3b"])
@pytest.mark.parametrize("alpha", [None, 0.25, 0.6])
def test_make_plans_match_reference(arch_id, alpha):
    pspec, jspec = get_arch(arch_id), jget_arch(arch_id)
    for pcfg, jcfg in ((None, None), (pspec.tiny, jspec.tiny)):
        pp, pg = make_plans(pspec, alpha, model_cfg=pcfg)
        jp, jg = jmake_plans(jspec, alpha, model_cfg=jcfg)
        assert pg == jg and sorted(pp) == sorted(jp)
        for lv in pp:
            a, b = pp[lv], jp[lv]
            assert (a.level, a.kind, a.n_segments, a.bytes_fraction,
                    a.g_value) == (b.level, b.kind, b.n_segments,
                                   b.bytes_fraction, b.g_value)
            assert a.expert_mask is None and b.expert_mask is None
    if alpha is None and arch_id == ARCH:     # 5 of zamba2's 13 segments
        assert make_plans(pspec)[0][0.4].n_segments == 5


def test_gcurve_copy_matches_reference():
    """The port's numpy copy of ``core/gcurve.py`` gives the reference's
    values (the expert-subset plans will draw their g(alpha) from it)."""
    alphas = [0.1, 0.25, 0.5, 0.8]
    pop = pgc.zipf_popularity(16, 1.1)
    np.testing.assert_array_equal(pop, jgc.zipf_popularity(16, 1.1))
    _, pg, pfn = pgc.moe_expert_gcurve(pop, 2, alphas, n_samples=500, seed=3)
    _, jg, jfn = jgc.moe_expert_gcurve(pop, 2, alphas, n_samples=500, seed=3)
    np.testing.assert_array_equal(pg, jg)
    for fn_p, fn_j in ((pfn, jfn), (pgc.power_gcurve(1.5),
                                    jgc.power_gcurve(1.5)),
                       (pgc.fig23_like_gcurve(), jgc.fig23_like_gcurve()),
                       (pgc.uniform_moe_gcurve_analytic(16, 2),
                        jgc.uniform_moe_gcurve_analytic(16, 2))):
        assert [fn_p(a) for a in alphas + [0.0, 1.0]] == \
            [fn_j(a) for a in alphas + [0.0, 1.0]]


@pytest.mark.parametrize("level", [0.0, 0.4, 1.0])
def test_serve_slot_matches_reference(engines, level):
    jeng, peng = engines
    plans, _ = make_plans(peng.spec, model_cfg=peng.cfg)
    jplans, _ = jmake_plans(jeng.spec, model_cfg=jeng.cfg)
    prompts = np.random.default_rng(1).integers(0, 256, (4, 8))
    rp, rj = (np.random.default_rng(2), np.random.default_rng(2))
    a = peng.serve_slot(prompts, plans[level], rp)
    b = jeng.serve_slot(prompts, jplans[level], rj)
    assert (a.n_requests, a.served_edge, a.served_partial, a.forwarded,
            a.service_cost) == (b.n_requests, b.served_edge,
                                b.served_partial, b.forwarded, b.service_cost)
    if level == 0.0:
        assert a.edge_tokens is None and b.edge_tokens is None
        return
    n_seg = plans[level].n_segments
    hid, _, _ = jtf.forward(jeng.params, jeng.cfg,
                            {"tokens": jnp.asarray(prompts)},
                            n_segments=n_seg)
    want = np.asarray(jtf.logits_fn(jeng.params, jeng.cfg, hid)[:, -1])
    np.testing.assert_allclose(peng.last_logits.numpy(), want, rtol=TOL,
                               atol=TOL)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * TOL * max(1.0, np.abs(want).max())
    assert clear.any()
    np.testing.assert_array_equal(a.edge_tokens[clear], b.edge_tokens[clear])


def _controller_run(ctrl, x, c, svc=None):
    for t, (xt, ct) in enumerate(zip(x, c)):
        ctrl.step(int(xt), float(ct), None if svc is None else svc[t])
    return ctrl


def _assert_same_accounting(p, j):
    assert p.slot == j.slot
    assert [(r.slot, r.level_idx, r.level, r.x, r.rent, r.service, r.fetch)
            for r in p.records] == \
        [(r.slot, r.level_idx, r.level, r.x, r.rent, r.service, r.fetch)
         for r in j.records]
    assert p.total_cost() == j.total_cost()
    assert p.cost_breakdown() == j.cost_breakdown()
    np.testing.assert_array_equal(p.level_histogram(), j.level_histogram())


@pytest.mark.parametrize("policy", ["alpha-RR", "RR"])
@pytest.mark.parametrize("model2", [False, True])
def test_controller_matches_reference_bitwise(policy, model2):
    pcls, jcls = ((AlphaRR, JAlphaRR) if policy == "alpha-RR"
                  else (RetroRenting, JRetroRenting))
    rng = np.random.default_rng(3)
    T = 150
    x = rng.integers(0, 4, T)
    c = rng.uniform(0.1, 2.0, T).astype(np.float32)
    costs = dict(M=6.0, alpha=0.5, g_alpha=0.25, c_min=0.1, c_max=2.0)
    p = HostingController(HostingCosts.three_level(**costs), pcls,
                          device="cpu")
    j = JController(JCosts.three_level(**costs), jcls)
    svc = None
    if model2:                       # realised per-level costs (coupled)
        u = rng.random((T, 4))
        svc = [np.array([float(np.sum(u[t, :xt] < gk))
                         for gk in p.costs.g]) for t, xt in enumerate(x)]
    _assert_same_accounting(_controller_run(p, x, c, svc),
                            _controller_run(j, x, c, svc))
    assert p.level_histogram()[1:].sum() > 0      # the policy did move


def test_alpha_rr_params_resolve_the_card_by_default():
    """One instance's params go to the CUDA card unless the caller asks
    for the CPU, as every port entry point does
    (``_device.resolve_device``); without a card that raises instead of
    falling back.  The controller builds its policy's params on its own
    device."""
    import torch
    from repro_torch.core.policies import alpha_rr_params
    costs = HostingCosts.three_level(M=6.0, alpha=0.5, g_alpha=0.25)
    for policy in (AlphaRR(costs), RetroRenting(costs)):
        if torch.cuda.is_available():
            assert policy.params["levels"].device.type == "cuda"
            assert alpha_rr_params(costs)["M"].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA card"):
                policy.params
            with pytest.raises(RuntimeError, match="CUDA card"):
                alpha_rr_params(costs)
        cpu = policy.params_on("cpu")
        assert {k: v.device.type for k, v in cpu.items()} == \
            {"M": "cpu", "levels": "cpu", "mask": "cpu"}
        assert cpu["levels"].shape == (1, policy.costs.K)
        assert policy.fns("cpu").params["levels"].device.type == "cpu"
    ctrl = HostingController(costs, device="cpu")
    assert all(v.device.type == "cpu" for v in ctrl._params.values())


def test_controller_rounds_as_the_eager_reference():
    """Finding 3: the reference's controller steps alpha-RR outside any
    jit, so ``c * lv + svc`` and the margins round twice.  On this near tie
    (probe found by search) one FMA switches to level alpha in the second
    slot and two roundings stay at level 0; the port's controller follows
    the reference, and the fused fleet step differs."""
    costs = dict(M=1.2, alpha=0.7, g_alpha=0.1)
    c = 0.08571282029151917              # a float32 value, exactly
    p = HostingController(HostingCosts.three_level(**costs), device="cpu")
    j = JController(JCosts.three_level(**costs))
    fused = HostingController(HostingCosts.three_level(**costs),
                              device="cpu")
    fused._step = alpha_rr_step
    for ctrl in (p, j, fused):
        _controller_run(ctrl, [1, 1, 1], [c, c, c])
    _assert_same_accounting(p, j)
    assert [r.level_idx for r in p.records] == [0, 0, 0]
    assert [r.level_idx for r in fused.records] == [0, 0, 1]


def test_controller_state_dict_round_trip():
    costs = HostingCosts.three_level(M=6.0, alpha=0.5, g_alpha=0.25)
    rng = np.random.default_rng(4)
    x, c = rng.integers(0, 3, 120), rng.uniform(0.1, 2.0, 120)
    whole = _controller_run(HostingController(costs, device="cpu"), x, c)
    first = _controller_run(HostingController(costs, device="cpu"),
                            x[:57], c[:57])
    resumed = HostingController(costs, device="cpu")
    resumed.load_state_dict(first.state_dict())
    _controller_run(resumed, x[57:], c[57:])
    _assert_same_accounting(resumed, whole)
    # and the port's checkpoint restores the reference's controller
    j = _controller_run(JController(JCosts.three_level(6.0, 0.5, 0.25)),
                        x[:57], c[:57])
    j.load_state_dict(first.state_dict())
    _controller_run(j, x[57:], c[57:])
    _assert_same_accounting(resumed, j)


@pytest.mark.parametrize("use_model2", [False, True])
def test_scheduler_matches_reference(engines, use_model2):
    jeng, peng = engines
    rng = np.random.default_rng(5)
    T = 30
    arrivals = rng.integers(0, 5, T)
    rents = rng.uniform(0.5, 2.5, T)
    kw = dict(M=5.0, seed=11, use_model2=use_model2)
    a = EdgeServingScheduler(peng.spec, engine=peng, **kw).run(arrivals,
                                                               rents)
    b = JScheduler(jeng.spec, engine=jeng, **kw).run(arrivals, rents)
    assert a.n_slots == b.n_slots == T
    assert a.n_requests == b.n_requests == int(arrivals.sum())
    assert (a.served_edge, a.served_partial, a.forwarded) == \
        (b.served_edge, b.served_partial, b.forwarded)
    assert a.served_edge + a.served_partial + a.forwarded == a.n_requests
    assert a.total_cost == b.total_cost and a.breakdown == b.breakdown
    np.testing.assert_array_equal(a.level_histogram, b.level_histogram)
    assert a.summary() == b.summary()

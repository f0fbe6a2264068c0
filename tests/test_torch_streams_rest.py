"""The rest of the port's scenario layer and the simulator's last helpers
against the JAX package, bit for bit (``np.array_equal``), in both
threefry layouts wherever they draw: ``slot_keys``, the adversarial baits
(streams and array builders), ``arma_rents`` at q = 1 (XLA's MA(1) op
order), the PRNG backend switch per stream family, kernel P's shaped
uniform (``jax.random.uniform(key, (n,))``), ``model2_service_matrix``,
``sim_chunk_lanes`` and ``alpha_rr_hosting``."""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import arrivals as ja
from repro.core import scenarios as js
from repro.core import simulator as jsim
from repro.core.costs import HostingCosts as JCosts
from repro.core.costs import HostingGrid as JGrid
from repro.core.policies import AlphaRR as JAlphaRR
from repro.core.policies import StaticPolicy as JStatic
from repro.core.policies.alpha_rr import alpha_rr_hosting as j_alpha_rr_hosting
from repro_torch.convert import tree_from_numpy
from repro_torch.core import arrivals as pa
from repro_torch.core import scenarios as ps
from repro_torch.core import simulator as psim
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.policies import AlphaRR, StaticPolicy, alpha_rr_hosting
from repro_torch.core.simulator import sim_acc0
from repro_torch.kernels import hosting as H

LAYOUTS = [True, False]
CPU = "cpu"
T = 300


def _pk(key):
    return tree_from_numpy(np.asarray(key), CPU)


def _both(part):
    """jax's and the port's threefry layout flags, opened together."""
    stack = contextlib.ExitStack()
    stack.enter_context(jax.threefry_partitionable(part))
    stack.enter_context(H.threefry_partitionable(part))
    return stack


def _equal(ref, got):
    if isinstance(ref, tuple):
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            _equal(r, g)
    else:
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_slot_keys_match(partitionable):
    with _both(partitionable):
        keys = jax.random.split(jax.random.PRNGKey(9), 3)
        tids = jnp.asarray([0, 1, 7, 300, 2 ** 31 - 1], jnp.int32)
        want = jax.vmap(lambda k: js.slot_keys(k, tids))(keys)
        got = ps.slot_keys(_pk(keys), torch.as_tensor(np.asarray(tids)))
        np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                      got.numpy())


def test_adversarial_baits_match():
    """Both Theorem-4 constructions: the streams at per-instance taus (one
    past the horizon, one at 0) through any chunking, and the array
    builders."""
    taus = np.array([0, 5, 64, 299, 1000], np.int32)
    bars = np.array([0, 3, 63, 250, 10], np.int32)
    for ref, got in (
            (js.adversarial_fetch_bait(taus, 5),
             ps.adversarial_fetch_bait(taus, 5, device=CPU)),
            (js.adversarial_evict_bait(bars, taus, 5),
             ps.adversarial_evict_bait(bars, taus, 5, device=CPU))):
        want = js.materialize_stream(ref, T, 64)
        for chunk in (None, 64, 97):
            _equal(want, ps.materialize_stream(got, T, chunk))
    np.testing.assert_array_equal(ja.adversarial_fetch_bait(40, T),
                                  pa.adversarial_fetch_bait(40, T, CPU))
    np.testing.assert_array_equal(ja.adversarial_evict_bait(30, 50, T),
                                  pa.adversarial_evict_bait(30, 50, T, CPU))


# ARMA at q = 1: (AR orders, rows).  p = 1 fuses the AR product into the
# add, p = 2 is fma(a1, b1, a0 * b0), p = 3 a left-to-right sum on a batch
# and an FMA chain on one row; the MA term is one FMA into the rest.
MA1_CASES = [(p, B) for p in (1, 2, 3) for B in (1, 4)]


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("p,B", MA1_CASES)
def test_arma_rents_at_q1_match_the_jitted_reference(p, B, partitionable):
    """XLA's MA(1) op order, pinned against the jitted reference's scan:
    ``x = fma(th0, eps0, phi . hist + e)`` (``phi . hist + e`` as at q >=
    2), and the one initial innovation ``sigma * (sqrt(2) * erf_inv(u))``
    rounded twice (XLA folds sigma into the sqrt(2) only for q >= 2).
    Shared and per-instance coefficients, chunked three ways."""
    rng = np.random.default_rng(10 * p + B)
    ar_shared = tuple(float(v) for v in rng.random(p) * 0.8 / p)
    ar_rows = (rng.random((B, p)) * 0.8 / p).astype(np.float32)
    ma_rows = (rng.random((B, 1)) * 0.6).astype(np.float32)
    with _both(partitionable):
        key = jax.random.PRNGKey(5 + p)
        for ar, ma in ((ar_shared, (0.4,)), (ar_rows, ma_rows)):
            ref = js.arma_rents(key, 0.35, B, ar=ar, ma=ma, sigma=0.08)
            got = ps.arma_rents(_pk(key), 0.35, B, ar=ar, ma=ma, sigma=0.08,
                                device=CPU)
            want = np.asarray(js.materialize_stream(ref, T, 64))
            for chunk in (None, 64, 97):
                np.testing.assert_array_equal(
                    ps.materialize_stream(got, T, chunk), want)


def _family(kind, key, B):
    """(reference stream, port stream) of one stream family."""
    k = _pk(key)
    return {
        "bernoulli": (js.bernoulli_arrivals(key, 0.35, B),
                      ps.bernoulli_arrivals(k, 0.35, B, device=CPU)),
        "uniform": (js.uniform_rents(key, 0.35, 0.2, B),
                    ps.uniform_rents(k, 0.35, 0.2, B, device=CPU)),
        "na": (js.na_rents(key, 0.35, 0.2, B),
               ps.na_rents(k, 0.35, 0.2, B, device=CPU)),
        "ge-bernoulli": (js.ge_arrivals(key, 0.1, 0.4, 0.9, 0.2, B,
                                        emission="bernoulli"),
                         ps.ge_arrivals(k, 0.1, 0.4, 0.9, 0.2, B,
                                        emission="bernoulli", device=CPU)),
        "ge-poisson": (js.ge_arrivals(key, 0.1, 0.4, 6.0, 1.0, B),
                       ps.ge_arrivals(k, 0.1, 0.4, 6.0, 1.0, B, device=CPU)),
        "bursty": (js.bursty_arrivals(key, B),
                   ps.bursty_arrivals(k, B, device=CPU)),
        "poisson": (js.poisson_arrivals(key, 3.0, B),
                    ps.poisson_arrivals(k, 3.0, B, device=CPU)),
        "arma": (js.spot_rents(key, 0.35, B),
                 ps.spot_rents(k, 0.35, B, device=CPU)),
    }[kind]


@pytest.mark.parametrize("kind", ["bernoulli", "uniform", "na",
                                  "ge-bernoulli", "ge-poisson", "bursty",
                                  "poisson", "arma"])
def test_pallas_backend_draws_each_family_as_the_reference(kind):
    """``with_prng_backend(stream, "pallas")`` under the default
    (partitionable) layout equals the reference's Pallas path, family by
    family: the slot uniforms (Bernoulli, uniform and NA rents, the GE
    chain and its Bernoulli emissions) in the original layout; the GE
    chain's initial draw, the Poisson emissions and the normals in the
    active one.  B = 64, so that the GE chains' initial states tell the
    layouts apart."""
    B, key = 64, jax.random.PRNGKey(3)
    ref, got = _family(kind, key, B)
    want = js.materialize_stream(js.with_prng_backend(ref, "pallas"), 200,
                                 128)
    _equal(want, ps.materialize_stream(ps.with_prng_backend(got, "pallas"),
                                       200, 128))
    _equal(js.materialize_stream(ref, 200, 128),
           ps.materialize_stream(got, 200, 128))


def test_pallas_backend_is_the_original_layout():
    """The backend's layout: ``combine(bernoulli_arrivals, uniform_rents)``,
    B = 6, T = 300, chunks of 128, keys built under the default layout:
    the "pallas" backend equals the scenario materialised under the
    original layout, and differs from it under the default, in the
    reference and in the port alike."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))

    def scen(mod, k, **kw):
        return mod.combine(mod.bernoulli_arrivals(k(k1), 0.35, 6, **kw),
                           mod.uniform_rents(k(k2), 0.35, 0.2, 6, **kw))

    for mod, k, kw in ((js, lambda a: a, {}), (ps, _pk, dict(device=CPU))):
        sc = scen(mod, k, **kw)
        pal = mod.materialize(mod.with_prng_backend(sc, "pallas"), T, 128)
        dflt = mod.materialize(sc, T, 128)
        with _both(False):
            orig = mod.materialize(sc, T, 128)
        for a, b, c in zip(pal[:2], orig[:2], dflt[:2]):
            np.testing.assert_array_equal(a, b)
            assert not np.array_equal(a, c)
    want = js.materialize(js.with_prng_backend(scen(js, lambda a: a),
                                               "pallas"), T, 128)
    got = ps.materialize(ps.with_prng_backend(
        scen(ps, _pk, device=CPU), "pallas"), T, 128)
    for a, b in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(a, b)


def test_prng_backend_names_are_checked():
    sc = ps.bernoulli_arrivals(ps.prng_key(0, CPU), 0.3, 2, device=CPU)
    assert ps.PRNG_BACKENDS == js.PRNG_BACKENDS
    assert ps.with_prng_backend(sc, "xla") is sc
    with pytest.raises(ValueError, match="prng backend"):
        ps.with_prng_backend(sc, "nope")


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_shaped_uniform_matches_jax(partitionable):
    """``jax.random.uniform(key, (n,))`` of one key: even and odd n (the
    original layout appends a 0 counter), one word, a shaped [T, R] draw
    flattened; the wrapper takes the plain version on the CPU and counts
    no launch."""
    with _both(partitionable):
        key = jax.random.PRNGKey(17)
        before = H.shaped_uniform.launches
        for shape in ((1,), (2,), (7,), (1024,), (13, 7)):
            want = np.asarray(jax.random.uniform(key, shape)).reshape(-1)
            n = int(np.prod(shape))
            np.testing.assert_array_equal(
                H.shaped_uniform(_pk(key), n).numpy(), want)
        assert H.shaped_uniform.launches == before


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_model2_service_matrix_matches(partitionable):
    """T * R odd and even, ``max_per_slot`` given and from the arrivals."""
    costs = JCosts(M=4.0, levels=(0.0, 0.3, 0.7, 1.0), g=(1.0, 0.6, 0.2, 0.0))
    pcosts = HostingCosts(M=4.0, levels=(0.0, 0.3, 0.7, 1.0),
                          g=(1.0, 0.6, 0.2, 0.0))
    rng = np.random.default_rng(4)
    with _both(partitionable):
        key = jax.random.PRNGKey(23)
        for Tn, mx, R in ((101, 5, 7), (64, 6, None), (33, 2, 3)):
            x = rng.integers(0, mx + 1, Tn).astype(np.int32)
            want = np.asarray(jsim.model2_service_matrix(key, costs, x, R))
            got = psim.model2_service_matrix(_pk(key), pcosts, x, R,
                                             device=CPU)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


def test_alpha_rr_hosting_matches():
    costs = JCosts(M=6.0, levels=(0.0, 0.4, 1.0), g=(1.0, 0.5, 0.0))
    pcosts = HostingCosts(M=6.0, levels=(0.0, 0.4, 1.0), g=(1.0, 0.5, 0.0))
    rng = np.random.default_rng(8)
    x = rng.integers(0, 3, T).astype(np.int32)
    c = rng.uniform(0.1, 0.6, T).astype(np.float32)
    svc = rng.integers(0, 3, (T, 3)).astype(np.float32)
    for kw in ({}, dict(svc=svc)):
        np.testing.assert_array_equal(
            np.asarray(j_alpha_rr_hosting(costs, x, c, **kw)),
            alpha_rr_hosting(pcosts, x, c, device=CPU, **kw))


# sim_chunk_lanes: an alpha-RR lane of 3 levels, a static lane of 3 (held
# at 0.35, whose rent products round) and an alpha-RR lane of 5, over one
# shared slab of R rows
LANES = (((0.0, 0.3, 1.0), (1.0, 0.6, 0.0), 2.5),
         ((0.0, 0.35, 1.0), (1.0, 0.55, 0.0), 4.0),
         ((0.0, 0.2, 0.45, 0.7, 1.0), (1.0, 0.75, 0.5, 0.2, 0.0), 8.0))


def _lane_policies(R):
    """Each lane's [R]-row policy, reference and port."""
    js_, ps_ = [], []
    for i, (lv, g, M) in enumerate(LANES):
        jg = JGrid.from_costs([JCosts(M=M, levels=lv, g=g)] * R)
        pg = HostingGrid.from_costs([HostingCosts(M=M, levels=lv, g=g)] * R,
                                    device=CPU)
        if i == 1:
            js_.append(JStatic.batch(jg, 1))
            ps_.append(StaticPolicy.batch(pg, 1))
        else:
            js_.append(JAlphaRR.batch(jg))
            ps_.append(AlphaRR.batch(pg))
    return js_, ps_


@pytest.mark.parametrize("R", [2, 12])
def test_sim_chunk_lanes_matches(R):
    """Two chunks of the fan-out's lane step, carries threaded, the
    horizons mixed: the reference's per-instance ``sim_chunk_lanes`` under
    ``jit(vmap)`` (as its fan-out cores run it) against the port's
    batched one; each lane's service costs its own Model-1 ``x * g``.
    At R = 2 the small-batch fusion applies to the static lane."""
    rng = np.random.default_rng(R)
    chunk = 64
    x = rng.integers(0, 3, (R, 2 * chunk)).astype(np.int32)
    c = rng.uniform(0.1, 0.6, (R, 2 * chunk)).astype(np.float32)
    side = np.zeros((R, 2 * chunk), np.int32)
    T_len = rng.integers(chunk // 2, 2 * chunk + 1, R).astype(np.int32)
    jpols, ppols = _lane_policies(R)
    lvs = [np.asarray(lv, np.float32) for lv, _, _ in LANES]
    gs = [np.asarray(g, np.float32) for _, g, _ in LANES]
    Ms = [np.float32(M) for _, _, M in LANES]
    steps = tuple(f.step_fn for f in jpols)

    def one(params, carries, T_len, t0, x, c, side):
        svcs = tuple(x.astype(jnp.float32)[:, None] * g[None, :] for g in gs)
        return jsim.sim_chunk_lanes(
            steps, True, params, tuple(jnp.asarray(lv) for lv in lvs),
            tuple(jnp.asarray(M) for M in Ms), T_len, t0, carries, x, c,
            svcs, side)

    run = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, None, 0, 0, 0)))
    jcar = tuple((jax.vmap(f.init_fn)(f.params), jax.vmap(
        lambda _: jsim.sim_acc0(len(lv), jnp.float32))(jnp.arange(R)))
        for f, lv in zip(jpols, lvs))
    pcar = tuple((f.init_fn(f.params), sim_acc0(R, len(lv), CPU))
                 for f, lv in zip(ppols, lvs))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    for i in range(2):
        sl = slice(i * chunk, (i + 1) * chunk)
        jcar, jr = run(tuple(f.params for f in jpols), jcar, jnp.asarray(T_len), i * chunk,
                       x[:, sl], c[:, sl], side[:, sl])
        pcar, pr = psim.sim_chunk_lanes(
            tuple(f.step_fn for f in ppols), True,
            tuple(f.params for f in ppols),
            tuple(t(lv)[None].expand(R, -1).contiguous() for lv in lvs),
            tuple(torch.full((R,), float(M)) for M in Ms), t(T_len),
            i * chunk, pcar, t(x[:, sl]), t(c[:, sl]),
            tuple(psim.model1_svc(t(x[:, sl]),
                                  t(g)[None].expand(R, -1).contiguous())
                  for g in gs), t(side[:, sl]))
        for p in range(len(LANES)):
            np.testing.assert_array_equal(np.asarray(jr[p]), pr[p].numpy())
            for f in ("sums", "counts"):
                np.testing.assert_array_equal(np.asarray(jcar[p][1][f]),
                                              pcar[p][1][f].numpy())

"""The DP forward chunk (kernel D's plain version and the cost assembly
around it) and the batched offline OPT against the JAX package, bitwise."""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.costs import HostingCosts as JCosts, HostingGrid as JGrid
from repro_torch.core.costs import HostingCosts, HostingGrid
from repro_torch.core.policies import offline_opt as popt
from repro_torch.kernels import hosting as phost

# the module (repro.core.policies re-exports a function of the same name)
jopt = importlib.import_module("repro.core.policies.offline_opt")
CPU = "cpu"


def _ref_chunk(J, tids, c, svc, lv, kmask, M, T_len):
    f = jax.jit(jax.vmap(
        lambda J, c, s, lv, km, m, tl: jopt.dp_fwd_chunk(
            J, jnp.asarray(tids), c, s, lv, km, jopt.dp_fetch_matrix(m, lv),
            tl, backend="xla")))
    J2, args = f(J, c, svc, lv, kmask, M, T_len)
    return np.asarray(J2), np.asarray(args)


def _port_chunk(J, tids, c, svc, lv, kmask, M, T_len):
    t = torch.from_numpy
    J2, args = popt.dp_fwd_chunk(
        t(J), t(tids), t(c), t(svc), t(lv), t(kmask),
        popt.dp_fetch_matrix(t(M), t(lv)), t(T_len))
    return J2.numpy(), args.numpy()


def _case(rng, R, chunk, K, grid_values: bool):
    """Random chunk inputs: mixed K (padded levels masked), rows frozen
    part-way (T_len inside the chunk), rows whose frontier is all +inf, and
    -- with ``grid_values`` -- costs on a half-integer grid, so that equal
    transition costs (argmin ties) are common."""
    k_eff = rng.integers(2, K + 1, R)
    kmask = np.arange(K)[None, :] < k_eff[:, None]
    lv = np.ones((R, K), np.float32)
    for i, k in enumerate(k_eff):
        lv[i, :k] = np.linspace(0.0, 1.0, k)
    if grid_values:
        lv = np.round(lv * 2) / 2
        c = rng.integers(0, 4, (R, chunk)).astype(np.float32) / 2
        svc = rng.integers(0, 4, (R, chunk, K)).astype(np.float32) / 2
        M = rng.integers(1, 4, R).astype(np.float32)
    else:
        c = (rng.random((R, chunk)) * 1.5).astype(np.float32)
        svc = (rng.integers(0, 3, (R, chunk, 1))
               * (1.0 - lv[:, None, :]) * 0.9).astype(np.float32)
        M = (rng.random(R) * 20 + 0.5).astype(np.float32)
    J = (rng.random((R, K)) * 3).astype(np.float32)
    J[0] = np.inf                                     # all-+inf columns
    J[1, 1:] = np.inf
    J = np.where(kmask, J, np.inf).astype(np.float32)
    t0 = 100
    tids = (t0 + np.arange(chunk)).astype(np.int32)
    T_len = rng.integers(t0 - 5, t0 + chunk + 5, R).astype(np.int32)
    return J, tids, c, svc, lv.astype(np.float32), kmask, M, T_len


@pytest.mark.parametrize("grid_values", [False, True])
def test_dp_fwd_chunk_matches_reference(grid_values):
    rng = np.random.default_rng(7 + grid_values)
    args = _case(rng, R=6, chunk=128, K=5, grid_values=grid_values)
    J_ref, a_ref = _ref_chunk(*args)
    J_got, a_got = _port_chunk(*args)
    np.testing.assert_array_equal(J_ref, J_got)
    np.testing.assert_array_equal(a_ref, a_got)
    if grid_values:   # the case really has ties between predecessors
        J = args[0]
        fetch = popt.dp_fetch_matrix(torch.from_numpy(args[6]),
                                     torch.from_numpy(args[4])).numpy()
        trans = J[:, :, None] + fetch
        assert (np.sort(trans, axis=1)[:, 0] == np.sort(trans, axis=1)[:, 1]
                ).any()


def test_dp_minplus_wrapper_is_the_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    J, tids, c, svc, lv, kmask, M, T_len = _case(rng, 4, 64, 3, True)
    t = torch.from_numpy
    w = torch.where(t(kmask)[:, None, :],
                    t(c)[:, :, None] * t(lv)[:, None, :] + t(svc),
                    float("inf"))
    fetch = popt.dp_fetch_matrix(t(M), t(lv))
    valid = t(tids)[None, :] < t(T_len)[:, None]
    before = phost.dp_minplus.launches
    J1, a1 = phost.dp_minplus(t(J), w, fetch, valid)
    J2, a2 = phost.dp_minplus_plain(t(J), w, fetch, valid)
    assert torch.equal(J1, J2) and torch.equal(a1, a2)
    assert phost.dp_minplus.launches == before
    # frozen slots write the identity and keep J
    frozen = ~valid.numpy()
    assert (a1.numpy()[frozen] == np.arange(3)).all()


def _model1_case(rng, R, chunk, K, grid_values: bool):
    """``_case``'s chunk with Model-1 service: arrivals ``x`` and a per-row
    ``g`` in place of ``svc``; returns ``(J, tids, c, x, g, lv, kmask, M,
    T_len)`` and the Model-1 ``svc`` the reference is handed."""
    J, tids, c, _, lv, kmask, M, T_len = _case(rng, R, chunk, K, grid_values)
    x = rng.integers(0, 4, (R, chunk)).astype(np.int32)
    if grid_values:
        g = (rng.integers(0, 3, (R, K)) / 2).astype(np.float32)
    else:
        g = np.clip(0.9 - lv, 0.0, 1.0).astype(np.float32)
        g[:, 0] = 1.0
    # Model 1, as the reference's fleet prices it: float32(x) * g
    svc = (x[:, :, None].astype(np.float32) * g[:, None, :]).astype(
        np.float32)
    return (J, tids, c, x, g, lv, kmask, M, T_len), svc


@pytest.mark.parametrize("with_args", [False, True])
@pytest.mark.parametrize("grid_values", [False, True])
def test_dp_fwd_model1_plain_matches_reference(grid_values, with_args):
    """The fused kernel D's plain version, given ``x`` and ``g`` in place of
    ``svc``, is bitwise the reference's ``dp_fwd_chunk(backend="xla")``
    under Model-1 ``sck``: mixed K, horizons ending inside the chunk,
    all-+inf frontiers, and (``grid_values``) tied predecessors.  J does
    not depend on whether the argmin table is asked for."""
    rng = np.random.default_rng(17 + grid_values)
    (J, tids, c, x, g, lv, kmask, M, T_len), svc = _model1_case(
        rng, R=7, chunk=96, K=5, grid_values=grid_values)
    J_ref, a_ref = _ref_chunk(J, tids, c, svc, lv, kmask, M, T_len)
    t = torch.from_numpy
    fetch = popt.dp_fetch_matrix(t(M), t(lv))
    J_got, a_got = phost.dp_fwd_model1_plain(
        t(J), t(c), t(x), t(g), t(lv), t(kmask), fetch, t(T_len),
        int(tids[0]), with_args)
    np.testing.assert_array_equal(J_ref, J_got.numpy())
    if with_args:
        np.testing.assert_array_equal(a_ref, a_got.numpy())
    else:
        assert a_got is None
    assert (T_len < tids[-1]).any()             # horizons inside the chunk
    assert np.isinf(J_ref[0]).all()


def test_dp_fwd_model1_is_dp_fwd_chunk_on_model1_costs():
    """The fleet's Model-1 chunk (the fused kernel D's wrapper) and the
    general chunk agree bit for bit, J and argmins, and the wrapper takes
    the plain version on the CPU without touching any launch counter."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(23)
    (J, tids, c, x, g, lv, kmask, M, T_len), svc = _model1_case(
        rng, R=5, chunk=40, K=4, grid_values=True)
    t = torch.from_numpy
    fetch = popt.dp_fetch_matrix(t(M), t(lv))
    before = [k.launches for k in ops.KERNELS]
    J1, a1 = phost.dp_fwd_model1(t(J), t(c), t(x), t(g), t(lv), t(kmask),
                                 fetch, t(T_len), int(tids[0]),
                                 with_args=True)
    J2, a2 = popt.dp_fwd_chunk(t(J), t(tids), t(c), t(svc), t(lv),
                               t(kmask), fetch, t(T_len))
    assert torch.equal(J1, J2) and torch.equal(a1, a2)
    J3, a3 = phost.dp_fwd_model1(t(J), t(c), t(x), t(g), t(lv), t(kmask),
                                 fetch, t(T_len), int(tids[0]))
    assert torch.equal(J1, J3) and a3 is None
    assert [k.launches for k in ops.KERNELS] == before


def _grid_pair(rng, B):
    spec = []
    for i in range(B):
        if i % 3 == 2:
            spec.append((float(rng.uniform(2, 20)), (0.0, 0.25, 0.5, 1.0),
                         (1.0, 0.7, 0.4, 0.0)))
        else:
            a = float(rng.uniform(0.1, 0.7))
            spec.append((float(rng.uniform(2, 20)), (0.0, a, 1.0),
                         (1.0, max(0.9 - a, 0.0), 0.0)))
    ref = JGrid.from_costs([JCosts(M=m, levels=lv, g=g) for m, lv, g in spec])
    got = HostingGrid.from_costs([HostingCosts(M=m, levels=lv, g=g)
                                  for m, lv, g in spec], device=CPU)
    return ref, got


def test_offline_opt_batch_matches_reference():
    rng = np.random.default_rng(11)
    B, T = 6, 200
    jgrid, pgrid = _grid_pair(rng, B)
    x = rng.integers(0, 3, (B, T)).astype(np.int32)
    c = (rng.random((B, T)) * 1.2).astype(np.float32)
    ref = jopt.offline_opt_batch(jgrid, x, c)
    got = popt.offline_opt_batch(pgrid, torch.from_numpy(x),
                                 torch.from_numpy(c))
    np.testing.assert_array_equal(ref.cost, got.cost)
    np.testing.assert_array_equal(ref.r_hist, got.r_hist)
    for f in ("total", "rent", "service", "fetch", "level_slots"):
        np.testing.assert_array_equal(getattr(ref.sim, f),
                                      getattr(got.sim, f))
    assert pgrid.k_eff().tolist() == [3, 3, 4, 3, 3, 4]
    assert pgrid.top_index().tolist() == [2, 2, 3, 2, 2, 3]

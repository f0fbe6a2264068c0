"""Kernel D on a finished w (``dp_minplus``) and kernel S's gather route
at the edges of their tiling: their plain versions, which the card holds
the kernels to, bit for bit against the JAX package on the CPU.

D: ``dp_minplus_plain``, and the wrapper ``hosting.dp_minplus``, which
takes it on CPU tensors, at K = 1, 2, 3, 4, 5, 8, 9, 16, 17, 31 and 32
(D's instances of one K, the first of its bands of 12 to 32 and the
bands' edges), at chunks of 1, TILE - 1, TILE, TILE + 1, 1,000 and 1,001
slots (TILE, the kernel's tile at that K: ``_table_tiles.DPM_TILE``), on
1, 31 and 33 rows (the CTA's 32 rows and a row either side).  Prefix
masks (``t < T_len``) meet the reference's ``offline_opt.dp_fwd_chunk``
(its XLA scan); masks with holes meet the Pallas kernel ``dp_minplus_kc``
itself, run in interpret mode.  Costs lie on a coarse grid, so that ties
in ``trans`` are common; rows whose frontier is all +inf give all-+inf
columns, and masked levels are priced +inf.

S: ``sim_chunk_alpha_rr_svc_plain`` meets the reference's
``simulator.sim_chunk_core`` stepping ``alpha_rr_step``, vmapped over
rows, on a 31-level service slab through lanes of 2, 3 and 8 levels'
column maps (``beyond_knapsack_levels``' lanes), on 1, 4, 5 and 31 rows
(the few rows of the study's call, which S's gather route takes on
lanes over its levels from 4 levels), the trace on and off, the final fetch kept and dropped,
ragged chunks from an odd t0, horizons inside the chunk, from a carry in
mid-run, half the cases on a grid of eighths (ties between margins).  On
one row of at most 8 levels the reference fuses the rent's
product into its sum (``simulator.xla_acc_fma``), and the plain version
is asked to as well."""
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.policies.alpha_rr import alpha_rr_step as j_alpha_rr_step
from repro.core.policies.offline_opt import dp_fwd_chunk as j_dp_fwd_chunk
from repro.core.simulator import sim_chunk_core as j_sim_chunk_core
from repro.kernels.hosting import dp_minplus_kc
from repro_torch.core import simulator as psim
from repro_torch.core.policies.alpha_rr import alpha_rr_step
from repro_torch.core.policies.offline_opt import dp_fetch_matrix
from repro_torch.kernels import hosting as H
import _table_tiles as T

# ----------------------------------------------------------------------
# D on a finished w
# ----------------------------------------------------------------------

_KS = (1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32)
_RS = (1, 31, 33)


def _chunks(K):
    tile = T.DPM_TILE[K]
    return (1, tile - 1, tile, tile + 1, 1000, 1001)


# (R, chunk, K, mask): every chunk of every K, the rows cycled over _RS,
# prefix masks and masks with holes in turns
_D_CASES = [(_RS[(ki + ci) % 3], chunk, K, ("prefix", "holes")[ci % 2])
            for ki, K in enumerate(_KS) for ci, chunk in enumerate(_chunks(K))]

_T0 = 100

_dp_ref = jax.jit(jax.vmap(j_dp_fwd_chunk,
                           in_axes=(0, None, 0, 0, 0, 0, 0, 0)))
_kc_ref = jax.jit(jax.vmap(partial(dp_minplus_kc, interpret=True)))


def _d_case(R, chunk, K, seed):
    """D's inputs in numpy: rents on a quarter grid and levels on an
    eighth grid (their products exact, so w is the same however it is
    rounded), random service, a frontier on a half grid with all-+inf
    rows, masked levels past each row's level count, horizons inside the
    chunk and a mask with holes."""
    rng = np.random.default_rng(seed)
    k_eff = rng.integers(1, K + 1, R)
    kmask = np.arange(K)[None, :] < k_eff[:, None]
    lv = np.sort(rng.integers(0, 9, (R, K)) / 8, axis=1).astype(np.float32)
    M = rng.integers(1, 4, R).astype(np.float32)
    c = (rng.integers(0, 8, (R, chunk)) / 4).astype(np.float32)
    svc = (rng.random((R, chunk, K)) * 2).astype(np.float32)
    J = (rng.integers(0, 8, (R, K)) / 2).astype(np.float32)
    J[1::5] = np.inf                                  # all-+inf columns
    J[2::5, 1:] = np.inf
    J = np.where(kmask, J, np.inf).astype(np.float32)
    T_len = rng.integers(_T0 - 2, _T0 + chunk + 3, R).astype(np.int32)
    holes = rng.random((R, chunk)) < 0.7
    t = torch.from_numpy
    fetch = dp_fetch_matrix(t(M), t(lv)).numpy()
    w = torch.where(t(kmask)[:, None, :], t(c)[:, :, None]
                    * t(lv)[:, None, :] + t(svc), float("inf")).numpy()
    return dict(J=J, c=c, svc=svc, lv=lv, kmask=kmask, fetch=fetch,
                T_len=T_len, holes=holes, w=w)


def test_d_edges_follow_the_tiling():
    """The cases sit where they say: every K of the list, each at a slot
    either side of its tile, 1,000 and 1,001 slots and one slot, on 1, 31
    and 33 rows, with both kinds of mask; at K = 32 the tile is 4 slots."""
    for K in _KS:
        got = {chunk for _, chunk, k, _ in _D_CASES if k == K}
        assert got == set(_chunks(K)), K
        assert {mask for _, _, k, mask in _D_CASES if k == K} == {
            "prefix", "holes"}
    assert {R for R, *_ in _D_CASES} == set(_RS)
    assert T.DPM_TILE[32] == 4 and min(T.DPM_TILE.values()) == 4


def test_d_cases_have_ties_and_all_inf_columns():
    """The generator's frontiers meet ties between predecessors and rows
    whose every column is +inf."""
    d = _d_case(33, 4, 8, 0)
    trans = d["J"][:, :, None] + d["fetch"]
    low = np.sort(trans, axis=1)
    assert ((low[:, 0] == low[:, 1]) & np.isfinite(low[:, 0])).any()
    assert np.isinf(trans).all(axis=(1, 2)).any()


@pytest.mark.parametrize("R,chunk,K,mask", _D_CASES)
def test_dp_minplus_plain_matches_the_reference(R, chunk, K, mask):
    """``dp_minplus_plain`` and the wrapper on CPU tensors == the
    reference: the frontier after the chunk and the argmin table (the
    identity on invalid slots)."""
    d = _d_case(R, chunk, K, R * 10_000 + chunk * 40 + K)
    tids = (_T0 + np.arange(chunk)).astype(np.int32)
    j = jnp.asarray
    if mask == "prefix":
        valid = tids[None, :] < d["T_len"][:, None]
        J_ref, a_ref = _dp_ref(j(d["J"]), j(tids), j(d["c"]), j(d["svc"]),
                               j(d["lv"]), j(d["kmask"]), j(d["fetch"]),
                               j(d["T_len"]))
    else:
        valid = d["holes"]
        J_ref, a_ref = _kc_ref(j(d["J"]), j(d["w"]), j(d["fetch"]),
                               j(valid))
    t = torch.from_numpy
    args = (t(d["J"]), t(d["w"]), t(d["fetch"]), t(valid))
    before = H.dp_minplus.launches
    for fn in (H.dp_minplus_plain, H.dp_minplus):
        J2, a2 = fn(*args)
        np.testing.assert_array_equal(np.asarray(J_ref), J2.numpy())
        np.testing.assert_array_equal(np.asarray(a_ref), a2.numpy())
    assert H.dp_minplus.launches == before


# ----------------------------------------------------------------------
# S's gather route: alpha-RR on a 31-level slab, few rows
# ----------------------------------------------------------------------

_KF = 31
# (R, K, trace, chunk, include_final_fetch)
_S_CASES = [(R, K, trace, (1, 17, 333, 1001)[(ri + ki) % 4],
             (ri + ki + trace) % 2 == 0)
            for ri, R in enumerate((1, 4, 5, 31))
            for ki, K in enumerate((2, 3, 8)) for trace in (True, False)]


@lru_cache(maxsize=None)
def _sim_ref(include_final_fetch):
    core = partial(j_sim_chunk_core, j_alpha_rr_step, include_final_fetch)
    return jax.jit(jax.vmap(core, in_axes=(0, 0, 0, 0, None, 0, 0, 0, 0,
                                           0)))


def _s_case(R, K, chunk, seed, grid):
    """S's inputs in numpy: each row's K levels (the first 0, the last 1),
    its column map into a 31-level slab (the first and last columns
    always among them), the slab, rents, horizons inside the chunk, and a
    carry in mid-run (a held level, suffix minima, ages, sums, counts);
    ``grid``: the levels, the slab, the rents and the suffix minima on a
    grid of eighths, where margins tie and the first index must win."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        if grid:
            return (rng.integers(0, 9, shape) / 8).astype(np.float32)
        return rng.random(shape).astype(np.float32)

    lv = np.sort(draw(R, K), axis=1)
    lv[:, 0], lv[:, -1] = 0.0, 1.0
    cols = np.stack([np.sort(np.concatenate(
        ([0, _KF - 1], rng.choice(np.arange(1, _KF - 1), K - 2,
                                  replace=False)))) for _ in range(R)])
    slab = (draw(R, chunk, _KF) * 3).astype(np.float32)
    c = (draw(R, chunk) * 1.5).astype(np.float32)
    t0 = 4001
    return dict(
        lv=lv, M=(rng.random(R) * 20 + 0.5).astype(np.float32),
        cols=cols.astype(np.int32), slab=slab, c=c, t0=t0,
        T_len=rng.integers(t0 - 3, t0 + chunk + 3, R).astype(np.int32),
        r=rng.integers(0, K, R).astype(np.int32),
        S=np.where(rng.random((R, K)) < 0.3, np.float32(3.4e38),
                   (draw(R, K) * 4 - 2).astype(np.float32)),
        age=rng.integers(0, 4, R).astype(np.int32),
        sums=(rng.random((R, 3)) * 100).astype(np.float32),
        counts=rng.integers(0, 50, (R, K)).astype(np.int32))


@pytest.mark.parametrize("R,K,trace,chunk,iff", _S_CASES)
def test_gather_route_plain_matches_the_reference(R, K, trace, chunk, iff):
    """``sim_chunk_alpha_rr_svc_plain`` on a 31-level slab through a
    lane's column map == the reference's ``sim_chunk_core`` stepping
    ``alpha_rr_step`` on the lane's gathered columns: the policy state
    after the chunk, the three sums, the counts and the trace."""
    d = _s_case(R, K, chunk, R * 100 + K * 10 + chunk + trace, grid=iff)
    j = jnp.asarray
    svc = np.take_along_axis(d["slab"], d["cols"][:, None, :], axis=2)
    params = {"levels": d["lv"], "mask": np.ones((R, K), bool), "M": d["M"]}
    state = {"r": d["r"], "S": d["S"], "age": d["age"]}
    acc = {"sums": d["sums"], "counts": d["counts"]}
    zeros = np.zeros((R, chunk), np.int32)
    (want_st, want_acc), want_r = _sim_ref(iff)(
        {k: j(v) for k, v in params.items()}, j(d["lv"]), j(d["M"]),
        j(d["T_len"]), d["t0"],
        ({k: j(v) for k, v in state.items()},
         {k: j(v) for k, v in acc.items()}),
        j(zeros), j(d["c"]), j(svc), j(zeros))
    t = torch.from_numpy
    (st, ac), r = H.sim_chunk_alpha_rr_svc_plain(
        {k: t(v) for k, v in params.items()}, t(d["lv"]), t(d["M"]),
        t(d["T_len"]), d["t0"],
        ({k: t(v) for k, v in state.items()},
         {k: t(v) for k, v in acc.items()}),
        t(d["c"]), t(d["slab"]), t(d["cols"]), iff, trace,
        psim.xla_acc_fma(alpha_rr_step, R, K, iff))
    for k in want_st:
        np.testing.assert_array_equal(np.asarray(want_st[k]), st[k].numpy())
    for k in want_acc:
        np.testing.assert_array_equal(np.asarray(want_acc[k]),
                                      ac[k].numpy())
    if trace:
        np.testing.assert_array_equal(np.asarray(want_r), r.numpy())
    else:
        assert r is None

"""Kernel S's table variant and kernel D's ARGS route at the edges of the
kernels' tiling: their plain versions, bit for bit against the JAX package
on the CPU.

``sim_chunk_table_plain`` / ``sim_chunk_table_svc_plain`` (the static, MDP
and ABC tables) and ``dp_fwd_model1_plain`` / ``dp_fwd_model2_plain`` with
``with_args=True`` are what the card holds S's table variant and D's ARGS
route to.  Here they meet the reference's own per-instance functions,
``simulator.sim_chunk_core`` stepping ``static_step`` / ``mdp_step`` /
``abc_step`` and ``offline_opt.dp_fwd_chunk``, run under
``jax.jit(jax.vmap(...))``, at the shapes where the kernels' tiles and
rings turn over (``hosting.cu``: ``SimSmem``, ``DpSmem``; the sizes in
``tests/_table_tiles.py``): a slot either side of a tile and of the
ring's worth of tiles, ``chunk % 4 != 0`` (the 4-byte routes), whole
16-byte groups past the ring, one slot, K = 2, 3, 5 and 16, Model 1 and
Model-2 slabs with and without a column map, horizons that end inside the
chunk (frozen tails), side channels outside [0, 1] (clipped), the final
fetch kept and dropped.  Every batch here is wide enough (R * (K + 3) >
40) that the reference's vmapped scan does not fuse a sum's product into
its add (``simulator.xla_acc_fma``)."""
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.policies import baselines as jb
from repro.core.policies.offline_opt import dp_fwd_chunk as j_dp_fwd_chunk
from repro.core.simulator import sim_chunk_core as j_sim_chunk_core
from repro_torch.core import simulator as psim
from repro_torch.core.policies import abc_step, mdp_step, static_step
from repro_torch.core.policies.baselines import table_form
from repro_torch.core.policies.offline_opt import dp_fetch_matrix
from repro_torch.kernels import hosting as H
import _table_tiles as T

# S's tiles and rings at K = 3 (Model 1, a Model-2 slab), D's
_MT, _ST = T.SIM_TILE[(3, "model1")], T.SIM_TILE[(3, "model2")]
_MR = T.SIM_STAGES[(3, "model1")] * _MT
_SR = T.SIM_STAGES[(3, "model2")] * _ST
_DT = T.DP_TILE[3]
_DR = T.DP_ARGS_STAGES[(3, "model1")] * _DT

_S_CASES = [
    # (R, chunk, K, service, include_final_fetch).  Model 1 at K = 3: a
    # slot either side of a tile and of the ring (chunk % 4 != 0: the
    # 4-byte route)
    (37, _MT - 1, 3, "model1", True), (37, _MT + 1, 3, "model1", False),
    (37, _MR - 1, 3, "model1", False), (37, _MR + 1, 3, "model1", True),
    # a Model-2 slab at K = 3 likewise, and whole 16-byte groups past the
    # ring with a column map (the bulk route at odd R)
    (35, _ST - 1, 3, "model2", False), (35, _ST + 1, 3, "model2", True),
    (35, _SR - 1, 3, "model2", True), (35, _SR + 1, 3, "model2", False),
    (33, _SR + 4, 3, "model2-cols", True),
    # one slot; K = 2; K = 5 and 16 a slot past whole tiles
    (29, 1, 3, "model1", False), (37, 2 * _MT + 2, 2, "model1", True),
    (13, 4 * T.SIM_TILE[(5, "model2")] + 1, 5, "model2", True),
    (9, 3 * T.SIM_TILE[(16, "model2")] + 1, 16, "model2", False),
    (9, T.SIM_TILE[(16, "model1")] + 1, 16, "model1", True)]

_D_CASES = [
    # (R, chunk, K, service): a slot either side of a tile and of the
    # argmin table's ring (chunk % 4 != 0: the 4-byte write-back), whole
    # 16-byte groups either side of the ring (the bulk copies), one slot,
    # K = 5 and 16 a slot either side of whole tiles
    (37, _DT - 1, 3, "model1"), (37, _DT + 1, 3, "model1"),
    (37, _DR - 1, 3, "model1"), (37, _DR + 1, 3, "model1"),
    (33, _DR + 4, 3, "model2"), (33, _DR - 4, 3, "model2-cols"),
    (29, 1, 3, "model1"), (13, 4 * T.DP_TILE[5] + 1, 5, "model1"),
    (9, 3 * T.DP_TILE[16] - 1, 16, "model2"),
    (9, 2 * T.DP_TILE[16] + 1, 16, "model1")]

_STEPS = {"static": (static_step, jb.static_step),
          "mdp": (mdp_step, jb.mdp_step), "abc": (abc_step, jb.abc_step)}


@lru_cache(maxsize=None)
def _sim_ref(policy, include_final_fetch):
    core = partial(j_sim_chunk_core, _STEPS[policy][1], include_final_fetch)
    return jax.jit(jax.vmap(core, in_axes=(0, 0, 0, 0, None, 0, 0, 0, 0,
                                           0)))


def _dp_model1(J, tids, c, x, g, lv, kmask, fetch, T_len):
    # the Model-1 service x * g formed inside the jitted call, as the
    # reference's fleet cores form it (XLA contracts c * lv + x * g into
    # one FMA there; handed a finished service array it may not)
    return j_dp_fwd_chunk(J, tids, c, x.astype(jnp.float32)[:, None]
                          * g[None, :], lv, kmask, fetch, T_len)


_dp_ref = {"model1": jax.jit(jax.vmap(_dp_model1, in_axes=(
               0, None, 0, 0, 0, 0, 0, 0, 0))),
           "model2": jax.jit(jax.vmap(j_dp_fwd_chunk, in_axes=(
               0, None, 0, 0, 0, 0, 0, 0)))}


def test_edges_follow_the_tiling():
    """The shapes below sit where they say: S's a slot either side of its
    tile and its ring at K = 3 under Model 1 and on a Model-2 slab, whole
    16-byte groups past the ring at odd R, one slot, K = 2, 5 and 16, the
    final fetch kept and dropped; D's a slot either side of its tile and
    of the argmin table's ring, chunk % 4 of 0 to 3, K = 5 and 16."""
    m1 = {chunk for _, chunk, K, kind, _ in _S_CASES
          if K == 3 and kind == "model1"}
    assert {_MT - 1, _MT + 1, _MR - 1, _MR + 1, 1} <= m1
    m2 = {chunk for _, chunk, K, kind, _ in _S_CASES
          if K == 3 and kind == "model2"}
    assert {_ST - 1, _ST + 1, _SR - 1, _SR + 1} <= m2
    assert any(R % 2 and chunk % 4 == 0 and chunk > _SR
               for R, chunk, _, kind, _ in _S_CASES if kind != "model1")
    assert {K for _, _, K, _, _ in _S_CASES} == {2, 3, 5, 16}
    assert {iff for *_, iff in _S_CASES} == {True, False}
    d3 = {chunk for _, chunk, K, _ in _D_CASES if K == 3}
    assert {_DT - 1, _DT + 1, _DR - 1, _DR + 1, _DR + 4, _DR - 4, 1} <= d3
    assert {chunk % 4 for _, chunk, _, _ in _D_CASES} == {0, 1, 3}
    assert {kind for *_, kind in _D_CASES} == {"model1", "model2",
                                              "model2-cols"}
    for R, _, K, *_ in _S_CASES + _D_CASES:
        assert R * (K + 3) > 40


def _case(R, chunk, K, kind, seed):
    """Inputs in numpy: level grids (lv[0] = 0, g = clip(0.9 - lv)),
    rents, arrivals, a side channel of -1 .. 2, horizons inside the
    chunk, and Model-1 service or a Model-2 slab ("model2": its own K
    levels; "model2-cols": a column map of K of 5 levels)."""
    rng = np.random.default_rng(seed)
    lv = np.sort(rng.random((R, K)).astype(np.float32), axis=1)
    lv[:, 0] = 0.0
    g = np.clip(0.9 - lv, 0.0, 1.0).astype(np.float32)
    M = (rng.random(R) * 20 + 0.5).astype(np.float32)
    t0 = 4096
    T_len = rng.integers(t0 - 3, t0 + chunk + 3, R).astype(np.int32)
    c = (rng.random((R, chunk)) * 1.5).astype(np.float32)
    x = rng.integers(0, 30, (R, chunk)).astype(np.int32)
    side = rng.integers(-1, 3, (R, chunk)).astype(np.int32)
    d = dict(lv=lv, g=g, M=M, t0=t0, T_len=T_len, c=c, x=x, side=side,
             rng=rng, svc=x.astype(np.float32)[:, :, None] * g[:, None, :],
             port=dict(g=g))
    if kind != "model1":
        Kf = 5 if kind == "model2-cols" else K
        slab = (rng.integers(0, 8, (R, chunk, Kf)) / 2).astype(np.float32)
        cols = (np.sort(rng.permuted(np.tile(np.arange(Kf), (R, 1)),
                                     axis=1)[:, :K], 1).astype(np.int32)
                if kind == "model2-cols"
                else np.tile(np.arange(K, dtype=np.int32), (R, 1)))
        d["svc"] = np.take_along_axis(slab, cols[:, None, :], axis=2)
        d["port"] = dict(svc=slab,
                         svc_cols=cols if kind == "model2-cols" else None)
    return d


def _table_params(policy, R, K, rng):
    """A policy's per-row params in numpy: a static level a row, or MDP /
    ABC tables of two rows into the row's levels (ABC's thresholds inside
    the arrivals' range)."""
    if policy == "static":
        return {"level_idx": rng.integers(0, K, R).astype(np.int32)}
    pi = rng.integers(0, K, (R, 2, K)).astype(np.int32)
    if policy == "mdp":
        return {"pi": pi}
    return {"pi": pi, "x_threshold": rng.choice(
        np.float32([0.5, 1.5, 14.5, 29.5]), R)}


@pytest.mark.parametrize("policy", ["static", "mdp", "abc"])
@pytest.mark.parametrize("R,chunk,K,kind,iff", _S_CASES)
def test_table_plain_matches_the_reference(R, chunk, K, kind, iff, policy):
    """``sim_chunk_table_plain`` / ``sim_chunk_table_svc_plain`` ==
    the reference's ``sim_chunk_core`` stepping the static, MDP or ABC
    table, vmapped over rows, from a carry in mid-run: the level held
    after the chunk, the three sums, the counts and the trace."""
    d = _case(R, chunk, K, kind, R * 1000 + chunk + K)
    rng = d["rng"]
    assert not psim.xla_acc_fma(_STEPS[policy][1], R, K)
    params = _table_params(policy, R, K, rng)
    r0 = rng.integers(0, K, R).astype(np.int32)
    sums = (rng.random((R, 3)) * 100).astype(np.float32)
    counts = rng.integers(0, 50, (R, K)).astype(np.int32)
    j = jnp.asarray
    (want_st, want_acc), want_r = _sim_ref(policy, iff)(
        {k: j(v) for k, v in params.items()}, j(d["lv"]), j(d["M"]),
        j(d["T_len"]), d["t0"],
        ({"r": j(r0)}, {"sums": j(sums), "counts": j(counts)}),
        j(d["x"]), j(d["c"]), j(d["svc"]), j(d["side"]))
    t = torch.from_numpy
    tab = table_form(_STEPS[policy][0], {k: t(v) for k, v in params.items()},
                     K)
    carry = ({"r": t(r0)}, {"sums": t(sums), "counts": t(counts)})
    common = (t(d["lv"]),)
    if kind == "model1":
        (st, acc), r = H.sim_chunk_table_plain(
            *tab, *common, t(d["g"]), t(d["M"]), t(d["T_len"]), d["t0"],
            carry, t(d["x"]), t(d["c"]), t(d["side"]), iff, True)
    else:
        cols = d["port"]["svc_cols"]
        (st, acc), r = H.sim_chunk_table_svc_plain(
            *tab, *common, t(d["M"]), t(d["T_len"]), d["t0"], carry,
            t(d["x"]), t(d["c"]), t(d["side"]), t(d["port"]["svc"]),
            None if cols is None else t(cols), iff, True)
    np.testing.assert_array_equal(np.asarray(want_st["r"]), st["r"].numpy())
    for key in ("sums", "counts"):
        np.testing.assert_array_equal(np.asarray(want_acc[key]),
                                      acc[key].numpy(), err_msg=key)
    np.testing.assert_array_equal(np.asarray(want_r), r.numpy())
    assert (d["T_len"] < d["t0"] + chunk).any()          # frozen tails
    if policy == "mdp":
        assert ((d["side"] < 0) | (d["side"] > 1)).any()  # clipped


@pytest.mark.parametrize("R,chunk,K,kind", _D_CASES)
def test_argmin_table_plain_matches_the_reference(R, chunk, K, kind):
    """``dp_fwd_model1_plain`` / ``dp_fwd_model2_plain`` with
    ``with_args=True`` == the reference's ``dp_fwd_chunk``, vmapped over
    rows: the frontier and the argmin table, the identity past each row's
    horizon, from frontiers with +inf entries and masked levels."""
    d = _case(R, chunk, K, kind, 7 * R + chunk + K)
    rng = d["rng"]
    kmask = rng.random((R, K)) < 0.85
    kmask[:, 0] = True
    J = (rng.random((R, K)) * 3).astype(np.float32)
    J[0::7] = np.inf
    J[1::7, 1:] = np.inf
    J = np.where(kmask, J, np.inf).astype(np.float32)
    t = torch.from_numpy
    fetch = dp_fetch_matrix(t(d["M"]), t(d["lv"]))
    tids = np.arange(d["t0"], d["t0"] + chunk, dtype=np.int32)
    j = jnp.asarray
    svc = ((j(d["x"]), j(d["g"])) if kind == "model1" else (j(d["svc"]),))
    want_J, want_args = _dp_ref["model1" if kind == "model1" else "model2"](
        j(J), j(tids), j(d["c"]), *svc, j(d["lv"]), j(kmask),
        j(fetch.numpy()), j(d["T_len"]))
    if kind == "model1":
        got_J, got_args = H.dp_fwd_model1_plain(
            t(J), t(d["c"]), t(d["x"]), t(d["g"]), t(d["lv"]), t(kmask),
            fetch, t(d["T_len"]), d["t0"], with_args=True)
    else:
        cols = d["port"]["svc_cols"]
        got_J, got_args = H.dp_fwd_model2_plain(
            t(J), t(d["c"]), t(d["port"]["svc"]), t(d["lv"]), t(kmask),
            fetch, t(d["T_len"]), d["t0"],
            svc_cols=None if cols is None else t(cols), with_args=True)
    np.testing.assert_array_equal(np.asarray(want_J), got_J.numpy())
    np.testing.assert_array_equal(np.asarray(want_args), got_args.numpy())
    frozen = tids[None, :] >= d["T_len"][:, None]
    assert frozen.any() and (~frozen).any()
    ident = np.broadcast_to(np.arange(K, dtype=np.int32), got_args.shape)
    assert (got_args.numpy()[frozen] == ident[frozen]).all()

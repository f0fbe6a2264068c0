"""Kernels B's and E's plain versions at the edges of the kernels' tiling,
bit for bit against the JAX package on the CPU.

``dp_backtrack_plain`` and ``schedule_chunk_plain`` are what the card
holds kernels B (the DP's backtrack) and E (schedule pricing) to.  Here
they meet the reference's own per-instance functions,
``offline_opt.dp_backtrack_chunk`` and ``simulator.schedule_chunk_core``,
run under ``jax.jit(jax.vmap(...))`` as ``tests/_fleet_ref.py`` runs the
reference's cores, at the shapes where the kernels' tiles and routes
change (``hosting.cu``: ``be_tile``; the sizes in ``tests/_be_tiles.py``):
a slot either side of a tile and of the ring's worth of tiles,
``chunk * K % 4`` of 1, 2 and 3 (the 4-byte
cp.async route), a chunk of whole 16-byte groups at odd R (the bulk
route), K = 1 and K = 32; E also on Model-2 slabs of 32 levels (their own
levels, and a column map of 3), on a schedule that changes level every
slot and on one that never does, with horizons inside the chunk, levels
out of range and a carry in mid-run (sums of -0 in some rows).  Every
batch here is wide enough (R * (K + 3) > 40) that the reference's vmapped
scan does not fuse a sum's product into its add
(``simulator.xla_acc_fma``)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.policies.offline_opt import dp_backtrack_chunk
from repro.core.simulator import schedule_chunk_core
from repro_torch.core import simulator as psim
from repro_torch.kernels import hosting as H
import _be_tiles as T

_BT, _ET = T.B_TILE[3], T.E_TILE          # B's tile at K = 3, E's (Model 1)
_BR, _ER = T.STAGES * _BT, T.STAGES * _ET
_B32, _E32 = T.B_TILE[32], T.E_TILE_SLAB32  # B's at K = 32, E's on a
                                            # 32-level slab

_backtrack_ref = jax.jit(jax.vmap(dp_backtrack_chunk))
_schedule_ref = jax.jit(jax.vmap(schedule_chunk_core,
                                 in_axes=(0, 0, 0, None, 0, 0, 0, 0)))


_B_CASES = [
    # a slot either side of a tile and of the ring (chunk * K % 4 of 1 and
    # 3: the 4-byte route), and whole 16-byte groups past the ring
    (37, _BT - 1, 3), (37, _BT + 1, 3), (37, _BR - 1, 3),
    (37, _BR + 1, 3), (33, _BR + 4, 3),
    # chunk * K % 4 of 2; one slot; K = 1 and K = 32 at their tiles' edges
    (41, 999, 2), (9, 1, 3), (35, 4 * T.B_TILE[1] + 1, 1),
    (35, 4 * _B32 - 1, 32)]
_E_CASES = [
    # Model 1: a slot either side of a tile and of the ring (the 4-byte
    # route), whole 16-byte groups either side of the ring at odd R (the
    # bulk route), one slot, K = 32
    (37, _ET - 1, 3, "model1", "random"), (37, _ET + 1, 3, "model1", "random"),
    (37, _ER - 1, 3, "model1", "random"), (37, _ER + 1, 3, "model1", "random"),
    (33, _ER - 4, 3, "model1", "random"), (33, _ER + 4, 3, "model1", "random"),
    (9, 1, 3, "model1", "random"), (7, 333, 32, "model1", "random"),
    # a Model-2 slab of 32 levels: its own (either side of 4 tiles) and a
    # column map of 3 (chunk % 4 of 1 and 0)
    (5, 4 * _E32 + 4, 32, "model2", "random"),
    (5, 4 * _E32 + 1, 32, "model2", "random"),
    (37, 333, 3, "cols32", "random"), (37, 336, 3, "cols32", "random"),
    # the run counts: a new level every slot, one level throughout
    (37, 401, 3, "model1", "every"), (37, 400, 3, "model1", "never"),
    (37, 401, 5, "cols32", "every")]


def test_edges_follow_the_tiling():
    """The shapes below sit where they say: B's cover a slot either side
    of its tile and its ring at K = 3, ``chunk * K % 4`` of 0 to 3 (the
    4-byte route and the bulk one, the bulk one at odd R past the ring),
    one slot, and K = 1 and 32 a slot past or short of whole tiles; E's
    the same edges under Model 1, slabs of 32 levels either side of whole
    tiles, and the schedules that change level every slot and never."""
    b3 = {chunk for _, chunk, K in _B_CASES if K == 3}
    assert {_BT - 1, _BT + 1, _BR - 1, _BR + 1, 1} <= b3
    assert {chunk * K % 4 for _, chunk, K in _B_CASES} == {0, 1, 2, 3}
    assert any(R % 2 and chunk * K % 4 == 0 and chunk > _BR
               for R, chunk, K in _B_CASES)
    assert {chunk % T.B_TILE[K] for _, chunk, K in _B_CASES
            if K in (1, 32)} == {1, _B32 - 1}
    e1 = {(R % 2, chunk) for R, chunk, K, kind, _ in _E_CASES
          if kind == "model1" and K == 3}
    assert {c for _, c in e1} >= {_ET - 1, _ET + 1, _ER - 1, _ER + 1, 1}
    assert {(1, _ER - 4), (1, _ER + 4)} <= e1
    assert {chunk % _E32 for _, chunk, K, kind, _ in _E_CASES
            if kind == "model2" and K == 32} == {0, 1}
    assert {case[-1] for case in _E_CASES} == {"random", "every", "never"}


@pytest.mark.parametrize("R,chunk,K", _B_CASES)
def test_backtrack_plain_matches_the_reference(R, chunk, K):
    """``dp_backtrack_plain`` == the reference's ``dp_backtrack_chunk``,
    vmapped over rows: the level at the chunk's entry and the schedule."""
    rng = np.random.default_rng(R * 1000 + chunk + K)
    k = rng.integers(0, K, R).astype(np.int32)
    args = rng.integers(0, K, (R, chunk, K)).astype(np.int32)
    want_k, want_r = _backtrack_ref(jnp.asarray(k), jnp.asarray(args))
    got_k, got_r = H.dp_backtrack_plain(torch.from_numpy(k),
                                        torch.from_numpy(args))
    np.testing.assert_array_equal(np.asarray(want_k), got_k.numpy())
    np.testing.assert_array_equal(np.asarray(want_r), got_r.numpy())


def _schedule_case(R, chunk, K, kind, sched, seed):
    """E's inputs in numpy: level grids, rents, horizons inside the chunk,
    a carry in mid-run, a schedule ("random": levels out of [0, K) too;
    "every": a new level every slot; "never": one level a row), and
    Model-1 arrivals or a Model-2 slab ("model2": its own K levels;
    "cols32": a column map of K of its 32 levels)."""
    rng = np.random.default_rng(seed)
    lv = np.sort(rng.random((R, K)).astype(np.float32), axis=1)
    lv[:, 0] = 0.0
    M = (rng.random(R) * 20 + 0.5).astype(np.float32)
    t0 = 8192
    T_len = rng.integers(t0 - 3, t0 + chunk + 3, R).astype(np.int32)
    prev = rng.integers(-1, K + 1, R).astype(np.int32)
    sums = (rng.random((R, 3)) * 100).astype(np.float32)
    sums[::4] = -0.0
    counts = rng.integers(0, 50, (R, K)).astype(np.int32)
    c = (rng.random((R, chunk)) * 1.5).astype(np.float32)
    if sched == "every":
        r = np.broadcast_to((np.arange(chunk) % K).astype(np.int32),
                            (R, chunk)).copy()
    elif sched == "never":
        r = np.repeat(rng.integers(0, K, (R, 1)).astype(np.int32), chunk, 1)
    else:
        r = rng.integers(-1, K + 1, (R, chunk)).astype(np.int32)
    if kind == "model1":
        x = rng.integers(0, 30, (R, chunk)).astype(np.int32)
        g = np.clip(0.9 - lv, 0.0, 1.0).astype(np.float32)
        port = dict(x=x, g=g)
        svc = x.astype(np.float32)[:, :, None] * g[:, None, :]
    else:
        Kf = 32
        slab = (rng.integers(0, 8, (R, chunk, Kf)) / 2).astype(np.float32)
        if kind == "model2":
            cols = np.tile(np.arange(K, dtype=np.int32), (R, 1))
            port = dict(svc=slab)
        else:
            cols = np.sort(rng.integers(0, Kf, (R, K)), 1).astype(np.int32)
            port = dict(svc=slab, svc_cols=cols)
        svc = np.take_along_axis(slab, cols[:, None, :], axis=2)
    return dict(lv=lv, M=M, T_len=T_len, t0=t0, prev=prev, sums=sums,
                counts=counts, r=r, c=c, svc=svc, port=port)


@pytest.mark.parametrize("R,chunk,K,kind,sched", _E_CASES)
def test_schedule_plain_matches_the_reference(R, chunk, K, kind, sched):
    """``schedule_chunk_plain`` == the reference's ``schedule_chunk_core``,
    vmapped over rows: the held level, the three sums and the counts."""
    d = _schedule_case(R, chunk, K, kind, sched, R * 1000 + chunk + K)
    fma = psim.xla_acc_fma(None, R, K)
    assert not fma
    j = jnp.asarray
    (want_prev, want_acc), _ = _schedule_ref(
        j(d["lv"]), j(d["M"]), j(d["T_len"]), d["t0"],
        (j(d["prev"]), {"sums": j(d["sums"]), "counts": j(d["counts"])}),
        j(d["r"]), j(d["c"]), j(d["svc"]))
    t = torch.from_numpy
    got_prev, got_acc = H.schedule_chunk_plain(
        t(d["lv"]), t(d["M"]), t(d["T_len"]), d["t0"],
        (t(d["prev"]), {"sums": t(d["sums"]), "counts": t(d["counts"])}),
        t(d["r"]), t(d["c"]), **{k: t(v) for k, v in d["port"].items()},
        acc_fma=fma)
    np.testing.assert_array_equal(np.asarray(want_prev), got_prev.numpy())
    for key in ("sums", "counts"):
        np.testing.assert_array_equal(np.asarray(want_acc[key]),
                                      got_acc[key].numpy(), err_msg=key)
    if kind == "model1" and sched == "random":
        assert (d["T_len"] < d["t0"] + chunk).any()     # horizons inside

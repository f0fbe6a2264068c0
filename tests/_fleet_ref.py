"""The JAX package's per-instance fleet cores, run without their
``shard_map`` wrapper: the reference for obs-backed fleets.

On the installed jax the wrapped cores of ``repro.core.fleet`` raise the
``shard_map`` scan-carry ``TypeError`` for obs-backed fleets, but the cores
themselves (``_make_instance_core``, ``_make_fanout_instance_core``,
``_make_dp_instance_core``, ``_make_dp_ckpt_instance_core``,
``_make_schedule_instance_core``) run under ``jax.jit(jax.vmap(...))`` on
the fleet padded as the reference pads it.  A helper module of the port's
tests, not a test file."""
import jax
import jax.numpy as jnp
import numpy as np

import repro.core.fleet as RF
from repro.core.scenarios.base import chunk_geometry


def padded(jf, chunk_size):
    """``(padded fleet, n_chunks, T_pad)``: the reference's T padding."""
    n_chunks, T_pad = chunk_geometry(jf.T_max, chunk_size)
    return RF._pad_fleet(jf, jf.B, T_pad), n_chunks, T_pad


def _obs(p):
    args = (jnp.asarray(p.x), jnp.asarray(p.c))
    if p.svc is not None:
        args += (jnp.asarray(p.svc),)
    return args


def run(pol, jf, chunk_size=None, include_final_fetch=True,
        collect_trace=True):
    """``run_fleet(pol, jf)`` through ``_make_instance_core``."""
    p, n_chunks, _ = padded(jf, chunk_size)
    core = jax.jit(jax.vmap(RF._make_instance_core(
        pol.init_fn, pol.step_fn, include_final_fetch, n_chunks,
        p.svc is not None, p.side is not None, collect_trace)))
    args = (pol.params, p.grid.levels, p.grid.g, p.grid.M, jnp.asarray(p.T))
    args += _obs(p)
    if p.side is not None:
        args += (jnp.asarray(p.side),)
    out = core(*args)
    r, sums, counts = out if collect_trace else (None,) + tuple(out)
    return RF._fleet_result(r, sums, counts, jf.B, jf.T_max, jf.T)


def fanout(lanes, jf, chunk_size=None, include_final_fetch=True,
           collect_trace=True, with_opt=False):
    """The fan-out ``run_fleet(lanes, jf)`` through
    ``_make_fanout_instance_core``."""
    p, n_chunks, _ = padded(jf, chunk_size)
    mesh = RF.fleet_mesh()
    lane_args = RF._lane_arrays(lanes, p, 1, mesh)
    lane_fns = tuple((l.fns.init_fn, l.fns.step_fn) for l in lanes)
    lane_own = tuple(l.grid is not None for l in lanes)
    core = jax.jit(jax.vmap(RF._make_fanout_instance_core(
        lane_fns, lane_own, include_final_fetch, n_chunks, p.svc is not None,
        p.side is not None, collect_trace, with_opt, "xla")))
    args = (lane_args, jnp.asarray(p.T)) + _obs(p)
    if p.side is not None:
        args += (jnp.asarray(p.side),)
    outs = core(*args)
    n, i = len(lanes), 0
    r_lanes = None
    if collect_trace:
        r_lanes, i = outs[:n], n
    return RF._fanout_result(r_lanes, outs[i:i + n], outs[i + n:i + 2 * n],
                             outs[i + 2 * n:] if with_opt else None, jf.B,
                             jf.T_max, jf.T, 1, mesh)


def _grid_args(p):
    return (p.grid.M, p.grid.levels, p.grid.g, p.grid.mask, jnp.asarray(p.T))


def opt(jf, chunk_size=None, checkpointed=False, collect_schedule=True):
    """``offline_opt_fleet(jf)``'s cost (float64) and ``r_hist`` (int64,
    sliced to T_max; None without the schedule) through
    ``_make_dp_instance_core`` / ``_make_dp_ckpt_instance_core``."""
    p, n_chunks, _ = padded(jf, chunk_size)
    has_svc = p.svc is not None
    if checkpointed:
        core = RF._make_dp_ckpt_instance_core(n_chunks, has_svc,
                                              collect_schedule)
    else:
        core = RF._make_dp_instance_core(n_chunks, has_svc)
    out = jax.jit(jax.vmap(core))(*_grid_args(p), *_obs(p))
    cost, r = out if collect_schedule else (out, None)
    cost = np.asarray(cost).astype(np.float64)
    if r is None:
        return cost, None
    return cost, np.asarray(r)[:, :jf.T_max].astype(np.int64)


def schedule(jf, r_hist, chunk_size=None):
    """``evaluate_schedule_fleet(jf, r_hist)`` through
    ``_make_schedule_instance_core``."""
    p, n_chunks, T_pad = padded(jf, chunk_size)
    r = np.pad(np.asarray(r_hist, np.int32),
               ((0, 0), (0, T_pad - r_hist.shape[1])))
    core = jax.jit(jax.vmap(RF._make_schedule_instance_core(
        n_chunks, p.svc is not None)))
    sums, counts = core(p.grid.levels, p.grid.g, p.grid.M, jnp.asarray(p.T),
                        jnp.asarray(r), *_obs(p))
    return RF._fleet_result(r.astype(np.int64), sums, counts, jf.B,
                            jf.T_max, jf.T)


FIELDS = ("total", "rent", "service", "fetch", "level_slots", "T")


def assert_same(ref, got, trace=True):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f),
                                      err_msg=f)
    assert ref.n_seeds == got.n_seeds
    if trace:
        np.testing.assert_array_equal(ref.r_hist, got.r_hist)

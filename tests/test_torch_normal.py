"""The port's normal draw against jax's, bit for bit (``np.array_equal``):
XLA's float32 ``erf_inv`` (with its own ``log1p`` and ``log``) as
``kernels.hosting.erf_inv_plain`` transcribes it, and
``normal_chunk_plain`` against ``jax.random.normal`` on the reference's
per-slot keys, in both threefry layouts."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.scenarios.base import slot_keys
from repro_torch.kernels import hosting as H

LAYOUTS = [True, False]
LO = np.nextafter(np.float32(-1), np.float32(0))


def _erf_inv_inputs():
    """>= 2 M float32 inputs on [nextafter(-1, 0), 1): uniform, both tails
    (-log1p(-u * u) >= 5, Giles's second polynomial, past |u| ~ 0.9966),
    near 0 (log1p's rational branch) and the ends themselves."""
    rng = np.random.default_rng(0)
    tail = rng.uniform(1e-7, 4e-3, 300_000)
    u = np.concatenate([
        rng.uniform(-1, 1, 1_400_000), 1 - tail, tail - 1,
        rng.uniform(-1e-3, 1e-3, 100_000),
        [LO, -0.0, 0.0, 2.0 ** -24, -2.0 ** -24, 1 - 2.0 ** -24,
         np.nextafter(np.float32(1), np.float32(0))]]).astype(np.float32)
    return np.minimum(np.maximum(u, LO),
                      np.nextafter(np.float32(1), np.float32(0)))


def test_erf_inv_matches_xla_on_both_branches_and_the_ends():
    u = _erf_inv_inputs()
    assert u.size >= 2_000_000 and u.min() == LO and u.max() < 1
    ref = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    w = -np.log1p(-u.astype(np.float64) ** 2)
    assert (w >= 5.5).sum() > 10_000 and (w < 4.5).sum() > 10_000
    got = H.erf_inv_plain(torch.from_numpy(u)).numpy()
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def _slot_normals(keys, tids, scale=None):
    def one(k, s):
        n = jax.vmap(lambda kk: jax.random.normal(kk, (), jnp.float32))(
            slot_keys(k, tids))
        return n if s is None else s * n
    if scale is None:
        return jax.jit(jax.vmap(lambda k: one(k, None)))(keys)
    return jax.jit(jax.vmap(one))(keys, scale)


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_normal_chunk_matches_jax_normal(partitionable):
    """sigma = 1 is ``jax.random.normal`` itself; a scale inside a jit is
    folded into sqrt(2) first, ``(sigma * sqrt(2)) * erf_inv(u)``."""
    rng = np.random.default_rng(1)
    sigma = rng.uniform(0.01, 0.3, 37).astype(np.float32)
    tids = np.concatenate([np.arange(0, 300), [2 ** 31 - 1, 12345]]
                          ).astype(np.int32)
    with jax.threefry_partitionable(partitionable):
        keys = jax.random.split(jax.random.PRNGKey(5), 37)
        plain = _slot_normals(keys, tids)
        scaled = _slot_normals(keys, tids, sigma)
    pk = torch.from_numpy(np.asarray(keys).astype(np.int64))
    pt = torch.from_numpy(tids)
    got = H.normal_chunk_plain(pk, pt, torch.ones(37), partitionable)
    assert np.array_equal(got.numpy(), np.asarray(plain))
    got = H.normal_chunk_plain(pk, pt, torch.from_numpy(sigma),
                               partitionable)
    assert np.array_equal(got.numpy(), np.asarray(scaled))
    # the unscaled draw is not the scaled one's op order: the fold matters
    unfolded = torch.from_numpy(sigma)[:, None] * H.normal_chunk_plain(
        pk, pt, torch.ones(37), partitionable)
    assert not np.array_equal(unfolded.numpy(), np.asarray(scaled))

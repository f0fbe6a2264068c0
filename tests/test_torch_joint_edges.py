"""Kernel G's plain version, pinned against the reference: the joint
slab's service sums in ascending n (Model 2's gathered columns) and Model
1's products as an FMA chain, N = 1 to 4, both layouts, against the
materialised joint scenario and against the ``_joint_fns`` reduction
jitted under vmap at J = 16, 17 and 32; its w route == the fused D's
assembly."""
import numpy as np
import jax
import pytest

from repro.core import services as JSV
from repro.core.scenarios.base import materialize as jmaterialize
from repro_torch.core import services as SV
from repro_torch.core.scenarios.base import materialize
from repro_torch.kernels import hosting as H

import _joint_cases as JC
from _service_ref import LAYOUTS, _both, _joint_pair


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("model2", [True, False])
@pytest.mark.parametrize("N", [1, 2, 3, 4])
def test_joint_slab_sums_match_the_reference(N, model2, partitionable):
    """Kernel G's plain version == the reference's joint scenario,
    materialised: the service sums in ascending n from 0, Model 1's
    products as an FMA chain (``acc = fma(x_n, g, acc)``: two rounded ops
    differ from N = 2 on, which the Poisson arrivals here show), the
    arrivals summed, rent and side channel of lane 0."""
    sets = {1: [3, 3], 2: [6, 16], 3: [27, 27], 4: [19, 32]}[N]
    with _both(partitionable):
        jsf, psf, jsc, psc = _joint_pair(sets, 40, model2, seed=N)
        assert psf.N == N
        want = jmaterialize(JSV.joint_scenario(jsf, jsc), 40, chunk_size=16)
        got = materialize(SV.joint_scenario(psf, psc), 40, chunk_size=16)
        tiled = materialize(SV.service_scenario(psf, psc), 40, chunk_size=16)
    for a, b in zip(got, want):
        assert (a is None and b is None) or np.array_equal(a, np.asarray(b))
    if not model2 and N > 1:
        # the two-op form would differ: the pin is not vacuous
        x = tiled[0].reshape(psf.B, N, -1).astype(np.float32)
        g = SV.joint_scenario(psf, psc).params["g_lane"].numpy()
        acc = np.zeros(got[2].shape, np.float32)
        for n in range(N):
            acc = acc + x[:, n, :, None] * g[:, n, None, :]
        assert not np.array_equal(acc, got[2])


def _sum_cases():
    return [(N, J, m2) for N in (1, 2, 3, 4) for J in (16, 17, 32)
            for m2 in (True, False)]


@pytest.mark.parametrize("N,J,model2", _sum_cases())
def test_joint_slab_plain_is_the_reference_ops(N, J, model2):
    """G's plain version on random sub-slabs (J = 16, 17 and 32 states,
    N = 1 to 4) == the reference's ``_joint_fns`` reduction run jitted
    under vmap over the instances, and its w route == the fused D's
    assembly, at the same J."""
    import jax.numpy as jnp
    import torch
    R = 5
    K = 5
    x, c, side, svc, g_lane, idx = JC.joint_slab_case(R, N, 33, K, J,
                                                      model2, N * J)

    def ref(x_sub, svc_sub, g_l, ix):
        if model2:
            Nn, ch = x_sub.shape
            gathered = jnp.take_along_axis(
                svc_sub, jnp.broadcast_to(ix[:, None, :], (Nn, ch, J)),
                axis=2)
            return jnp.sum(gathered, axis=0), jnp.sum(x_sub, axis=0)
        return (jnp.sum(x_sub[:, :, None].astype(jnp.float32)
                        * g_l[:, None, :], axis=0), jnp.sum(x_sub, axis=0))

    xs = x.reshape(R, N, -1)
    sv = None if svc is None else svc.reshape(R, N, 33, K)
    gl = g_lane if g_lane is not None else np.zeros((R, N, J), np.float32)
    want_svc, want_x = jax.jit(jax.vmap(ref))(
        xs, sv if sv is not None else np.zeros((R, N, 33, 1), np.float32),
        gl, idx)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    gx, gc, gs, gsvc = H.joint_slab(t(x), t(c), t(side), t(svc), t(g_lane),
                                    t(idx))
    np.testing.assert_array_equal(gsvc.numpy(), np.asarray(want_svc))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(gc.numpy(), c.reshape(R, N, -1)[:, 0])
    np.testing.assert_array_equal(gs.numpy(), side.reshape(R, N, -1)[:, 0])
    # G's w route (N = 1, the identity as the states' levels)
    rng = np.random.default_rng(J)
    lv = rng.random((R, J)).astype(np.float32)
    kmask = rng.random((R, J)) < 0.8
    w = H.slab_w(gc, gsvc, t(lv), t(kmask))

    def fused(cc, s, l, m):
        return jnp.where(m[None, :], cc[:, None] * l[None, :] + s, jnp.inf)
    want_w = jax.jit(jax.vmap(fused))(gc.numpy(), gsvc.numpy(), lv, kmask)
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))

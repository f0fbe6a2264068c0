"""Kernel M's plain version and the port's Mamba2 block against the JAX
package: ``mamba2.ssd_chunked`` (the XLA path the reference model runs),
``ops.ssd_scan`` (the Pallas kernel in interpret mode) and the token
recurrence ``ref.ssd_scan_ref``.  Inputs come from numpy with a seed.

Tolerances: against the chunked forms, fp32 2e-5 relative to the largest
output (the same sums in another order, fp32 exp); against the token
recurrence 1e-3 (a different algorithm: the chunked form multiplies decays
exp(L_i - L_j) where the recurrence multiplies exp(la) step by step),
as tests/test_kernels.py holds the Pallas kernel; bf16 5e-2 (y is rounded
to bf16)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as jm
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba2 as pm

J_CHUNKED = jax.jit(jm.ssd_chunked, static_argnames=("chunk", "unroll"))
J_REF = jax.jit(jref.ssd_scan_ref)

SSD_SHAPES = [
    # (b, s, nh, dh, ng, ds, chunk): tests/test_kernels.py's sweep
    (1, 32, 2, 16, 1, 16, 16),
    (2, 64, 4, 32, 1, 32, 32),
    (1, 100, 4, 32, 2, 16, 32),    # ragged + grouped
    (2, 128, 8, 64, 1, 64, 64),
]


def _inputs(seed, b, s, nh, dh, ng, ds, dtype="float32", with_h0=False):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((b, s, nh, dh)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(f32)
    A = (-np.exp(rng.standard_normal(nh) * 0.5)).astype(f32)
    B = rng.standard_normal((b, s, ng, ds)).astype(f32)
    C = rng.standard_normal((b, s, ng, ds)).astype(f32)
    h0 = (rng.standard_normal((b, nh, dh, ds)).astype(f32) if with_h0
          else None)
    if dtype == "bfloat16":
        x, B, C = (a.astype(ml_dtypes.bfloat16) for a in (x, B, C))
    arrs = (x, dt, A, B, C, h0)
    return ([None if a is None else jnp.asarray(a) for a in arrs],
            [None if a is None else params_from_jax(a, device="cpu")
             for a in arrs])


def _close(port, want, tol, rel_to_max=True):
    want = np.asarray(want, np.float32)
    got = port.to(torch.float32).numpy()
    scale = max(1.0, float(np.abs(want).max())) if rel_to_max else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ssd_matches_reference(shape, dtype):
    *dims, chunk = shape
    (jx, jdt, jA, jB, jC, _), (x, dt, A, B, C, _) = _inputs(0, *dims, dtype)
    y, hT = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    assert y.dtype == x.dtype and hT.dtype == torch.float32
    tol = 5e-2 if dtype == "bfloat16" else 2e-5
    yc, hc = J_CHUNKED(jx, jdt, jA, jB, jC, chunk=chunk)
    _close(y, yc, tol)
    _close(hT, hc, tol)
    yk, hk = jops.ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk)
    _close(y, yk, tol)
    _close(hT, hk, tol)
    yr, hr = J_REF(jx, jdt, jA, jB, jC)
    _close(y, yr, max(tol, 1e-3))
    _close(hT, hr, 1e-3)


@pytest.mark.parametrize("s,chunk", [(48, 16), (45, 16)])
def test_plain_ssd_with_initial_state(s, chunk):
    """h0 given, whole and ragged S, against the chunked reference, the
    Pallas kernel and the port's own token recurrence."""
    (jx, jdt, jA, jB, jC, jh0), (x, dt, A, B, C, h0) = _inputs(
        1, 1, s, 2, 16, 1, 16, with_h0=True)
    y, hT = ops.ssd_scan(x, dt, A, B, C, h0=h0, chunk=chunk)
    yc, hc = J_CHUNKED(jx, jdt, jA, jB, jC, chunk=chunk, h0=jh0)
    _close(y, yc, 2e-5)
    _close(hT, hc, 2e-5)
    yk, hk = jops.ssd_scan(jx, jdt, jA, jB, jC, h0=jh0, chunk=chunk)
    _close(y, yk, 2e-5)
    _close(hT, hk, 2e-5)
    yr, hr = ref.ssd_scan_ref(x, dt, A, B, C, h0)
    _close(yr, J_REF(jx, jdt, jA, jB, jC, jh0)[0], 2e-5)
    _close(y, yr.numpy(), 1e-3)
    _close(hT, hr.numpy(), 1e-3)


def test_plain_ssd_state_continuation():
    """Two halves with the state carried == the whole sequence."""
    (_, _, _, _, _, _), (x, dt, A, B, C, _) = _inputs(2, 1, 64, 2, 16, 1, 16)
    y, hT = ops.ssd_scan(x, dt, A, B, C, chunk=16)
    h = 27                                  # a split inside a chunk
    y1, h1 = ops.ssd_scan(x[:, :h], dt[:, :h], A, B[:, :h], C[:, :h],
                          chunk=16)
    y2, h2 = ops.ssd_scan(x[:, h:], dt[:, h:], A, B[:, h:], C[:, h:],
                          h0=h1, chunk=16)
    _close(torch.cat([y1, y2], 1), y.numpy(), 1e-4)
    _close(h2, hT.numpy(), 1e-4)


def _mamba_pair():
    jcfg = jget_arch("mamba2-130m").tiny
    pcfg = get_arch("mamba2-130m").tiny
    jp = jm.mamba2_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    rng = np.random.default_rng(4)   # non-trivial biases and norm weights
    for name in ("conv_x_b", "conv_B_b", "conv_C_b", "dt_bias", "ssm_norm"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape)
                               .astype(np.float32) * 0.1)
    return jcfg, pcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


def test_mamba2_apply_prefill_and_decode():
    jcfg, pcfg, jp, pp = _mamba_pair()
    rng = np.random.default_rng(5)
    b, s = 2, 13                             # ragged against ssm_chunk 8
    x = rng.standard_normal((b, s + 1, pcfg.d_model)).astype(np.float32)
    apply = jax.jit(jm.mamba2_apply, static_argnums=(1,))
    out_j, h_j, conv_j = apply(jp, jcfg, jnp.asarray(x[:, :s]))
    out_p, h_p, conv_p = pm.mamba2_apply(pp, pcfg, torch.from_numpy(x[:, :s]))
    _close(out_p, out_j, 2e-5)
    _close(h_p, h_j, 2e-5)
    _close(conv_p, conv_j, 2e-5)
    # one-token decode from the prefill's states (the token recurrence)
    out_j, h_j2, conv_j2 = apply(jp, jcfg, jnp.asarray(x[:, s:]), h_j,
                                 conv_j)
    out_p, h_p2, conv_p2 = pm.mamba2_apply(pp, pcfg,
                                           torch.from_numpy(x[:, s:]), h_p,
                                           conv_p)
    _close(out_p, out_j, 2e-5)
    _close(h_p2, h_j2, 2e-5)
    _close(conv_p2, conv_j2, 2e-5)
    # and the decode continues the sequence: == the last row of a prefill
    full, _, _ = pm.mamba2_apply(pp, pcfg, torch.from_numpy(x))
    _close(out_p[:, 0], full[:, -1].numpy(), 1e-4)

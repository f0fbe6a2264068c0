"""Kernel F's plain version and the port's attention layer against the JAX
package (Pallas kernels in interpret mode, as tests/test_kernels.py runs
them).  Inputs come from numpy with a seed; bf16 inputs are rounded once
(ml_dtypes) and carried bit for bit.

Tolerances: fp32 2e-5 -- the same function summed in another order (key
tiles of 64 against the reference's blocks, one einsum against another)
with fp32 exp; bf16 2e-2 -- the output is rounded to bf16 once (an ulp is
2**-7 relative), and a different fp32 sum before that rounding can land on
the neighbouring bf16 value."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as pattn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the reference's functions, jitted once (eager jnp compiles every op)
J_REF = jax.jit(jref.flash_attention_ref, static_argnames=("causal",
                                                           "q_offset"))
J_NAIVE = jax.jit(jattn.attention_naive, static_argnums=(3, 4))
J_XLA = jax.jit(jattn.attention_xla_flash, static_argnums=(3, 4, 5))
J_GQA = jax.jit(jattn.gqa_apply, static_argnums=(1, 4))

ATTN_SHAPES = [
    # (B, Sq, Skv, Hq, Hkv, hd): tests/test_kernels.py's sweep
    (1, 16, 16, 1, 1, 16),
    (2, 64, 64, 4, 4, 32),
    (2, 128, 128, 4, 2, 64),      # GQA
    (1, 80, 80, 8, 1, 64),        # MQA, ragged seq
    (1, 256, 256, 2, 2, 128),
]


def _arr(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _qkv(seed, b, sq, skv, hq, hkv, hd, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [_arr(rng, (b, sq, hq, hd), dtype),
            _arr(rng, (b, skv, hkv, hd), dtype),
            _arr(rng, (b, skv, hkv, hd), dtype)]
    return ([jnp.asarray(a) for a in arrs],
            [params_from_jax(a, device="cpu") for a in arrs])


def _close(port, want, tol):
    np.testing.assert_allclose(port.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_reference_kernel_and_oracle(shape, dtype):
    b, sq, skv, hq, hkv, hd = shape
    (jq, jk, jv), (q, k, v) = _qkv(0, *shape, dtype)
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, jops.flash_attention(jq, jk, jv, causal=True, bq=64, bk=64),
           TOL[dtype])
    _close(out, J_REF(jq, jk, jv, causal=True), TOL[dtype])
    _close(ref.flash_attention_ref(q, k, v, causal=True),
           J_REF(jq, jk, jv, causal=True), TOL[dtype])


@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, Hq, Hkv, hd, q_offset)
    (2, 1, 77, 8, 2, 64, 76),       # decode over a ragged cache, GQA
    (1, 1, 100, 4, 4, 32, 60),      # decode, cache longer than the query
    (2, 5, 37, 4, 2, 16, 30),       # a short block of new queries, ragged
])
def test_plain_flash_decode_with_offset(case):
    *shape, off = case
    (jq, jk, jv), (q, k, v) = _qkv(1, *shape)
    out = ops.flash_attention(q, k, v, causal=True, q_offset=off)
    _close(out, jops.flash_attention(jq, jk, jv, causal=True, q_offset=off),
           TOL["float32"])
    _close(out, J_REF(jq, jk, jv, causal=True, q_offset=off),
           TOL["float32"])


def test_plain_flash_noncausal_ragged_against_the_oracle():
    """Non-causal over a ragged key length: held against the oracle only;
    the reference's Pallas wrapper is wrong there (next test)."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 2, 16, 80, 4, 2, 32)
    out = ops.flash_attention(q, k, v, causal=False)
    _close(out, J_REF(jq, jk, jv, causal=False), TOL["float32"])
    _close(ref.flash_attention_ref(q, k, v, causal=False),
           J_REF(jq, jk, jv, causal=False), TOL["float32"])


def test_reference_wrapper_lets_padded_keys_in_when_not_causal():
    """Pins the reference's fault (ROADMAP Queue 3): ``ops.flash_attention``
    pads K/V to a block multiple and bounds the keys by the padded length,
    so non-causal attention over 80 keys in blocks of 64 also attends to 48
    zero keys.  Causal attention is unaffected."""
    (jq, jk, jv), _ = _qkv(3, 1, 16, 80, 2, 2, 32)
    want = np.asarray(J_REF(jq, jk, jv, causal=False))
    got = np.asarray(jops.flash_attention(jq, jk, jv, causal=False,
                                          bq=64, bk=64))
    assert np.abs(got - want).max() > 1e-2
    want_c = np.asarray(J_REF(jq, jk, jv, causal=True))
    got_c = np.asarray(jops.flash_attention(jq, jk, jv, causal=True,
                                            bq=64, bk=64))
    assert np.abs(got_c - want_c).max() < 2e-5


@pytest.mark.parametrize("causal,off", [(True, 0), (True, 7), (False, 0)])
def test_attention_impls_match_reference(causal, off):
    (jq, jk, jv), (q, k, v) = _qkv(4, 2, 24, 24 + off, 4, 2, 16)
    if not causal:
        (jq, jk, jv), (q, k, v) = _qkv(4, 2, 24, 40, 4, 2, 16)
    _close(pattn.attention_naive(q, k, v, causal, off),
           J_NAIVE(jq, jk, jv, causal, off), TOL["float32"])
    _close(pattn.attention_xla_flash(q, k, v, causal, off, chunk=16),
           J_XLA(jq, jk, jv, causal, off, 16), TOL["float32"])
    for impl in pattn.IMPLS:
        _close(pattn.attend(q, k, v, causal, impl, off, chunk=16),
               J_REF(jq, jk, jv, causal, off), TOL["float32"])


def _gqa_pair(**over):
    jcfg = jget_arch("llama3.2-3b").tiny.with_(**over)
    pcfg = get_arch("llama3.2-3b").tiny.with_(**over)
    jp = jattn.gqa_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    rng = np.random.default_rng(6)
    if jcfg.qkv_bias:                # zero-initialised: give them values
        for name in ("bq", "bk", "bv"):
            jp[name] = jnp.asarray(rng.standard_normal(
                jp[name].shape).astype(np.float32) * 0.1)
    return jcfg, pcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


@pytest.mark.parametrize("over", [{}, {"rotary_dim": 8, "qkv_bias": True}])
def test_gqa_apply_with_and_without_a_cache(over):
    jcfg, pcfg, jp, pp = _gqa_pair(**over)
    rng = np.random.default_rng(7)
    b, s, smax = 2, 6, 10
    x = rng.standard_normal((b, s + 1, pcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s + 1, dtype=np.int32), (b, s + 1))
    y_j, _ = J_GQA(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), "naive")
    y_p, _ = pattn.gqa_apply(pp, pcfg, torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), "naive")
    _close(y_p, y_j, 1e-5)
    # prefill s tokens into a cache, then decode one at position s
    shape = (b, smax, pcfg.n_kv_heads, pcfg.head_dim)
    jc = (jnp.zeros(shape), jnp.zeros(shape))
    pc = (torch.zeros(shape), torch.zeros(shape))
    for lo, hi in ((0, s), (s, s + 1)):
        y_j, jc = J_GQA(jp, jcfg, jnp.asarray(x[:, lo:hi]),
                        jnp.asarray(pos[:, lo:hi]), "naive", jc,
                        jnp.int32(lo))
        y_p, pc = pattn.gqa_apply(pp, pcfg, torch.from_numpy(x[:, lo:hi]),
                                  torch.from_numpy(pos[:, lo:hi].copy()),
                                  "naive", pc, lo)
        _close(y_p, y_j, 1e-5)
        for a, w in zip(pc, jc):
            _close(a, w, 1e-6)

"""The port's decoder stack against the JAX package, at the tiny configs
of zamba2-1.2b (hybrid: ssm + the weight-tied shared block), mamba2-130m
(pure SSM) and llama3.2-3b (dense GQA, n_kv < n_heads, tied embeddings),
with the reference's weights carried across by ``params_from_jax``.

Tolerance: hidden states and logits 1e-4 -- fp32 throughout, the same
functions with matmuls, exp and the chunked SSD summed in another order
through 4-5 layers (measured differences are near 1e-6); prefill + one
decode step against the full forward 2e-3, as tests/test_arch_smoke.py
holds the reference (the decode step runs the token recurrence, the
prefill the chunked form)."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtf
from repro_torch.configs import all_archs, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as ptf

ARCHS = ["zamba2-1.2b", "mamba2-130m", "llama3.2-3b"]
TOL = 1e-4
J_FORWARD = jax.jit(jtf.forward, static_argnums=(1,),
                    static_argnames=("n_segments",))
J_LOGITS = jax.jit(jtf.logits_fn, static_argnums=(1,))


def _pair(arch_id, seed=0):
    jcfg, pcfg = jget_arch(arch_id).tiny, get_arch(arch_id).tiny
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    # zero-initialised norms and biases: give them values so a mix-up shows
    leaves, treedef = jax.tree.flatten(jp)
    rng = np.random.default_rng(seed + 1)
    leaves = [np.asarray(l) if np.any(np.asarray(l) != 0) else
              (rng.standard_normal(l.shape) * 0.1).astype(np.float32)
              for l in leaves]
    jp = jax.tree.unflatten(treedef, [jnp.asarray(l) for l in leaves])
    return jcfg, pcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


def _tokens(cfg, b, s, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(port.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_registry_and_param_counts():
    assert sorted(all_archs()) == sorted(ARCHS)
    for arch_id in ARCHS:
        p, j = get_arch(arch_id), jget_arch(arch_id)
        assert dataclasses.asdict(p)["model"]["segments"] == j.model.segments
        assert p.param_count() == j.param_count()
    z = get_arch("zamba2-1.2b").model
    assert sum(n for k, n in z.segments if k == "ssm") == 38
    assert sum(n for k, n in z.segments if k == "shared_ref") == 6
    for arch_id in ("deepseek-moe-16b", "deepseek-v2-236b",
                    "llama3.2-vision-11b", "musicgen-medium", "qwen2.5-14b"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
            get_arch(arch_id)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_and_logits_match_reference(arch_id):
    jcfg, pcfg, jp, pp = _pair(arch_id)
    tok = _tokens(pcfg, 2, 19)
    hid_j, _, _ = J_FORWARD(jp, jcfg, {"tokens": jnp.asarray(tok)})
    hid_p, caches, aux = ptf.forward(pp, pcfg,
                                     {"tokens": torch.from_numpy(tok)})
    assert hid_p.shape == (2, 19, pcfg.d_model) and aux == 0.0
    assert caches == [None] * len(pcfg.segments)
    _close(hid_p, hid_j)
    _close(ptf.logits_fn(pp, pcfg, hid_p), J_LOGITS(jp, jcfg, hid_j))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_segment_truncation_matches_reference(arch_id):
    jcfg, pcfg, jp, pp = _pair(arch_id)
    tok = _tokens(pcfg, 2, 11)
    n = max(1, len(pcfg.segments) // 2)
    hid_j, _, _ = J_FORWARD(jp, jcfg, {"tokens": jnp.asarray(tok)},
                            n_segments=n)
    hid_p, caches, _ = ptf.forward(pp, pcfg, {"tokens": torch.from_numpy(tok)},
                                   n_segments=n)
    assert len(caches) == n
    _close(hid_p, hid_j)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch_id):
    """As tests/test_arch_smoke.py: prefill S-1 tokens into caches, decode
    the last one, compare with one full forward -- and the caches with the
    reference's."""
    jcfg, pcfg, jp, pp = _pair(arch_id)
    b, s, smax = 2, 12, 16
    tok = _tokens(pcfg, b, s)
    full, _, _ = ptf.forward(pp, pcfg, {"tokens": torch.from_numpy(tok)})
    caches = ptf.make_caches(pcfg, b, smax, "cpu")
    _, caches, _ = ptf.forward(pp, pcfg,
                               {"tokens": torch.from_numpy(tok[:, :-1])},
                               caches=caches, cache_pos=0)
    step, caches, _ = ptf.forward(pp, pcfg,
                                  {"tokens": torch.from_numpy(tok[:, -1:])},
                                  caches=caches, cache_pos=s - 1)
    _close(step[:, 0], full[:, -1].numpy(), 2e-3)
    jc = jtf.make_caches(jcfg, b, smax)
    _, jc, _ = J_FORWARD(jp, jcfg, {"tokens": jnp.asarray(tok[:, :-1])},
                         caches=jc, cache_pos=jnp.int32(0))
    jstep, jc, _ = J_FORWARD(jp, jcfg, {"tokens": jnp.asarray(tok[:, -1:])},
                             caches=jc, cache_pos=jnp.int32(s - 1))
    _close(step, jstep)
    for pc, jcc in zip(caches, jc):
        for a, w in zip(pc, jcc):
            _close(a, w)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_cache_shapes_match_reference(arch_id):
    for which in ("tiny", "model"):
        pcfg = getattr(get_arch(arch_id), which)
        jcfg = getattr(jget_arch(arch_id), which)
        pspec = ptf.cache_spec(pcfg, 3, 40)
        jspec = jtf.cache_spec(jcfg, 3, 40)
        assert [tuple(s[:-1] for s in seg) for seg in pspec] == \
            [tuple(s[:-1] for s in seg) for seg in jspec]
        for pseg, jseg in zip(pspec, jspec):
            for ps, js in zip(pseg, jseg):
                assert str(ps[-1]).split(".")[-1] == jnp.dtype(js[-1]).name
    caches = ptf.make_caches(get_arch(arch_id).tiny, 3, 40, "cpu")
    for c, spec in zip(caches, ptf.cache_spec(get_arch(arch_id).tiny, 3, 40)):
        assert [tuple(t.shape) for t in c] == [s[:-1] for s in spec]


def test_params_from_jax_resolves_the_card_by_default():
    """Without ``device`` the carried weights go to the CUDA card, as every
    port entry point does (``_device.resolve_device``); without a card that
    raises instead of falling back to the CPU."""
    tree = {"w": np.ones((2, 3), np.float32), "seg": [{}]}
    if torch.cuda.is_available():
        assert params_from_jax(tree)["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA card"):
            params_from_jax(tree)
    assert params_from_jax(tree, device="cpu")["w"].device.type == "cpu"


def test_params_from_jax_carries_bf16_and_the_tree_layout():
    """bf16 leaves (ml_dtypes) keep their bits; the list of stacked segment
    dicts and the empty ``{}`` of each ``shared_ref`` keep their places."""
    jcfg = jget_arch("zamba2-1.2b").tiny.with_(param_dtype=jnp.bfloat16,
                                               compute_dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(4)))
    pp = params_from_jax(jp, device="cpu")
    assert sorted(pp) == sorted(jp)
    assert isinstance(pp["segments"], list)
    for (kind, n), seg, jseg in zip(jcfg.segments, pp["segments"],
                                    jp["segments"]):
        if kind == "shared_ref":
            assert seg == {} and jseg == {}
            continue
        assert seg["mixer"]["w_x"].shape[0] == n
    flat_p = jax.tree.leaves(jax.tree.map(lambda t: t, pp,
                                          is_leaf=torch.is_tensor))
    flat_j = jax.tree.leaves(jp)
    assert len(flat_p) == len(flat_j)
    for t, a in zip(flat_p, flat_j):
        assert t.shape == a.shape
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), a)
    # and the port runs the carried bf16 weights
    pcfg = get_arch("zamba2-1.2b").tiny.with_(param_dtype=torch.bfloat16,
                                              compute_dtype=torch.bfloat16)
    hid, _, _ = ptf.forward(pp, pcfg,
                            {"tokens": torch.from_numpy(_tokens(pcfg, 1, 9))})
    assert hid.dtype == torch.bfloat16 and torch.isfinite(hid.float()).all()

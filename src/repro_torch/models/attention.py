"""GQA/MHA/MQA self-attention (the port of ``repro/models/attention.py``).

``attend`` selects the inner implementation by ``impl``, as the reference
does, but on a CUDA card **every** ``impl`` runs kernel F
(``kernels.ops.flash_attention``): the tiny configs ask for ``naive``, the
full ones for ``xla_flash``, and both are the same function.  On the CPU:

  * ``naive``     materialises the [S, S] score matrix;
  * ``xla_flash`` the online softmax over key chunks (kernel F's plain
                  version with the reference's chunk);
  * ``pallas``    kernel F's plain version at the kernel's own tile.

All take GQA (n_kv <= n_q, n_q % n_kv == 0) and a causal flag and return
[B, S, Hq, hd].  MLA and cross-attention are not ported yet (ROADMAP.md
Queue 1 item 13).  The reference's ``flash_decode`` branch runs only under a
device mesh with tensor parallelism > 1, which the port does not have; a
config asking for it decodes on the plain path, as the reference does
without a mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30
IMPLS = ("naive", "xla_flash", "pallas")


def attention_naive(q, k, v, causal: bool, q_offset=0):
    """q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd]."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q = q.reshape(b, sq, hkv, hq // hkv, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).to(torch.float32)
    scores = scores / np.sqrt(hd)
    if causal:
        qpos = torch.arange(sq, device=q.device) + int(q_offset)
        kpos = torch.arange(skv, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, sq, hq, hd)


def attention_xla_flash(q, k, v, causal: bool, q_offset=0, chunk: int = 1024,
                        unroll: bool = False):
    """Online-softmax attention over key chunks of ``chunk`` (``unroll`` has
    no effect in the port).  The reference scales q in its own dtype before
    the fp32 cast; this applies the scale in fp32, as kernel F does."""
    del unroll
    return flash_attention_plain(q, k, v, causal, q_offset, block_k=chunk)


def attend(q, k, v, causal: bool, impl: str = "naive", q_offset=0,
           chunk: int = 1024, unroll: bool = False):
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl}")
    if q.device.type == "cuda":
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   q_offset=q_offset)
    if impl == "naive":
        return attention_naive(q, k, v, causal, q_offset)
    if impl == "xla_flash":
        return attention_xla_flash(q, k, v, causal, q_offset, chunk, unroll)
    return ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


# ----------------------------------------------------------------------
# Standard (GQA) attention layer
# ----------------------------------------------------------------------

def gqa_init(generator, cfg, dtype, device=None):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(generator, d, hq * hd, dtype, device),
        "wk": dense_init(generator, d, hkv * hd, dtype, device),
        "wv": dense_init(generator, d, hkv * hd, dtype, device),
        "wo": dense_init(generator, hq * hd, d, dtype, device,
                         scale=1.0 / np.sqrt(hq * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dtype, device=device)
    return p


def gqa_qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    rd = cfg.rotary_dim or hd
    q = apply_rope(q, positions, cfg.rope_theta, rd)
    k = apply_rope(k, positions, cfg.rope_theta, rd)
    return q, k, v


def gqa_apply(p, cfg, x, positions, impl, kv_cache=None, cache_pos=None):
    """Self-attention.  With ``kv_cache=(k, v)`` [B,Smax,Hkv,hd] the new k/v
    are written at ``cache_pos`` (in place: the cache tensors are updated
    and returned) and attention runs over the whole cache, the causal mask
    shifted by ``cache_pos`` hiding the slots not written yet."""
    q, k, v = gqa_qkv(p, cfg, x, positions)
    if kv_cache is not None:
        ck, cv = kv_cache
        pos = int(cache_pos)
        s = x.shape[1]
        ck[:, pos:pos + s] = k.to(ck.dtype)
        cv[:, pos:pos + s] = v.to(cv.dtype)
        out = attend(q, ck, cv, causal=True, impl=impl, q_offset=pos,
                     chunk=cfg.attn_chunk, unroll=cfg.scan_unroll)
        new_cache = (ck, cv)
    else:
        out = attend(q, k, v, causal=True, impl=impl,
                     chunk=cfg.attn_chunk, unroll=cfg.scan_unroll)
        new_cache = None
    b, s = x.shape[:2]
    y = out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return y, new_cache


def _not_ported(what):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1 item 13)")


def mla_init(*args, **kwargs):
    _not_ported("MLA (multi-head latent attention)")


def mla_apply(*args, **kwargs):
    _not_ported("MLA (multi-head latent attention)")


def cross_init(*args, **kwargs):
    _not_ported("cross-attention")


def cross_apply(*args, **kwargs):
    _not_ported("cross-attention")

"""Kernel **F**, flash-attention forward: its wrapper and its plain PyTorch
version.  The port of the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention_bhsd``; the CUDA source
is ``csrc/flash_attention.cu``.

Both take the public layouts, q ``[B, Sq, Hq, hd]`` and k/v ``[B, Skv,
Hkv, hd]`` (q-head h reads kv-head ``h // (Hq // Hkv)``), and return
``[B, Sq, Hq, hd]`` in q's dtype: an online softmax over key tiles with m,
l and acc in fp32, the scale applied in fp32 after the load, keys masked by
``kpos < Skv`` (the true length; nothing is padded) and, when causal,
``kpos <= qpos + q_offset``, and out ``acc / max(l, 1e-30)``.

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it checks device, dtype, shape and contiguity, launches on the current
stream, raises on a refused launch and counts the launch.  The reference
wrapper (``repro/kernels/ops.py:flash_attention``) pads K/V to a block
multiple and passes the padded length as the key bound, so its non-causal
attention over a ragged key length lets the zero keys into the softmax;
this kernel masks with the true length and is held against
``ref.flash_attention_ref`` there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
#: keys per tile, in the kernel and in the plain version
BLOCK_K = 64
HEAD_DIMS = (16, 32, 64, 128)


def _scale(hd: int) -> float:
    return float(np.float32(1.0 / np.sqrt(hd)))


def flash_attention_plain(q, k, v, causal: bool = True, q_offset: int = 0,
                          block_k: int = BLOCK_K):
    """Plain version of kernel F (shapes as the module says), an online
    softmax over ``block_k``-key tiles in fp32."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    qf = q.reshape(b, sq, hkv, g, hd).to(torch.float32) * _scale(hd)
    qpos = torch.arange(sq, device=dev) + int(q_offset)
    m = torch.full((b, sq, hkv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, hkv, g, hd), dtype=torch.float32, device=dev)
    kv_end = min(skv, sq + int(q_offset)) if causal else skv
    for k0 in range(0, kv_end, block_k):
        kb = k[:, k0:k0 + block_k].to(torch.float32)
        vb = v[:, k0:k0 + block_k].to(torch.float32)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        if causal:
            kpos = torch.arange(k0, k0 + kb.shape[1], device=dev)
            ok = kpos[None, :] <= qpos[:, None]
            s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p,
                                                    vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """Kernel F on CUDA tensors (bf16 or fp32, head dim in ``HEAD_DIMS``),
    ``flash_attention_plain`` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, q_offset)
    dev, dtype = q.device, q.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention takes bf16 or fp32, got {dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_tensor(name, t, dtype, None, dev)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Sq,Hq,hd] and k/v [B,Skv,Hkv,hd], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if hq % hkv != 0:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} "
                         f"kv heads")
    if skv < 1 or int(q_offset) < 0:
        raise ValueError(f"need Skv >= 1 and q_offset >= 0, got {skv}, "
                         f"{q_offset}")
    out = torch.empty_like(q)
    err = _build.library("flash_attention").launch_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        hq, hkv, hd, int(causal), int(q_offset), int(dtype == torch.bfloat16),
        _build.stream(dev))
    _build.raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

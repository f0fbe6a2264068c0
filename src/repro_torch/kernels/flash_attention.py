"""Kernel **F**, flash-attention forward: its wrapper, its two CUDA
kernels and its plain PyTorch version.  The port of the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention_bhsd``; the CUDA source
is ``csrc/flash_attention.cu``.

All take the public layouts, q ``[B, Sq, Hq, hd]`` and k/v ``[B, Skv,
Hkv, hd]`` (q-head h reads kv-head ``h // (Hq // Hkv)``), and return
``[B, Sq, Hq, hd]`` in q's dtype: an online softmax over key tiles with m,
l and acc in fp32, the scale applied in fp32, keys masked by ``kpos <
Skv`` (the true length; nothing is padded) and, when causal, ``kpos <= qpos
+ q_offset``, and out ``acc / max(l, 1e-30)``.

``flash_attention`` takes the plain version only for CPU tensors.  For CUDA
tensors it checks device, dtype, shape and contiguity and dispatches on
(dtype, hd), explicitly:

* bf16 with hd in ``WGMMA_HEAD_DIMS`` (64, 128): ``flash_attention_wgmma``,
  the tensor-core kernel (wgmma, P split into two bf16 terms);
* fp32 with hd in ``HEAD_DIMS``, and bf16 with hd 16 or 32:
  ``flash_attention_fma``, the fp32-FMA kernel.

Each launcher launches on the current stream, raises on a refused launch
and adds one to its own ``launches`` counter; ``flash_attention.launches``
counts the launches of both.  There is no fallback between the two and
none to the plain version.  The reference wrapper
(``repro/kernels/ops.py:flash_attention``) pads K/V to a block multiple and
passes the padded length as the key bound, so its non-causal attention over
a ragged key length lets the zero keys into the softmax; these kernels mask
with the true length and are held against ``ref.flash_attention_ref``
there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
#: keys per tile, in the kernel and in the plain version
BLOCK_K = 64
HEAD_DIMS = (16, 32, 64, 128)
#: the head dims of the tensor-core kernel (bf16 only)
WGMMA_HEAD_DIMS = (64, 128)


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


def _check(q, k, v, dtypes):
    """The shape rules both kernels share; returns (b, sq, skv, hq, hkv,
    hd)."""
    dev, dtype = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {dev}; "
                         f"flash_attention runs the plain version there")
    if dtype not in dtypes:
        raise TypeError(f"flash_attention takes {dtypes}, got {dtype}")
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
    if hq % hkv != 0:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} "
                         f"kv heads")
    if skv < 1:
        raise ValueError(f"need Skv >= 1, got {skv}")
    return b, sq, skv, hq, hkv, hd


def flash_attention_wgmma(q, k, v, causal: bool = True, q_offset: int = 0):
    """The tensor-core kernel on CUDA tensors: bf16, hd in
    ``WGMMA_HEAD_DIMS``."""
    b, sq, skv, hq, hkv, hd = _check(q, k, v, (torch.bfloat16,))
    if hd not in WGMMA_HEAD_DIMS or int(q_offset) < 0:
        raise ValueError(f"the wgmma kernel takes head dims "
                         f"{WGMMA_HEAD_DIMS} and q_offset >= 0, got {hd}, "
                         f"{q_offset}")
    out = torch.empty_like(q)
    err = _build.library("flash_attention").launch_flash_attention_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        hq, hkv, hd, int(causal), int(q_offset), _build.stream(q.device))
    _build.raise_on(err, "flash_attention_wgmma")
    flash_attention_wgmma.launches += 1
    return out


def flash_attention_fma(q, k, v, causal: bool = True, q_offset: int = 0):
    """The fp32-FMA kernel on CUDA tensors: bf16 or fp32, hd in
    ``HEAD_DIMS``."""
    b, sq, skv, hq, hkv, hd = _check(q, k, v,
                                     (torch.bfloat16, torch.float32))
    if hd not in HEAD_DIMS or int(q_offset) < 0:
        raise ValueError(f"the fma kernel takes head dims {HEAD_DIMS} and "
                         f"q_offset >= 0, got {hd}, {q_offset}")
    out = torch.empty_like(q)
    err = _build.library("flash_attention").launch_flash_attention_fma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        hq, hkv, hd, int(causal), int(q_offset),
        int(q.dtype == torch.bfloat16), _build.stream(q.device))
    _build.raise_on(err, "flash_attention_fma")
    flash_attention_fma.launches += 1
    return out


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """Kernel F on CUDA tensors, dispatched on (dtype, hd) as the module
    says; ``flash_attention_plain`` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, q_offset)
    if q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS:
        out = flash_attention_wgmma(q, k, v, causal, q_offset)
    else:
        out = flash_attention_fma(q, k, v, causal, q_offset)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention_wgmma.launches = 0
flash_attention_fma.launches = 0

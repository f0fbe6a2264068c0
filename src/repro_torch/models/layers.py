"""Primitive layers (the port of ``repro/models/layers.py``): plain
functions over explicit parameter dicts of tensors.

Init functions take a ``torch.Generator`` (on the device the tensors are
made on; None draws from torch's default generator, as on the ``meta``
device) and return the dict for one layer.  The reference's fp32 upcasts
are kept: norms and RoPE compute in fp32 and cast back, logits are fp32.
"""
from __future__ import annotations

import numpy as np
import torch


def truncated_normal(generator, shape, stddev, dtype, device=None):
    """``stddev`` times a standard normal truncated to [-2, 2]."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * stddev).to(dtype)


def dense_init(generator, d_in, d_out, dtype, device=None,
               scale: float | None = None):
    std = scale if scale is not None else (1.0 / np.sqrt(d_in))
    return truncated_normal(generator, (d_in, d_out), std, dtype, device)


def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + w.to(torch.float32))).to(dt)


# ----------------------------------------------------------------------
# Rotary position embeddings (full or partial; llama-style half rotation).
# ----------------------------------------------------------------------

def rope_freqs(rotary_dim: int, theta: float, device=None):
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=device) / rotary_dim
    return 1.0 / (theta ** exps)                       # [rotary_dim // 2]


def apply_rope(x, positions, theta: float, rotary_dim: int | None = None):
    """x: [..., S, H, hd]; positions: [..., S] integer. Rotates the first
    ``rotary_dim`` features (partial RoPE)."""
    hd = x.shape[-1]
    rd = rotary_dim if rotary_dim is not None else hd
    inv = rope_freqs(rd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv  # [..., S, rd/2]
    cos = torch.cos(ang)[..., None, :]                  # [..., S, 1, rd/2]
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    x1, x2 = torch.chunk(x_rot, 2, dim=-1)
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), x_pass], dim=-1)


# ----------------------------------------------------------------------
# Gated MLP (SwiGLU).
# ----------------------------------------------------------------------

def mlp_init(generator, d_model, d_ff, dtype, device=None):
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype, device),
        "w_in": dense_init(generator, d_model, d_ff, dtype, device),
        "w_out": dense_init(generator, d_ff, d_model, dtype, device),
    }


def mlp_apply(p, x):
    h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_in"])
    return h @ p["w_out"]


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------

def embed_init(generator, vocab, d_model, dtype, device=None):
    return truncated_normal(generator, (vocab, d_model),
                            1.0 / np.sqrt(d_model), dtype, device)


def embed_apply(table, tokens):
    return table[tokens]


def unembed_apply(w, x):
    """x [.., D] @ w [D, V] -> fp32 logits."""
    return (x @ w).to(torch.float32)

"""Plain oracles for kernels F and M (the port of
``repro/kernels/ref.py``): full-softmax attention and the token-by-token
SSD recurrence.  The tests sweep the kernels' plain versions, and through
them the kernels, against these."""
from __future__ import annotations

import numpy as np
import torch


def flash_attention_ref(q, k, v, causal: bool = True, q_offset: int = 0):
    """q [B,S,Hq,hd]; k/v [B,Skv,Hkv,hd] -> [B,S,Hq,hd]; fp32 softmax over
    the whole key axis."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, sq, hkv, g, hd).to(torch.float32) / np.sqrt(hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32))
    if causal:
        qpos = torch.arange(sq, device=q.device) + int(q_offset)
        kpos = torch.arange(skv, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(b, sq, hq, hd).to(q.dtype)


def ssd_scan_ref(x, dt, A, B, C, h0=None):
    """Token-level recurrence. x [b,s,nh,dh]; dt [b,s,nh]; A [nh];
    B/C [b,s,ng,ds].  Returns (y [b,s,nh,dh] in x's dtype, hT fp32)."""
    b, s, nh, dh = x.shape
    ng, ds = B.shape[2], B.shape[3]
    rep = nh // ng
    h = (torch.zeros((b, nh, dh, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    ys = []
    for t in range(s):
        la = dt[:, t] * A[None, :]
        bt = torch.repeat_interleave(B[:, t], rep, dim=1).to(torch.float32)
        ct = torch.repeat_interleave(C[:, t], rep, dim=1).to(torch.float32)
        u = (x[:, t] * dt[:, t][..., None]).to(torch.float32)
        h = torch.exp(la)[:, :, None, None] * h + u[..., None] * bt[:, :, None, :]
        ys.append(torch.einsum("bhdn,bhn->bhd", h, ct))
    return torch.stack(ys, dim=1).to(x.dtype), h

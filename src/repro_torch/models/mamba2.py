"""Mamba2 (state-space duality) block (the port of
``repro/models/mamba2.py``): the chunked SSD for prefill and the one-token
recurrent step for decode.

Math per head (state size ds, head dim dh), discretised:
    la_t   = dt_t * A                    (A < 0, per head; la = log decay)
    h_t    = exp(la_t) h_{t-1} + dt_t * x_t B_t^T          [dh, ds]
    y_t    = h_t C_t + D * x_t

``ssd_chunked`` is ``kernels.ops.ssd_scan``: kernel M on the card, its
plain version (the reference's ``ssd_chunked`` op for op) on the CPU.  The
one-token decode step with a state keeps the reference's token recurrence
``ssd_reference`` in PyTorch on both; the reference runs no kernel there
either.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import dense_init, rms_norm


def mamba2_init(generator, cfg, dtype, device=None):
    """Separate projections (w_z / w_x / w_B / w_C / w_dt), as the
    reference keeps them; ``out_proj`` is the last draw."""
    d = cfg.d_model
    di = cfg.ssm_d_inner
    ng, ds, nh = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_n_heads
    gdim = ng * ds
    kc = cfg.ssm_d_conv

    def conv(width):
        w = torch.randn((kc, width), generator=generator,
                        dtype=torch.float32, device=device)
        return (w / np.sqrt(kc)).to(dtype)

    def zeros(n, dt=dtype):
        return torch.zeros((n,), dtype=dt, device=device)

    p = {
        "w_z": dense_init(generator, d, di, dtype, device),
        "w_x": dense_init(generator, d, di, dtype, device),
        "w_B": dense_init(generator, d, gdim, dtype, device),
        "w_C": dense_init(generator, d, gdim, dtype, device),
        "w_dt": dense_init(generator, d, nh, dtype, device),
        "conv_x": conv(di), "conv_x_b": zeros(di),
        "conv_B": conv(gdim), "conv_B_b": zeros(gdim),
        "conv_C": conv(gdim), "conv_C_b": zeros(gdim),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=device)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": zeros(nh, torch.float32),
        "ssm_norm": zeros(di),
        "out_proj": dense_init(generator, di, d, dtype, device),
    }
    return p


def _causal_conv(xbc, w, b, conv_state=None):
    """Depthwise causal conv over the sequence axis. xbc [B,S,C]; w [K,C].
    With ``conv_state`` [B,K-1,C] (decode) the state is prepended; returns
    ``(silu(conv + b), new_state)``."""
    kw = w.shape[0]
    if conv_state is None:
        pad = torch.nn.functional.pad(xbc, (0, 0, kw - 1, 0))
        new_state = pad[:, -(kw - 1):, :] if kw > 1 else None
    else:
        pad = torch.cat([conv_state, xbc], dim=1)
        new_state = pad[:, -(kw - 1):, :]
    n = pad.shape[1] - (kw - 1)
    out = pad[:, 0:n, :] * w[0]
    for i in range(1, kw):
        out = out + pad[:, i:i + n, :] * w[i]
    return torch.nn.functional.silu(out + b), new_state


def ssd_chunked(x, dt, A, B, C, chunk: int = 128, h0=None,
                unroll: bool = False):
    """x [b,s,nh,dh]; dt [b,s,nh]; A [nh]; B,C [b,s,ng,ds] -> (y
    [b,s,nh,dh], h_final [b,nh,dh,ds]); ``unroll`` has no effect."""
    del unroll
    return ops.ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                        B.contiguous(), C.contiguous(),
                        None if h0 is None else h0.contiguous(), chunk)


def ssd_reference(x, dt, A, B, C, h0=None):
    """Token-by-token recurrence (decode, and the semantic ground truth):
    ``kernels.ref.ssd_scan_ref``."""
    return ref.ssd_scan_ref(x, dt, A, B, C, h0)


def mamba2_apply(p, cfg, x, ssm_state=None, conv_state=None,
                 impl: str = "chunked"):
    """Full block. x [B,S,D].  For decode pass states (S=1).  The conv cache
    keeps the reference's concatenated layout [B, K-1, di + 2*ng*ds]."""
    b, s, d = x.shape
    di, ng, ds, nh = (cfg.ssm_d_inner, cfg.ssm_n_groups, cfg.ssm_state,
                      cfg.ssm_n_heads)
    gdim = ng * ds
    dh = di // nh
    z = x @ p["w_z"]
    xr = x @ p["w_x"]
    Br = x @ p["w_B"]
    Cr = x @ p["w_C"]
    dt_raw = x @ p["w_dt"]
    cs = (None, None, None)
    if conv_state is not None:
        cs = (conv_state[..., :di], conv_state[..., di:di + gdim],
              conv_state[..., di + gdim:])
    xi, ncx = _causal_conv(xr, p["conv_x"], p["conv_x_b"], cs[0])
    B, ncb = _causal_conv(Br, p["conv_B"], p["conv_B_b"], cs[1])
    C, ncc = _causal_conv(Cr, p["conv_C"], p["conv_C_b"], cs[2])
    new_conv = (None if ncx is None else torch.cat([ncx, ncb, ncc], dim=-1))
    xi = xi.reshape(b, s, nh, dh)
    B = B.reshape(b, s, ng, ds)
    C = C.reshape(b, s, ng, ds)
    dt = torch.nn.functional.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if impl == "pallas":
        y, hT = ops.ssd_scan(xi.contiguous(), dt, A, B.contiguous(),
                             C.contiguous(), ssm_state, cfg.ssm_chunk)
    elif s == 1 and ssm_state is not None:
        y, hT = ssd_reference(xi, dt, A, B, C, h0=ssm_state)
    else:
        y, hT = ssd_chunked(xi, dt, A, B, C, chunk=cfg.ssm_chunk,
                            h0=ssm_state, unroll=cfg.scan_unroll)
    y = y + p["D"][None, None, :, None] * xi.to(torch.float32)
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * torch.nn.functional.silu(z), p["ssm_norm"])
    out = y @ p["out_proj"]
    return out, hT, new_conv

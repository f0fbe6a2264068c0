"""Kernel **M**, the Mamba2 SSD chunked scan: its wrapper and its plain
PyTorch version.  The port of the Pallas kernel
``repro/kernels/ssd_scan.py:ssd_scan_bhcqd``, whose oracle is the XLA path
the reference model runs, ``repro/models/mamba2.py:ssd_chunked``; the CUDA
source is ``csrc/ssd_scan.cu``.

Public layouts: x ``[b, s, nh, dh]``, dt ``[b, s, nh]`` fp32, A ``[nh]``
fp32, B/C ``[b, s, ng, ds]`` (head h reads group ``h * ng // nh``), h0
``[b, nh, dh, ds]`` fp32 or None.  Returns ``(y [b, s, nh, dh] in x's
dtype, hT [b, nh, dh, ds] fp32)``.  Per chunk of ``chunk`` tokens, with
``L = cumsum(dt * A)`` and ``u = x * dt``:

    y_i = sum_{j<=i} (C_i . B_j) exp(L_i - L_j) u_j + exp(L_i) C_i h^T
    h'  = exp(L_Q) h + sum_j (u_j exp(L_Q - L_j))^T B_j

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it checks device, dtype, shape and contiguity, launches on the current
stream, raises on a refused launch and counts the launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def ssd_scan_plain(x, dt, A, B, C, h0=None, chunk: int = 128):
    """Plain version of kernel M: ``ssd_chunked`` of the reference, op for
    op (zero padding to a chunk multiple, the causal mask applied in log
    space before ``exp``, fp32 state)."""
    b, s, nh, dh = x.shape
    ng, ds = B.shape[2], B.shape[3]
    rep = nh // ng
    nch = -(-s // chunk)
    pad = nch * chunk - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    xs = x.reshape(b, nch, chunk, nh, dh)
    dts = dt.reshape(b, nch, chunk, nh)
    Bs = B.reshape(b, nch, chunk, ng, ds)
    Cs = C.reshape(b, nch, chunk, ng, ds)
    L = torch.cumsum(dts * A[None, None, None, :], dim=2)   # [b,nc,Q,nh]
    iq = torch.arange(chunk, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None]
    h = (torch.zeros((b, nh, dh, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    ys = []
    for c in range(nch):
        xq, dtq, lq = xs[:, c], dts[:, c], L[:, c]
        bqh = torch.repeat_interleave(Bs[:, c], rep, dim=2).to(torch.float32)
        cqh = torch.repeat_interleave(Cs[:, c], rep, dim=2).to(torch.float32)
        u = xq * dtq[..., None]                              # [b,Q,nh,dh]
        g = torch.einsum("bihn,bjhn->bhij", cqh, bqh)
        dec = (lq[:, :, None, :] - lq[:, None, :, :]).permute(0, 3, 1, 2)
        dec = torch.where(causal, dec, float("-inf"))
        m = torch.where(causal, g, 0.0) * torch.exp(dec)
        y_intra = torch.einsum("bhij,bjhd->bihd", m, u.to(torch.float32))
        y_inter = torch.einsum("bihn,bhdn->bihd",
                               cqh * torch.exp(lq)[..., None], h)
        lQ = lq[:, -1, :]                                    # [b,nh]
        w = torch.exp(lQ[:, None, :] - lq)                   # [b,Q,nh]
        h = (torch.exp(lQ)[:, :, None, None] * h
             + torch.einsum("bjhd,bjhn->bhdn",
                            (u * w[..., None]).to(torch.float32), bqh))
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(b, nch * chunk, nh, dh)[:, :s]
    return y, h


def ssd_scan(x, dt, A, B, C, h0=None, chunk: int = 128):
    """Kernel M on CUDA tensors (x/B/C bf16 or fp32, one dtype), and
    ``ssd_scan_plain`` on CPU tensors."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, h0, chunk)
    dev, dtype = x.device, x.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ssd_scan takes bf16 or fp32 x, got {dtype}")
    b, s, nh, dh = x.shape
    ng, ds = B.shape[2], B.shape[3]
    f32 = torch.float32
    ins = [("x", x, dtype, (b, s, nh, dh)), ("dt", dt, f32, (b, s, nh)),
           ("A", A, f32, (nh,)), ("B", B, dtype, (b, s, ng, ds)),
           ("C", C, dtype, (b, s, ng, ds))]
    if h0 is not None:
        ins.append(("h0", h0, f32, (b, nh, dh, ds)))
    for name, t, dt_, shape in ins:
        _build.check_tensor(name, t, dt_, shape, dev)
    if s < 1 or chunk < 1 or nh % ng != 0:
        raise ValueError(f"need s >= 1, chunk >= 1 and nh % ng == 0, got "
                         f"s={s}, chunk={chunk}, nh={nh}, ng={ng}")
    y = torch.empty_like(x)
    hT = torch.empty((b, nh, dh, ds), dtype=f32, device=dev)
    # widths whose chunk does not fit in shared memory are refused by the
    # launch (cudaErrorInvalidValue)
    err = _build.library("ssd_scan").launch_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        hT.data_ptr(), b, s, nh, dh, ng, ds, int(chunk),
        int(dtype == torch.bfloat16), _build.stream(dev))
    _build.raise_on(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, hT


ssd_scan.launches = 0

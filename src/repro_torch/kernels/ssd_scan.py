"""Kernel **M**, the Mamba2 SSD chunked scan: its wrapper, its two CUDA
kernels and its plain PyTorch version.  The port of the Pallas kernel
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

``ssd_scan`` takes the plain version only for CPU tensors.  For CUDA
tensors it checks device, dtype, shape and contiguity and dispatches
explicitly on (dtype, widths, chunk):

* bf16 x/B/C with dh and ds multiples of 16 up to 128 and
  ``min(chunk, s) <= 128``: ``ssd_scan_mma``, the tensor-core kernel
  (mma.sync, the fp32 side of every product split into two bf16 terms);
* everything else (fp32 inputs, other widths or chunks): ``ssd_scan_fma``,
  the fp32-FMA kernel.

Each launcher launches on the current stream, raises on a refused launch
and adds one to its own ``launches`` counter; ``ssd_scan.launches`` counts
the launches of both.  There is no fallback between the two and none to the
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: the widest dh / ds and the longest chunk the tensor-core kernel takes
MMA_MAX_WIDTH = 128
MMA_MAX_CHUNK = 128


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


def _check(x, dt, A, B, C, h0, chunk, dtypes):
    """The shape rules both kernels share; returns (b, s, nh, dh, ng,
    ds)."""
    dev, dtype = x.device, x.dtype
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {dev}; "
                         f"ssd_scan runs the plain version there")
    if dtype not in dtypes:
        raise TypeError(f"ssd_scan takes {dtypes} x, got {dtype}")
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
    return b, s, nh, dh, ng, ds


def _mma_takes(dh, ds, s, chunk) -> bool:
    return (dh % 16 == 0 and ds % 16 == 0 and dh <= MMA_MAX_WIDTH
            and ds <= MMA_MAX_WIDTH and min(chunk, s) <= MMA_MAX_CHUNK)


def _launch(fn, x, dt, A, B, C, h0, chunk, *extra):
    b, s, nh, dh = x.shape
    ng, ds = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    hT = torch.empty((b, nh, dh, ds), dtype=torch.float32, device=x.device)
    err = getattr(_build.library("ssd_scan"), fn)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        hT.data_ptr(), b, s, nh, dh, ng, ds, int(chunk), *extra,
        _build.stream(x.device))
    _build.raise_on(err, fn)
    return y, hT


def ssd_scan_mma(x, dt, A, B, C, h0=None, chunk: int = 128):
    """The tensor-core kernel on CUDA tensors: bf16 x/B/C, dh and ds
    multiples of 16 up to ``MMA_MAX_WIDTH``, ``min(chunk, s) <=
    MMA_MAX_CHUNK``."""
    _, s, _, dh, _, ds = _check(x, dt, A, B, C, h0, chunk,
                                (torch.bfloat16,))
    if not _mma_takes(dh, ds, s, chunk):
        raise ValueError(f"the mma kernel takes dh, ds multiples of 16 up "
                         f"to {MMA_MAX_WIDTH} and min(chunk, s) <= "
                         f"{MMA_MAX_CHUNK}, got dh={dh}, ds={ds}, "
                         f"chunk={chunk}, s={s}")
    out = _launch("launch_ssd_scan_mma", x, dt, A, B, C, h0, chunk)
    ssd_scan_mma.launches += 1
    return out


def ssd_scan_fma(x, dt, A, B, C, h0=None, chunk: int = 128):
    """The fp32-FMA kernel on CUDA tensors: x/B/C bf16 or fp32 (one dtype);
    widths whose chunk does not fit in shared memory are refused by the
    launch (cudaErrorInvalidValue)."""
    _check(x, dt, A, B, C, h0, chunk, (torch.bfloat16, torch.float32))
    out = _launch("launch_ssd_scan_fma", x, dt, A, B, C, h0, chunk,
                  int(x.dtype == torch.bfloat16))
    ssd_scan_fma.launches += 1
    return out


def ssd_scan(x, dt, A, B, C, h0=None, chunk: int = 128):
    """Kernel M on CUDA tensors, dispatched on (dtype, widths, chunk) as the
    module says; ``ssd_scan_plain`` on CPU tensors."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, h0, chunk)
    if x.dtype == torch.bfloat16 and _mma_takes(x.shape[3], B.shape[3],
                                                x.shape[1], chunk):
        out = ssd_scan_mma(x, dt, A, B, C, h0, chunk)
    else:
        out = ssd_scan_fma(x, dt, A, B, C, h0, chunk)
    ssd_scan.launches += 1
    return out


ssd_scan.launches = 0
ssd_scan_mma.launches = 0
ssd_scan_fma.launches = 0

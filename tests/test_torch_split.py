"""Why kernels F and M pay for a second tensor-core product: their
arithmetic emulated in PyTorch on the CPU and held to the plain versions
under the rule the card's checks use (``chip_smoke.py``,
``tests/test_torch_cuda.py``).  No card is needed.

The tensor cores multiply bf16 by bf16 into an fp32 sum.  q, k, v, x, B
and C are bf16 already and enter unrounded; what the kernels must round is
the fp32 side of each product: F's P (the softmax weights) and M's folded
matrices (the decay matrix times dt, h, and B times dt and the decay).
Rounded once to bf16 (8 bits), the outputs miss the rule; split into
``hi = bf16(v)`` and ``lo = bf16(v - hi)`` (about 16 bits), each term
multiplied in, they meet it.

The rule: bf16 outputs element by element, |kernel - plain| <= 2**-7 *
|plain| + 1e-5 * max(1, max |plain|); M's fp32 state normwise, max
|kernel - plain| <= 1e-4 * max(1, max |plain|).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain

TOL_F32, TOL_STATE, RTOL_BF16 = 1e-5, 1e-4, 2.0 ** -7
f32, bf16 = torch.float32, torch.bfloat16


def _share(k, p, tol):
    """The worst element's share of its limit (<= 1 passes)."""
    kd, pd = k.double(), p.double()
    rtol = RTOL_BF16 if k.dtype == bf16 else 0.0
    atol = tol * max(1.0, float(pd.abs().max()))
    return float(((kd - pd).abs() / (rtol * pd.abs() + atol)).max())


def _round(v):
    """The fp32 side of a product rounded once to bf16."""
    return (v.to(bf16).to(f32),)


def _split(v):
    """The fp32 side split into two bf16 terms, hi + lo."""
    hi = v.to(bf16).to(f32)
    return hi, (v - hi).to(bf16).to(f32)


def _products(terms, other, eq):
    """Each bf16 term multiplied into ``other``, the products summed in
    fp32 (what the tensor cores do term by term)."""
    return sum(torch.einsum(eq, t, other) for t in terms)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(bf16)


# ----------------------------------------------------------------------
# F: P = softmax weights, split before P V
# ----------------------------------------------------------------------

def flash_emulated(q, k, v, form, block_k=64):
    """Kernel F's arithmetic, causal: S = q k^T in fp32 from bf16
    operands, an online softmax over ``block_k``-key tiles with m, l and
    O in fp32, P turned into bf16 terms by ``form`` before O += P V, l
    summed from the fp32 P."""
    b, s, h, hd = q.shape
    qf, kf, vf = (t.to(f32) for t in (q, k, v))
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    pos = torch.arange(s)
    m = torch.full((b, s, h), -torch.inf)
    l = torch.zeros((b, s, h))
    o = torch.zeros((b, s, h, hd))
    for k0 in range(0, s, block_k):
        sc = torch.einsum("bqhd,bkhd->bqhk", qf, kf[:, k0:k0 + block_k]) \
            * scale
        ok = pos[k0:k0 + block_k][None, :] <= pos[:, None]
        sc = torch.where(ok[None, :, None, :], sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _products(
            form(p), vf[:, k0:k0 + block_k], "bqhk,bkhd->bqhd")
        m = m_new
    return (o / torch.clamp_min(l, 1e-30)[..., None]).to(bf16)


@pytest.fixture(scope="module")
def flash_case():
    rng = np.random.default_rng(13)
    q, k, v = (_bf16(rng, 2, 320, 2, 64) for _ in range(3))
    return q, k, v, flash_attention_plain(q, k, v, True, 0)


def test_flash_two_term_p_meets_the_rule(flash_case):
    q, k, v, plain = flash_case
    assert _share(flash_emulated(q, k, v, _split), plain, TOL_F32) <= 1.0


def test_flash_p_rounded_once_misses_the_rule(flash_case):
    q, k, v, plain = flash_case
    assert _share(flash_emulated(q, k, v, _round), plain, TOL_F32) > 10.0


# ----------------------------------------------------------------------
# M: the folded fp32 matrices, split before each product
# ----------------------------------------------------------------------

def ssd_emulated(x, dt, A, B, C, form, chunk=128):
    """Kernel M's arithmetic (ng = 1, s a multiple of ``chunk``): per
    chunk G = C B^T in fp32 from bf16 operands; y_intra = (G o exp(L_i -
    L_j) dt_j, masked) x; y_inter = exp(L_i) C h^T; h' = exp(L_Q) h + x^T
    (B o dt_j exp(L_Q - L_j)); every fp32 matrix turned into bf16 terms by
    ``form`` before its product, h kept in fp32."""
    b, s, nh, dh = x.shape
    ds = B.shape[-1]
    xf, Bf, Cf = (t.to(f32) for t in (x, B, C))
    h = torch.zeros((b, nh, dh, ds))
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    ys = []
    for c0 in range(0, s, chunk):
        xc, Bc, Cc = (t[:, c0:c0 + chunk] for t in (xf, Bf[:, :, 0],
                                                     Cf[:, :, 0]))
        dtc = dt[:, c0:c0 + chunk]                            # [b, Q, nh]
        L = torch.cumsum(dtc * A, dim=1)
        G = torch.einsum("bin,bjn->bij", Cc, Bc)
        dec = (L[:, :, None, :] - L[:, None, :, :]).permute(0, 3, 1, 2)
        dec = torch.where(causal, dec, -torch.inf)
        Mf = G[:, None] * torch.exp(dec) * dtc.permute(0, 2, 1)[:, :, None, :]
        y = _products(form(Mf), xc, "bhij,bjhd->bihd")
        y = y + torch.exp(L)[..., None] * _products(
            form(h), Cc, "bhdn,bin->bihd")
        LQ = L[:, -1]                                         # [b, nh]
        w = dtc * torch.exp(LQ[:, None, :] - L)               # [b, Q, nh]
        Bw = Bc[:, :, None, :] * w[..., None]                 # [b, Q, nh, n]
        h = torch.exp(LQ)[:, :, None, None] * h + _products(
            form(Bw), xc, "bjhn,bjhd->bhdn")
        ys.append(y.to(bf16))
    return torch.cat(ys, dim=1), h


@pytest.fixture(scope="module")
def ssd_case():
    rng = np.random.default_rng(17)
    b, s, nh, dh, ds = 1, 256, 4, 64, 64
    x, B, C = _bf16(rng, b, s, nh, dh), _bf16(rng, b, s, 1, ds), \
        _bf16(rng, b, s, 1, ds)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, nh)).astype(np.float32)))
    A = -torch.exp(torch.from_numpy(
        (0.5 * rng.standard_normal(nh)).astype(np.float32)))
    return (x, dt, A, B, C), ssd_scan_plain(x, dt, A, B, C, chunk=128)


def test_ssd_split_form_meets_the_rule(ssd_case):
    args, (y_plain, h_plain) = ssd_case
    y, h = ssd_emulated(*args, _split)
    assert _share(y, y_plain, TOL_F32) <= 1.0
    assert _share(h, h_plain, TOL_STATE) <= 1.0


def test_ssd_bf16_operands_miss_the_rule_for_y_and_for_the_state(ssd_case):
    args, (y_plain, h_plain) = ssd_case
    y, h = ssd_emulated(*args, _round)
    assert _share(y, y_plain, TOL_F32) > 10.0
    assert _share(h, h_plain, TOL_STATE) > 10.0

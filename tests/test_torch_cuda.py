"""Kernels F, M, the fused D and S (alpha-RR and the table variant, under
Model 1 and on a Model-2 service slab, of up to 32 levels), P's Poisson
(both branches), Model-2 variants (up to 32 levels), ARMA rents (at q = 1
too, and on one row), the shaped uniform of one key, and the serving
engine, on the card:
held against their plain versions (the ``cuda`` tests skip without a card;
run them on the card with ``python -m pytest -m cuda
tests/test_torch_cuda.py``).  D and S are held bit for bit
(``torch.equal``).  The
CPU tests here check what surrounds the kernels: the per-library build
table and the wrappers' CPU route.  No JAX: this file runs where the port
runs.

Tolerances, as ``chip_smoke.py`` states them.  fp32 outputs, normwise
(max |kernel - plain| <= tol * max(1, max |plain|)): 1e-5 -- the same sums
in another order and the card's expf; M's fp32 y 1e-4 -- up to 2 * chunk
terms per output; M's fp32 state 1e-4 -- 128-term sums per chunk in
another order, compounded over the chunks.  bf16 outputs, element by
element: both versions round an fp32 value to bf16, one ulp (at most
2**-7 of the element) apart, so |kernel - plain| <= 2**-7 * |plain| +
1e-5 * max(1, max |plain|), the second term bounding the fp32 difference
before the rounding."""
import numpy as np
import pytest
import torch

from repro_torch.core.policies.baselines import table_form
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import hosting as H
from repro_torch.kernels import ssd_scan as SSD

import _be_tiles as T
import _table_tiles as TT

TOL_F32, TOL_STATE, RTOL_BF16 = 1e-5, 1e-4, 2.0 ** -7


def _rel(k, p):
    d = float((k.double() - p.double()).abs().max())
    return d / max(1.0, float(p.double().abs().max()))


def _close(k, p, tol):
    """|k - p| <= rtol * |p| + tol * max(1, max |p|) for every element,
    rtol 2**-7 for bf16 outputs and 0 for fp32 ones."""
    kd, pd = k.double(), p.double()
    rtol = RTOL_BF16 if k.dtype == torch.bfloat16 else 0.0
    atol = tol * max(1.0, float(pd.abs().max()))
    return bool(((kd - pd).abs() <= rtol * pd.abs() + atol).all())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_cuda.py)")
    return "cuda"


def test_build_table_is_per_library():
    assert set(_build.LIBRARIES) == {"hosting", "flash_attention",
                                     "ssd_scan"}
    paths = set()
    for name, (flags, symbols) in _build.LIBRARIES.items():
        assert (_build._CSRC / f"{name}.cu").exists()
        assert "arch=compute_90a,code=sm_90a" in flags and symbols
        src = (_build._CSRC / f"{name}.cu").read_text()
        for sym in symbols:
            assert f"int {sym}(" in src, (name, sym)
        paths.add(_build.library_path(name))
    assert len(paths) == 3
    # bit-exact hosting kernels forbid contraction; F and M need not
    assert "--fmad=false" in _build.LIBRARIES["hosting"][0]
    assert "--fmad=false" not in _build.LIBRARIES["flash_attention"][0]
    assert "--fmad=false" not in _build.LIBRARIES["ssd_scan"][0]


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 9, 2, 16), generator=g) for _ in range(3))
    counters = (FA.flash_attention, FA.flash_attention_wgmma,
                FA.flash_attention_fma, SSD.ssd_scan, SSD.ssd_scan_mma,
                SSD.ssd_scan_fma)
    before = [k.launches for k in counters]
    assert torch.equal(FA.flash_attention(q, k, v, True, 0),
                       FA.flash_attention_plain(q, k, v, True, 0))
    x = torch.randn((1, 11, 2, 8), generator=g)
    dt = torch.rand((1, 11, 2), generator=g)
    A = -torch.rand(2, generator=g)
    B, C = (torch.randn((1, 11, 1, 4), generator=g) for _ in range(2))
    for a, b in zip(SSD.ssd_scan(x, dt, A, B, C, chunk=4),
                    SSD.ssd_scan_plain(x, dt, A, B, C, chunk=4)):
        assert torch.equal(a, b)
    assert [k.launches for k in counters] == before
    # the kernels' own launchers refuse CPU tensors instead of building
    for launch, args in ((FA.flash_attention_wgmma, (q, k, v)),
                         (FA.flash_attention_fma, (q, k, v)),
                         (SSD.ssd_scan_mma, (x, dt, A, B, C)),
                         (SSD.ssd_scan_fma, (x, dt, A, B, C))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch(*args)


def test_bf16_rule_catches_a_normaliser_missing_a_late_key_tile():
    """The element-by-element bf16 rule has teeth where a normwise one does
    not: an output whose softmax normaliser leaves out keys 64..127 for the
    rows past 1024 (those rows scaled by 1 / (1 - their weight on the
    tile), a few per cent) is refused, while a limit of 2**-7 of the
    largest output (the first row, v[0] itself) lets it pass."""
    g = torch.Generator().manual_seed(5)
    b, s, h, hd, cut = 1, 2048, 2, 64, 1024
    q, k, v = (torch.randn((b, s, h, hd), generator=g).to(torch.bfloat16)
               for _ in range(3))
    good = FA.flash_attention_plain(q, k, v)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / hd ** 0.5
    sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                        float("-inf"))
    w_tile = torch.softmax(sc, -1)[..., 64:128].sum(-1)     # [b, h, s]
    scale = (1 / (1 - w_tile)).permute(0, 2, 1)[..., None]  # [b, s, h, 1]
    bad = good.clone()
    bad[:, cut:] = (good.float() * scale)[:, cut:].to(torch.bfloat16)
    assert _close(good, good, TOL_F32)
    assert not _close(bad, good, TOL_F32)
    assert _rel(bad, good) <= RTOL_BF16 + 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, dtype, kernel): the
    # wgmma kernel takes bf16 at hd 64 / 128, the fma kernel the rest
    (2, 64, 64, 4, 4, 16, True, 0, torch.float32, "fma"),
    (2, 100, 100, 4, 2, 32, True, 0, torch.float32, "fma"),
    (1, 80, 80, 8, 1, 64, True, 0, torch.bfloat16, "wgmma"),
    (1, 256, 256, 2, 2, 128, True, 0, torch.bfloat16, "wgmma"),
    (2, 1, 300, 4, 4, 64, True, 299, torch.bfloat16, "wgmma"),
    (1, 7, 300, 4, 4, 64, True, 200, torch.float32, "fma"),
    (2, 16, 80, 2, 2, 32, False, 0, torch.float32, "fma"),
    # the tensor-core kernel's edges: Sq not a multiple of its 128-row
    # q tile, decode at q_offset = Skv - 1, Skv ragged against the 64-key
    # tile, non-causal over a ragged Skv, GQA 8/2 at hd = 128
    (2, 200, 200, 4, 4, 64, True, 0, torch.bfloat16, "wgmma"),
    (2, 1, 2048, 4, 4, 64, True, 2047, torch.bfloat16, "wgmma"),
    (1, 100, 333, 2, 2, 64, True, 233, torch.bfloat16, "wgmma"),
    (2, 77, 1000, 4, 4, 64, False, 0, torch.bfloat16, "wgmma"),
    (2, 300, 300, 8, 2, 128, True, 0, torch.bfloat16, "wgmma"),
    # bf16 below the tensor-core head dims, and fp32 at them, stay on fma
    (2, 130, 130, 4, 4, 32, True, 0, torch.bfloat16, "fma"),
    (1, 140, 140, 2, 2, 64, True, 0, torch.float32, "fma"),
])
def test_flash_attention_kernel_matches_plain(case):
    dev = _card()
    b, sq, skv, hq, hkv, hd, causal, off, dtype, kernel = case
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, sq, hq, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, skv, hkv, hd), generator=g, device=dev)
            .to(dtype) for _ in range(2))
    ran = {"wgmma": FA.flash_attention_wgmma, "fma": FA.flash_attention_fma}
    n = FA.flash_attention.launches
    before = {name: fn.launches for name, fn in ran.items()}
    out = FA.flash_attention(q, k, v, causal, off)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == n + 1
    assert {name: fn.launches - before[name] for name, fn in ran.items()} \
        == {name: int(name == kernel) for name in ran}
    assert out.dtype == dtype and out.shape == q.shape
    assert _close(out, FA.flash_attention_plain(q, k, v, causal, off),
                  TOL_F32)


@pytest.mark.cuda
def test_flash_attention_kernels_agree_with_each_other():
    """Both kernels of F take bf16 at hd 64: held to each other under the
    same rule as to the plain version."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((2, 333, 4, 64), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    for causal in (True, False):
        a = FA.flash_attention_wgmma(q, k, v, causal, 0)
        b = FA.flash_attention_fma(q, k, v, causal, 0)
        torch.cuda.synchronize()
        assert _close(a, b, TOL_F32)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take():
    dev = _card()
    q = torch.randn((1, 8, 2, 64), device=dev)
    with pytest.raises(TypeError):
        FA.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError):
        FA.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        FA.flash_attention(torch.randn((1, 8, 2, 48), device=dev),
                           torch.randn((1, 8, 2, 48), device=dev),
                           torch.randn((1, 8, 2, 48), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (b, s, nh, dh, ng, ds, chunk, dtype, h0, kernel): the mma kernel
    # takes bf16 with dh, ds multiples of 16 up to 128 and min(chunk, s)
    # <= 128, the fma kernel the rest
    (1, 32, 2, 16, 1, 16, 16, torch.float32, False, "fma"),
    (1, 100, 4, 32, 2, 16, 32, torch.float32, True, "fma"),
    (2, 13, 4, 32, 1, 16, 8, torch.bfloat16, True, "mma"),
    (1, 200, 8, 64, 1, 128, 128, torch.float32, False, "fma"),
    (2, 300, 8, 64, 1, 64, 128, torch.bfloat16, False, "mma"),
    # the tensor-core kernel's edges: the scheduler's 8-token prompts
    # (chunk 8, s = 8), a ragged length with h0, ds = 128, both widths
    # 128 with two groups
    (2, 8, 8, 64, 1, 64, 8, torch.bfloat16, False, "mma"),
    (2, 2003, 8, 64, 1, 64, 128, torch.bfloat16, True, "mma"),
    (1, 300, 4, 64, 1, 128, 128, torch.bfloat16, True, "mma"),
    (1, 200, 8, 128, 2, 128, 128, torch.bfloat16, True, "mma"),
    # bf16 past its edges stays on fma: a chunk of 256, dh not a multiple
    # of 16
    (1, 300, 4, 64, 1, 64, 256, torch.bfloat16, False, "fma"),
    (1, 70, 4, 24, 1, 16, 32, torch.bfloat16, True, "fma"),
])
def test_ssd_kernel_matches_plain(case):
    dev = _card()
    b, s, nh, dh, ng, ds, chunk, dtype, with_h0, kernel = case
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = randn(b, s, nh, dh).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, s, nh))
    A = -torch.exp(randn(nh) * 0.5)
    B, C = randn(b, s, ng, ds).to(dtype), randn(b, s, ng, ds).to(dtype)
    h0 = randn(b, nh, dh, ds) if with_h0 else None
    ran = {"mma": SSD.ssd_scan_mma, "fma": SSD.ssd_scan_fma}
    n = SSD.ssd_scan.launches
    before = {name: fn.launches for name, fn in ran.items()}
    y, hT = SSD.ssd_scan(x, dt, A, B, C, h0, chunk)
    torch.cuda.synchronize()
    assert SSD.ssd_scan.launches == n + 1
    assert {name: fn.launches - before[name] for name, fn in ran.items()} \
        == {name: int(name == kernel) for name in ran}
    yp, hp = SSD.ssd_scan_plain(x, dt, A, B, C, h0, chunk)
    assert y.dtype == dtype and hT.dtype == torch.float32
    # fp32 y sums up to 2 * chunk terms per output: 10x the fp32 tolerance
    assert _close(y, yp, TOL_F32 * 10 if dtype == torch.float32
                  else TOL_F32)
    assert _close(hT, hp, TOL_STATE)
    with pytest.raises(TypeError):
        SSD.ssd_scan(x, dt, A, B.float() if dtype != torch.float32
                     else B.to(torch.bfloat16), C, h0, chunk)


@pytest.mark.cuda
def test_ssd_kernels_agree_with_each_other():
    """Both kernels of M take bf16 at dh = ds = 64, chunk 128: held to each
    other under the same rule as to the plain version."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = randn(2, 333, 8, 64).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(randn(2, 333, 8))
    A = -torch.exp(randn(8) * 0.5)
    B, C = (randn(2, 333, 1, 64).to(torch.bfloat16) for _ in range(2))
    h0 = randn(2, 8, 64, 64)
    ya, ha = SSD.ssd_scan_mma(x, dt, A, B, C, h0, 128)
    yb, hb = SSD.ssd_scan_fma(x, dt, A, B, C, h0, 128)
    torch.cuda.synchronize()
    assert _close(ya, yb, TOL_F32)
    assert _close(ha, hb, TOL_STATE)


@pytest.mark.cuda
def test_serving_engine_on_the_card_matches_the_cpu():
    dev = _card()
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.partial import make_plans
    spec = get_arch("zamba2-1.2b")
    params = init_params(spec.tiny, torch.Generator().manual_seed(1), "cpu")
    cpu = ServingEngine(spec, params=params, device="cpu")
    card = ServingEngine(spec, device=dev, params=_to(params, dev))
    plans, _ = make_plans(spec, model_cfg=spec.tiny)
    prompts = np.random.default_rng(3).integers(0, 256, (3, 21))
    n = FA.flash_attention.launches, SSD.ssd_scan.launches
    for level in (0.4, 1.0):
        rc = cpu.serve_slot(prompts, plans[level], np.random.default_rng(0))
        rd = card.serve_slot(prompts, plans[level], np.random.default_rng(0))
        assert (rc.served_edge, rc.served_partial, rc.service_cost) == \
            (rd.served_edge, rd.served_partial, rd.service_cost)
        assert _rel(card.last_logits.cpu(), cpu.last_logits) <= 1e-4
    assert FA.flash_attention.launches == n[0] + 2 + 1
    assert SSD.ssd_scan.launches == n[1] + 4 + 2


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ----------------------------------------------------------------------
# Kernels D (fused with the Model-1 cost assembly) and S, bit for bit.
# ----------------------------------------------------------------------

def _hosting_case(dev, R, chunk, K, mixed, ties, seed):
    """Fleet-chunk inputs made with numpy: per-row level grids (with
    ``mixed``, 2..K live levels and the rest masked), rents and arrivals,
    horizons ending inside the chunk; with ``ties``, costs on a
    half-integer grid so that equal transition costs are common."""
    rng = np.random.default_rng(seed)
    k_eff = rng.integers(2, K + 1, R) if mixed else np.full(R, K)
    kmask = np.arange(K)[None, :] < k_eff[:, None]
    lv = np.ones((R, K), np.float32)
    for i, k in enumerate(k_eff):
        lv[i, :k] = np.linspace(0.0, 1.0, k)
    if ties:
        lv = np.round(lv * 2) / 2
        c = rng.integers(0, 4, (R, chunk)).astype(np.float32) / 2
        M = rng.integers(1, 4, R).astype(np.float32)
    else:
        c = (rng.random((R, chunk)) * 1.5).astype(np.float32)
        M = (rng.random(R) * 20 + 0.5).astype(np.float32)
    g = np.clip(0.9 - lv, 0.0, 1.0).astype(np.float32)
    g[:, 0] = 1.0
    x = rng.integers(0, 4, (R, chunk)).astype(np.int32)
    t0 = 4096
    T_len = rng.integers(t0 - 5, t0 + chunk + 5, R).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return dict(lv=t(lv.astype(np.float32)), g=t(g), kmask=t(kmask),
                M=t(M), c=t(c), x=t(x), T_len=t(T_len), t0=t0,
                k_eff=k_eff, rng=rng)


def _counts(*fns):
    return [f.launches for f in fns]


@pytest.mark.cuda
@pytest.mark.parametrize("with_args", [False, True])
@pytest.mark.parametrize("case", [
    # (R, chunk, K, mixed, ties): the fleet's K = 3 and K = 2 at full
    # width; R ragged against the CTA's 32 rows; chunk 1 and 1,001 (the
    # 4-byte cp.async route) and 1,000 (ragged against the 64-slot tile);
    # a mixed K = 5 grid with ties; K = 16 (fetch in shared memory)
    (4096, 4096, 3, False, False),
    (4096, 4096, 2, False, True),
    (4093, 1000, 3, False, True),
    (4096, 1, 3, False, False),
    (4093, 1001, 2, False, False),
    (4093, 1000, 5, True, True),
    (300, 999, 16, True, False),
    (64, 4096, 16, False, True),
])
def test_fused_dp_kernel_matches_plain(case, with_args):
    from repro_torch.core.policies.offline_opt import dp_fetch_matrix
    dev = _card()
    R, chunk, K, mixed, ties = case
    d = _hosting_case(dev, R, chunk, K, mixed, ties, seed=R + chunk + K)
    J = (d["rng"].random((R, K)) * 3).astype(np.float32)
    J[0::7] = np.inf                                  # all-+inf frontiers
    J[1::7, 1:] = np.inf
    J = torch.from_numpy(np.where(d["kmask"].cpu().numpy(), J, np.inf)
                         .astype(np.float32)).to(dev)
    fetch = dp_fetch_matrix(d["M"], d["lv"])
    args = (J, d["c"], d["x"], d["g"], d["lv"], d["kmask"], fetch,
            d["T_len"], d["t0"], with_args)
    before = _counts(H.dp_fwd_model1, H.dp_minplus)
    Jk, ak = H.dp_fwd_model1(*args)
    torch.cuda.synchronize()
    assert _counts(H.dp_fwd_model1, H.dp_minplus) == [before[0] + 1,
                                                      before[1]]
    Jp, ap = H.dp_fwd_model1_plain(*args)
    assert torch.equal(Jk, Jp)
    if with_args:
        assert torch.equal(ak, ap)
    else:
        assert ak is None and ap is None
    # the frozen slots really occur, and so do live ones
    assert bool((d["T_len"] < d["t0"] + chunk).any())
    assert bool(torch.isfinite(Jk).any())


@pytest.mark.cuda
@pytest.mark.parametrize("collect_trace", [False, True])
@pytest.mark.parametrize("case", [
    # (R, chunk, K, mixed, include_final_fetch)
    (4096, 2048, 3, False, True),
    (4096, 1000, 2, False, False),
    (4093, 1000, 5, True, True),
    (4093, 1001, 3, False, False),
    (4096, 1, 3, False, True),
    (300, 999, 16, True, False),
    (64, 2048, 16, False, True),
])
def test_sim_kernel_matches_plain(case, collect_trace):
    dev = _card()
    R, chunk, K, mixed, iff = case
    d = _hosting_case(dev, R, chunk, K, mixed, False, seed=3 * R + chunk + K)
    rng = d["rng"]
    params = {"levels": d["lv"], "mask": d["kmask"], "M": d["M"]}
    # a carry in mid-run: held levels on live levels, suffix minima and
    # ages of every kind (BIG right after a switch), sums and counts
    r0 = (rng.random(R) * d["k_eff"]).astype(np.int32)
    S0 = (rng.random((R, K)) * 4 - 2).astype(np.float32)
    S0[rng.random((R, K)) < 0.3] = np.float32(3.4e38)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    state = {"r": t(r0), "S": t(S0),
             "age": t(rng.integers(0, 3, R).astype(np.int32))}
    acc = {"sums": t((rng.random((R, 3)) * 100).astype(np.float32)),
           "counts": t(rng.integers(0, 50, (R, K)).astype(np.int32))}
    args = (params, d["lv"], d["g"], d["M"], d["T_len"], d["t0"],
            (state, acc), d["x"], d["c"], iff, collect_trace)
    before = H.sim_chunk_alpha_rr.launches
    (sk, ak), rk = H.sim_chunk_alpha_rr(*args)
    torch.cuda.synchronize()
    assert H.sim_chunk_alpha_rr.launches == before + 1
    (sp, ap), rp = H.sim_chunk_alpha_rr_plain(*args)
    for key in sp:
        assert torch.equal(sk[key], sp[key]), key
    for key in ap:
        assert torch.equal(ak[key], ap[key]), key
    if collect_trace:
        assert torch.equal(rk, rp)
        if chunk > 1:
            assert bool((rk != rk[:, :1]).any())      # the policy moved
    else:
        assert rk is None and rp is None


# ----------------------------------------------------------------------
# Kernel P: the counter-keyed stream kernels.  Bit for bit (torch.equal):
# the hash is integer arithmetic, the flips and the compare exact, and the
# rents one FMA on both sides.
# ----------------------------------------------------------------------

P_VARIANTS = ("uniform", "uniform-salt", "bernoulli", "uniform_rents",
              "na_rents", "ge_bernoulli", "ge_states")


def _p_inputs(dev, R, seed):
    """Row params made with numpy: keys, p, a mixed flip, lo / hi, GE
    probabilities and rates, a carried-in GE state."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    f32 = lambda: t(rng.random(R).astype(np.float32))  # noqa: E731
    lo = (rng.random(R) * 0.3).astype(np.float32)
    return dict(
        keys=t(rng.integers(0, 2 ** 32, (R, 2), dtype=np.uint64)
               .astype(np.int64)),
        p=f32(), flip=t(rng.random(R) < 0.5), lo=t(lo),
        hi=t((lo + rng.random(R) * 0.5).astype(np.float32)),
        ge=[f32() for _ in range(4)],
        s=t(rng.integers(0, 2, R).astype(np.int32)))


def _p_call(name, d, tids, part, plain):
    """``name``'s wrapper (or its plain version) on the inputs ``d``."""
    sfx = "_plain" if plain else ""
    keys = d["keys"]
    if name.startswith("uniform") and not name.startswith("uniform_rents"):
        salt = 1 if name == "uniform-salt" else None
        return getattr(H, "slot_uniform" + sfx)(keys, tids, salt, part)
    if name == "bernoulli":
        return getattr(H, "bernoulli_arrivals_chunk" + sfx)(
            keys, tids, d["p"], d["flip"], part)
    if name == "uniform_rents":
        return getattr(H, "uniform_rents_chunk" + sfx)(
            keys, tids, d["lo"], d["hi"], d["flip"], part)
    if name == "na_rents":
        return getattr(H, "na_rents_chunk" + sfx)(keys, tids, d["lo"],
                                                  d["hi"], part)
    # ge_states: the chain without its emissions (the GE-Poisson stream's)
    return getattr(H, "ge_bernoulli_chunk" + sfx)(keys, tids, d["s"],
                                                  *d["ge"], part,
                                                  name == "ge_bernoulli")


def _p_launcher(name):
    return {"uniform": H.slot_uniform, "uniform-salt": H.slot_uniform,
            "bernoulli": H.bernoulli_arrivals_chunk,
            "uniform_rents": H.uniform_rents_chunk,
            "na_rents": H.na_rents_chunk,
            "ge_bernoulli": H.ge_bernoulli_chunk,
            "ge_states": H.ge_bernoulli_chunk}[name]


def test_stream_wrappers_take_the_plain_version_only_on_the_cpu():
    d = _p_inputs("cpu", 5, 0)
    tids = torch.arange(3, 40, dtype=torch.int32)
    before = [_p_launcher(n).launches for n in P_VARIANTS]
    ge_plain = H.ge_bernoulli_chunk_plain.card_calls
    for name in P_VARIANTS:
        for part in (True, False):
            a, b = (_p_call(name, d, tids, part, plain)
                    for plain in (False, True))
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert (x is None and y is None) or torch.equal(x, y), name
            if name == "ge_states":
                assert a[2] is None
    assert [_p_launcher(n).launches for n in P_VARIANTS] == before
    assert H.ge_bernoulli_chunk_plain.card_calls == ge_plain


@pytest.mark.cuda
@pytest.mark.parametrize("part", [True, False])
@pytest.mark.parametrize("case", [
    # (R, t0, chunk): the fleet's slab; an odd start with chunk % 4 != 0
    # (the scalar-store route) and R off every block size; a chunk of 1
    # (the GE init's draw); an odd start at the top of the counter range
    # (NA pairs cut at both ends); a GE tile cut short (chunk % 128)
    (4096, 61440, 4096),
    (4093, 61441, 1001),
    (4096, 0x7FFFFFFF, 1),
    (300, 2 ** 31 - 999, 999),
    (129, 7, 300),
])
@pytest.mark.parametrize("name", P_VARIANTS)
def test_stream_kernel_matches_plain(name, case, part):
    dev = _card()
    R, t0, chunk = case
    d = _p_inputs(dev, R, seed=R + chunk)
    tids = torch.arange(t0, t0 + chunk, dtype=torch.int64).to(
        torch.int32).to(dev)
    launcher = _p_launcher(name)
    before = launcher.launches
    k = _p_call(name, d, tids, part, plain=False)
    torch.cuda.synchronize()
    assert launcher.launches == before + 1
    p = _p_call(name, d, tids, part, plain=True)
    for a, b in zip(k if isinstance(k, tuple) else (k,),
                    p if isinstance(p, tuple) else (p,)):
        assert (a is None and b is None) or (
            a.dtype == b.dtype and torch.equal(a, b)), name


# ----------------------------------------------------------------------
# Kernel P's normals and the ARMA rents.  Bit for bit (torch.equal): XLA's
# erf_inv / log transcribed op for op on both sides, its FMA sites as
# __fmaf_rn and fma32, the recursion in the same order.
# ----------------------------------------------------------------------

def _arma_inputs(dev, R, p, q, seed):
    """Per-instance coefficients, params and a carried-in state, made with
    numpy."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    f32 = lambda *s, lo=0.0, hi=1.0: t(  # noqa: E731
        rng.uniform(lo, hi, s).astype(np.float32))
    return dict(
        keys=t(rng.integers(0, 2 ** 32, (R, 2), dtype=np.uint64)
               .astype(np.int64)),
        hist=f32(R, p, lo=-0.1, hi=0.1), eps=f32(R, q, lo=-0.1, hi=0.1),
        phi=f32(R, p, hi=0.6 / p), th=f32(R, q, hi=0.4 / q),
        sigma=f32(R, lo=0.01, hi=0.2), mean=f32(R, lo=0.2, hi=0.6),
        c_min=f32(R, lo=0.05, hi=0.15), c_max=f32(R, lo=0.7, hi=1.2))


def _arma_call(d, tids, part, plain):
    fn = H.arma_rents_chunk_plain if plain else H.arma_rents_chunk
    return fn(d["keys"], tids, d["hist"], d["eps"], d["phi"], d["th"],
              d["sigma"], d["mean"], d["c_min"], d["c_max"], part)


def test_normal_and_arma_wrappers_take_the_plain_version_only_on_the_cpu():
    d = _arma_inputs("cpu", 5, 4, 2, 0)
    tids = torch.arange(3, 40, dtype=torch.int32)
    counters = (H.normal_chunk, H.arma_rents_chunk)
    before = [k.launches for k in counters]
    plain_calls = H.arma_rents_chunk_plain.card_calls
    for part in (True, False):
        assert torch.equal(H.normal_chunk(d["keys"], tids, d["sigma"], part),
                           H.normal_chunk_plain(d["keys"], tids, d["sigma"],
                                                part))
        for a, b in zip(_arma_call(d, tids, part, False),
                        _arma_call(d, tids, part, True)):
            assert torch.equal(a, b)
    assert [k.launches for k in counters] == before
    assert H.arma_rents_chunk_plain.card_calls == plain_calls


@pytest.mark.cuda
@pytest.mark.parametrize("part", [True, False])
@pytest.mark.parametrize("case", [
    # (R, t0, chunk): the fleet's slab; an odd start with chunk % 4 != 0
    # and R off every block size; one slot at the top of the counter range
    (4096, 61440, 4096), (4093, 61441, 1001), (300, 0x7FFFFFFF, 1)])
def test_normal_kernel_matches_plain(case, part):
    dev = _card()
    R, t0, chunk = case
    d = _arma_inputs(dev, R, 4, 2, seed=R + chunk)
    tids = torch.arange(t0, t0 + chunk, dtype=torch.int64).to(
        torch.int32).to(dev)
    before = H.normal_chunk.launches
    k = H.normal_chunk(d["keys"], tids, d["sigma"], part)
    torch.cuda.synchronize()
    assert H.normal_chunk.launches == before + 1
    assert torch.equal(k, H.normal_chunk_plain(d["keys"], tids, d["sigma"],
                                               part))


@pytest.mark.cuda
@pytest.mark.parametrize("part", [True, False])
@pytest.mark.parametrize("pq", [(4, 2), (1, 2), (2, 3), (8, 8), (1, 1),
                                (2, 1), (4, 1)])
def test_arma_kernel_matches_plain(pq, part):
    """Chunks in a row, the state carried.  R = 301 (8 rows a block, R off
    the block's rows): a ragged chunk (not a tile multiple, chunk % 4 !=
    0), a whole 64-slot chunk, one slot.  R = 5 (fewer rows than a block
    holds): a chunk shorter than one tile, one that wraps the ring of tile
    buffers twice over, one slot.  R = 4,001 (32 rows a block on the
    H100, the last block ragged): a chunk that wraps the ring many times."""
    dev = _card()
    p, q = pq
    for R, chunks in ((301, ((5, 999), (1004, 64), (1068, 1))),
                      (5, ((0, 20), (20, 300), (320, 1))),
                      (4001, ((7, 1000),))):
        d = _arma_inputs(dev, R, p, q, seed=p * 10 + q + R)
        k_state = p_state = (d["hist"], d["eps"])
        before = H.arma_rents_chunk.launches
        for t0, chunk in chunks:
            tids = torch.arange(t0, t0 + chunk, dtype=torch.int32,
                                device=dev)
            k = H.arma_rents_chunk(d["keys"], tids, *k_state, d["phi"],
                                   d["th"], d["sigma"], d["mean"],
                                   d["c_min"], d["c_max"], part)
            torch.cuda.synchronize()
            pl = H.arma_rents_chunk_plain(d["keys"], tids, *p_state,
                                          d["phi"], d["th"], d["sigma"],
                                          d["mean"], d["c_min"], d["c_max"],
                                          part)
            for a, b in zip(k, pl):
                assert torch.equal(a, b), (R, t0, chunk)
            k_state, p_state = k[:2], pl[:2]
        assert H.arma_rents_chunk.launches == before + len(chunks)
    assert H.arma_rents_chunk.ma1_launches >= (q == 1) * 7


@pytest.mark.cuda
@pytest.mark.parametrize("part", [True, False])
@pytest.mark.parametrize("pq", [(4, 2), (1, 2), (2, 3), (3, 3), (8, 8),
                                (1, 1), (2, 1), (3, 1)])
def test_arma_kernel_on_one_row_matches_plain(pq, part):
    """One row (R = 1: XLA's dots are FMA chains there, the kernel's
    kDotChain instances): Figs 23-25's 4,000 slots in one chunk, then a
    ragged chunk and one slot, the state carried."""
    dev = _card()
    p, q = pq
    d = _arma_inputs(dev, 1, p, q, seed=p * 10 + q)
    k_state = p_state = (d["hist"], d["eps"])
    for t0, chunk in ((0, 4000), (4000, 999), (4999, 1)):
        tids = torch.arange(t0, t0 + chunk, dtype=torch.int32, device=dev)
        k = H.arma_rents_chunk(d["keys"], tids, *k_state, d["phi"], d["th"],
                               d["sigma"], d["mean"], d["c_min"],
                               d["c_max"], part)
        torch.cuda.synchronize()
        pl = H.arma_rents_chunk_plain(d["keys"], tids, *p_state, d["phi"],
                                      d["th"], d["sigma"], d["mean"],
                                      d["c_min"], d["c_max"], part)
        for a, b in zip(k, pl):
            assert torch.equal(a, b), (t0, chunk)
        k_state, p_state = k[:2], pl[:2]


def test_shaped_uniform_takes_the_plain_version_only_on_the_cpu():
    """``jax.random.uniform(key, (n,))`` of one key: on the CPU the wrapper
    is its plain version and counts no launch.  In the original layout n =
    7 hashes the counter pairs (0, 4), (1, 5), (2, 6) and (3, 0) (a 0
    appended), n = 8 the same but (3, 7): the two draws differ in word 3
    alone."""
    key = torch.tensor([0, 17], dtype=torch.int64)
    before = H.shaped_uniform.launches
    for part in (True, False):
        for n in (1, 2, 7, 1024):
            assert torch.equal(H.shaped_uniform(key, n, part),
                               H.shaped_uniform_plain(key, n, part))
    assert H.shaped_uniform.launches == before
    even, odd = (H.shaped_uniform_plain(key, n, False) for n in (8, 7))
    same = even[:7] == odd
    assert same[[0, 1, 2, 4, 5, 6]].all() and not same[3]


@pytest.mark.cuda
@pytest.mark.parametrize("part", [True, False])
@pytest.mark.parametrize("n", [1, 2, 3, 1024, 6001 * 7, 2 ** 20 + 1])
def test_shaped_uniform_kernel_matches_plain(n, part):
    """The shaped uniform of one key: ``jax.random.choice``'s (1,024,)
    draw, ``model2_service_matrix``'s (6,001, 7) one (T * R odd), a
    million words and one more, one, two and three words."""
    dev = _card()
    key = torch.tensor([7, 2 ** 32 - 3], dtype=torch.int64, device=dev)
    before = H.shaped_uniform.launches
    k = H.shaped_uniform(key, n, part)
    torch.cuda.synchronize()
    assert H.shaped_uniform.launches == before + 1
    assert torch.equal(k, H.shaped_uniform_plain(key, n, part))


# ----------------------------------------------------------------------
# Kernel P's Poisson and Model-2 service variants, and D and S on a
# Model-2 service slab, bit for bit.
# ----------------------------------------------------------------------

POISSON_LAMS = (0.0, 0.15, 1.2, 2.0, 4.0, 8.0, 9.99)


def _svc_inputs(dev, R, chunk, K, Kf, seed):
    """Row keys, Poisson rates cycling over ``POISSON_LAMS``, GE states
    and rates, arrivals (some past 24 requests), a service slab of ``Kf``
    levels (counts on a half-integer grid, so ties are common) and a
    column map of ``K`` of its levels, made with numpy.  For the service
    draws also ``x_wide``: arrivals in [-5, 120] with a row of zeros, a
    row at 120 and a row of negatives in each five; ``g1`` and ``g16``:
    unsorted levels with exact 0.0 and 1.0 entries."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    lam = np.resize(np.asarray(POISSON_LAMS, np.float32), R)
    cols = np.sort(rng.integers(0, Kf, (R, K)), axis=1).astype(np.int32)
    cols[:, 0], cols[:, -1] = 0, Kf - 1
    g = np.sort(rng.random((R, Kf)).astype(np.float32), axis=1)[:, ::-1]
    return dict(
        keys=t(rng.integers(0, 2 ** 32, (R, 2), dtype=np.uint64)
               .astype(np.int64)),
        lam=t(lam), lam_h=t(rng.uniform(0, 9.99, R).astype(np.float32)),
        states=t(rng.integers(0, 2, (R, chunk)).astype(np.int32)),
        x=t(rng.integers(0, 30, (R, chunk)).astype(np.int32)),
        g=t(g), cols=t(cols),
        svc=t((rng.integers(0, 8, (R, chunk, Kf)) / 2).astype(np.float32)),
        x_wide=t(_wide_arrivals(rng, R, chunk)),
        g1=t(_unsorted_levels(rng, R, 1)), g16=t(_unsorted_levels(rng, R, 16)))


def _wide_arrivals(rng, R, chunk):
    x = rng.integers(-5, 121, (R, chunk)).astype(np.int32)
    x[0::5], x[1::5], x[2::5] = 0, 120, -3
    return x


def _unsorted_levels(rng, R, K):
    g = rng.random((R, K)).astype(np.float32)
    g.flat[::3], g.flat[1::7] = 0.0, 1.0
    return g


def test_poisson_model2_and_svc_wrappers_take_the_plain_version_on_the_cpu():
    from repro_torch.core.policies.alpha_rr import alpha_rr_init
    from repro_torch.core.policies.offline_opt import dp_fetch_matrix
    from repro_torch.core.simulator import sim_acc0
    R, chunk, K = 9, 33, 2
    d = _svc_inputs("cpu", R, chunk, K, 3, 0)
    h = _hosting_case("cpu", R, chunk, K, False, True, 1)
    tids = torch.arange(7, 7 + chunk, dtype=torch.int32)
    counters = (H.poisson_chunk, H.model2_service_chunk, H.dp_fwd_model2,
                H.sim_chunk_alpha_rr_svc)
    before = [k.launches for k in counters]
    plain = (H.poisson_chunk_plain.card_calls,
             H.model2_service_chunk_plain.card_calls, H.fma32.card_calls)
    for part in (True, False):
        assert torch.equal(
            H.poisson_chunk(d["keys"], tids, d["lam"], 1, d["states"],
                            d["lam_h"], part),
            H.poisson_chunk_plain(d["keys"], tids, d["lam"], 1, d["states"],
                                  d["lam_h"], part))
        assert torch.equal(
            H.model2_service_chunk(d["keys"], tids, d["x"], d["g"], 24, part),
            H.model2_service_chunk_plain(d["keys"], tids, d["x"], d["g"], 24,
                                         part))
    J = torch.zeros((R, K))
    dargs = (J, h["c"], d["svc"], h["lv"], h["kmask"],
             dp_fetch_matrix(h["M"], h["lv"]), h["T_len"], h["t0"],
             d["cols"], True)
    for a, b in zip(H.dp_fwd_model2(*dargs), H.dp_fwd_model2_plain(*dargs)):
        assert torch.equal(a, b)
    params = {"levels": h["lv"], "mask": h["kmask"], "M": h["M"]}
    sargs = (params, h["lv"], h["M"], h["T_len"], h["t0"],
             (alpha_rr_init(params), sim_acc0(R, K, "cpu")), h["c"],
             d["svc"], d["cols"])
    (sk, ak), rk = H.sim_chunk_alpha_rr_svc(*sargs)
    (sp, ap), rp = H.sim_chunk_alpha_rr_svc_plain(*sargs)
    assert torch.equal(rk, rp) and torch.equal(ak["sums"], ap["sums"])
    assert [k.launches for k in counters] == before
    assert (H.poisson_chunk_plain.card_calls,
            H.model2_service_chunk_plain.card_calls,
            H.fma32.card_calls) == plain


@pytest.mark.cuda
@pytest.mark.parametrize("part", [True, False])
@pytest.mark.parametrize("case", [
    # (R, t0, chunk): a reduced fleet slab; an odd start with chunk % 4 !=
    # 0 and R off every block size; one slot at the top of the counters;
    # the figures' slabs (Figs 10-11: 40 x 2,000, Figs 12-15: 76 x 6,000),
    # neither chunk a multiple of a Poisson ticket (128, 64 or 32 slots)
    (256, 61440, 1024), (253, 61441, 1001), (300, 0x7FFFFFFF, 1),
    (40, 2000, 2000), (76, 0, 6000)])
def test_poisson_and_model2_kernels_match_plain(case, part):
    """Per-row rates at every rate of Knuth's branch, the salted GE form at
    per-slot rates, and Model-2 service at K = 2, 3 and 5, odd and even
    request counts.  Then rows at rate 0 beside rows at 9.99 (draws that
    end at once beside the longest), and the salted GE form with states
    that flip every slot between those two rates.  Last the service
    draws' ragged cases (see below); no chunk here is a multiple of a
    warp's span of 128, 64 or 32 slots but the first."""
    dev = _card()
    R, t0, chunk = case
    tids = torch.arange(t0, t0 + chunk, dtype=torch.int64).to(
        torch.int32).to(dev)
    for Kf in (2, 3, 5):
        d = _svc_inputs(dev, R, chunk, 2, Kf, seed=R + chunk + Kf)
        before = (H.poisson_chunk.launches, H.model2_service_chunk.launches)
        k = H.poisson_chunk(d["keys"], tids, d["lam"], None, None, None,
                            part)
        kg = H.poisson_chunk(d["keys"], tids, d["lam"], 1, d["states"],
                             d["lam_h"], part)
        torch.cuda.synchronize()
        assert torch.equal(k, H.poisson_chunk_plain(d["keys"], tids,
                                                    d["lam"], None, None,
                                                    None, part))
        assert torch.equal(kg, H.poisson_chunk_plain(
            d["keys"], tids, d["lam"], 1, d["states"], d["lam_h"], part))
        for n_max in (24, 7):
            m = H.model2_service_chunk(d["keys"], tids, d["x"], d["g"],
                                       n_max, part)
            torch.cuda.synchronize()
            assert torch.equal(m, H.model2_service_chunk_plain(
                d["keys"], tids, d["x"], d["g"], n_max, part)), (Kf, n_max)
        assert (H.poisson_chunk.launches, H.model2_service_chunk.launches) \
            == (before[0] + 2, before[1] + 2)
    lo_hi = torch.tensor([0.0, 9.99], dtype=torch.float32).repeat(
        (R + 1) // 2)[:R].contiguous().to(dev)
    flips = ((torch.arange(chunk)[None, :] + torch.arange(R)[:, None]) % 2
             ).to(torch.int32).to(dev)
    for salt, states, lam_h in ((None, None, None),
                                (1, flips, lo_hi.flip(0).contiguous())):
        before = H.poisson_chunk.launches
        k = H.poisson_chunk(d["keys"], tids, lo_hi, salt, states, lam_h,
                            part)
        torch.cuda.synchronize()
        assert H.poisson_chunk.launches == before + 1
        assert torch.equal(k, H.poisson_chunk_plain(
            d["keys"], tids, lo_hi, salt, states, lam_h, part)), salt
    # the service draws where requests are spread over a warp's lanes: a
    # slot's requests over several passes (n_max 33, 100), one request
    # a slot at most, odd n_max, rows of empty slots beside rows at n_max,
    # negative arrivals, K = 1 and 16 with unsorted levels that hold 0.0
    # and 1.0, then levels tied to drawn uniforms and one float above
    before = H.model2_service_chunk.launches
    for g in (d["g1"], d["g16"], d["g"]):
        for n_max in (1, 33, 100):
            m = H.model2_service_chunk(d["keys"], tids, d["x_wide"], g, n_max,
                                       part)
            torch.cuda.synchronize()
            assert torch.equal(m, H.model2_service_chunk_plain(
                d["keys"], tids, d["x_wide"], g, n_max, part)), (g.shape,
                                                                 n_max)
    u = H.uniform_from_bits(H.shaped_bits(
        *H._slot_keys(d["keys"], tids, None), 24, part))[:, 0, :4]
    up = torch.tensor(2.0, device=dev)
    tied = torch.stack([u[:, 0], torch.nextafter(u[:, 1], up), u[:, 2],
                        torch.nextafter(u[:, 3], -up)], 1).contiguous()
    x = d["x_wide"].clone()
    x[:, 0] = 24
    m = H.model2_service_chunk(d["keys"], tids, x, tied, 24, part)
    torch.cuda.synchronize()
    assert torch.equal(m, H.model2_service_chunk_plain(d["keys"], tids, x,
                                                       tied, 24, part))
    assert H.model2_service_chunk.launches == before + 10


@pytest.mark.cuda
@pytest.mark.parametrize("with_args", [False, True])
@pytest.mark.parametrize("case", [
    # (R, chunk, K, Kf, cols): the figures' K = 3 slab and RR's endpoint
    # columns of it (the bulk route, with and without a map); R ragged
    # against the CTA's rows, chunks 1 and 1,001; K = 5; K = 16 out of a
    # K = 16 slab, ragged (the gather route) and aligned (bulk), with and
    # without a map; more slab columns than a bulk stage holds (K = 2 of
    # 5: gather on an aligned slab; K = 4 of 6: D gathers, S copies in bulk)
    (1024, 1024, 3, 3, False), (1024, 1024, 2, 3, True),
    (1021, 1001, 3, 5, True), (1024, 1, 2, 2, False),
    (253, 999, 5, 5, False), (96, 333, 16, 16, True),
    (1024, 1024, 2, 2, False), (96, 336, 16, 16, False),
    (96, 336, 16, 16, True), (1024, 1024, 2, 5, True),
    (256, 512, 4, 6, True)])
def test_svc_dp_and_sim_kernels_match_plain(case, with_args):
    from repro_torch.core.policies.alpha_rr import alpha_rr_init
    from repro_torch.core.policies.offline_opt import dp_fetch_matrix
    from repro_torch.core.simulator import sim_acc0
    dev = _card()
    R, chunk, K, Kf, use_cols = case
    h = _hosting_case(dev, R, chunk, K, K > 3, True, seed=R + chunk + K)
    d = _svc_inputs(dev, R, chunk, K, Kf, seed=R + K)
    cols = d["cols"] if use_cols else None
    J = torch.zeros((R, K), device=dev)
    J[1::5] = float("inf")
    dargs = (J, h["c"], d["svc"], h["lv"], h["kmask"],
             dp_fetch_matrix(h["M"], h["lv"]), h["T_len"], h["t0"], cols,
             with_args)
    before = (H.dp_fwd_model2.launches, H.sim_chunk_alpha_rr_svc.launches)
    k = H.dp_fwd_model2(*dargs)
    torch.cuda.synchronize()
    p = H.dp_fwd_model2_plain(*dargs)
    assert torch.equal(k[0], p[0])
    assert (k[1] is None and p[1] is None) or torch.equal(k[1], p[1])
    params = {"levels": h["lv"], "mask": h["kmask"], "M": h["M"]}
    carry = (alpha_rr_init(params), sim_acc0(R, K, dev))
    sargs = (params, h["lv"], h["M"], h["T_len"], h["t0"], carry, h["c"],
             d["svc"], cols, not with_args, with_args)
    (sk, ak), rk = H.sim_chunk_alpha_rr_svc(*sargs)
    torch.cuda.synchronize()
    (sp, ap), rp = H.sim_chunk_alpha_rr_svc_plain(*sargs)
    for a, b in ((sk, sp), (ak, ap)):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    assert (rk is None and rp is None) or torch.equal(rk, rp)
    assert (H.dp_fwd_model2.launches, H.sim_chunk_alpha_rr_svc.launches) \
        == (before[0] + 1, before[1] + 1)


# ----------------------------------------------------------------------
# Model-2 slabs of more than 16 levels (up to hosting.M2_MAX_K): P's
# service draws on its bands of a run-time K, S's svc variants by their
# gather route; D refuses them.  Bit for bit.
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("part", [True, False])
@pytest.mark.parametrize("K", [6, 8, 9, 16, 17, 24, 25, 31, 32])
@pytest.mark.parametrize("case", [
    # (R, t0, chunk): beyond_knapsack_levels' chunk (4 rows x 4,000 slots,
    # aligned), a ragged slab from an odd start, one slot at the top of the
    # counters
    (4, 0, 4000), (253, 61441, 1001), (300, 0x7FFFFFFF, 1)])
def test_wide_model2_service_kernel_matches_plain(case, K, part):
    """K levels, unsorted with 0.0 and 1.0 among them, at each end of the
    kernel's bands of a run-time K (K <= 8, 16, 24, 32): at most one
    request a slot on Bernoulli arrivals, then 24 and 100 on arrivals in
    [-5, 120] with rows of empty slots and rows past the cap; the launches
    past DPF_MAX_K levels count as wide."""
    dev = _card()
    R, t0, chunk = case
    rng = np.random.default_rng(R + K + chunk)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    tids = torch.arange(t0, t0 + chunk, dtype=torch.int64).to(
        torch.int32).to(dev)
    keys = t(rng.integers(0, 2 ** 32, (R, 2), dtype=np.uint64)
             .astype(np.int64))
    g = t(_unsorted_levels(rng, R, K))
    x1 = t(rng.integers(0, 2, (R, chunk)).astype(np.int32))
    x_wide = t(_wide_arrivals(rng, R, chunk))
    before = (H.model2_service_chunk.launches,
              H.model2_service_chunk.wide_launches)
    for x, n_max in ((x1, 1), (x_wide, 24), (x_wide, 100)):
        m = H.model2_service_chunk(keys, tids, x, g, n_max, part)
        torch.cuda.synchronize()
        assert m.shape == (R, chunk, K)
        assert torch.equal(m, H.model2_service_chunk_plain(
            keys, tids, x, g, n_max, part)), n_max
    wide = 3 if K > H.DPF_MAX_K else 0
    assert (H.model2_service_chunk.launches,
            H.model2_service_chunk.wide_launches) == (before[0] + 3,
                                                      before[1] + wide)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (R, chunk, K, Kf): slabs whose rows are 16-byte aligned (where the
    # bulk route's alignment test passes and the width sends S to its
    # gather route) and ragged ones; lanes of 2 to 16 levels gathering
    # their columns (beyond_knapsack_levels' lanes hold 2 to 8 of 31)
    (1024, 1024, 2, 17), (1021, 1001, 3, 31), (96, 336, 8, 32),
    (4, 4000, 8, 31), (253, 999, 16, 17), (1024, 1, 2, 32),
    (96, 333, 5, 24)])
def test_wide_svc_sim_kernels_match_plain(case):
    """alpha-RR's S (with and without the trace and the final fetch) and
    the table variant (MDP) on a slab of Kf > 16 levels through a column
    map, each == its plain version; D refuses the slab, naming the
    ROADMAP item that widens it."""
    from repro_torch.core.policies.alpha_rr import alpha_rr_init
    from repro_torch.core.policies.offline_opt import dp_fetch_matrix
    from repro_torch.core.simulator import sim_acc0
    dev = _card()
    R, chunk, K, Kf = case
    h = _hosting_case(dev, R, chunk, K, K > 3, True, seed=R + chunk + K)
    d = _svc_inputs(dev, R, chunk, K, Kf, seed=R + K)
    params = {"levels": h["lv"], "mask": h["kmask"], "M": h["M"]}
    before = (H.sim_chunk_alpha_rr_svc.launches,
              H.sim_chunk_alpha_rr_svc.wide_launches,
              H.sim_chunk_table_svc.launches,
              H.sim_chunk_table_svc.wide_launches)
    for flag in (False, True):
        carry = (alpha_rr_init(params), sim_acc0(R, K, dev))
        sargs = (params, h["lv"], h["M"], h["T_len"], h["t0"], carry,
                 h["c"], d["svc"], d["cols"], flag, flag)
        (sk, ak), rk = H.sim_chunk_alpha_rr_svc(*sargs)
        torch.cuda.synchronize()
        (sp, ap), rp = H.sim_chunk_alpha_rr_svc_plain(*sargs)
        for a, b in ((sk, sp), (ak, ap)):
            for key in a:
                assert torch.equal(a[key], b[key]), (flag, key)
        assert (rk is None and rp is None) or torch.equal(rk, rp)
    tab = table_form(*_table_case(dev, R, chunk, K, "mdp", seed=R + K), K)
    side = torch.from_numpy(h["rng"].integers(-1, 3, (R, chunk)).astype(
        np.int32)).to(dev)
    targs = (*tab, h["lv"], h["M"], h["T_len"], h["t0"],
             ({"r": torch.zeros(R, dtype=torch.int32, device=dev)},
              sim_acc0(R, K, dev)), h["x"], h["c"], side, d["svc"],
             d["cols"], True, True)
    (sk, ak), rk = H.sim_chunk_table_svc(*targs)
    torch.cuda.synchronize()
    (sp, ap), rp = H.sim_chunk_table_svc_plain(*targs)
    assert torch.equal(sk["r"], sp["r"]) and torch.equal(rk, rp)
    for key in ap:
        assert torch.equal(ak[key], ap[key]), key
    assert (H.sim_chunk_alpha_rr_svc.launches,
            H.sim_chunk_alpha_rr_svc.wide_launches,
            H.sim_chunk_table_svc.launches,
            H.sim_chunk_table_svc.wide_launches) == (
                before[0] + 2, before[1] + 2, before[2] + 1, before[3] + 1)
    dargs = (torch.zeros((R, K), device=dev), h["c"], d["svc"], h["lv"],
             h["kmask"], dp_fetch_matrix(h["M"], h["lv"]), h["T_len"],
             h["t0"], d["cols"])
    with pytest.raises(ValueError, match="Queue 1 item 11"):
        H.dp_fwd_model2(*dargs)


@pytest.mark.cuda
def test_wide_slab_limits_are_the_launchers():
    """The wrappers' limits are the launchers': the service launcher, and
    S's, take M2_MAX_K levels and refuse one more (cudaErrorInvalidValue,
    1) when called past the wrappers' checks; the wrappers raise first."""
    dev = _card()
    lib = _build.library("hosting")
    R, chunk = 2, 8
    tids = torch.arange(chunk, dtype=torch.int32, device=dev)
    keys = torch.zeros((R, 2), dtype=torch.int64, device=dev)
    x = torch.ones((R, chunk), dtype=torch.int32, device=dev)
    for K, want in ((H.M2_MAX_K, 0), (H.M2_MAX_K + 1, 1)):
        g = torch.full((R, K), 0.5, device=dev)
        out = torch.empty((R, chunk, K), device=dev)
        err = lib.launch_model2_service(
            keys.data_ptr(), tids.data_ptr(), x.data_ptr(), g.data_ptr(),
            out.data_ptr(), R, chunk, K, 1, 1, _build.stream(dev))
        torch.cuda.synchronize()
        assert err == want, K
    with pytest.raises(ValueError, match=f"K <= {H.M2_MAX_K}"):
        H.model2_service_chunk(keys, tids, x, torch.full(
            (R, H.M2_MAX_K + 1), 0.5, device=dev), 1)


# ----------------------------------------------------------------------
# P's Poisson variant at rates of 10 and above (Hormann's rejection) and
# S's table variant (static, MDP, ABC).  Bit for bit.
# ----------------------------------------------------------------------

REJECTION_LAMS = (10.0, 10.5, 37.0, 200.0, 1e5)


@pytest.mark.cuda
@pytest.mark.parametrize("part", [True, False])
@pytest.mark.parametrize("case", [
    # (R, t0, chunk): a reduced fleet slab; an odd start with chunk % 4 !=
    # 0 and R off every block size; one slot at the top of the counters;
    # Figs 17-22's chunk (84 rows x 512 slots)
    (256, 61440, 1024), (253, 61441, 1001), (300, 0x7FFFFFFF, 1),
    (84, 2560, 512)])
def test_poisson_rejection_kernel_matches_plain(case, part):
    """Per-row rates at {10, 10.5, 37, 200, 1e5}; rows that mix rates
    below and above 10 (0, 2, 9.99, 10, 200); rates below 10 only (a
    launch that the kernel does not count as one on Hormann's branch); the
    salted GE form at the figure's rates 10 / 200 and at 2 / 20 (a row's
    slots on both branches), its states from the GE chain over two chunks
    with the chain's state carried."""
    dev = _card()
    R, t0, chunk = case
    rng = np.random.default_rng(R + chunk)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    keys = t(rng.integers(0, 2 ** 32, (R, 2), dtype=np.uint64)
             .astype(np.int64))
    tids = torch.arange(t0, t0 + chunk, dtype=torch.int64).to(
        torch.int32).to(dev)
    mixed = np.resize(np.float32([0.0, 2.0, 9.99, 10.0, 200.0]), R)
    knuth = np.resize(np.float32([0.0, 2.0, 9.99]), R)
    # (rates, whether the kernel counts the launch as one on Hormann's
    # branch)
    for lam, rej in ((np.resize(np.float32(REJECTION_LAMS), R), 1),
                     (mixed, 1), (knuth, 0)):
        before = H.poisson_chunk.launches
        n_rej = H.poisson_rejection_launches()
        k = H.poisson_chunk(keys, tids, t(lam), None, None, None, part)
        torch.cuda.synchronize()
        assert H.poisson_chunk.launches == before + 1
        assert H.poisson_rejection_launches() == n_rej + rej
        assert torch.equal(k, H.poisson_chunk_plain(keys, tids, t(lam), None,
                                                    None, None, part))
    for hi, lo in ((200.0, 10.0), (20.0, 2.0)):
        lam_h = t(np.full(R, hi, np.float32))
        lam_l = t(np.full(R, lo, np.float32))
        s = t(rng.integers(0, 2, R).astype(np.int32))
        p = t(np.full(R, 0.4, np.float32))
        for first, n in ((t0, chunk), (t0 + chunk, chunk)):
            tt = torch.arange(first, first + n, dtype=torch.int64).to(
                torch.int32).to(dev)
            s, states, _ = H.ge_bernoulli_chunk(keys, tt, s, p, p, lam_h,
                                                lam_l, part, emit=False)
            k = H.poisson_chunk(keys, tt, lam_l, 1, states, lam_h, part)
            torch.cuda.synchronize()
            assert torch.equal(k, H.poisson_chunk_plain(
                keys, tt, lam_l, 1, states, lam_h, part)), (hi, first)


def _table_case(dev, R, chunk, K, policy, seed):
    """A table policy's ``(step_fn, params)`` on R rows, made with numpy:
    MDP and ABC tables of two rows mapping into each row's live levels,
    ABC thresholds inside the arrivals' range, a static level a row."""
    from repro_torch.core.policies import abc_step, mdp_step
    from repro_torch.core.policies.baselines import static_step
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    if policy == "static":
        return static_step, {"level_idx": t(rng.integers(0, K, R)
                                            .astype(np.int32))}
    pi = t(rng.integers(0, K, (R, 2, K)).astype(np.int32))
    if policy == "mdp":
        return mdp_step, {"pi": pi}
    return abc_step, {"pi": pi, "x_threshold": t(
        rng.choice(np.float32([0.5, 1.5, 2.0, 14.5]), R))}


@pytest.mark.cuda
@pytest.mark.parametrize("collect_trace", [False, True])
@pytest.mark.parametrize("policy", ["static", "mdp", "abc"])
@pytest.mark.parametrize("case", [
    # (R, chunk, K, service, include_final_fetch): Model 1 at the fleet's
    # K = 3 and full width, ragged rows and chunks (the 4-byte cp.async
    # route), one slot, K = 2 and 16; Model 2 on the slab's own levels
    # (bulk), RR's endpoint columns of a K = 3 slab (bulk, with a map), a
    # ragged slab (gather), K = 16
    (4096, 1024, 3, "model1", True), (4093, 1001, 2, "model1", False),
    (4096, 1, 3, "model1", True), (300, 999, 16, "model1", False),
    (1024, 1024, 3, "model2", True), (1024, 1024, 2, "model2-cols", False),
    (1021, 1001, 3, "model2-cols", True), (96, 333, 16, "model2", False)])
def test_table_kernel_matches_plain(case, policy, collect_trace):
    """S's table variant == ``simulator.sim_chunk_core`` stepping the
    static, MDP or ABC table (``table_form``): a carried-in level, sums
    and counts, side
    channels out of [0, 1] (clipped), horizons inside the chunk."""
    from repro_torch.core.simulator import sim_acc0
    dev = _card()
    R, chunk, K, service, iff = case
    h = _hosting_case(dev, R, chunk, K, False, False, seed=R + chunk + K)
    tab = table_form(*_table_case(dev, R, chunk, K, policy, seed=R + K), K)
    rng = h["rng"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    side = t(rng.integers(-1, 3, (R, chunk)).astype(np.int32))
    x = t(rng.integers(0, 30, (R, chunk)).astype(np.int32))
    acc = sim_acc0(R, K, dev)
    acc["sums"] += t((rng.random((R, 3)) * 100).astype(np.float32))
    acc["counts"] += t(rng.integers(0, 50, (R, K)).astype(np.int32))
    carry = ({"r": t(rng.integers(0, K, R).astype(np.int32))}, acc)
    if service == "model1":
        args = (*tab, h["lv"], h["g"], h["M"], h["T_len"], h["t0"], carry,
                x, h["c"], side, iff, collect_trace)
        kern, plain = H.sim_chunk_table, H.sim_chunk_table_plain
    else:
        Kf = 3 if service == "model2-cols" else K
        d = _svc_inputs(dev, R, chunk, K, Kf, seed=R + K)
        cols = d["cols"] if service == "model2-cols" else None
        args = (*tab, h["lv"], h["M"], h["T_len"], h["t0"], carry, x,
                h["c"], side, d["svc"], cols, iff, collect_trace)
        kern, plain = H.sim_chunk_table_svc, H.sim_chunk_table_svc_plain
    before = kern.launches
    (sk, ak), rk = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    (sp, ap), rp = plain(*args)
    assert torch.equal(sk["r"], sp["r"])
    for key in ap:
        assert torch.equal(ak[key], ap[key]), key
    assert (rk is None and rp is None) or torch.equal(rk, rp)


def test_table_wrappers_take_the_plain_version_only_on_the_cpu():
    """On CPU tensors the table wrappers are their plain versions: no
    launch, no card call counted."""
    from repro_torch.core.simulator import sim_acc0
    R, chunk, K = 9, 33, 3
    h = _hosting_case("cpu", R, chunk, K, False, False, 2)
    d = _svc_inputs("cpu", R, chunk, K, K, 0)
    counters = (H.sim_chunk_table, H.sim_chunk_table_svc)
    before = [k.launches for k in counters]
    calls = (H.sim_chunk_table_plain.card_calls,
             H.sim_chunk_table_svc_plain.card_calls)
    side = d["states"]
    for policy in ("static", "mdp", "abc"):
        pi, obs, thr = table_form(*_table_case("cpu", R, chunk, K, policy,
                                               1), K)
        carry = ({"r": torch.zeros(R, dtype=torch.int32)},
                 sim_acc0(R, K, "cpu"))
        for kern, plain, extra in (
                (H.sim_chunk_table, H.sim_chunk_table_plain,
                 dict(g=h["g"])),
                (H.sim_chunk_table_svc, H.sim_chunk_table_svc_plain,
                 dict(svc=d["svc"]))):
            a = dict(pi=pi, obs=obs, x_threshold=thr, lv=h["lv"], M=h["M"],
                     T_len=h["T_len"], t0=h["t0"], carry=carry, x=d["x"],
                     c=h["c"], side=side, **extra)
            (sk, ak), rk = kern(**a)
            (sp, ap), rp = plain(**a)
            assert torch.equal(rk, rp) and torch.equal(ak["sums"],
                                                       ap["sums"])
    assert [k.launches for k in counters] == before
    assert (H.sim_chunk_table_plain.card_calls,
            H.sim_chunk_table_svc_plain.card_calls) == calls


# ----------------------------------------------------------------------
# B (the DP's backtrack), E (schedule pricing) and S with the rent fused
# (the reference's small batches, simulator.xla_acc_fma).  Bit for bit.
# ----------------------------------------------------------------------

def _table(dev, R, chunk, K, seed):
    """A random argmin table [R, chunk, K] int32 (entries in [0, K)) and
    the levels ``k`` [R] at its end."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (t(rng.integers(0, K, R).astype(np.int32)),
            t(rng.integers(0, K, (R, chunk, K)).astype(np.int32)))


def _schedule_args(dev, R, chunk, K, svc_kind, seed, sched="random"):
    """E's inputs: the grid, horizons inside the chunk, a carry in mid-run
    (held level, sums, -0 in every fifth row, counts), schedules (``sched``: "random", with
    levels out of [0, K) too; "every", a new level every slot; "never",
    one level a row throughout), and Model-1 arrivals or a Model-2 slab
    ("model2": the slab's own K levels; "model2-cols": a column map of a
    5-level slab, "model2-cols32" of a 32-level one)."""
    h = _hosting_case(dev, R, chunk, K, K > 3, False, seed)
    rng = h["rng"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    sums = (rng.random((R, 3)) * 100).astype(np.float32)
    sums[::5] = -0.0                    # x + 0 is +0: masked slots count
    carry = (t(rng.integers(0, K, R).astype(np.int32)),
             {"sums": t(sums),
              "counts": t(rng.integers(0, 50, (R, K)).astype(np.int32))})
    r = rng.integers(-1, K + 1, (R, chunk)).astype(np.int32)
    if sched == "every":
        r = np.broadcast_to((np.arange(chunk) % K).astype(np.int32),
                            (R, chunk))
    elif sched == "never":
        r = np.broadcast_to(rng.integers(0, K, (R, 1)).astype(np.int32),
                            (R, chunk))
    kw = dict(x=h["x"], g=h["g"])
    if svc_kind != "model1":
        Kf = {"model2-cols": 5, "model2-cols32": 32}.get(svc_kind, K)
        d = _svc_inputs(dev, R, chunk, K, Kf, seed)
        kw = dict(svc=d["svc"],
                  svc_cols=None if svc_kind == "model2" else d["cols"])
    return (h["lv"], h["M"], h["T_len"], h["t0"], carry, t(r), h["c"]), kw


# B's and E's tiles at K = 3 under Model 1 (slots) and their rings
_BT, _ET = T.B_TILE[3], T.E_TILE
_BT_RING, _ET_RING = T.STAGES * _BT, T.STAGES * _ET


@pytest.mark.cuda
def test_be_tiles_fit_the_kernels_ring():
    """The library's tiles (``be_tile``) are whole groups of 4 slots, no
    longer than the chunk needs, a row's segment within its words; E's
    hold an odd number of groups and a row of each array within a tensor
    copy's box of 256 words; and the tiles and the ring depth are the
    ones the tests put their edge shapes around (``_be_tiles.py``)."""
    _card()
    lib = _build.library("hosting")
    for words, box in ((1, 0), (2, 0), (3, 0), (16, 0), (32, 0), (3, 1),
                       (5, 3), (7, 5), (15, 13), (34, 32)):
        for chunk in (1, 3, 4, 5, 8, 103, 4096, 100_000):
            ts = lib.be_tile_slots(words, chunk, box)
            assert ts % 4 == 0 and 4 <= ts <= max(4, -(-chunk // 4) * 4)
            assert ts * words <= max(320, 4 * words)
            if box:
                assert (ts // 4) % 2 == 1 and ts * box <= 256
    big = 1 << 20
    assert {K: lib.be_tile_slots(K, big, 0) for K in T.B_TILE} == T.B_TILE
    assert (lib.be_tile_slots(3, big, 1), lib.be_tile_slots(34, big, 32),
            lib.be_ring_stages()) == (T.E_TILE, T.E_TILE_SLAB32, T.STAGES)


def test_backtrack_and_schedule_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors B's and E's wrappers are their plain versions: no
    launch, no card call counted; B chained over two halves of a table is
    the whole table's walk."""
    k, args = _table("cpu", 7, 40, 3, 0)
    counters = (H.dp_backtrack, H.schedule_chunk)
    before = [c.launches for c in counters]
    calls = (H.dp_backtrack_plain.card_calls,
             H.schedule_chunk_plain.card_calls)
    k0, r = H.dp_backtrack(k, args)
    k1, r2 = H.dp_backtrack_plain(k, args[:, 20:].contiguous())
    k2, r1 = H.dp_backtrack_plain(k1, args[:, :20].contiguous())
    assert torch.equal(k0, k2) and torch.equal(r, torch.cat([r1, r2], 1))
    for kind in ("model1", "model2-cols"):
        a, kw = _schedule_args("cpu", 9, 33, 3, kind, 1)
        for fma in (False, True):
            p1, acc1 = H.schedule_chunk(*a, **kw, acc_fma=fma)
            p2, acc2 = H.schedule_chunk_plain(*a, **kw, acc_fma=fma)
            assert torch.equal(p1, p2) and torch.equal(acc1["sums"],
                                                       acc2["sums"])
    assert [c.launches for c in counters] == before
    assert (H.dp_backtrack_plain.card_calls,
            H.schedule_chunk_plain.card_calls) == calls


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (R, chunk, K): the fleet's K = 3 at full width; ragged rows and a
    # ragged, odd chunk; K = 16 (the fused D's widest); K = 32 (D on a
    # finished w); one slot; one row
    (4096, 4096, 3), (4093, 1001, 2), (300, 999, 16), (65, 17, 32),
    (4096, 1, 3), (1, 300, 4),
    # the ring's edges at K = 3: a slot either side of a tile and of a
    # ring's worth of tiles (chunk * K % 4 of 1 and 3: the 4-byte route),
    # and a chunk of whole 16-byte groups either side (the bulk route)
    (4093, _BT - 1, 3), (4093, _BT + 1, 3), (300, _BT_RING - 1, 3),
    (300, _BT_RING + 1, 3), (300, _BT_RING - 4, 3), (300, _BT_RING + 4, 3),
    # chunk * K % 4 of 2; K = 1 and K = 32 at their tiles' edges
    (257, 999, 2), (65, 4 * T.B_TILE[1] + 1, 1),
    (65, 4 * T.B_TILE[32] - 1, 32),
    # a bulk-aligned chunk of odd R, and (R, chunk, K, "4-byte") the same
    # shapes with the table one word off a 16-byte boundary
    (33, _BT_RING + 4, 3), (33, _BT_RING + 4, 3, "4-byte"),
    (4096, 4096, 3, "4-byte")])
def test_backtrack_kernel_matches_plain(case):
    """B == its plain version: the level at the chunk's entry and the
    schedule, on random tables (every entry a live level), on its bulk
    and its 4-byte route."""
    dev = _card()
    R, chunk, K = case[:3]
    k, args = _table(dev, R, chunk, K, seed=R + chunk + K)
    if case[3:] == ("4-byte",):
        args = H.misaligned(args)
    before = H.dp_backtrack.launches
    kk, rk = H.dp_backtrack(k, args)
    torch.cuda.synchronize()
    assert H.dp_backtrack.launches == before + 1
    kp, rp = H.dp_backtrack_plain(k, args)
    assert torch.equal(kk, kp) and torch.equal(rk, rp)
    assert bool((rk != rk[:, :1]).any()) or chunk == 1 or K == 1


@pytest.mark.cuda
@pytest.mark.parametrize("acc_fma", [False, True])
@pytest.mark.parametrize("case", [
    # (R, chunk, K, service): Model 1 at the fleet's width and K = 3, a
    # ragged slab, K = 16 and 32, one slot; Model 2 on the slab's own
    # levels and through a column map of a 5-level slab
    (4096, 4096, 3, "model1"), (4093, 1001, 2, "model1"),
    (300, 999, 16, "model1"), (65, 333, 32, "model1"),
    (4096, 1, 3, "model1"), (1024, 1024, 3, "model2"),
    (1021, 1001, 3, "model2-cols"), (6, 300, 3, "model2-cols"),
    # the ring's edges under Model 1: a slot either side of a tile and of
    # a ring's worth of tiles (the 4-byte route), whole 16-byte groups
    # either side of the ring (the bulk route), of odd R
    (4093, _ET - 1, 3, "model1"), (4093, _ET + 1, 3, "model1"),
    (300, _ET_RING - 1, 3, "model1"), (300, _ET_RING + 1, 3, "model1"),
    (33, _ET_RING - 4, 3, "model1"), (33, _ET_RING + 4, 3, "model1"),
    # a Model-2 slab of 32 levels: its own, and a column map of K = 3
    (300, 4 * T.E_TILE_SLAB32 + 4, 32, "model2"),
    (300, 4 * T.E_TILE_SLAB32 + 1, 32, "model2"),
    (257, 333, 3, "model2-cols32"), (257, 336, 3, "model2-cols32"),
    # (..., schedule, route): a new level every slot, one level throughout;
    # the fleet's shape with r one word off a 16-byte boundary
    (4093, 1001, 3, "model1", "every"), (1024, 1024, 3, "model1", "never"),
    (1021, 1000, 5, "model2-cols", "every"),
    (4096, 4096, 3, "model1", "random", "4-byte"),
    (1021, 1000, 3, "model2-cols", "random", "4-byte")])
def test_schedule_kernel_matches_plain(case, acc_fma):
    """E == its plain version: a carry in mid-run, horizons inside the
    chunk, levels out of range priced nothing, with and without the sums'
    products fused, on its bulk and its 4-byte route."""
    dev = _card()
    R, chunk, K, kind = case[:4]
    sched = case[4] if len(case) > 4 else "random"
    a, kw = _schedule_args(dev, R, chunk, K, kind, seed=R + chunk + K,
                           sched=sched)
    if case[5:] == ("4-byte",):
        a = a[:5] + (H.misaligned(a[5]),) + a[6:]
    before = H.schedule_chunk.launches
    pk, ak = H.schedule_chunk(*a, **kw, acc_fma=acc_fma)
    torch.cuda.synchronize()
    assert H.schedule_chunk.launches == before + 1
    pp, ap = H.schedule_chunk_plain(*a, **kw, acc_fma=acc_fma)
    assert torch.equal(pk, pp)
    for key in ap:
        assert torch.equal(ak[key], ap[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (R, chunk, K, policy): one alpha-RR row (the reference fuses the
    # rent there), three static rows, and the same at fleet width; K = 4,
    # whose levels 1/3 and 2/3 make the rent's products inexact
    (1, 2048, 4, "alpha-rr"), (3, 999, 4, "static"),
    (4096, 1024, 4, "alpha-rr"), (4093, 1001, 4, "static")])
def test_sim_kernel_with_the_rent_fused_matches_plain(case):
    """S (alpha-RR and the table variant) with ``rent_fma``: == its plain
    version, and (over thousands of rows) the fused rent really differs
    from the two roundings somewhere."""
    from repro_torch.core.policies.alpha_rr import alpha_rr_init
    from repro_torch.core.simulator import sim_acc0
    dev = _card()
    R, chunk, K, policy = case
    h = _hosting_case(dev, R, chunk, K, False, False, seed=R + chunk + K)
    sums = []
    for fma in (True, False):
        if policy == "alpha-rr":
            params = {"levels": h["lv"], "mask": h["kmask"], "M": h["M"]}
            args = (params, h["lv"], h["g"], h["M"], h["T_len"], h["t0"],
                    (alpha_rr_init(params), sim_acc0(R, K, dev)), h["x"],
                    h["c"], True, True, fma)
            kern, plain = H.sim_chunk_alpha_rr, H.sim_chunk_alpha_rr_plain
        else:
            tab = table_form(*_table_case(dev, R, chunk, K, policy, R), K)
            args = (*tab, h["lv"], h["g"], h["M"], h["T_len"], h["t0"],
                    ({"r": torch.zeros(R, dtype=torch.int32, device=dev)},
                     sim_acc0(R, K, dev)), h["x"], h["c"], None, True, True,
                    fma)
            kern, plain = H.sim_chunk_table, H.sim_chunk_table_plain
        (sk, ak), rk = kern(*args)
        torch.cuda.synchronize()
        (sp, ap), rp = plain(*args)
        for key in ap:
            assert torch.equal(ak[key], ap[key]), (fma, key)
        assert torch.equal(rk, rp)
        sums.append(ak["sums"])
    assert torch.equal(sums[0][:, 1:], sums[1][:, 1:])
    if R >= 1000:
        assert not torch.equal(sums[0][:, 0], sums[1][:, 0])


# ----------------------------------------------------------------------
# S's table variant and D's ARGS route at their redesign's tile and ring
# edges (the sizes in _table_tiles.py; the CPU side holds the plain
# versions to the reference at the same shapes,
# tests/test_torch_table_edges.py).  Bit for bit.
# ----------------------------------------------------------------------

_MT, _ST = TT.SIM_TILE[(3, "model1")], TT.SIM_TILE[(3, "model2")]
_MR = TT.SIM_STAGES[(3, "model1")] * _MT
_SR = TT.SIM_STAGES[(3, "model2")] * _ST
_DT = TT.DP_TILE[3]
_DR = TT.DP_ARGS_STAGES[(3, "model1")] * _DT


@pytest.mark.cuda
def test_table_and_args_tiles_are_the_librarys():
    """The library's tiles and ring depths of S's table variant and of
    D's ARGS route (``sim_tile_slots``, ``sim_ring_stages``,
    ``dp_tile_slots``, ``dp_args_stages``) are the ones the edge shapes
    are placed around (``_table_tiles.py``): whole 16-slot groups, at
    least two cooked stages, at least one args stage."""
    _card()
    lib = _build.library("hosting")
    svc = {"model1": 0, "model2": 1}
    for (K, kind), tile in TT.SIM_TILE.items():
        assert lib.sim_tile_slots(K, svc[kind]) == tile, (K, kind)
        assert tile % 16 == 0
    for (K, kind), stages in TT.SIM_STAGES.items():
        assert lib.sim_ring_stages(K, svc[kind]) == stages, (K, kind)
        assert stages >= 2
    for K, tile in TT.DP_TILE.items():
        assert lib.dp_tile_slots(K) == tile, K
    for (K, kind), stages in TT.DP_ARGS_STAGES.items():
        assert lib.dp_args_stages(K, svc[kind]) == stages, (K, kind)
        assert stages >= 1
    assert lib.sim_tile_slots(17, 0) == -1 and lib.dp_tile_slots(0) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["static", "mdp", "abc"])
@pytest.mark.parametrize("case", [
    # (R, chunk, K, service, include_final_fetch, collect_trace): a slot
    # either side of a tile and of the ring (the 4-byte route), whole
    # 16-byte groups either side of the ring at R - 3 rows (tensor
    # copies), one slot, K = 2, 5 and 16, a column map
    (4093, _MT - 1, 3, "model1", True, False),
    (4093, _MT + 1, 3, "model1", False, True),
    (4093, _MR - 4, 3, "model1", False, False),
    (4093, _MR + 4, 3, "model1", True, True),
    (4093, _ST - 1, 3, "model2", False, True),
    (4093, _SR + 1, 3, "model2", True, False),
    (4093, _SR - 4, 3, "model2", True, True),
    (4093, _SR + 4, 3, "model2-cols", False, False),
    (37, 1, 3, "model1", True, True),
    (61, 2 * _MT + 4, 2, "model1", True, False),
    (64, 4 * TT.SIM_TILE[(5, "model2")] + 4, 5, "model2", False, True),
    (61, 3 * TT.SIM_TILE[(16, "model2")] + 1, 16, "model2", True, True),
    (64, TT.SIM_TILE[(16, "model1")] + 4, 16, "model1", False, False)])
def test_table_kernel_at_its_tiles_edges(case, policy):
    """S's table variant == its plain version where its tiles and rings
    turn over: a carried-in level, sums and counts, side channels of -1 ..
    2 (clipped), horizons inside the chunk."""
    from repro_torch.core.simulator import sim_acc0
    dev = _card()
    R, chunk, K, service, iff, trace = case
    h = _hosting_case(dev, R, chunk, K, False, False, seed=R + 3 * chunk + K)
    tab = table_form(*_table_case(dev, R, chunk, K, policy, seed=R + K), K)
    rng = h["rng"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    side = t(rng.integers(-1, 3, (R, chunk)).astype(np.int32))
    x = t(rng.integers(0, 30, (R, chunk)).astype(np.int32))
    acc = sim_acc0(R, K, dev)
    acc["sums"] += t((rng.random((R, 3)) * 100).astype(np.float32))
    acc["counts"] += t(rng.integers(0, 50, (R, K)).astype(np.int32))
    carry = ({"r": t(rng.integers(0, K, R).astype(np.int32))}, acc)
    if service == "model1":
        args = (*tab, h["lv"], h["g"], h["M"], h["T_len"], h["t0"], carry,
                x, h["c"], side, iff, trace)
        kern, plain = H.sim_chunk_table, H.sim_chunk_table_plain
    else:
        Kf = 5 if service == "model2-cols" else K
        d = _svc_inputs(dev, R, chunk, K, Kf, seed=R + K)
        cols = d["cols"] if service == "model2-cols" else None
        args = (*tab, h["lv"], h["M"], h["T_len"], h["t0"], carry, x,
                h["c"], side, d["svc"], cols, iff, trace)
        kern, plain = H.sim_chunk_table_svc, H.sim_chunk_table_svc_plain
    before = kern.launches
    (sk, ak), rk = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    (sp, ap), rp = plain(*args)
    assert torch.equal(sk["r"], sp["r"])
    for key in ap:
        assert torch.equal(ak[key], ap[key]), key
    assert (rk is None and rp is None) or torch.equal(rk, rp)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (R, chunk, K, service): a slot either side of a tile and of the
    # argmin table's ring (the 4-byte write-back), whole 16-byte groups
    # either side of the ring (bulk copies), one slot, K = 5 and 16, a
    # column map
    (4093, _DT - 1, 3, "model1"), (4093, _DT + 1, 3, "model1"),
    (4093, _DR - 4, 3, "model1"), (4093, _DR + 4, 3, "model1"),
    (4093, _DR + 1, 3, "model2"), (4093, _DR - 4, 3, "model2-cols"),
    (37, 1, 3, "model1"), (61, 4 * TT.DP_TILE[5] + 4, 5, "model1"),
    (64, 3 * TT.DP_TILE[16] + 4, 16, "model2"),
    (61, 2 * TT.DP_TILE[16] + 1, 16, "model1")])
def test_args_route_at_its_tiles_edges(case):
    """D's ARGS route == its plain version (the frontier and the argmin
    table, the identity past each row's horizon) where its tiles and the
    argmin table's ring turn over."""
    from repro_torch.core.policies.offline_opt import dp_fetch_matrix
    dev = _card()
    R, chunk, K, service = case
    d = _hosting_case(dev, R, chunk, K, K > 3, False, seed=R + chunk + K)
    J = (d["rng"].random((R, K)) * 3).astype(np.float32)
    J[0::7] = np.inf
    J = torch.from_numpy(np.where(d["kmask"].cpu().numpy(), J, np.inf)
                         .astype(np.float32)).to(dev)
    fetch = dp_fetch_matrix(d["M"], d["lv"])
    if service == "model1":
        args = (J, d["c"], d["x"], d["g"], d["lv"], d["kmask"], fetch,
                d["T_len"], d["t0"], True)
        kern, plain = H.dp_fwd_model1, H.dp_fwd_model1_plain
    else:
        Kf = 5 if service == "model2-cols" else K
        s = _svc_inputs(dev, R, chunk, K, Kf, seed=R + K)
        args = (J, d["c"], s["svc"], d["lv"], d["kmask"], fetch, d["T_len"],
                d["t0"], s["cols"] if service == "model2-cols" else None,
                True)
        kern, plain = H.dp_fwd_model2, H.dp_fwd_model2_plain
    before = kern.args_launches
    Jk, ak = kern(*args)
    torch.cuda.synchronize()
    assert kern.args_launches == before + 1
    Jp, ap = plain(*args)
    assert torch.equal(Jk, Jp) and torch.equal(ak, ap)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (R, K, policy, service, include_final_fetch): MDP and ABC on the
    # reference's small batches (simulator.xla_fetch_fma)
    (5, 3, "mdp", "model1", True), (2, 12, "abc", "model1", True),
    (3, 6, "mdp", "model2", True), (5, 3, "abc", "model2", False)])
def test_table_kernel_with_the_sums_fused_matches_plain(case):
    """S's table variant with the rent and the fetch fused into their sums
    (E passes over its trace, the fetch over the trace a slot later) ==
    its plain version, with and without the trace."""
    from repro_torch.core.simulator import sim_acc0
    dev = _card()
    R, K, policy, service, iff = case
    chunk = 777
    h = _hosting_case(dev, R, chunk, K, False, False, seed=R + K)
    tab = table_form(*_table_case(dev, R, chunk, K, policy, seed=R), K)
    rng = h["rng"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    side = t(rng.integers(-1, 3, (R, chunk)).astype(np.int32))
    x = t(rng.integers(0, 30, (R, chunk)).astype(np.int32))
    for trace in (False, True):
        acc = sim_acc0(R, K, dev)
        acc["sums"] += t((rng.random((R, 3)) * 100).astype(np.float32))
        carry = ({"r": t(rng.integers(0, K, R).astype(np.int32))}, acc)
        if service == "model1":
            args = (*tab, h["lv"], h["g"], h["M"], h["T_len"], h["t0"],
                    carry, x, h["c"], side, iff, trace, True, True)
            kern, plain = H.sim_chunk_table, H.sim_chunk_table_plain
        else:
            d = _svc_inputs(dev, R, chunk, K, K, seed=R + K)
            args = (*tab, h["lv"], h["M"], h["T_len"], h["t0"], carry, x,
                    h["c"], side, d["svc"], None, iff, trace, True, True)
            kern, plain = H.sim_chunk_table_svc, H.sim_chunk_table_svc_plain
        (sk, ak), rk = kern(*args)
        torch.cuda.synchronize()
        (sp, ap), rp = plain(*args)
        assert torch.equal(sk["r"], sp["r"])
        for key in ap:
            assert torch.equal(ak[key], ap[key]), (trace, key)
        assert (rk is None and rp is None) or torch.equal(rk, rp)


# ----------------------------------------------------------------------
# D on a finished w (dp_minplus_kernel) at its tiles' edges: a slot either
# side of a tile (the sizes in _table_tiles.py), 1,000 and 1,001 slots
# (the 4-byte route), whole 16-slot groups (the tensor copies), rows
# ragged against the CTA's 32, prefix masks and masks with holes, ties
# and all-+inf columns.  Bit for bit.
# ----------------------------------------------------------------------

_DPM_KS = tuple(TT.DPM_TILE)


def _minplus_case(dev, R, chunk, K, seed, holes):
    """Inputs of D on a finished w on a half-integer grid (ties between
    predecessors are common): fetch = M * max(lv[k] - lv[kp], 0), rows
    whose frontier is all +inf, levels priced +inf (masked), and a valid
    mask with holes or a prefix of each row."""
    rng = np.random.default_rng(seed)
    lv = np.sort(rng.integers(0, 9, (R, K)) / 8, axis=1).astype(np.float32)
    M = rng.integers(1, 4, R).astype(np.float32)
    fetch = (M[:, None, None] * np.maximum(lv[:, None, :] - lv[:, :, None],
                                           0)).astype(np.float32)
    J = (rng.integers(0, 8, (R, K)) / 2).astype(np.float32)
    J[0::5] = np.inf
    J[1::5, 1:] = np.inf
    w = (rng.integers(0, 6, (R, chunk, K)) / 4).astype(np.float32)
    w[rng.random((R, K))[:, None, :].repeat(chunk, 1) < 0.15] = np.inf
    if holes:
        valid = rng.random((R, chunk)) < 0.7
    else:
        valid = np.arange(chunk)[None, :] < rng.integers(0, chunk + 2,
                                                         R)[:, None]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return t(J), t(w), t(fetch), t(valid)


@pytest.mark.cuda
def test_dp_minplus_tiles_are_the_librarys():
    """The library's tile of D on a finished w (``dp_minplus_tile_slots``)
    is the one the edge shapes are placed around (``_table_tiles.py``): a
    multiple of 4, at most 252 words a row's tile, an odd number of
    16-byte units a staged row."""
    _card()
    lib = _build.library("hosting")
    for K in range(1, H.DP_MAX_K + 1):
        tile = lib.dp_minplus_tile_slots(K)
        assert tile % 4 == 0 and 4 <= tile * K <= 252, K
        assert ((tile * K + 4) // 4) % 2 == 1, K
        if K in TT.DPM_TILE:
            assert tile == TT.DPM_TILE[K], K
    assert lib.dp_minplus_tile_slots(0) == -1
    assert lib.dp_minplus_tile_slots(H.DP_MAX_K + 1) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("K", _DPM_KS)
def test_dp_minplus_kernel_at_its_tiles_edges(K):
    """D on a finished w == its plain version (the frontier and the argmin
    table, the identity on invalid slots) a slot either side of its tile,
    at 1,000, 1,001 and whole 16-slot groups of slots, on 1, 31 and 33
    rows, with prefix masks and masks with holes; once more with every
    input one word off 16 bytes (the 4-byte route on an aligned chunk)."""
    dev = _card()
    tile = TT.DPM_TILE[K]
    chunks = (1, tile - 1, tile, tile + 1, 1000, 1001, 16 * tile, 4096)
    for chunk in chunks:
        for R in (1, 31, 33):
            for holes in (False, True):
                args = _minplus_case(dev, R, chunk, K, R * chunk + K, holes)
                before = H.dp_minplus.launches
                Jk, ak = H.dp_minplus(*args)
                torch.cuda.synchronize()
                assert H.dp_minplus.launches == before + 1
                Jp, ap = H.dp_minplus_plain(*args)
                assert torch.equal(Jk, Jp), (chunk, R, holes)
                assert torch.equal(ak, ap), (chunk, R, holes)
    args = _minplus_case(dev, 33, 16 * tile, K, K, True)
    Jk, ak = H.dp_minplus(*(H.misaligned(a) for a in args))
    Jp, ap = H.dp_minplus_plain(*args)
    assert torch.equal(Jk, Jp) and torch.equal(ak, ap)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 16, 32])
def test_dp_minplus_kernel_at_fleet_width(K):
    """D on a finished w at the fleet's width (4,093 rows, ragged against
    the CTA's 32) == its plain version, on both routes."""
    dev = _card()
    for chunk in (1024, 1001):
        args = _minplus_case(dev, 4093, chunk, K, chunk + K, chunk % 2 == 1)
        Jk, ak = H.dp_minplus(*args)
        torch.cuda.synchronize()
        Jp, ap = H.dp_minplus_plain(*args)
        assert torch.equal(Jk, Jp) and torch.equal(ak, ap), chunk


# ----------------------------------------------------------------------
# S's gather route on few rows (its few-rows instances: 4 to 8 levels of a
# slab of more than 16, up to 4 x the SM count rows) at the CPU edge
# tests' shapes (tests/test_torch_minplus_edges.py).  Bit for bit.
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 3, 8])
@pytest.mark.parametrize("R", [1, 4, 5, 31])
def test_gather_route_on_few_rows_matches_plain(R, K):
    """alpha-RR's S on a 31-level slab through a lane of K levels' column
    map == its plain version: ragged chunks from an odd t0, the trace on
    and off, the final fetch kept and dropped, horizons inside the chunk,
    from a carry in mid-run, on a grid of eighths (ties between margins)
    and on uniform draws; and a row either side of the few-rows route's
    one wave at K = 8."""
    dev = _card()
    Kf, t0 = 31, 4001
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(R, chunk, grid) for chunk in (1, 17, 333, 1001)
             for grid in (False, True)]
    if (R, K) == (4, 8):
        cases += [(4 * n_sm, 333, True), (4 * n_sm + 1, 333, False)]
    for i, (RR, chunk, grid) in enumerate(cases):
        rng = np.random.default_rng(RR * 1000 + chunk + K + grid)

        def draw(*shape):
            if grid:
                return (rng.integers(0, 9, shape) / 8).astype(np.float32)
            return rng.random(shape).astype(np.float32)

        lv = np.sort(draw(RR, K), axis=1)
        lv[:, 0], lv[:, -1] = 0.0, 1.0
        cols = np.stack([np.sort(np.concatenate(
            ([0, Kf - 1], rng.choice(np.arange(1, Kf - 1), K - 2,
                                     replace=False))))
            for _ in range(RR)]).astype(np.int32)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
        S = np.where(rng.random((RR, K)) < 0.3, np.float32(3.4e38),
                     (draw(RR, K) * 4 - 2).astype(np.float32))
        params = {"levels": t(lv), "mask": t(np.ones((RR, K), bool)),
                  "M": t((draw(RR) * 20 + 0.5).astype(np.float32))}
        carry = ({"r": t(rng.integers(0, K, RR).astype(np.int32)),
                  "S": t(S), "age": t(rng.integers(0, 4, RR).astype(
                      np.int32))},
                 {"sums": t((rng.random((RR, 3)) * 100).astype(np.float32)),
                  "counts": t(rng.integers(0, 50, (RR, K)).astype(
                      np.int32))})
        T_len = t(rng.integers(t0 - 3, t0 + chunk + 3, RR).astype(np.int32))
        for trace in (True, False):
            args = (params, params["levels"], params["M"], T_len, t0, carry,
                    t((draw(RR, chunk) * 1.5).astype(np.float32)),
                    t((draw(RR, chunk, Kf) * 3).astype(np.float32)),
                    t(cols), i % 2 == 0, trace)
            (sk, ak), rk = H.sim_chunk_alpha_rr_svc(*args)
            torch.cuda.synchronize()
            (sp, ap), rp = H.sim_chunk_alpha_rr_svc_plain(*args)
            for a, b in ((sk, sp), (ak, ap)):
                for key in a:
                    assert torch.equal(a[key], b[key]), (RR, chunk, key)
            assert (rk is None and rp is None) or torch.equal(rk, rp)

"""Kernels F and M, and the serving engine, on the card: held against their
plain versions (the ``cuda`` tests skip without a card; run them on the
card with ``python -m pytest -m cuda tests/test_torch_cuda.py``).  The
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

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SSD

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

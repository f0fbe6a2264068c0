"""Composable decoder stack (the port of ``repro/models/transformer.py``).

A model is a sequence of *segments* ``(kind, n)``: n structurally identical
layers whose parameters are stacked on a leading axis ``[n, ...]``; the
port runs layer ``i`` of a segment in a Python loop (the reference's
``lax.scan``).  Kinds ported:

  dense        pre-norm GQA/MHA/MQA self-attn + pre-norm SwiGLU MLP
  ssm          Mamba2 block
  shared_ref   one application of the model-level weight-tied attn+MLP
               block (zamba2); its parameters live at
               ``params["shared_block"]``, and each occurrence keeps its
               own KV cache.

``moe``, ``mla_dense``, ``mla_moe`` and ``cross``, the frontends and
``lm_loss`` are not ported yet (ROADMAP.md Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as ssm_mod
from repro_torch.models.layers import (dense_init, embed_apply, embed_init,
                                       mlp_apply, mlp_init, rms_norm,
                                       unembed_apply)

PORTED_KINDS = ("dense", "ssm", "shared_ref")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config with torch dtypes.  ``remat``,
    ``remat_policy``, ``scan_unroll``, ``fsdp_experts`` and
    ``decode_impl`` are kept so configs copy across; they have no effect
    in the port (it runs eagerly, has no autodiff rematerialisation and no
    device mesh)."""
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Tuple[str, int], ...]
    d_head: int = 0                      # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rotary_dim: int = 0                  # 0 -> full head dim
    # MLA
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    mla_nope_dim: int = 128
    mla_rope_dim: int = 64
    mla_v_dim: int = 128
    # MoE
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    # SSM
    ssm_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 128
    # frontends
    frontend: Optional[str] = None
    frontend_dim: int = 0
    frontend_tokens: int = 0
    # numerics / lowering
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    attn_impl: str = "xla_flash"
    attn_chunk: int = 1024
    moe_capacity_factor: float = 1.25
    loss_chunk: int = 512
    tie_embeddings: bool = False
    scan_unroll: bool = False
    remat_policy: str = "full"
    decode_impl: str = "auto"
    fsdp_experts: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def n_layers(self) -> int:
        return sum(n for _, n in self.segments)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def check_ported(cfg: ModelConfig):
    """Raise for segment kinds or frontends the port does not run yet."""
    bad = sorted({k for k, _ in cfg.segments if k not in PORTED_KINDS})
    if bad or cfg.frontend is not None:
        what = ", ".join(bad + ([f"the {cfg.frontend} frontend"]
                                if cfg.frontend else []))
        raise NotImplementedError(
            f"{cfg.name}: {what} not ported yet (ROADMAP.md Queue 1 item 13)")


# ----------------------------------------------------------------------
# Param init
# ----------------------------------------------------------------------

def _layer_init(kind: str, generator, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    if kind == "dense":
        return {"norm_attn": torch.zeros((d,), dtype=dtype, device=device),
                "attn": attn_mod.gqa_init(generator, cfg, dtype, device),
                "norm_ffn": torch.zeros((d,), dtype=dtype, device=device),
                "ffn": mlp_init(generator, d, cfg.d_ff, dtype, device)}
    if kind == "ssm":
        return {"norm": torch.zeros((d,), dtype=dtype, device=device),
                "mixer": ssm_mod.mamba2_init(generator, cfg, dtype, device)}
    if kind == "shared_ref":
        return {}                        # tied weights at params["shared_block"]
    raise NotImplementedError(
        f"segment kind {kind!r} is not ported yet (ROADMAP.md Queue 1 "
        f"item 13)")


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg: ModelConfig, generator=None, device=None):
    """Random parameters for ``cfg``, drawn from ``generator`` (which must
    live on ``device``); the tree has the reference's layout."""
    check_ported(cfg)
    dtype = cfg.param_dtype
    params = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                  dtype, device)}
    if any(kind == "shared_ref" for kind, _ in cfg.segments):
        params["shared_block"] = _layer_init("dense", generator, cfg, dtype,
                                             device)
    segs = []
    for kind, n in cfg.segments:
        if kind == "shared_ref":
            segs.append({})
            continue
        segs.append(_stack([_layer_init(kind, generator, cfg, dtype, device)
                            for _ in range(n)]))
    params["segments"] = segs
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                       device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                       dtype, device)
    return params


# ----------------------------------------------------------------------
# Layer bodies
# ----------------------------------------------------------------------

def _apply_layer(kind, p, cfg, x, positions, cache, cache_pos):
    if kind == "dense":
        h, new_kv = attn_mod.gqa_apply(p["attn"], cfg,
                                       rms_norm(x, p["norm_attn"]), positions,
                                       cfg.attn_impl, cache, cache_pos)
        x = x + h
        y = mlp_apply(p["ffn"], rms_norm(x, p["norm_ffn"]))
        return x + y, new_kv
    if kind == "ssm":
        sstate = cache[0] if cache is not None else None
        cstate = cache[1] if cache is not None else None
        y, hT, new_conv = ssm_mod.mamba2_apply(p["mixer"], cfg,
                                               rms_norm(x, p["norm"]),
                                               ssm_state=sstate,
                                               conv_state=cstate)
        return x + y, ((hT, new_conv) if cache is not None else None)
    raise NotImplementedError(
        f"segment kind {kind!r} is not ported yet (ROADMAP.md Queue 1 "
        f"item 13)")


def _segment_forward(kind, n, seg_params, cfg, x, positions, seg_cache,
                     cache_pos, shared_block):
    """One segment's layers in order.  A stacked cache is updated in place
    (layer i's slice) and returned."""
    if kind == "shared_ref":
        return _apply_layer("dense", shared_block, cfg, x, positions,
                            seg_cache, cache_pos)
    for i in range(n):
        cache_i = (None if seg_cache is None
                   else tuple(c[i] for c in seg_cache))
        x, new_i = _apply_layer(kind, _index(seg_params, i), cfg, x,
                                positions, cache_i, cache_pos)
        if kind == "ssm" and new_i is not None:   # attention wrote in place
            for c, new in zip(seg_cache, new_i):
                if new is not None:
                    c[i] = new
    return x, seg_cache


def forward(params, cfg: ModelConfig, batch, caches=None, cache_pos=None,
            n_segments: int | None = None):
    """Run the stack.

    batch: dict with "tokens" [B,S] (integer tensor).
    caches: as ``make_caches`` returns (None = prefill without a cache);
      updated in place and returned.
    cache_pos: the position of the first token (an int) when caches are
      given.
    n_segments: truncate the stack (partial-hosting layer-prefix plans).

    Returns (hidden [B,S,D], new_caches, aux_losses = 0.0).
    """
    check_ported(cfg)
    x = embed_apply(params["embed"], batch["tokens"]).to(cfg.compute_dtype)
    b, s = x.shape[:2]
    pos0 = 0 if cache_pos is None else int(cache_pos)
    positions = (pos0 + torch.arange(s, dtype=torch.int32, device=x.device)
                 ).expand(b, s)
    segs = cfg.segments if n_segments is None else cfg.segments[:n_segments]
    new_caches = []
    for i, (kind, n) in enumerate(segs):
        seg_cache = caches[i] if caches is not None else None
        x, ncache = _segment_forward(kind, n, params["segments"][i], cfg, x,
                                     positions, seg_cache, pos0,
                                     params.get("shared_block"))
        new_caches.append(ncache)
    x = rms_norm(x, params["final_norm"])
    return x, new_caches, 0.0


def logits_fn(params, cfg: ModelConfig, hidden):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return unembed_apply(w, hidden)


# ----------------------------------------------------------------------
# KV / state caches
# ----------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Shapes and dtypes of every segment's cache: tuples of
    ``(*shape, dtype)``."""
    check_ported(cfg)
    dt = cfg.compute_dtype
    hd = cfg.head_dim
    specs = []
    for kind, n in cfg.segments:
        if kind == "dense":
            specs.append(((n, batch, max_len, cfg.n_kv_heads, hd, dt),
                          (n, batch, max_len, cfg.n_kv_heads, hd, dt)))
        elif kind == "ssm":
            di = cfg.ssm_d_inner
            conv_dim = di + 2 * cfg.ssm_n_groups * cfg.ssm_state
            specs.append((
                (n, batch, cfg.ssm_n_heads, di // cfg.ssm_n_heads,
                 cfg.ssm_state, torch.float32),
                (n, batch, cfg.ssm_d_conv - 1, conv_dim, dt)))
        else:                            # shared_ref: one occurrence's K/V
            specs.append(((batch, max_len, cfg.n_kv_heads, hd, dt),
                          (batch, max_len, cfg.n_kv_heads, hd, dt)))
    return specs


def make_caches(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return [tuple(torch.zeros(s[:-1], dtype=s[-1], device=device)
                  for s in spec)
            for spec in cache_spec(cfg, batch, max_len)]

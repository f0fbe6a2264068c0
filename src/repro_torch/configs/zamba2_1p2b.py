"""zamba2-1.2b [hybrid]: 38 Mamba2 layers + a weight-tied shared attention
block applied every ~6 layers.  38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000 ssm_state=64.  [arXiv:2411.15242; hf]"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.transformer import ModelConfig

# 6 shared-attention applications interleaved with 38 mamba2 layers
_SEGMENTS = tuple([("shared_ref", 1), ("ssm", 6)] * 6 + [("ssm", 2)])

MODEL = ModelConfig(
    name="zamba2-1.2b",
    d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000,
    segments=_SEGMENTS,
    rope_theta=10000.0,
    ssm_state=64, ssm_d_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_n_groups=1,
)

TINY = ModelConfig(
    name="zamba2-tiny",
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
    segments=tuple([("shared_ref", 1), ("ssm", 2)] * 2),
    ssm_state=16, ssm_d_conv=4, ssm_expand=2, ssm_head_dim=32, ssm_n_groups=1,
    param_dtype=torch.float32, compute_dtype=torch.float32,
    attn_impl="naive", remat=False, ssm_chunk=8, loss_chunk=16,
)

ARCH = register(ArchSpec(
    arch_id="zamba2-1.2b", family="hybrid", model=MODEL, tiny=TINY,
    partial_plan="layer_prefix", alpha_default=0.4, g_alpha_default=0.45,
    long_context_ok=True,
    source="arXiv:2411.15242; hf",
    notes="Hybrid SSM: long_500k runs (decode state is O(1) for SSM layers; "
          "the 6 shared-attn applications decode one query against the cache).",
))

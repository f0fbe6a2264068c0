"""mamba2-130m [ssm]: 24L d_model=768, attention-free SSD, ssm_state=128,
vocab=50280.  [arXiv:2405.21060; unverified]"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.transformer import ModelConfig

MODEL = ModelConfig(
    name="mamba2-130m",
    d_model=768, n_heads=12, n_kv_heads=12, d_ff=0, vocab_size=50280,
    segments=(("ssm", 24),),
    ssm_state=128, ssm_d_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_n_groups=1,
)

TINY = ModelConfig(
    name="mamba2-tiny",
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=256,
    segments=(("ssm", 2),),
    ssm_state=16, ssm_d_conv=4, ssm_expand=2, ssm_head_dim=32, ssm_n_groups=1,
    param_dtype=torch.float32, compute_dtype=torch.float32,
    attn_impl="naive", remat=False, ssm_chunk=8, loss_chunk=16,
)

ARCH = register(ArchSpec(
    arch_id="mamba2-130m", family="ssm", model=MODEL, tiny=TINY,
    partial_plan="layer_prefix", alpha_default=0.5, g_alpha_default=0.5,
    long_context_ok=True,
    source="arXiv:2405.21060; unverified",
    notes="Attention-free: long_500k runs (O(1) decode state). Model too "
          "small for TP on a 16-wide model axis: sharded DP-only with "
          "params replicated (see sharding rules).",
))

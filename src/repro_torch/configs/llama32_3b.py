"""llama3.2-3b [dense]: 28L d_model=3072 24H (kv=8) d_ff=8192 vocab=128256,
tied embeddings, rope theta 500k.  [hf:meta-llama/Llama-3.2-3B; unverified]"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.transformer import ModelConfig

MODEL = ModelConfig(
    name="llama3.2-3b",
    d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192, vocab_size=128256,
    segments=(("dense", 28),),
    rope_theta=500000.0, tie_embeddings=True,
)

TINY = ModelConfig(
    name="llama3.2-tiny",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    segments=(("dense", 2),), tie_embeddings=True,
    param_dtype=torch.float32, compute_dtype=torch.float32,
    attn_impl="naive", remat=False, loss_chunk=16,
)

ARCH = register(ArchSpec(
    arch_id="llama3.2-3b", family="dense", model=MODEL, tiny=TINY,
    partial_plan="layer_prefix", alpha_default=0.5, g_alpha_default=0.55,
    long_context_ok=False,
    source="hf:meta-llama/Llama-3.2-3B; unverified",
    notes="alpha+g(alpha)>=1 at the default point: Theorem 1 predicts "
          "alpha-RR degenerates to RR here (verified in benchmarks). "
          "long_500k skipped (full attention).",
))

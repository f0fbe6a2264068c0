"""The decoder stack of the LM serving path (the port of ``repro.models``):
layers, GQA attention over kernel F, Mamba2 over kernel M, and the segment
stack."""
from repro_torch.models.transformer import (ModelConfig, cache_spec,
                                            forward, init_params, logits_fn,
                                            make_caches)

__all__ = ["ModelConfig", "init_params", "forward", "logits_fn",
           "make_caches", "cache_spec"]

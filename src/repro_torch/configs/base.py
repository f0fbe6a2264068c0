"""Architecture registry (the port of ``repro/configs/base.py``): each arch
contributes an ``ArchSpec`` with the published config, a reduced ``tiny``
variant for CPU tests, its partial-hosting plan and the input-shape grid.

The port registers the archs whose segment kinds it runs (dense, ssm,
shared_ref): zamba2-1.2b, mamba2-130m and llama3.2-3b.  ``get_arch`` of one
of the reference's other archs raises, naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.transformer import ModelConfig, check_ported


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int           # train/prefill length, or KV-cache length for decode
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    model: ModelConfig
    tiny: ModelConfig
    partial_plan: str                 # "layer_prefix" (Model 1) | "expert_subset" (Model 2)
    alpha_default: float              # default partial hosting level
    g_alpha_default: float            # measured/assumed g(alpha) for the plan
    long_context_ok: bool             # run long_500k? (sub-quadratic families only)
    source: str
    notes: str = ""

    def shapes(self):
        for s in SHAPES.values():
            if s.name == "long_500k" and not self.long_context_ok:
                continue
            yield s

    def param_count(self) -> int:
        """Parameter count, from an init on the ``meta`` device (shapes
        only, nothing allocated)."""
        from repro_torch.models.transformer import init_params
        tree = init_params(self.model, None, torch.device("meta"))
        return _count(tree)


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count(v) for v in tree)
    return tree.numel()


_REGISTRY: Dict[str, ArchSpec] = {}
# the reference's archs whose segment kinds or frontends are not ported
_NOT_PORTED = {
    "deepseek-moe-16b": "moe", "deepseek-v2-236b": "mla_moe",
    "granite-20b": "its config", "qwen2.5-14b": "its config",
    "stablelm-1.6b": "its config", "musicgen-medium": "the audio frontend",
    "llama3.2-vision-11b": "cross and the vision frontend",
}


def register(spec: ArchSpec) -> ArchSpec:
    if spec.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch {spec.arch_id}")
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id}: {_NOT_PORTED[arch_id]} not ported yet (ROADMAP.md "
            f"Queue 1 item 13)")
    spec = _REGISTRY[arch_id]
    check_ported(spec.model)
    return spec


def all_archs() -> Dict[str, ArchSpec]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import llama32_3b, mamba2_130m, zamba2_1p2b  # noqa

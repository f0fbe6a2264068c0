from repro_torch.configs.base import (SHAPES, ArchSpec, ShapeSpec, all_archs,
                                      get_arch, register)

__all__ = ["ArchSpec", "ShapeSpec", "SHAPES", "get_arch", "all_archs",
           "register"]

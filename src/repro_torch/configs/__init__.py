from .base import (ARCH_IDS, SHAPES, ArchConfig, ShapeSpec, cache_specs,
                   get_config, input_specs, reduced, supports, torch_dtype)

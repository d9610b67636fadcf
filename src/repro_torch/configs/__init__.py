"""Architecture registry: ``--arch <id>`` -> ArchConfig (FULL or SMOKE)."""

from .base import (ArchConfig, InputShape, SHAPES, TRAIN_4K, PREFILL_32K,
                   DECODE_32K, LONG_500K)
from .registry import ARCH_IDS, get_arch, input_specs, make_inputs

__all__ = ["ArchConfig", "InputShape", "SHAPES", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K", "ARCH_IDS", "get_arch", "input_specs",
           "make_inputs"]

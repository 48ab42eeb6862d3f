"""High-level pipelines: reconstruction and coloration."""

from .coloration import ColorationConfig, ColorationPipeline
from .reconstruction import (
    ReconstructionConfig,
    ReconstructionPipeline,
    ReconstructionResult,
)
from .streaming import batched, prefetch_views

__all__ = [
    "ColorationConfig",
    "ColorationPipeline",
    "ReconstructionConfig",
    "ReconstructionPipeline",
    "ReconstructionResult",
    "batched",
    "prefetch_views",
]

"""High-level pipelines: reconstruction, coloration and the filter API."""

from .coloration import ColorationConfig, ColorationPipeline
from .filter import ReconstructionFilter
from .reconstruction import (
    ReconstructionConfig,
    ReconstructionPipeline,
    ReconstructionResult,
)
from .streaming import batched, prefetch_views

__all__ = [
    "ColorationConfig",
    "ColorationPipeline",
    "ReconstructionFilter",
    "ReconstructionConfig",
    "ReconstructionPipeline",
    "ReconstructionResult",
    "batched",
    "prefetch_views",
]

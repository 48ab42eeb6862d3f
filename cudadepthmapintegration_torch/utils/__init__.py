"""Utilities: logging, phase timing and dtype conversions."""

from .log import RAY_POTENTIAL_ASCII, Log

__all__ = ["Log", "RAY_POTENTIAL_ASCII"]

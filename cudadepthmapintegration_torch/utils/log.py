"""Structured logging + verbose console output.

Mirrors the reference's ``--verbose`` ``ShowInformation``/``ShowFilledParameters``
UX (``Reconstruction/main.cxx:386-454``) with per-phase timing that feeds the
``--summary`` report (``main.cxx:458-516``).
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager

__all__ = ["Log", "RAY_POTENTIAL_ASCII"]

# The reference prints an ASCII plot of the TSDF profile in verbose mode
# (Reconstruction/main.cxx:414-427); kept for UX parity.
RAY_POTENTIAL_ASCII = r"""
                                                            _________
     rho|                                                  /         |
        |                                                 /          |
        |                                                /           |
       0| _   _   _   _   _   _   _   _   _   _   _   _ /_   _   _  _|_____
        |___________________________________           /
 eta*rho|                                  |          /     |
        |                                  |         /
        |                                  |________/       |
        |                                               |
                                           |        |   d   |
                                        Delta   d-thick  d+thick
"""


class Log:
    """Verbose-gated logger with named phase timers."""

    def __init__(self, verbose: bool = False, stream=None):
        self.verbose = verbose
        self.stream = stream or sys.stdout
        self.timings: dict[str, float] = {}

    def info(self, message: str) -> None:
        if self.verbose:
            print(message, file=self.stream, flush=True)

    def always(self, message: str) -> None:
        print(message, file=self.stream, flush=True)

    def progress(self, i: int, n: int) -> None:
        """Percent progress like the view loop (CudaReconstruction.cu:345)."""
        if self.verbose and n:
            print(f"\r{(100 * i) // n} %", end="", file=self.stream, flush=True)

    @contextmanager
    def phase(self, name: str):
        """Time a named phase; accumulates into :attr:`timings`."""
        self.info(f"** {name}...")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt

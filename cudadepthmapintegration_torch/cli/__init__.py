"""Command-line interfaces mirroring the reference executables.

Submodules load lazily so ``python -m cudadepthmapintegration_torch.cli.X``
doesn't trigger runpy's double-import warning.
"""

import importlib

__all__ = ["colorize", "fuse_rgbd", "reconstruct"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)

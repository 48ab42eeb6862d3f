"""Fault-tolerant, resumable fusion runner.

The reference aborts the whole job on any error (``gpuAssert`` calls
``exit()`` — ``CudaReconstruction.cu:68-76``). For long runs we instead
exploit the algebra: fusion is an order-independent SUM over views
(``CudaReconstruction.cu:211``), so work splits into idempotent view-range
units. A failed unit is retried from a pre-attempt snapshot; a crashed run
resumes from its checkpoint.

Crash-safety model: the volume AND the completed-unit set are saved in ONE
atomic ``os.replace`` (the unit set rides in the checkpoint's ``extra``
meta), so there is no window where the volume contains a unit the
bookkeeping does not know about. A checkpoint whose unit layout
(unit_size / num_hosts / host_id) no longer matches is discarded entirely —
volume included — so stale contributions can never be double-fused.

Multi-process model: every process runs the same runner with (host_id,
num_hosts); units are statically striped across processes; each fuses only
its units into its own volume partial (checkpointed under a host-suffixed
path), and partial volumes are summed once at the end via
:func:`..parallel.distributed.all_sum_volume`.

The semantics, and the checkpoint files, are those of the JAX package's
runner: a checkpoint written by either resumes in the other.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Sequence

import numpy as np

from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential
from ..utils.log import Log
from .checkpoint import FusionCheckpoint, load_checkpoint, save_checkpoint

__all__ = [
    "WorkUnit",
    "FaultTolerantRunner",
    "FusionUnitError",
    "NON_TRANSIENT_EXCEPTIONS",
]

# Exception classes that indicate a PROGRAMMING error in `integrate_fn`
# (wrong signature, missing attribute, bad key/index), not a transient
# fault of the device or I/O path. Retrying these cannot succeed — it
# only buries the traceback under max_retries sleep-and-retry cycles —
# so the runner checkpoints completed progress and re-raises on the
# FIRST attempt. Everything else (device errors, OSError, RuntimeError
# from a lost buffer) stays retried: fusion units are idempotent, so a
# transient retry is always safe.
NON_TRANSIENT_EXCEPTIONS = (
    TypeError,
    AttributeError,
    KeyError,
    IndexError,
    NameError,
    NotImplementedError,
    AssertionError,
)


class FusionUnitError(RuntimeError):
    """Raised when work units remain failed after all retries.

    A reconstruction silently missing views is worse than a crash, so this
    is the default outcome (``on_failure="raise"``); completed units are
    checkpointed first, so a fixed rerun resumes instead of restarting.
    """

    def __init__(self, failed_units: list[int]):
        self.failed_units = list(failed_units)
        super().__init__(
            f"{len(self.failed_units)} work unit(s) failed after retries: "
            f"{self.failed_units}"
        )


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    unit_id: int
    start: int  # first view index (inclusive)
    stop: int  # last view index (exclusive)


def _units_for(n_views: int, unit_size: int) -> list[WorkUnit]:
    return [
        WorkUnit(unit_id=i, start=s, stop=min(s + unit_size, n_views))
        for i, s in enumerate(range(0, n_views, unit_size))
    ]


class FaultTolerantRunner:
    """Runs fusion as retried, checkpointed, idempotent view-range units.

    `integrate_fn(volume_or_none, views) -> volume` applies one unit. It MAY
    mutate the volume it receives and MAY fail non-atomically: every
    attempt is fed a fresh copy of a host-side snapshot taken before the
    unit, so retries never observe partial accumulation.

    on_failure: ``"raise"`` (default) raises :class:`FusionUnitError` after
    all units have been attempted and progress checkpointed; ``"partial"``
    returns the volume with ``failed_units`` recorded (caller must check it).
    """

    def __init__(
        self,
        grid: VoxelGrid,
        params: RayPotential,
        integrate_fn: Callable,
        unit_size: int = 32,
        max_retries: int = 3,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 1,
        host_id: int = 0,
        num_hosts: int = 1,
        on_failure: str = "raise",
        log: Log | None = None,
    ):
        if on_failure not in ("raise", "partial"):
            raise ValueError("on_failure must be 'raise' or 'partial'")
        self.grid = grid
        self.params = params
        self.integrate_fn = integrate_fn
        self.unit_size = int(unit_size)
        self.max_retries = int(max_retries)
        self._base_checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.host_id = int(host_id)
        self.num_hosts = int(num_hosts)
        self.on_failure = on_failure
        self.log = log or Log()
        self.completed_units: set[int] = set()
        self.failed_units: list[int] = []

    @property
    def checkpoint_path(self) -> str | None:
        """Per-host checkpoint file: hosts must never share one path (a
        resumed host could otherwise load another host's partial volume,
        which still "matches" the grid/params check)."""
        if self._base_checkpoint_path is None:
            return None
        if self.num_hosts == 1:
            return self._base_checkpoint_path
        return f"{self._base_checkpoint_path}.h{self.host_id}"

    # -- checkpoint ----------------------------------------------------------

    def _layout(self) -> dict:
        return {
            "unit_size": self.unit_size,
            "num_hosts": self.num_hosts,
            "host_id": self.host_id,
        }

    def _checkpoint(self, volume: np.ndarray, n_views: int) -> None:
        by_id = {u.unit_id: u for u in _units_for(n_views, self.unit_size)}
        fused = sum(
            by_id[u].stop - by_id[u].start
            for u in self.completed_units
            if u in by_id
        )
        save_checkpoint(
            self.checkpoint_path,
            FusionCheckpoint(
                volume=np.asarray(volume),
                views_fused=fused,
                grid=self.grid,
                params=self.params,
                extra={
                    "runner": {
                        **self._layout(),
                        "completed_units": sorted(self.completed_units),
                    }
                },
            ),
        )

    def _try_resume(self) -> np.ndarray | None:
        """Returns the resumed volume, or None to start from scratch.

        Volume and completed-unit set are accepted or rejected TOGETHER:
        a checkpoint without matching unit bookkeeping is discarded so its
        volume cannot be double-fused."""
        path = self.checkpoint_path
        if path is None or not os.path.exists(path):
            return None
        ckpt = load_checkpoint(path)
        if not ckpt.matches(self.grid, self.params):
            self.log.info("checkpoint does not match configuration; ignoring")
            return None
        book = ckpt.extra.get("runner")
        if book is None or {
            k: book.get(k) for k in ("unit_size", "num_hosts", "host_id")
        } != self._layout():
            self.log.info(
                "checkpoint unit layout changed; restarting from scratch"
            )
            return None
        self.completed_units = set(book.get("completed_units", []))
        self.log.info(
            f"resumed: {len(self.completed_units)} units already fused"
        )
        return ckpt.volume

    # -- run -----------------------------------------------------------------

    def run(self, views: Sequence, resume: bool = True) -> np.ndarray:
        """Fuse this host's share of `views`; returns the host's volume."""
        volume = self._try_resume() if resume else None
        self.failed_units = []

        units = [
            u
            for u in _units_for(len(views), self.unit_size)
            if u.unit_id % self.num_hosts == self.host_id
            and u.unit_id not in self.completed_units
        ]
        done_since_ckpt = 0
        for unit in units:
            # Pre-attempt snapshot: integrate_fn may mutate its input or
            # fail after partial accumulation; every attempt restarts here.
            snapshot = None if volume is None else np.array(volume, copy=True)
            ok = False
            for attempt in range(self.max_retries):
                try:
                    batch = [views[i] for i in range(unit.start, unit.stop)]
                    seed = (
                        None if snapshot is None
                        else np.array(snapshot, copy=True)
                    )
                    volume = self.integrate_fn(seed, batch)
                    ok = True
                    break
                except NON_TRANSIENT_EXCEPTIONS as e:
                    # Programming error: fail fast on attempt 1, but save
                    # completed progress first so a fixed rerun resumes.
                    self.log.always(
                        f"unit {unit.unit_id} failed with non-transient "
                        f"{type(e).__name__}: {e} — not retrying"
                    )
                    if self.checkpoint_path and done_since_ckpt:
                        self._checkpoint(volume, len(views))
                    raise
                except Exception as e:
                    self.log.always(
                        f"unit {unit.unit_id} attempt {attempt + 1} failed: {e}"
                    )
                    time.sleep(0.01 * (attempt + 1))
            if not ok:
                self.failed_units.append(unit.unit_id)
                volume = snapshot  # unit contributed nothing
                continue
            self.completed_units.add(unit.unit_id)
            done_since_ckpt += 1
            if (
                self.checkpoint_path
                and done_since_ckpt >= self.checkpoint_every
            ):
                self._checkpoint(volume, len(views))
                done_since_ckpt = 0
        if self.checkpoint_path and done_since_ckpt:
            self._checkpoint(volume, len(views))
        if self.failed_units:
            if self.on_failure == "raise":
                raise FusionUnitError(self.failed_units)
            self.log.always(
                f"WARNING: units failed after retries: {self.failed_units}; "
                f"returning PARTIAL volume (on_failure='partial')"
            )
        if volume is None:
            volume = np.zeros(self.grid.volume_shape, np.float32)
        return np.asarray(volume)

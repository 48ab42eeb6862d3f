"""Load the native host library for the port's tests that also call the
JAX package's native route.

Both packages load ``native/build/libcdmi_native.so``. On a checkout with no
``native/build/``, test processes that start at once may each build it:
the port's loader builds under a lock into a private file and renames it
into place, but the JAX package's loader (``cudadepthmapintegration_tpu/
native.py``) runs ``make`` with no lock, writes the file in place, and keeps
any failure to load for the life of the process (``_tried``). A process
that met a half-written library then fails every JAX native call after it.

:func:`load_both` loads the port's library first (a whole file, built once),
then the JAX package's; if the JAX loader has kept a failure, it clears the
JAX module's ``_tried`` and ``_lib`` and loads again. That is test-side
state only: the JAX package is not changed.
"""

import time

import pytest

from cudadepthmapintegration_torch import native
from cudadepthmapintegration_tpu import native as jax_native

RETRIES = 5


def load_both() -> None:
    """Load the port's library (raising with make's output if it cannot be
    built), then the JAX package's, clearing a kept failure of the JAX
    loader up to ``RETRIES`` times. Raises RuntimeError if the JAX loader
    still cannot load it."""
    native._load()
    for attempt in range(RETRIES):
        if jax_native._load() is not None:
            return
        jax_native._tried = False
        jax_native._lib = None
        time.sleep(0.2 * (attempt + 1))
    raise RuntimeError(f"the JAX package's native loader failed {RETRIES} times")


@pytest.fixture(scope="module", autouse=True)
def native_libraries():
    """Module fixture: both packages' native libraries loaded."""
    load_both()

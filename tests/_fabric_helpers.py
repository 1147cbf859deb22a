"""Functions that the fabric's worker processes load by reference: the
pickled ``fn`` of a GENERIC op, or a module a worker preloads.  This module
imports nothing of the JAX package, so a worker that loads it stays free
of it; the tests put its directory on the workers' ``PYTHONPATH``."""

import atexit
import os
import sys
import time


def hold_until(x, path="", timeout_s=120.0):
    """Identity that returns once ``path`` exists (or after
    ``timeout_s``): a job that holds its worker until the test releases
    it by creating the file."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.01)
    return x


def jax_or_repro_modules():
    """The loaded modules of the JAX package or of jax itself."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "repro") or m.startswith(("jax.",
                                                            "repro.")))


def _dump_modules():
    out = os.environ.get("STRATUM_TEST_MODULES_OUT")
    if out:
        with open(f"{out}.{os.getpid()}", "w") as f:
            f.write("\n".join(["loaded"] + jax_or_repro_modules()))


# preloaded by a worker (``ProcConfig.preload``): at the worker's exit,
# after it has built its service and run its jobs, write what it loaded
if os.environ.get("STRATUM_TEST_MODULES_OUT"):
    atexit.register(_dump_modules)

"""Process start-up helpers shared by every entry point (CLIs, bench,
examples, chip_smoke.py): the persistent compile cache and a line naming
the device the process runs on."""

from __future__ import annotations

import os
import sys

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def setup_compile_cache(environ=None) -> str:
    """Point JAX's persistent compile cache at a fixed directory and return
    it.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache lives at ``<repo>/.jax_cache``
    — a fixed path, since a directory that moves between runs never finds
    its earlier entries.  Call before the first compilation."""
    environ = os.environ if environ is None else environ
    if environ.get(CACHE_ENV):
        return environ[CACHE_ENV]
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_line() -> str:
    """``backend=<platform> kind=<device_kind> count=<n>`` for the default
    devices, as JAX reports them."""
    devs = jax.devices()
    return (f"backend={devs[0].platform} kind={devs[0].device_kind} "
            f"count={len(devs)}")


def announce_device(file=None) -> str:
    """Print :func:`device_line` (stderr by default, so stdout formats stay
    as they are) and return it."""
    line = device_line()
    print(f"device: {line}", file=file if file is not None else sys.stderr,
          flush=True)
    return line


def start(file=None) -> str:
    """Entry-point prologue: compile cache, then the device line."""
    setup_compile_cache()
    return announce_device(file)

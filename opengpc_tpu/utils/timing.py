"""Phase timing and device benchmarking.

Equivalent of the reference's chrono tick helpers (``sysTick``/``tickToMs``,
/root/reference/lib/gpc/inference.hpp:62-70, training.hpp:73-80) plus the
device machinery those can't provide:

* :class:`PhaseTimer` — named wall-clock phases, printable as the same
  style of per-phase ms report the reference prints.
* :func:`device_time_per_iter` — true device time per pipeline iteration,
  measured by differencing two chained ``lax.fori_loop`` lengths and
  fetching one scalar, so per-dispatch host overhead cancels out.
* :func:`trace` — context manager around ``jax.profiler.trace`` for
  XLA device timeline captures.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import jax
import numpy as np


class PhaseTimer:
    """Accumulates named wall-clock phases.

    >>> t = PhaseTimer()
    >>> with t.phase("preprocess"): ...
    >>> with t.phase("match"): ...
    >>> print(t.report())   # tPreprocess: 1.2 ms, tMatch: 3.4 ms
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def ms(self, name: str) -> float:
        return self.totals.get(name, 0.0) * 1e3

    def report(self) -> str:
        return ", ".join(
            f"t{k[:1].upper()}{k[1:]}: {v * 1e3:.2f} ms"
            for k, v in self.totals.items()
        )


def device_time_per_iter(
    step: Callable,
    args: tuple,
    make_dep: Callable,
    n_short: int = 3,
    n_long: int = 23,
    repeats: int = 3,
) -> float:
    """Seconds of device time per ``step(*args)`` iteration.

    ``step(*args) -> scalar`` is the unit of work; ``make_dep(scalar,
    args) -> args`` must fold the scalar back into the inputs so chained
    iterations cannot be elided or overlapped.  Runs ``n_short`` and
    ``n_long`` chained iterations inside single jitted ``fori_loop``s,
    fetches one scalar from each, and returns the time difference per
    extra iteration (best of ``repeats``).
    """
    import jax.numpy as jnp

    def chained(n):
        @jax.jit
        def run(*a):
            def body(_, carry):
                acc, cur = carry
                s = step(*cur)
                return acc + s.astype(acc.dtype), make_dep(s, cur)

            # float accumulator: exact enough for a chained checksum and
            # avoids the x64-disabled int64 truncation warning
            acc, _ = jax.lax.fori_loop(0, n, body, (jnp.float32(0), a))
            return acc

        return run

    short, long_ = chained(n_short), chained(n_long)
    args = tuple(jax.device_put(a) for a in args)
    float(np.asarray(short(*args)))  # compile + warm
    float(np.asarray(long_(*args)))
    best_s = best_l = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(np.asarray(short(*args)))
        best_s = min(best_s, time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(np.asarray(long_(*args)))
        best_l = min(best_l, time.perf_counter() - t0)
    # difference the per-length minima (robust to one-off host stalls);
    # sub-noise-floor work can still come out slightly negative — clamp
    return max((best_l - best_s) / (n_long - n_short), 0.0)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a jax.profiler trace (viewable in TensorBoard/XProf).

    No-op when ``log_dir`` is None — callers can thread a CLI flag
    straight through.
    """
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield

"""Randomized-input generators for the oracle-differential fuzz tests
(tests/test_parity.py)."""

from __future__ import annotations

import numpy as np

from opengpc_tpu.forest import Fern, Forest, SCALE_HALF, Test


def random_forest(rng: np.random.Generator,
                  max_ferns: int = 4,
                  max_tests_per_fern: int = 12) -> Forest:
    """A random VALID forest: 1..max_ferns ferns of random scales, test
    offsets spanning each scale's half-width (the reference trainer's
    candidate domain, training.hpp:85-97), and either all-zero taus (zero
    type) or taus drawn from the tau optimizer's [-10, 10) range.  Total
    test counts can cross both routing boundaries: >30 tests falls off the
    sentinel-packed fast contracts, >32 exercises the reference filter
    mask's file-order cap (inference.hpp:420-424)."""
    zero = bool(rng.integers(0, 2))
    ferns = []
    for _ in range(int(rng.integers(1, max_ferns + 1))):
        scale = int(rng.choice(list(SCALE_HALF)))
        half = SCALE_HALF[scale]
        tests = tuple(
            Test(ix=int(rng.integers(-half, half + 1)),
                 iy=int(rng.integers(-half, half + 1)),
                 jx=int(rng.integers(-half, half + 1)),
                 jy=int(rng.integers(-half, half + 1)),
                 tau=0 if zero else int(rng.integers(-10, 10)))
            for _ in range(int(rng.integers(1, max_tests_per_fern + 1))))
        ferns.append(Fern(scale, tests))
    return Forest(tuple(ferns))

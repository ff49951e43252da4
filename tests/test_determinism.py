"""Seeded reproducibility (the reference is nondeterministic; we are not)."""

import numpy as np

from opengpc_tpu.config import fern_factory, tau_optimizer
from opengpc_tpu.forest import serialize_forest
from opengpc_tpu.mine import mine_stereo_pair
from opengpc_tpu.train import train_forest


def test_training_deterministic_for_seed():
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 256, (300, 729)).astype(np.int16)
    pos = np.clip(ref + rng.integers(-8, 9, ref.shape), 0, 255)
    neg = rng.integers(0, 256, ref.shape)
    trips = np.stack([ref, pos, neg], axis=1).astype(np.uint8)

    settings = fern_factory(1, 1, 1, 3)
    a = train_forest(trips, settings, tau_optimizer(num_resamples=4),
                     seed=11, verbose=False)
    b = train_forest(trips, settings, tau_optimizer(num_resamples=4),
                     seed=11, verbose=False)
    c = train_forest(trips, settings, tau_optimizer(num_resamples=4),
                     seed=12, verbose=False)
    assert serialize_forest(a) == serialize_forest(b)
    assert serialize_forest(a) != serialize_forest(c)


def test_mining_deterministic_for_seed():
    disp = np.full((80, 120), 4, np.int32)
    zeros = np.zeros((80, 120), np.uint8)
    a = mine_stereo_pair(disp, zeros, zeros, 50, 10, 20,
                         np.random.default_rng(3))
    b = mine_stereo_pair(disp, zeros, zeros, 50, 10, 20,
                         np.random.default_rng(3))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_cli_help_smoke():
    import subprocess
    import sys

    for mod in ("opengpc_tpu.cli.sparsematch", "opengpc_tpu.cli.train",
                "opengpc_tpu.cli.extract"):
        r = subprocess.run(
            [sys.executable, "-m", mod, "--help"],
            capture_output=True, text=True,
            env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode == 0, r.stderr
        assert "usage" in r.stdout.lower()


def test_matcher_contracts_deterministic():
    """The unstable-sort-based contracts emit byte-identical buffers across
    runs (the sorted keys are unique, so sort instability is unobservable
    in the outputs)."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch_global_rows,
                                   build_sparsematch_rows)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    rng = np.random.default_rng(8)
    left = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    right = np.roll(left, -3, axis=1)
    for builder, settings in (
        (build_sparsematch_rows,
         InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                           disp_high=32, capacity=4096)),
        (build_sparsematch_global_rows,
         InferenceSettings(gradient_threshold=5, epipolar_mode=False,
                           disp_high=32, capacity=4096)),
    ):
        m = builder(forest, settings)
        a = m(left, right)
        b = m(left, right)
        for x, y in zip(__import__("jax").tree_util.tree_leaves(a),
                        __import__("jax").tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

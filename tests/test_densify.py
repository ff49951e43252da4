"""Sparse-to-dense densification tests."""

import numpy as np

from opengpc_tpu.densify import densify_supports


def test_constant_disparity_fills_constant():
    sup = np.array([[10, 10, 7], [30, 20, 7], [50, 15, 7]])
    # multigrid default: constant seed fields reproduce exactly
    dense, filled = densify_supports(sup, (32, 64))
    assert filled.all()
    np.testing.assert_allclose(dense, 7.0, atol=1e-4)
    dense, filled = densify_supports(sup, (32, 64), num_iters=100,
                                     method="jacobi")
    assert filled.all()
    np.testing.assert_allclose(dense, 7.0, atol=1e-4)


def test_known_pixels_pinned():
    sup = np.array([[5, 5, 2], [20, 20, 10]])
    dense, filled = densify_supports(sup, (28, 28), num_iters=60)
    assert dense[5, 5] == 2.0 and dense[20, 20] == 10.0
    assert filled.all()
    # interpolated values stay within the support range
    assert dense.min() >= 2.0 - 1e-4 and dense.max() <= 10.0 + 1e-4


def test_limited_iters_leave_far_pixels_unfilled():
    # jacobi-specific semantics: the fill radius is the sweep count
    sup = np.array([[0, 0, 3]])
    dense, filled = densify_supports(sup, (16, 16), num_iters=4,
                                     method="jacobi")
    assert filled[0, 0] and filled[4, 0] and not filled[15, 15]
    # the multigrid default has no such radius bound: same seeds fill all
    dense, filled = densify_supports(sup, (16, 16))
    assert filled.all()


def test_empty_supports():
    dense, filled = densify_supports(np.zeros((0, 3)), (8, 8), num_iters=4)
    assert not filled.any()
    dense, filled = densify_supports(np.zeros((0, 3)), (8, 8),
                                     method="jacobi", num_iters=4)
    assert not filled.any()


def test_two_plane_scene_accuracy():
    rng = np.random.default_rng(0)
    h, w = 48, 96
    gt = np.where(np.arange(w)[None, :] < w // 2, 4, 12).astype(np.int32)
    gt = np.broadcast_to(gt, (h, w))
    ys = rng.integers(0, h, 300)
    xs = rng.integers(0, w, 300)
    sup = np.stack([xs, ys, gt[ys, xs]], axis=1)
    dense, filled = densify_supports(sup, (h, w))
    assert filled.all()
    # away from the plane boundary, the fill should be near-exact
    err = np.abs(dense - gt)
    interior = np.ones((h, w), bool)
    interior[:, w // 2 - 6: w // 2 + 6] = False
    assert np.median(err[interior]) < 1.0


def test_jacobi_relaxes_toward_linear_ramp():
    """Two pinned seeds on a narrow strip: enough sweeps approach the
    linear (harmonic) interpolant between them, not a frozen step."""
    sup = np.array([[2, 1, 0], [18, 1, 16]])
    dense, filled = densify_supports(sup, (3, 21), num_iters=2000,
                                     method="jacobi")
    assert filled.all()
    line = dense[1, 2:19]
    want = np.linspace(0, 16, 17)
    assert np.abs(line - want).max() < 1.5
    # strictly increasing along the seed line (no plateau/step artifact)
    assert (np.diff(line) > 0).all()


def test_densify_from_masked_equals_host_path():
    """Device-resident masked consumer == decode-then-densify, bit for bit
    (VERDICT r3 item 6: the match.py claim, proved)."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.densify import densify_from_masked, densify_supports
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch_masked,
                                   masked_supports_to_numpy)
    from opengpc_tpu.utils.scenes import make_scene

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1 << 16)
    left, right, _, _ = make_scene(np.random.default_rng(31), 160, 320)
    buf, counts = build_sparsematch_masked(forest, settings)(left, right)
    supp = masked_supports_to_numpy(buf, counts, settings.disp_high)
    assert len(supp) > 500
    want_d, want_f = densify_supports(supp, left.shape, num_iters=24)
    got_d, got_f = densify_from_masked(buf, counts, settings.disp_high,
                                       num_iters=24)
    np.testing.assert_array_equal(np.asarray(got_f), want_f)
    np.testing.assert_array_equal(np.asarray(got_d), want_d)
    # both seeding implementations are bit-identical (sort-merge is the
    # production path; scatter is the measured-slow reference)
    from opengpc_tpu.densify import _densify_from_masked

    sc_d, sc_f = _densify_from_masked(buf, settings.disp_high, 24,
                                      seed_impl="scatter")
    np.testing.assert_array_equal(np.asarray(sc_f), want_f)
    np.testing.assert_array_equal(np.asarray(sc_d), want_d)


def test_multigrid_fills_wide_hole_exactly_constant():
    """VERDICT r4 #4 'done' criterion: a >=128-px hole.  Border-only
    seeds of constant value leave a 156x296 interior hole; the multigrid
    path must fill ALL of it (exactly, since diffusion of a constant is
    that constant), while the 64-sweep Jacobi provably cannot reach the
    center (fill radius == sweep count)."""
    h, w = 160, 300
    sup = ([(x, 0, 7) for x in range(w)] + [(x, h - 1, 7) for x in range(w)]
           + [(0, y, 7) for y in range(h)] + [(w - 1, y, 7) for y in range(h)])
    sup = np.array(sup)
    dense, filled = densify_supports(sup, (h, w))
    assert filled.all()
    np.testing.assert_allclose(dense, 7.0, atol=1e-4)
    _, fj = densify_supports(sup, (h, w), method="jacobi")  # 64 sweeps
    assert not fj.all(), "jacobi reached the hole center in 64 sweeps?!"


def test_multigrid_bounded_diff_vs_converged_jacobi():
    """Bounded-diff contract on a smooth field: seeds pin a 0..W-1 linear
    ramp at the left/right columns (the harmonic solution IS the ramp);
    the multigrid result must stay within a few disparity units of the
    converged interpolant at the default sweeps-per-level."""
    h, w = 48, 160
    sup = np.array([(0, y, 0) for y in range(h)]
                   + [(w - 1, y, w - 1) for y in range(h)])
    dm, fm = densify_supports(sup, (h, w))
    assert fm.all()
    ramp = np.broadcast_to(np.arange(w, dtype=np.float32), (h, w))
    err = np.abs(dm - ramp)
    # default 10 sweeps/level measured max 5.1 on this scene (3.2% of the
    # 159-unit range); gate with headroom against regressions
    assert err.max() < 8.0, err.max()
    assert err.mean() < 5.0, err.mean()
    # and the knob tightens it: 24 sweeps/level roughly halves the error
    d24, _ = densify_supports(sup, (h, w), num_iters=24)
    assert np.abs(d24 - ramp).max() < err.max()


def test_multigrid_pins_seeds_and_stays_in_range():
    rng = np.random.default_rng(9)
    h, w = 64, 96
    n = 40
    xs = rng.integers(0, w, n)
    ys = rng.integers(0, h, n)
    ds = rng.integers(-20, 21, n)
    sup = np.stack([xs, ys, ds], axis=1)
    dense, filled = densify_supports(sup, (h, w))
    assert filled.all()
    # convex averaging: interpolant bounded by the seed range
    assert dense.min() >= ds.min() - 1e-3 and dense.max() <= ds.max() + 1e-3
    # seeds pinned exactly (last-write for duplicate (x, y) is a set; use
    # unique locations only)
    seen = {}
    for x, y, d in sup.tolist():
        seen.setdefault((x, y), []).append(d)
    for (x, y), vals in seen.items():
        if len(vals) == 1:
            assert dense[y, x] == float(vals[0])


def test_multigrid_odd_prime_shapes():
    """Odd/prime dims hit the restriction's (h%2, w%2) zero-padding at
    every level and the upsample's [:h, :w] crop — the two places an
    off-by-one would silently shift the grid (densify.py
    _diffuse_multigrid).  Zero-count pad cells are "unknown", so the
    interpolant must stay seed-pinned, range-bounded, and fully filled
    exactly as on even shapes."""
    rng = np.random.default_rng(31)
    for h, w in ((77, 131), (53, 9), (7, 257)):
        n = max(6, (h * w) // 200)
        xs = rng.integers(0, w, n)
        ys = rng.integers(0, h, n)
        ds = rng.integers(-20, 21, n)
        sup = np.stack([xs, ys, ds], axis=1)
        dense, filled = densify_supports(sup, (h, w))
        assert dense.shape == (h, w) and filled.shape == (h, w)
        assert filled.all(), (h, w)
        assert dense.min() >= ds.min() - 1e-3, (h, w)
        assert dense.max() <= ds.max() + 1e-3, (h, w)
        seen = {}
        for x, y, d in sup.tolist():
            seen.setdefault((x, y), []).append(d)
        for (x, y), vals in seen.items():
            if len(vals) == 1:
                assert dense[y, x] == float(vals[0]), (h, w, x, y)

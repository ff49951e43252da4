"""Multi-scale pyramid matching tests."""

import os

import numpy as np

from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.forest import load_forest
from opengpc_tpu.infer import build_sparsematch, supports_to_numpy
from opengpc_tpu.pyramid import (
    build_pyramid_sparsematch,
    downscale2,
    pyramid_supports_to_numpy,
)

FORESTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "forests"
)


def make_pair(h, w, d, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w + d)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                + np.roll(base, 1, 1) + np.roll(base, -1, 1) + base) / 5
    scene = base.astype(np.uint8)
    return scene[:, :w].copy(), scene[:, d:].copy()


def test_downscale2_exact():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (10, 14)).astype(np.uint8)
    got = np.asarray(downscale2(img))
    x = img.astype(int)
    want = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) // 4
    np.testing.assert_array_equal(got, want[:5, :7])


def test_pyramid_level0_equals_plain_matcher():
    left, right = make_pair(96, 160, 4, seed=1)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, capacity=8192)
    plain = build_sparsematch(forest, settings)
    pyr = build_pyramid_sparsematch(forest, settings, num_levels=2)
    want = set(map(tuple, supports_to_numpy(*plain(left, right)).tolist()))
    rows = pyramid_supports_to_numpy(*pyr(left, right))
    got0 = set(map(tuple, rows[rows[:, 3] == 0][:, :3].tolist()))
    assert got0 == want


def test_pyramid_coarse_levels_scale_back():
    """True disparity 8: level 1 sees d=4, scaled back to 8."""
    left, right = make_pair(128, 256, 8, seed=2)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, capacity=8192)
    pyr = build_pyramid_sparsematch(forest, settings, num_levels=3)
    rows = pyramid_supports_to_numpy(*pyr(left, right))
    for level in (0, 1):
        sel = rows[rows[:, 3] == level]
        assert len(sel) > 20, f"level {level} produced too few supports"
        acc = (sel[:, 2] == 8).mean()
        assert acc > 0.95, f"level {level} disparity accuracy {acc}"


def test_pyramid_dedup_finest_wins():
    """Default merge policy: at most one support per (x, y); level-0
    supports are never overridden by coarser levels (VERDICT r1 item 7)."""
    left, right = make_pair(128, 256, 8, seed=2)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    # capacity >= level-0 pixels: the dedup=False comparison path trims at
    # capacity while the dedup=True row-form fast path is lossless; a
    # lossy raw baseline would make the subset checks vacuous
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, capacity=65536)
    raw = build_pyramid_sparsematch(forest, settings, num_levels=3, dedup=False)
    deduped = build_pyramid_sparsematch(forest, settings, num_levels=3, dedup=True)
    rows_raw = pyramid_supports_to_numpy(*raw(left, right))
    rows = pyramid_supports_to_numpy(*deduped(left, right))

    # the scene actually produces cross-level (x, y) conflicts
    key_raw = rows_raw[:, 1].astype(np.int64) * 256 + rows_raw[:, 0]
    assert len(np.unique(key_raw)) < len(key_raw), "fixture has no conflicts"

    # dedup: unique pixels, and each survivor is the min level of its pixel
    key = rows[:, 1].astype(np.int64) * 256 + rows[:, 0]
    assert len(np.unique(key)) == len(key)
    min_level = {}
    for x, y, d, lv in rows_raw:
        k = int(y) * 256 + int(x)
        min_level[k] = min(min_level.get(k, 99), int(lv))
    for x, y, d, lv in rows:
        assert int(lv) == min_level[int(y) * 256 + int(x)]

    # every level-0 support survives verbatim
    lv0_raw = set(map(tuple, rows_raw[rows_raw[:, 3] == 0].tolist()))
    lv0 = set(map(tuple, rows[rows[:, 3] == 0].tolist()))
    assert lv0 == lv0_raw

    # per-level counts reflect the post-dedup emission
    _, _, _, lv_b, counts = deduped(left, right)
    for level in range(3):
        assert int(counts[level]) == int((np.asarray(lv_b) == level).sum())


def test_pyramid_batched():
    left, right = make_pair(64, 128, 2, seed=3)
    lefts = np.stack([left, left])
    rights = np.stack([right, right])
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 capacity=4096)
    pyr = build_pyramid_sparsematch(forest, settings, num_levels=2)
    xs, ys, ds, lv, counts = pyr(lefts, rights)
    assert counts.shape == (2, 2)
    a = pyramid_supports_to_numpy(xs[0], ys[0], ds[0], lv[0], counts[0])
    b = pyramid_supports_to_numpy(xs[1], ys[1], ds[1], lv[1], counts[1])
    np.testing.assert_array_equal(a, b)


def test_pyramid_batched_fold_equals_per_pair():
    """The batched rows-pyramid FOLD (per-level (B*hs, 2W_l) row sorts +
    one (B, K) dedup sort, VERDICT r4 #2a) must reproduce each pair's
    single-pair pyramid support set exactly — distinct scenes with
    distinct disparities so cross-pair leakage cannot hide."""
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, capacity=65536)
    pyr = build_pyramid_sparsematch(forest, settings, num_levels=3)
    pairs = [make_pair(96, 160, 2 + 3 * b, seed=20 + b) for b in range(3)]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    out = pyr(lefts, rights)
    for b, (l, r) in enumerate(pairs):
        single = pyr(l, r)
        want = set(map(tuple, pyramid_supports_to_numpy(*single).tolist()))
        got = set(map(tuple, pyramid_supports_to_numpy(
            *(np.asarray(o)[b] for o in out)).tolist()))
        assert got == want, (b, len(got), len(want))
        np.testing.assert_array_equal(np.asarray(out[4])[b],
                                      np.asarray(single[4]))


def test_pyramid_batched_fold_ineligible_falls_back():
    """Non-packable settings (global mode) must keep the lax.map path and
    still agree per pair."""
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=False,
                                 vertical_tolerance=1, capacity=8192)
    pyr = build_pyramid_sparsematch(forest, settings, num_levels=2)
    l0, r0 = make_pair(64, 96, 3, seed=31)
    l1, r1 = make_pair(64, 96, 5, seed=32)
    out = pyr(np.stack([l0, l1]), np.stack([r0, r1]))
    for b, (l, r) in enumerate([(l0, r0), (l1, r1)]):
        want = set(map(tuple,
                       pyramid_supports_to_numpy(*pyr(l, r)).tolist()))
        got = set(map(tuple, pyramid_supports_to_numpy(
            *(np.asarray(o)[b] for o in out)).tolist()))
        assert got == want


def test_pyramid_compact_equals_rows_sparse():
    """Chunk-compacted pyramid (r4 adoption, experiments/exp_pyr.py):
    identical support set to the rows pyramid on a realistic-density
    scene, overflow False."""
    from opengpc_tpu.pyramid import build_pyramid_sparsematch_compact
    from opengpc_tpu.utils.scenes import make_sparse_pair

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1 << 16)
    left, right = make_sparse_pair(120, 256, 8, density=0.15)
    rows = build_pyramid_sparsematch(forest, settings, num_levels=3)
    comp = build_pyramid_sparsematch_compact(forest, settings, num_levels=3)
    out = comp(left, right)
    assert not bool(np.asarray(out[-1])), "sparse scene must not overflow"
    got = pyramid_supports_to_numpy(*out[:-1])
    want = pyramid_supports_to_numpy(*rows(left, right))
    assert got.shape[0] > 0
    assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))


def test_pyramid_compact_overflow_and_eligibility():
    from opengpc_tpu.pyramid import build_pyramid_sparsematch_compact

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1 << 16)
    # ~79%-dense texture: >k candidates per chunk, flag MUST trip
    left, right = make_pair(120, 256, 8, seed=1)
    comp = build_pyramid_sparsematch_compact(forest, settings, num_levels=2)
    assert bool(np.asarray(comp(left, right)[-1]))

    # non-epipolar settings are ineligible (trace-time ValueError)
    bad = build_pyramid_sparsematch_compact(
        forest, InferenceSettings(epipolar_mode=False, disp_high=32))
    try:
        bad(left, right)
        assert False, "expected ValueError"
    except ValueError as e:
        assert "compact pyramid" in str(e)


def test_pyramid_compact_batched_fold_equals_per_pair():
    """Batched compact pyramid HYBRID fold (r5): per-pair decoded sets
    equal single-pair compact runs on sparse scenes; overflow flags are
    PER PAIR (B,) — the fold attributes each row's chunk overflow back
    to its pair, so a dense pair flags without tainting its neighbors."""
    from opengpc_tpu.pyramid import build_pyramid_sparsematch_compact
    from opengpc_tpu.utils.scenes import make_sparse_pair

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, capacity=65536,
                                 disp_high=32)
    comp = build_pyramid_sparsematch_compact(forest, settings,
                                             num_levels=2)
    pairs = [make_sparse_pair(96, 160, 3 + b, density=0.15, seed=40 + b)
             for b in range(3)]
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    out = comp(lb, rb)
    assert np.asarray(out[-1]).shape == (3,)  # per-pair flags
    assert not np.asarray(out[-1]).any()
    for b, (l, r) in enumerate(pairs):
        single = comp(l, r)
        assert not bool(np.asarray(single[-1]))
        want = set(map(tuple,
                       pyramid_supports_to_numpy(*single[:-1]).tolist()))
        got = set(map(tuple, pyramid_supports_to_numpy(
            *(np.asarray(o)[b] for o in out[:-1])).tolist()))
        assert got == want and len(want) > 50, b
    # a dense pair in the stack flags ITSELF and only itself, and the
    # sparse neighbor's outputs stay exact next to it
    dl, dr = make_pair(96, 160, 3, seed=77)
    out2 = comp(np.stack([pairs[0][0], dl]), np.stack([pairs[0][1], dr]))
    ovf2 = np.asarray(out2[-1])
    assert not bool(ovf2[0]) and bool(ovf2[1]), ovf2
    single0 = comp(*pairs[0])
    want0 = set(map(tuple,
                    pyramid_supports_to_numpy(*single0[:-1]).tolist()))
    got0 = set(map(tuple, pyramid_supports_to_numpy(
        *(np.asarray(o)[0] for o in out2[:-1])).tolist()))
    assert got0 == want0


def test_cli_pyramid_masked_compact(tmp_path, capsys):
    """--pyramid N --contract masked-compact: sparse frame rides the
    compact pyramid; dense frame takes the rows-pyramid overflow
    fallback; outputs match plain --pyramid runs either way."""
    import sys

    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.utils.scenes import make_sparse_pair

    forest_path = os.path.join(FORESTS, "defaultZeroForest.txt")
    scenes = {
        "sparse": make_sparse_pair(120, 256, 8, density=0.15),
        "dense": make_pair(120, 256, 8, seed=1),
    }
    for name, (left, right) in scenes.items():
        lp = str(tmp_path / f"{name}_l.png")
        rp = str(tmp_path / f"{name}_r.png")
        write_png(lp, left)
        write_png(rp, right)
        outs = {}
        for label, extra in (("compact", ["--contract", "masked-compact"]),
                             ("plain", [])):
            op = str(tmp_path / f"{name}_{label}.png")
            sp = str(tmp_path / f"{name}_{label}.txt")
            rc = cli_main([forest_path, lp, rp, "--out", op,
                           "--pyramid", "2", "--disp-high", "32",
                           "--supports-out", sp] + extra)
            err = capsys.readouterr().err
            assert rc == 0, (name, label)
            if label == "plain" and name == "sparse":
                # auto single-pair pyramid is density-adaptive too (r5)
                assert "chunk-compacted pyramid" in err, err
            if label == "plain" and name == "dense":
                assert "chunk-compacted pyramid" not in err, err
            with open(sp) as f:
                outs[label] = sorted(f.read().splitlines())
        assert outs["compact"] == outs["plain"], name

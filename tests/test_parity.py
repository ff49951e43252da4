"""Pixel-for-pixel parity of the JAX pipeline against the native CPU oracle.

The oracle (cpp/oracle.cc) implements the scalar contract semantics of the
reference (SURVEY.md §7); every op and the full sparse-match path must agree
exactly.
"""

import os
import subprocess

import numpy as np
import pytest

from opengpc_tpu import forest as forest_mod
from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.infer import build_sparsematch, supports_to_numpy
from opengpc_tpu.io.raw import read_raw, write_raw
from opengpc_tpu.ops.census import census5x5
from opengpc_tpu.ops.codes import leaf_codes
from opengpc_tpu.ops.preprocess import box3, candidate_mask, sobel3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORESTS = os.path.join(REPO, "forests")


def run_oracle(oracle_path, *args):
    subprocess.run([oracle_path] + [str(a) for a in args], check=True)


def random_image(rng, h, w, smooth_scale=4):
    """Random image with spatial structure (pure noise has no stable edges)."""
    small = rng.integers(0, 256, size=(h // smooth_scale + 2, w // smooth_scale + 2))
    img = np.kron(small, np.ones((smooth_scale, smooth_scale)))[:h, :w]
    noise = rng.integers(-12, 13, size=(h, w))
    return np.clip(img + noise, 0, 255).astype(np.uint8)


@pytest.fixture(params=[(48, 64), (61, 97), (128, 160)])
def image(request):
    rng = np.random.default_rng(sum(request.param))
    return random_image(rng, *request.param)


def test_box_parity(image, oracle_path, tmp_path):
    inp, out = str(tmp_path / "in.raw"), str(tmp_path / "out.raw")
    write_raw(inp, image)
    run_oracle(oracle_path, "box", inp, out)
    want = read_raw(out)
    got = np.asarray(box3(image))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("threshold", [5, 10, 40])
def test_sobel_parity(image, oracle_path, tmp_path, threshold):
    inp, out = str(tmp_path / "in.raw"), str(tmp_path / "out.raw")
    write_raw(inp, image)
    run_oracle(oracle_path, "sobel", inp, out, threshold)
    want = read_raw(out)
    got = np.asarray(sobel3(image, threshold))
    np.testing.assert_array_equal(got, want)


def test_census_parity(image, oracle_path, tmp_path):
    inp, out = str(tmp_path / "in.raw"), str(tmp_path / "out.raw")
    write_raw(inp, image)
    run_oracle(oracle_path, "census", inp, out)
    want = read_raw(out)
    got = np.asarray(census5x5(image)).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "forest_file", ["defaultZeroForest.txt", "defaultTauForest.txt"]
)
def test_codes_parity(image, oracle_path, tmp_path, forest_file):
    forest = forest_mod.load_forest(os.path.join(FORESTS, forest_file))
    mask = forest_mod.make_filter_mask(forest)

    smooth = np.asarray(box3(image))
    grad = np.asarray(sobel3(image, 10))
    sm_p, gr_p, out = (str(tmp_path / n) for n in ("s.raw", "g.raw", "c.raw"))
    write_raw(sm_p, smooth)
    write_raw(gr_p, grad)
    run_oracle(oracle_path, "codes", sm_p, gr_p, os.path.join(FORESTS, forest_file), out)
    want = read_raw(out)  # uint32, nonzero only at candidates

    codes = np.asarray(leaf_codes(smooth, mask)).astype(np.uint32)
    cand = np.asarray(candidate_mask(grad))
    np.testing.assert_array_equal(np.where(cand, codes, 0), np.where(cand, want, 0))
    assert cand.sum() > 0, "test image produced no candidates"


def _oracle_supports(oracle_path, tmp_path, forest_path, left, right, s, epipolar):
    lp, rp, out = (str(tmp_path / n) for n in ("l.raw", "r.raw", "supp.txt"))
    write_raw(lp, left)
    write_raw(rp, right)
    run_oracle(
        oracle_path, "sparsematch", forest_path, lp, rp, out,
        s.gradient_threshold, s.vertical_tolerance, s.disp_high,
        1 if epipolar else 0, 0,
    )
    with open(out) as f:
        rows = [tuple(int(v) for v in line.split()) for line in f if line.strip()]
    return set(rows)


@pytest.mark.parametrize("epipolar", [True, False])
@pytest.mark.parametrize(
    "forest_file", ["defaultZeroForest.txt", "defaultTauForest.txt"]
)
def test_sparsematch_parity(oracle_path, tmp_path, forest_file, epipolar):
    rng = np.random.default_rng(7)
    h, w = 96, 128
    left = random_image(rng, h, w)
    # right = left shifted a few px -> plenty of real collisions
    shift = 3
    right = np.roll(left, -shift, axis=1)
    right[:, -shift:] = rng.integers(0, 256, size=(h, shift)).astype(np.uint8)

    forest_path = os.path.join(FORESTS, forest_file)
    settings = InferenceSettings(
        gradient_threshold=5, disp_high=128,
        vertical_tolerance=1, epipolar_mode=epipolar, capacity=65536,
    )
    want = _oracle_supports(
        oracle_path, tmp_path, forest_path, left, right, settings, epipolar
    )

    forest = forest_mod.load_forest(forest_path)
    match = build_sparsematch(forest, settings)
    xs, ys, ds, count = match(left, right)
    got_arr = supports_to_numpy(xs, ys, ds, count)
    got = set(map(tuple, got_arr.tolist()))

    assert int(count) == len(got_arr), "capacity overflow in test"
    assert got == want
    assert len(want) > 0, "oracle found no supports; test not meaningful"


def test_sparsematch_batched_vmap():
    """vmap over a batch axis gives the same supports per pair."""
    rng = np.random.default_rng(11)
    h, w = 64, 96
    lefts = np.stack([random_image(rng, h, w) for _ in range(3)])
    rights = np.stack([np.roll(l, -2, axis=1) for l in lefts])

    forest = forest_mod.load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, capacity=16384
    )
    match = build_sparsematch(forest, settings)

    bx, by, bd, bcount = match(lefts, rights)
    for k in range(3):
        xs, ys, ds, count = match(lefts[k], rights[k])
        single = set(map(tuple, supports_to_numpy(xs, ys, ds, count).tolist()))
        batched = set(
            map(tuple, supports_to_numpy(bx[k], by[k], bd[k], bcount[k]).tolist())
        )
        assert single == batched


@pytest.mark.parametrize("num_tests", [31, 32])
@pytest.mark.parametrize("epipolar", [True, False])
def test_sparsematch_parity_wide_forest(oracle_path, tmp_path, num_tests,
                                        epipolar):
    """Forests beyond 30 tests: codes use the int32 MSB (negative values)
    and the matcher must take the unpacked sort path."""
    from opengpc_tpu.forest import Fern, Forest, SCALE_L, Test, save_forest

    rng = np.random.default_rng(num_tests)
    tests = tuple(
        Test(*(int(v) for v in rng.integers(-13, 14, size=4)),
             int(rng.integers(-10, 10)))
        for _ in range(num_tests)
    )
    forest = Forest((Fern(SCALE_L, tests),))
    forest_path = str(tmp_path / "wide.txt")
    save_forest(forest, forest_path)

    h, w = 80, 112
    left = random_image(rng, h, w)
    right = np.roll(left, -2, axis=1)
    right[:, -2:] = rng.integers(0, 256, size=(h, 2)).astype(np.uint8)

    settings = InferenceSettings(
        gradient_threshold=5, disp_high=64, vertical_tolerance=1,
        epipolar_mode=epipolar, capacity=32768,
    )
    want = _oracle_supports(
        oracle_path, tmp_path, forest_path, left, right, settings, epipolar
    )
    match = build_sparsematch(forest, settings)
    got = set(map(tuple, supports_to_numpy(*match(left, right)).tolist()))
    assert got == want
    assert len(want) > 0


def test_sparsematch_parity_fuzz(oracle_path, tmp_path):
    """Seeded settings/scene fuzz: random thresholds, tolerances, disparity
    caps, modes, forests, image shapes (incl. odd widths) and scene types —
    full-pipeline support sets must equal the oracle on every draw.  Widens
    parity coverage beyond the fixed combos above (the knobs interact:
    margin vs shape, vert_tol in global mode, |d| windows vs scene)."""
    from opengpc_tpu.utils.scenes import make_scene

    # deterministic in CI; OGPC_FUZZ_SEED / OGPC_FUZZ_TRIALS let a soak
    # run widen the sweep without changing the committed behavior
    seed = int(os.environ.get("OGPC_FUZZ_SEED", 2024))
    trials = int(os.environ.get("OGPC_FUZZ_TRIALS", 10))
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        h = int(rng.integers(40, 140))
        w = int(rng.integers(48, 200))
        grad_thresh = int(rng.integers(1, 41))
        vert_tol = int(rng.integers(0, 3))
        disp_high = int(rng.choice([8, 32, 64, 128]))
        epipolar = bool(rng.integers(0, 2))
        forest_file = str(rng.choice(
            ["defaultZeroForest.txt", "defaultTauForest.txt"]))
        if rng.integers(0, 2):
            left = random_image(rng, h, w)
            shift = int(rng.integers(1, 6))
            right = np.roll(left, -shift, axis=1)
            right[:, -shift:] = rng.integers(0, 256, (h, shift)).astype(np.uint8)
        else:
            left, right, _, _ = make_scene(rng, h, w)

        settings = InferenceSettings(
            gradient_threshold=grad_thresh, disp_high=disp_high,
            vertical_tolerance=vert_tol, epipolar_mode=epipolar,
            capacity=65536,
        )
        forest_path = os.path.join(FORESTS, forest_file)
        want = _oracle_supports(oracle_path, tmp_path, forest_path,
                                left, right, settings, epipolar)
        forest = forest_mod.load_forest(forest_path)
        match = build_sparsematch(forest, settings)
        got = set(map(tuple, supports_to_numpy(*match(left, right)).tolist()))
        ctx = (f"trial {trial}: {h}x{w} thr={grad_thresh} vt={vert_tol} "
               f"dh={disp_high} epi={epipolar} {forest_file}")
        assert got == want, ctx

        # the fast output contracts must carry the identical set on the
        # same draw (epipolar -> row-form incl. the stacked batch path;
        # global -> segmented global rows)
        if epipolar:
            from opengpc_tpu.infer import (_rows_ok, build_sparsematch_rows,
                                           row_supports_to_numpy)

            fmask = forest_mod.make_filter_mask(forest)
            if _rows_ok(fmask, left.shape, settings):
                rows = build_sparsematch_rows(forest, settings)
                (xs, ds), counts = rows(left, right)
                got_r = set(map(tuple, row_supports_to_numpy(
                    xs, ds, counts).tolist()))
                assert got_r == want, f"row-form {ctx}"
                lb = np.stack([left, left])
                rb = np.stack([right, right])
                (bxs, bds), bcounts = rows(lb, rb)
                got_b = set(map(tuple, row_supports_to_numpy(
                    bxs[1], bds[1], bcounts[1]).tolist()))
                assert got_b == want, f"stacked-batch {ctx}"

                from opengpc_tpu.infer import (build_sparsematch_masked,
                                               masked_supports_to_numpy)

                buf, counts = build_sparsematch_masked(
                    forest, settings)(left, right)
                got_m = set(map(tuple, masked_supports_to_numpy(
                    buf, counts, settings.disp_high).tolist()))
                assert got_m == want, f"masked {ctx}"

                from opengpc_tpu.infer import \
                    build_sparsematch_masked_compact

                cbuf, ccounts, ovf = build_sparsematch_masked_compact(
                    forest, settings)(left, right)
                if not bool(np.asarray(ovf)):
                    got_c = set(map(tuple, masked_supports_to_numpy(
                        cbuf, ccounts, settings.disp_high).tolist()))
                    assert got_c == want, f"masked-compact {ctx}"
        else:
            from opengpc_tpu.infer import (_global_rows_ok,
                                           build_sparsematch_global_rows,
                                           global_row_supports_to_numpy)

            fmask = forest_mod.make_filter_mask(forest)
            if _global_rows_ok(fmask, left.shape, settings):
                grows = build_sparsematch_global_rows(forest, settings)
                (xs, ys, ds), counts = grows(left, right)
                got_g = set(map(tuple, global_row_supports_to_numpy(
                    xs, ys, ds, counts).tolist()))
                assert got_g == want, f"global-rows {ctx}"

                from opengpc_tpu.infer import \
                    build_sparsematch_global_compact

                (cxs, cys, cds), ccounts, ovf = \
                    build_sparsematch_global_compact(
                        forest, settings,
                        chunk=128, k=64)(left, right)
                if not bool(np.asarray(ovf)):
                    got_gc = set(map(tuple, global_row_supports_to_numpy(
                        cxs, cys, cds, ccounts).tolist()))
                    assert got_gc == want, f"global-compact {ctx}"


def test_fast_contracts_minimal_interior():
    """Edge sizes around the interior-margin slice: h=28 leaves exactly two
    candidate rows, h=27 none at all — the fast contracts must stay
    set-equal to the flat pipeline (which never slices) at both."""
    import numpy as np

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch,
                                   build_sparsematch_masked,
                                   build_sparsematch_rows,
                                   masked_supports_to_numpy,
                                   row_supports_to_numpy, supports_to_numpy)

    rng = np.random.default_rng(11)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=16, epipolar_mode=True,
                                 capacity=2048)
    for h in (27, 28, 30):
        left = random_image(rng, h, 64)
        right = np.roll(left, -3, axis=1)
        flat = build_sparsematch(forest, settings)
        want = set(map(tuple,
                       supports_to_numpy(*flat(left, right)).tolist()))
        buf, counts = build_sparsematch_masked(
            forest, settings)(left, right)
        got_m = set(map(tuple, masked_supports_to_numpy(
            buf, counts, settings.disp_high).tolist()))
        assert got_m == want, f"masked h={h}"
        (xs, ds), rc = build_sparsematch_rows(
            forest, settings)(left, right)
        got_r = set(map(tuple,
                        row_supports_to_numpy(xs, ds, rc).tolist()))
        assert got_r == want, f"rows h={h}"
        if h == 28:
            assert len(want) > 0, "h=28 should still emit supports"


def test_sparsematch_adversarial_corners(oracle_path, tmp_path):
    """Degenerate/extreme settings vs the oracle: disp_high=0 (only d=0
    passes the filter), gradient_threshold=0 (everything textured is a
    candidate), images too narrow/short for ANY interior candidates, the
    minimal 29x29 interior, a large vertical tolerance in global mode, and
    capacity=1 truncation semantics (count reports the TRUE total)."""
    rng = np.random.default_rng(99)
    forest = forest_mod.load_forest(
        os.path.join(FORESTS, "defaultZeroForest.txt"))
    forest_path = os.path.join(FORESTS, "defaultZeroForest.txt")
    cases = [
        dict(h=60, w=90, grad=5, vt=0, dh=0, epi=True),
        dict(h=60, w=90, grad=0, vt=0, dh=16, epi=True),
        dict(h=60, w=20, grad=5, vt=0, dh=16, epi=True),
        dict(h=8, w=90, grad=5, vt=0, dh=16, epi=True),
        dict(h=60, w=90, grad=5, vt=4, dh=8, epi=False),
        dict(h=29, w=29, grad=1, vt=0, dh=128, epi=True),
    ]
    saw_nonempty = False
    for i, c in enumerate(cases):
        left = random_image(rng, c["h"], c["w"])
        right = np.roll(left, -3, axis=1)
        s = InferenceSettings(
            gradient_threshold=c["grad"], vertical_tolerance=c["vt"],
            disp_high=c["dh"], epipolar_mode=c["epi"], capacity=65536)
        sub = tmp_path / f"case{i}"
        sub.mkdir()
        want = _oracle_supports(oracle_path, sub, forest_path, left, right,
                                s, c["epi"])
        m = build_sparsematch(forest, s)
        got = set(map(tuple, supports_to_numpy(*m(left, right)).tolist()))
        assert got == want, (c, len(got), len(want))
        saw_nonempty = saw_nonempty or len(want) > 0
        # the fast contracts must agree on the same degenerate draw
        from opengpc_tpu.infer import (_rows_ok, build_sparsematch_masked,
                                       masked_supports_to_numpy)

        fmask = forest_mod.make_filter_mask(forest)
        if c["epi"] and _rows_ok(fmask, left.shape, s):
            buf, counts = build_sparsematch_masked(
                forest, s)(left, right)
            got_m = set(map(tuple, masked_supports_to_numpy(
                buf, counts, s.disp_high).tolist()))
            assert got_m == want, (c, "masked")
    assert saw_nonempty  # at least threshold=0 / global-vt cases match

    # capacity=1: truncated buffers, true count
    left = random_image(rng, 60, 90)
    right = np.roll(left, -3, axis=1)
    s = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                          disp_high=16, epipolar_mode=True, capacity=1)
    sub = tmp_path / "cap1"
    sub.mkdir()
    s_full = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                               disp_high=16, epipolar_mode=True,
                               capacity=65536)
    want = _oracle_supports(oracle_path, sub, forest_path, left, right,
                            s_full, True)
    xs, ys, ds, count = build_sparsematch(forest, s)(
        left, right)
    assert int(count) == len(want) > 1
    got = supports_to_numpy(xs, ys, ds, count)
    assert len(got) == 1 and tuple(got[0].tolist()) in want


def test_sparsematch_parity_random_forest_fuzz(oracle_path, tmp_path):
    """Random-FOREST fuzz (r4): the committed fuzz above draws scenes and
    settings but always uses the two pretrained forests — this draws the
    forest itself: 1-4 ferns, random scales, offsets spanning each scale's
    half-width, zero and tau types, and total test counts crossing BOTH
    routing boundaries (>30 tests falls off the sentinel-packed fast
    contracts onto the flat matcher; >32 exercises the file-order cap of
    the reference filter mask, inference.hpp:420-424).  Support sets must
    equal the oracle on every draw; eligible draws also pin the masked
    contract."""
    from opengpc_tpu.forest import make_filter_mask, save_forest
    from opengpc_tpu.infer import (_rows_ok, build_sparsematch_masked,
                                   masked_supports_to_numpy)
    from opengpc_tpu.utils.fuzz import random_forest
    from opengpc_tpu.utils.scenes import make_scene

    seed = int(os.environ.get("OGPC_FUZZ_SEED", 4096))
    trials = int(os.environ.get("OGPC_FUZZ_TRIALS", 8))
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        forest = random_forest(rng)
        zero = forest.is_zero
        n_ferns = len(forest.ferns)
        n_total = sum(len(f.tests) for f in forest.ferns)
        forest_path = str(tmp_path / f"rf{trial}.txt")
        save_forest(forest, forest_path)

        h = int(rng.integers(48, 120))
        w = int(rng.integers(56, 160))
        epipolar = bool(rng.integers(0, 2))
        settings = InferenceSettings(
            gradient_threshold=int(rng.integers(1, 30)),
            disp_high=int(rng.choice([16, 64, 128])),
            vertical_tolerance=int(rng.integers(0, 3)),
            epipolar_mode=epipolar, capacity=65536,
        )
        left, right, _, _ = make_scene(rng, h, w)
        want = _oracle_supports(oracle_path, tmp_path, forest_path,
                                left, right, settings, epipolar)
        match = build_sparsematch(forest, settings)
        got = set(map(tuple, supports_to_numpy(*match(left, right)).tolist()))
        ctx = (f"trial {trial}: {n_ferns} ferns/{n_total} tests "
               f"zero={zero} {h}x{w} epi={epipolar}")
        assert got == want, ctx

        fmask = make_filter_mask(forest)
        if _rows_ok(fmask, left.shape, settings):
            buf, counts = build_sparsematch_masked(
                forest, settings)(left, right)
            got_m = set(map(tuple, masked_supports_to_numpy(
                buf, counts, settings.disp_high).tolist()))
            assert got_m == want, f"masked {ctx}"

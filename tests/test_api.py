"""Correspondence/descriptor API surfaces and metrics."""

import os

import numpy as np
import pytest

from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.forest import load_forest
from opengpc_tpu.infer import (
    build_sparsematch,
    build_stereomatch,
    extract_descriptors,
    supports_to_numpy,
)
from opengpc_tpu.metrics import support_pr_vs_reference, support_precision

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


def test_stereomatch_correspondences():
    left, right = make_pair(80, 128, 6, seed=1)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, capacity=8192)
    match = build_stereomatch(forest, settings)
    sx, sy, tx, ty, count = match(left, right)
    n = int(count)
    assert n > 50
    sx, sy, tx, ty = (np.asarray(a)[:n] for a in (sx, sy, tx, ty))
    # true correspondence: same row, tar x = src x - 6
    assert (sy == ty).mean() > 0.95
    assert ((sx - tx) == 6).mean() > 0.95


def test_stereomatch_consistent_with_sparsematch():
    """Global sparsematch == stereomatch + rectified filter."""
    left, right = make_pair(64, 96, 3, seed=2)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=False, disp_high=32,
        vertical_tolerance=1, capacity=8192,
    )
    sparse = build_sparsematch(forest, settings)
    stereo = build_stereomatch(forest, settings)
    want = set(map(tuple, supports_to_numpy(*sparse(left, right)).tolist()))
    sx, sy, tx, ty, count = stereo(left, right)
    n = int(count)
    got = set()
    for i in range(n):
        dx = int(sx[i]) - int(tx[i])
        if abs(int(sy[i]) - int(ty[i])) <= 1 and abs(dx) <= 32:
            got.add((int(sx[i]), int(sy[i]), dx))
    assert got == want


def test_extract_descriptors():
    left, _ = make_pair(64, 96, 3, seed=3)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5)
    desc = extract_descriptors(left, forest, settings)
    assert desc.shape[1] == 3
    assert len(desc) > 20
    # candidates respect the margin
    assert (desc[:, 0] >= 13).all() and (desc[:, 1] >= 13).all()
    # scan order: rows ascending
    assert (np.diff(desc[:, 1]) >= 0).all()


def test_support_precision_metric():
    gt = np.full((50, 60), 7.0)
    sup = np.array([[20, 20, 7], [30, 30, 7], [40, 40, 3]])
    prec, n = support_precision(sup, gt, tol=1.0)
    assert n == 3 and abs(prec - 2 / 3) < 1e-9
    valid = np.ones((50, 60), bool)
    valid[40, 40] = False
    prec, n = support_precision(sup, gt, valid, tol=1.0)
    assert n == 2 and prec == 1.0


def test_support_pr_vs_reference_metric():
    a = np.array([[1, 2, 3], [4, 5, 6]])
    b = np.array([[1, 2, 3], [7, 8, 9], [10, 11, 12]])
    prec, rec = support_pr_vs_reference(a, b)
    assert abs(prec - 0.5) < 1e-9 and abs(rec - 1 / 3) < 1e-9


def test_match_reference_quirk_vs_oracle(oracle_path, tmp_path):
    """Host quirk matcher reproduces the oracle's quirk-mode supports."""
    import subprocess

    from opengpc_tpu.io.raw import write_raw
    from opengpc_tpu.match import match_reference_quirk

    rng = np.random.default_rng(5)
    h, w = 72, 104
    left, right = make_pair(h, w, 4, seed=5)
    forest_path = os.path.join(FORESTS, "defaultZeroForest.txt")
    settings = InferenceSettings(gradient_threshold=5, disp_high=64,
                                 vertical_tolerance=1, capacity=16384)

    lp, rp, op = (str(tmp_path / n) for n in ("l.raw", "r.raw", "o.txt"))
    write_raw(lp, left)
    write_raw(rp, right)
    subprocess.run(
        [oracle_path, "sparsematch", forest_path, lp, rp, op,
         "5", "1", "64", "1", "1"],  # epipolar, QUIRK mode
        check=True,
    )
    with open(op) as f:
        want = set(tuple(int(v) for v in line.split()) for line in f
                   if line.strip())

    forest = load_forest(forest_path)
    dl = extract_descriptors(left, forest, settings)
    dr = extract_descriptors(right, forest, settings)
    corr = match_reference_quirk(dl, dr, epipolar=True)
    got = set()
    for sx, sy, tx, ty in corr:
        if abs(int(sy) - int(ty)) <= 1 and abs(int(sx) - int(tx)) <= 64:
            got.add((int(sx), int(sy), int(sx) - int(tx)))
    assert got == want and len(want) > 0


def test_row_form_equals_flat_pipeline():
    """Row-form matcher (maximum-throughput contract) emits exactly the
    flat pipeline's support set, in the same (y, x) order, single and
    batched."""
    from opengpc_tpu.infer import (build_sparsematch, build_sparsematch_rows,
                                   row_supports_to_numpy, supports_to_numpy)

    left, right = make_pair(96, 160, 5, seed=9)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, capacity=16384)
    flat = build_sparsematch(forest, settings)
    rows = build_sparsematch_rows(forest, settings)
    want = supports_to_numpy(*flat(left, right))
    (xs, ds), counts = rows(left, right)
    got = row_supports_to_numpy(xs, ds, counts)
    assert len(want) > 100
    np.testing.assert_array_equal(
        got[np.lexsort((got[:, 0], got[:, 1]))],
        want[np.lexsort((want[:, 0], want[:, 1]))],
    )
    # batch path
    lb = np.stack([left, left])
    rb = np.stack([right, right])
    (xs_b, ds_b), counts_b = rows(lb, rb)
    a = row_supports_to_numpy(xs_b[0], ds_b[0], counts_b[0])
    b = row_supports_to_numpy(xs_b[1], ds_b[1], counts_b[1])
    np.testing.assert_array_equal(a, b)
    assert len(a) == len(got)


def test_row_form_rejects_unsupported_modes():
    from opengpc_tpu.infer import build_sparsematch_rows, row_supports_to_numpy

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    left, right = make_pair(48, 64, 2, seed=1)
    rows = build_sparsematch_rows(
        forest, InferenceSettings(epipolar_mode=False)
    )
    with pytest.raises(ValueError, match="epipolar"):
        rows(left, right)
    with pytest.raises(ValueError, match="batch"):
        row_supports_to_numpy(
            np.zeros((2, 4, 8), np.int32), np.zeros((2, 4, 8), np.int32),
            np.zeros((2, 4), np.int32),
        )


def test_match_hashmatch_pipeline_vs_oracle(oracle_path, tmp_path):
    """Full pipeline (device descriptors -> host hashmatch -> rectified
    filter) reproduces the oracle's useHashtable-mode supports, in order."""
    import subprocess

    from opengpc_tpu.io.raw import write_raw
    from opengpc_tpu.match import match_hashmatch

    left, right = make_pair(72, 104, 4, seed=5)
    forest_path = os.path.join(FORESTS, "defaultZeroForest.txt")
    settings = InferenceSettings(gradient_threshold=5, disp_high=64,
                                 vertical_tolerance=1, capacity=16384)

    lp, rp, op = (str(tmp_path / n) for n in ("l.raw", "r.raw", "o.txt"))
    write_raw(lp, left)
    write_raw(rp, right)
    subprocess.run(
        [oracle_path, "sparsematch", forest_path, lp, rp, op,
         "5", "1", "64", "1", "2"],  # epipolar, HASHMATCH mode
        check=True,
    )
    with open(op) as f:
        want = [tuple(int(v) for v in line.split()) for line in f
                if line.strip()]

    forest = load_forest(forest_path)
    dl = extract_descriptors(left, forest, settings)
    dr = extract_descriptors(right, forest, settings)
    corr = match_hashmatch(dl, dr, epipolar=True)
    got = [
        (int(sx), int(sy), int(sx) - int(tx))
        for sx, sy, tx, ty in corr
        if abs(int(sy) - int(ty)) <= 1 and abs(int(sx) - int(tx)) <= 64
    ]
    assert got == want and len(want) > 0


def test_batched_rows_stacked_equals_per_pair():
    """The stacked batched row-form path (ONE (B*H, 2W) segmented sort,
    infer._sparsematch_rows_batched_impl) must equal B independent
    single-pair row-form runs exactly — different scene per batch
    element."""
    from opengpc_tpu.infer import build_sparsematch_rows, row_supports_to_numpy

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, disp_high=64,
                                 capacity=16384)
    pairs = [make_pair(80, 144, d, seed=30 + d) for d in (3, 7, 11)]
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    rows = build_sparsematch_rows(forest, settings)
    (xs_b, ds_b), counts_b = rows(lb, rb)
    assert xs_b.shape == lb.shape and counts_b.shape == lb.shape[:2]
    for k in range(len(pairs)):
        (xs, ds), counts = rows(pairs[k][0], pairs[k][1])
        want = row_supports_to_numpy(xs, ds, counts)
        got = row_supports_to_numpy(xs_b[k], ds_b[k], counts_b[k])
        assert len(want) > 100
        np.testing.assert_array_equal(got, want)


def test_global_rows_equals_flat_global():
    """Segmented global row-form contract (match.match_global_rows) emits
    exactly the flat global pipeline's support set,
    across vertical tolerances and on a multi-plane scene."""
    from opengpc_tpu.infer import (build_sparsematch,
                                   build_sparsematch_global_rows,
                                   global_row_supports_to_numpy)
    from opengpc_tpu.utils.scenes import make_scene

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    scenes = [make_pair(96, 160, 7, seed=1)]
    scenes.append(make_scene(np.random.default_rng(3), 144, 192)[:2])
    for vt, dh in ((0, 64), (2, 32)):
        settings = InferenceSettings(
            gradient_threshold=5, vertical_tolerance=vt, disp_high=dh,
            epipolar_mode=False, capacity=65536,
        )
        for left, right in scenes:
            flat = build_sparsematch(forest, settings)
            rows = build_sparsematch_global_rows(forest, settings)
            want = supports_to_numpy(*flat(left, right))
            (xs, ys, ds), counts = rows(left, right)
            got = global_row_supports_to_numpy(xs, ys, ds, counts)
            assert len(want) > 100
            assert (set(map(tuple, got.tolist()))
                    == set(map(tuple, want.tolist())))
    # batched (lax.map) path (same-shape pairs)
    p0 = make_pair(96, 160, 7, seed=1)
    p1 = make_pair(96, 160, 11, seed=2)
    lb = np.stack([p0[0], p1[0]])
    rb = np.stack([p0[1], p1[1]])
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=64, epipolar_mode=False,
                                 capacity=65536)
    rows = build_sparsematch_global_rows(forest, settings)
    (xs, ys, ds), counts = rows(lb, rb)
    flat = build_sparsematch(forest, settings)
    for k in range(2):
        want = supports_to_numpy(*flat(lb[k], rb[k]))
        got = global_row_supports_to_numpy(xs[k], ys[k], ds[k], counts[k])
        assert (set(map(tuple, got.tolist()))
                == set(map(tuple, want.tolist())))


def test_global_rows_rejects_unsupported_modes():
    from opengpc_tpu.infer import build_sparsematch_global_rows

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    left, right = make_pair(48, 64, 2, seed=1)
    rows = build_sparsematch_global_rows(
        forest, InferenceSettings(epipolar_mode=True)
    )
    with pytest.raises(ValueError, match="global"):
        rows(left, right)


def test_cli_sequence_mode_e2e(tmp_path):
    """Sequence (directory) mode end-to-end over a 12-frame synthetic
    rectified stereo sequence with a mid-sequence shape change: per-frame
    supports files written, each frame's set equal to a direct single-pair
    run, and the shape-change frames take the flat fallback without
    recompiling per frame (VERDICT r2 item 6 — real Sintel is not
    downloadable here, BASELINE.md)."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    frames = []
    for i in range(12):
        if i in (5, 6):  # mid-sequence shape change -> flat fallback
            l, r = make_pair(72, 112, 3 + (i % 4), seed=50 + i)
        else:
            l, r = make_pair(96, 144, 3 + (i % 4), seed=50 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
        frames.append((l, r))
    out = tmp_path / "out" / "d.png"
    rc = cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                   "--disp-high", "32", "--out", str(out)])
    assert rc == 0
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1 << 16)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    matchers = {}
    for i, (l, r) in enumerate(frames):
        sf = tmp_path / "out" / f"supports_{i:04d}.txt"
        assert sf.exists(), f"missing {sf}"
        got = np.loadtxt(str(sf), dtype=np.int64).reshape(-1, 3)
        if l.shape not in matchers:
            matchers[l.shape] = build_sparsematch(forest, settings)
        want = supports_to_numpy(*matchers[l.shape](l, r))
        assert len(want) > 50
        assert (set(map(tuple, got.tolist()))
                == set(map(tuple, want.tolist()))), f"frame {i}"


def test_masked_contract_equals_flat_pipeline():
    """Masked sorted-order contract (build_sparsematch_masked): decoded
    set equals the flat pipeline's, single and batched
    (the batch folds into the row axis), and counts match the buffer."""
    from opengpc_tpu.infer import (build_sparsematch_masked,
                                   masked_supports_to_numpy)

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, disp_high=64,
                                 capacity=16384)
    pairs = [make_pair(80, 144, d, seed=60 + d) for d in (3, 9)]
    flat = build_sparsematch(forest, settings)
    masked = build_sparsematch_masked(forest, settings)
    for left, right in pairs:
        want = supports_to_numpy(*flat(left, right))
        buf, counts = masked(left, right)
        got = masked_supports_to_numpy(buf, counts, settings.disp_high)
        assert len(want) > 100
        assert (set(map(tuple, got.tolist()))
                == set(map(tuple, want.tolist())))
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    bufs, cnts = masked(lb, rb)
    assert bufs.shape == (2, 80, 2 * 144)
    for k, (left, right) in enumerate(pairs):
        want = supports_to_numpy(*flat(left, right))
        got = masked_supports_to_numpy(bufs[k], cnts[k],
                                       settings.disp_high)
        assert (set(map(tuple, got.tolist()))
                == set(map(tuple, want.tolist())))


def test_masked_contract_rejects_unsupported_modes():
    from opengpc_tpu.infer import (build_sparsematch_masked,
                                   masked_supports_to_numpy)

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    left, right = make_pair(48, 64, 2, seed=1)
    m = build_sparsematch_masked(
        forest, InferenceSettings(epipolar_mode=False)
    )
    with pytest.raises(ValueError, match="epipolar"):
        m(left, right)
    with pytest.raises(ValueError, match="batch"):
        masked_supports_to_numpy(np.zeros((2, 4, 8), np.int32),
                                 np.zeros((2, 4), np.int32), 8)


def test_interior_margin_slice_invariants():
    """The fast contracts sort only the candidate-interior rows
    (infer._interior_rows; candidates need y in [13, h-13),
    inference.hpp:318-325) and pad the margin rows back: margin rows must
    be empty in every contract, tiny images (h <= 27, no candidate rows at
    all) must still run, and the sliced outputs must keep full-image
    coordinates."""
    from opengpc_tpu.infer import (_MARGIN, build_sparsematch_masked,
                                   build_sparsematch_rows,
                                   masked_supports_to_numpy)
    from opengpc_tpu.match import MASKED_SENTINEL

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, disp_high=32,
                                 capacity=4096)
    left, right = make_pair(72, 112, 4, seed=31)
    buf, counts = build_sparsematch_masked(forest, settings)(left, right)
    buf, counts = np.asarray(buf), np.asarray(counts)
    assert buf.shape == (72, 224) and counts.shape == (72,)
    assert (buf[:_MARGIN] == MASKED_SENTINEL).all()
    assert (buf[72 - _MARGIN:] == MASKED_SENTINEL).all()
    assert counts[:_MARGIN].sum() == 0 and counts[72 - _MARGIN:].sum() == 0
    got = masked_supports_to_numpy(buf, counts, settings.disp_high)
    assert len(got) > 50
    ys = got[:, 1]
    assert ys.min() >= _MARGIN and ys.max() < 72 - _MARGIN

    (xs, ds), rc = build_sparsematch_rows(forest, settings)(left, right)
    rc = np.asarray(rc)
    assert rc.shape == (72,)
    assert rc[:_MARGIN].sum() == 0 and rc[72 - _MARGIN:].sum() == 0
    assert rc.sum() == len(got)

    # tiny image: no candidate rows at all -> empty outputs, no crash
    tl, tr = make_pair(24, 64, 2, seed=32)
    tbuf, tcounts = build_sparsematch_masked(forest, settings)(tl, tr)
    assert tbuf.shape == (24, 128)
    assert int(np.asarray(tcounts).sum()) == 0


def test_masked_decode_native_equals_numpy(monkeypatch):
    """cpp/decode.cc's branchless scan must produce byte-identical (n, 3)
    arrays (same scan order) as the numpy flat-nonzero fallback."""
    import opengpc_tpu.io.png as iopng
    from opengpc_tpu.infer import (build_sparsematch_masked,
                                   masked_supports_to_numpy)

    if iopng._native_lib() is None:
        pytest.skip("native library not built")
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, disp_high=48,
                                 capacity=8192)
    left, right = make_pair(96, 160, 7, seed=77)
    buf, counts = build_sparsematch_masked(forest, settings)(left, right)
    native = masked_supports_to_numpy(buf, counts, settings.disp_high)
    assert len(native) > 100
    monkeypatch.setattr(iopng, "_NATIVE", None)
    monkeypatch.setattr(iopng, "_NATIVE_TRIED", True)
    fallback = masked_supports_to_numpy(buf, counts, settings.disp_high)
    assert native.dtype == fallback.dtype == np.int32
    assert (native == fallback).all()


def test_masked_decode_parallel_equals_sequential(monkeypatch):
    """The threaded masked decode (ogpc_masked_decode_par: per-row offsets
    from the counts prefix sum, parallel row ranges) must be byte-identical
    to the sequential scan at every thread count, and must keep the
    count-mismatch error contract."""
    import ctypes

    import opengpc_tpu.io.png as iopng
    from opengpc_tpu.infer import (build_sparsematch_masked,
                                   masked_supports_to_numpy)
    from opengpc_tpu.match import MASKED_SENTINEL

    lib = iopng._native_lib()
    if lib is None:
        pytest.skip("native library not built")
    assert hasattr(lib, "ogpc_masked_decode_par"), \
        "stale cpp/build/libopengpc_io.so: rebuild with `make -C cpp`"
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, disp_high=48,
                                 capacity=8192)
    left, right = make_pair(96, 160, 7, seed=77)
    buf, counts = build_sparsematch_masked(forest, settings)(left, right)
    buf = np.ascontiguousarray(np.asarray(buf), dtype=np.int32)
    counts = np.ascontiguousarray(np.asarray(counts), dtype=np.int32)
    n = int(counts.sum())
    assert n > 100
    seq = masked_supports_to_numpy(buf, counts, settings.disp_high)

    # the buffer is below the size threshold — force the par path and sweep
    # thread counts incl. more threads than rows carry hits
    monkeypatch.setattr(iopng, "_DECODE_PAR_MIN_ELEMS", 0)
    for t in (1, 2, 5, 8):
        monkeypatch.setattr(iopng, "_DECODE_THREADS", t)
        got = masked_supports_to_numpy(buf, counts, settings.disp_high)
        assert (got == seq).all(), t

    # direct-lib sweep on an adversarial split: thread boundaries land
    # mid-row-run, trailing misses must divert to scratch, not race
    out = np.empty((n + 1, 3), dtype=np.int32)
    for t in (3, 7):
        out[:] = -1
        got_n = lib.ogpc_masked_decode_par(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            buf.shape[0], buf.shape[1], settings.disp_high,
            MASKED_SENTINEL,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, t)
        assert got_n == n
        assert (out[:n] == seq).all(), t

    # mismatched counts (buffer holds more hits than claimed) must raise
    bad = counts.copy()
    nz = np.flatnonzero(bad)
    bad[nz[0]] -= 1
    monkeypatch.setattr(iopng, "_DECODE_THREADS", 5)
    with pytest.raises(ValueError, match="disagrees with per-row"):
        masked_supports_to_numpy(buf, bad, settings.disp_high)

    # CANCELING per-row errors (row A short by 1, row B long by 1: the
    # grand total still equals sum(row_counts)) must also raise — the
    # parallel scan's output placement depends on the per-row counts, so
    # a total-only check would silently return corrupt triples here
    bad = counts.copy()
    bad[nz[0]] -= 1
    bad[nz[1]] += 1
    with pytest.raises(ValueError, match="disagrees with per-row"):
        masked_supports_to_numpy(buf, bad, settings.disp_high)


def test_cli_sequence_mode_batched(tmp_path):
    """Sequence mode with --batch 3: same-shape frames are stacked into
    one (B*H, 2W) dispatch (with a mid-sequence shape change flushing the
    group to the flat fallback, and a non-full leftover group at the end);
    every per-frame supports file must equal a direct single-pair run."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    frames = []
    for i in range(11):  # 11 = 3+3 then shape-change, then 3+2 leftover
        if i == 6:
            l, r = make_pair(72, 112, 4, seed=90 + i)
        else:
            l, r = make_pair(96, 144, 3 + (i % 4), seed=90 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
        frames.append((l, r))
    out = tmp_path / "out" / "d.png"
    rc = cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                   "--disp-high", "32", "--batch", "3", "--out", str(out)])
    assert rc == 0
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1 << 16)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    matchers = {}
    for i, (l, r) in enumerate(frames):
        sf = tmp_path / "out" / f"supports_{i:04d}.txt"
        assert sf.exists(), f"missing {sf}"
        from opengpc_tpu.io.supports import read_supports
        got = read_supports(str(sf))
        if l.shape not in matchers:
            matchers[l.shape] = build_sparsematch(forest, settings)
        want = supports_to_numpy(*matchers[l.shape](l, r))
        assert len(want) > 50
        assert (set(map(tuple, got.tolist()))
                == set(map(tuple, want.tolist()))), f"frame {i}"
    # --batch outside sequence mode is rejected
    lp, rp = str(ldir / "f0000.png"), str(rdir / "f0000.png")
    assert cli_main(["forests/defaultZeroForest.txt", lp, rp,
                     "--batch", "2"]) == 1


def test_cli_flag_combinations_smoke(tmp_path):
    """argv smoke of the remaining CLI flag surfaces: --pyramid with
    --densify and --trace together (single pair), and --contract rejection
    in sequence mode."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import read_png, write_png

    left, right = make_pair(64, 96, 3, seed=5)
    lp, rp = tmp_path / "l.png", tmp_path / "r.png"
    write_png(str(lp), left)
    write_png(str(rp), right)
    out = tmp_path / "d.png"
    dense = tmp_path / "dense.png"
    trace_dir = tmp_path / "trace"
    rc = cli_main([os.path.join(FORESTS, "defaultZeroForest.txt"),
                   str(lp), str(rp), "--disp-high", "16", "--pyramid", "2",
                   "--densify", str(dense), "--trace", str(trace_dir),
                   "--out", str(out), "--supports-out",
                   str(tmp_path / "s.txt")])
    assert rc == 0
    assert out.exists() and dense.exists()
    arr, _ = read_png(str(dense))
    assert arr.ndim == 3 and arr.shape[:2] == (64, 96)

    # --contract flat is rejected in sequence (directory) mode (masked
    # became a supported sequence contract in r4); --shard-frame now
    # COMPOSES with sequence mode (2-D mesh, r4) and must succeed
    ldir = tmp_path / "ld"
    rdir = tmp_path / "rd"
    ldir.mkdir()
    rdir.mkdir()
    write_png(str(ldir / "f0.png"), left)
    write_png(str(rdir / "f0.png"), right)
    assert cli_main([os.path.join(FORESTS, "defaultZeroForest.txt"),
                     str(ldir), str(rdir), "--contract", "flat",
                     "--out", str(tmp_path / "x" / "d.png")]) == 1
    assert cli_main([os.path.join(FORESTS, "defaultZeroForest.txt"),
                     str(ldir), str(rdir), "--shard-frame", "2",
                     "--out", str(tmp_path / "x" / "d.png")]) == 0


def test_cli_max_tests_fast_preset(tmp_path):
    """--max-tests N truncates the loaded forest in file order before any
    builder sees it (the fast preset: a small-enough N rides the packed
    single-operand sort).  Supports must equal a direct run on
    make_filter_mask(forest, max_tests=N); out-of-range N errors."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.forest import make_filter_mask
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.io.supports import read_supports
    from opengpc_tpu.match import _pack_ok

    left, right = make_pair(96, 160, 7, seed=77)
    lp, rp = tmp_path / "l.png", tmp_path / "r.png"
    write_png(str(lp), left)
    write_png(str(rp), right)
    sup = tmp_path / "s.txt"
    rc = cli_main([os.path.join(FORESTS, "defaultZeroForest.txt"),
                   str(lp), str(rp), "--disp-high", "48",
                   "--max-tests", "17",
                   "--out", str(tmp_path / "d.png"),
                   "--supports-out", str(sup)])
    assert rc == 0
    got = read_supports(str(sup))

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    mask17 = make_filter_mask(forest, max_tests=17)
    assert _pack_ok(mask17.num_tests, 2 * 160)  # the preset's raison d'etre
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, disp_high=48,
                                 capacity=1 << 16)
    want = supports_to_numpy(
        *build_sparsematch(mask17, settings)(left, right))
    assert len(want) > 100
    assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))

    # out-of-range rejected
    assert cli_main([os.path.join(FORESTS, "defaultZeroForest.txt"),
                     str(lp), str(rp), "--max-tests", "31",
                     "--out", str(tmp_path / "d2.png")]) == 1
    assert cli_main([os.path.join(FORESTS, "defaultZeroForest.txt"),
                     str(lp), str(rp), "--max-tests", "0",
                     "--out", str(tmp_path / "d2.png")]) == 1


def test_cli_densify_device_path_byte_equal(tmp_path):
    """--densify on the masked contracts rides the DEVICE-RESIDENT
    densify_from_masked (no decode/re-upload); the written PNG must stay
    byte-identical to the host decode-then-densify path (flat contract),
    for both the full-width and the chunk-compacted masked buffers."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.utils.scenes import make_sparse_pair

    left, right = make_sparse_pair(96, 128, 6, density=0.15, seed=11)
    lp, rp = tmp_path / "l.png", tmp_path / "r.png"
    write_png(str(lp), left)
    write_png(str(rp), right)
    base = [os.path.join(FORESTS, "defaultZeroForest.txt"), str(lp),
            str(rp), "--disp-high", "16", "--out", str(tmp_path / "d.png")]
    pngs = {}
    for contract in ("flat", "masked", "masked-compact"):
        dense = tmp_path / f"dense_{contract}.png"
        assert cli_main(base + ["--contract", contract,
                                "--densify", str(dense)]) == 0
        pngs[contract] = dense.read_bytes()
    assert pngs["masked"] == pngs["flat"]
    assert pngs["masked-compact"] == pngs["flat"]


def test_cli_shard_frame_matches_single_device(tmp_path):
    """--shard-frame 8 (single-frame row sharding over the 8-device CPU
    mesh) writes the same supports file as the default single-device run."""
    from opengpc_tpu.cli.sparsematch import main as sparsematch_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.io.supports import read_supports
    from opengpc_tpu.utils.scenes import make_pair

    left, right = make_pair(128, 160, 6)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(lp, left)
    write_png(rp, right)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = os.path.join(repo, "forests", "defaultZeroForest.txt")
    base = [forest, lp, rp, "--disp-high", "32",
            "--out", str(tmp_path / "d.png")]
    rc = sparsematch_main(base + ["--supports-out",
                                  str(tmp_path / "s_single.txt")])
    assert rc == 0
    rc = sparsematch_main(base + ["--shard-frame", "8", "--supports-out",
                                  str(tmp_path / "s_shard.txt")])
    assert rc == 0
    a = read_supports(str(tmp_path / "s_single.txt"))
    b = read_supports(str(tmp_path / "s_shard.txt"))
    assert len(a) > 100
    assert set(map(tuple, a.tolist())) == set(map(tuple, b.tolist()))
    # rows contract variant too
    rc = sparsematch_main(base + ["--shard-frame", "8", "--contract", "rows",
                                  "--supports-out",
                                  str(tmp_path / "s_shard_rows.txt")])
    assert rc == 0
    c = read_supports(str(tmp_path / "s_shard_rows.txt"))
    assert set(map(tuple, c.tolist())) == set(map(tuple, a.tolist()))
    # global mode row-shards via the distributed bucket sort (r4); the
    # dense make_pair scene trips the overflow guard and re-runs on one
    # device full-width, so the supports must still equal the plain
    # single-device global run
    rc = sparsematch_main(base + ["--global-mode", "--supports-out",
                                  str(tmp_path / "g_single.txt")])
    assert rc == 0
    rc = sparsematch_main(base + ["--shard-frame", "8", "--global-mode",
                                  "--supports-out",
                                  str(tmp_path / "g_shard.txt")])
    assert rc == 0
    ga = read_supports(str(tmp_path / "g_single.txt"))
    gb = read_supports(str(tmp_path / "g_shard.txt"))
    assert len(ga) > 100
    assert set(map(tuple, ga.tolist())) == set(map(tuple, gb.tolist()))
    # rejected combinations
    assert sparsematch_main(base + ["--shard-frame", "3"]) == 1  # 128 % 3
    # explicit contracts the sharded builder can't honor must error out,
    # never silently remap to the masked contract (r4 review finding)
    for bad in ("flat", "global-rows", "global-compact"):
        assert sparsematch_main(
            base + ["--shard-frame", "8", "--contract", bad]) == 1
    # and the epipolar-only contracts are rejected under --global-mode
    assert sparsematch_main(
        base + ["--shard-frame", "8", "--global-mode",
                "--contract", "masked"]) == 1


def test_cli_shard_frame_pyramid_unpackable_keys_message(tmp_path, capfd):
    """--shard-frame --pyramid on a frame whose (pixel, level, d) dedup
    key exceeds int32 packing: the CLI must print a message and return 1
    (r5 review finding — the builder's in-trace ValueError leaked as a
    raw traceback; _rows_ok alone doesn't cover the dedup-key budget).
    512x512 at disp_high 512 x 3 levels: (512*512*4)<<11 == 2^31."""
    from opengpc_tpu.cli.sparsematch import main as sparsematch_main
    from opengpc_tpu.io.png import write_png

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(512, 512), dtype=np.uint8)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(lp, img)
    write_png(rp, img)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = os.path.join(repo, "forests", "defaultZeroForest.txt")
    rc = sparsematch_main([forest, lp, rp, "--disp-high", "512",
                           "--shard-frame", "2", "--pyramid", "3",
                           "--out", str(tmp_path / "d.png")])
    err = capfd.readouterr().err
    assert rc == 1
    assert "exceeds int32 packing" in err, err
    # the same shape at a tame disp_high is packable and must run
    rc = sparsematch_main([forest, lp, rp, "--disp-high", "32",
                           "--shard-frame", "2", "--pyramid", "3",
                           "--out", str(tmp_path / "d.png"),
                           "--supports-out", str(tmp_path / "s.txt")])
    assert rc == 0


def test_cli_sequence_mode_masked_contract(tmp_path):
    """Sequence mode with --contract masked (+ --batch 2, shape change,
    leftover group): per-frame supports equal direct single-pair runs."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.io.supports import read_supports

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    frames = []
    for i in range(7):  # 2+2, shape-change flush, leftover single
        if i == 4:
            l, r = make_pair(72, 112, 4, seed=70 + i)
        else:
            l, r = make_pair(96, 144, 3 + (i % 3), seed=70 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
        frames.append((l, r))
    out = tmp_path / "out" / "d.png"
    rc = cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                   "--disp-high", "32", "--batch", "2",
                   "--contract", "masked", "--out", str(out)])
    assert rc == 0
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1 << 16)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    matchers = {}
    for i, (l, r) in enumerate(frames):
        got = read_supports(str(tmp_path / "out" / f"supports_{i:04d}.txt"))
        if l.shape not in matchers:
            matchers[l.shape] = build_sparsematch(forest, settings)
        want = supports_to_numpy(*matchers[l.shape](l, r))
        assert len(want) > 50
        assert (set(map(tuple, got.tolist()))
                == set(map(tuple, want.tolist()))), f"frame {i}"
    # explicit masked on an ineligible setup errors out (global mode)
    assert cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                     "--global-mode", "--contract", "masked",
                     "--out", str(out)]) == 1


def test_cli_sequence_mode_global_rows(tmp_path):
    """--global-mode sequences ride the segmented global contract (with
    --batch 2): per-frame supports equal direct single-pair flat runs."""
    import dataclasses

    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.io.supports import read_supports

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    frames = []
    for i in range(5):
        l, r = make_pair(80, 128, 2 + i, seed=60 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
        frames.append((l, r))
    out = tmp_path / "out" / "d.png"
    rc = cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                   "--disp-high", "32", "--global-mode", "--batch", "2",
                   "--out", str(out)])
    assert rc == 0
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=False,
                                 capacity=1 << 16)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    flat = build_sparsematch(forest, settings)
    for i, (l, r) in enumerate(frames):
        got = read_supports(str(tmp_path / "out" / f"supports_{i:04d}.txt"))
        want = supports_to_numpy(*flat(l, r))
        assert len(want) > 50
        assert (set(map(tuple, got.tolist()))
                == set(map(tuple, want.tolist()))), f"frame {i}"


def test_masked_compact_contract():
    """Chunk-compacted masked contract: exact set equality with the flat
    pipeline on a low-density scene (incl. batch fold + odd width that
    exercises the chunk padding), and a trustworthy overflow flag on a
    dense scene."""
    from opengpc_tpu.infer import (build_sparsematch,
                                   build_sparsematch_masked_compact,
                                   masked_supports_to_numpy)
    from opengpc_tpu.utils.scenes import make_pair, make_sparse_pair

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1 << 16)
    flat = build_sparsematch(forest, settings)

    for h, w in ((160, 256), (150, 250)):  # 2W=500: not a chunk multiple
        l, r = make_sparse_pair(h, w, 8, density=0.15, seed=h)
        compact = build_sparsematch_masked_compact(
            forest, settings, chunk=128, k=64)
        buf, counts, ovf = compact(l, r)
        assert not bool(np.asarray(ovf)), (h, w)
        got = masked_supports_to_numpy(buf, counts, settings.disp_high)
        want = supports_to_numpy(*flat(l, r))
        assert len(want) > 200
        assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))
        # batch fold
        lb, rb = np.stack([l, l]), np.stack([r, r])
        bbuf, bcounts, bovf = compact(lb, rb)
        assert not bool(np.asarray(bovf))
        for i in range(2):
            gi = masked_supports_to_numpy(np.asarray(bbuf)[i],
                                          np.asarray(bcounts)[i],
                                          settings.disp_high)
            assert set(map(tuple, gi.tolist())) == set(map(tuple,
                                                           want.tolist()))

    # dense scene trips the overflow guard instead of dropping supports
    dl, dr = make_pair(160, 256, 8)
    compact = build_sparsematch_masked_compact(
        forest, settings, chunk=128, k=64)
    _, _, ovf = compact(dl, dr)
    assert bool(np.asarray(ovf))


def test_global_compact_contract():
    """Chunk-compacted GLOBAL contract (r4): exact set equality with the
    flat global pipeline on a low-density scene (incl. an odd width that
    exercises the chunk padding and the batched lax.map path with
    per-pair overflow flags), and a trustworthy overflow flag on a dense
    scene."""
    from opengpc_tpu.infer import (build_sparsematch,
                                   build_sparsematch_global_compact,
                                   global_row_supports_to_numpy)
    from opengpc_tpu.utils.scenes import make_pair, make_sparse_pair

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=False,
                                 capacity=1 << 16)
    flat = build_sparsematch(forest, settings)
    dl, dr = make_pair(160, 256, 8, seed=7)

    for h, w in ((160, 256), (150, 250)):  # 2W=500: not a chunk multiple
        l, r = make_sparse_pair(h, w, 8, density=0.15, seed=h)
        compact = build_sparsematch_global_compact(
            forest, settings, chunk=128, k=64)
        (xs, ys, ds), counts, ovf = compact(l, r)
        assert not bool(np.asarray(ovf)), (h, w)
        got = global_row_supports_to_numpy(xs, ys, ds, counts)
        want = supports_to_numpy(*flat(l, r))
        assert len(want) > 200
        assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))
        if (h, w) == (160, 256):
            # mixed batch through lax.map: per-pair overflow flags — the
            # sparse pair stays exact, the dense pair flags truthfully
            lb, rb = np.stack([l, dl]), np.stack([r, dr])
            (bxs, bys, bds), bcounts, bovf = compact(lb, rb)
            bovf = np.asarray(bovf)
            assert not bool(bovf[0]) and bool(bovf[1])
            g0 = global_row_supports_to_numpy(
                np.asarray(bxs)[0], np.asarray(bys)[0], np.asarray(bds)[0],
                np.asarray(bcounts)[0])
            assert set(map(tuple, g0.tolist())) == set(map(tuple,
                                                           want.tolist()))

    # dense scene trips the overflow guard instead of dropping supports
    compact = build_sparsematch_global_compact(
        forest, settings, chunk=128, k=64)
    _, _, ovf = compact(dl, dr)
    assert bool(np.asarray(ovf))


def test_cli_masked_compact_contract(tmp_path):
    """--contract masked-compact: same supports as the default run on a
    sparse frame, and the dense-frame overflow fallback also matches."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.io.supports import read_supports
    from opengpc_tpu.utils.scenes import make_sparse_pair

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = os.path.join(repo, "forests", "defaultZeroForest.txt")
    import contextlib
    import io

    for name, (l, r) in (
            ("sparse", make_sparse_pair(160, 256, 8, density=0.15)),
            ("dense", make_pair(160, 256, 8, seed=3))):
        lp, rp = str(tmp_path / f"{name}_l.png"), str(tmp_path / f"{name}_r.png")
        write_png(lp, l)
        write_png(rp, r)
        base = [forest, lp, rp, "--disp-high", "32",
                "--out", str(tmp_path / "d.png")]
        assert cli_main(base + ["--supports-out",
                                str(tmp_path / f"{name}_a.txt")]) == 0
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert cli_main(base + ["--contract", "masked-compact",
                                    "--supports-out",
                                    str(tmp_path / f"{name}_b.txt")]) == 0
        # the dense frame MUST trip the overflow guard and take the
        # full-width fallback; the sparse frame must not — otherwise the
        # fallback branch has no coverage (r4 review finding)
        assert ("masked-compact overflow" in err.getvalue()) == (
            name == "dense"), (name, err.getvalue())
        a = read_supports(str(tmp_path / f"{name}_a.txt"))
        b = read_supports(str(tmp_path / f"{name}_b.txt"))
        assert len(a) > 100, name
        assert set(map(tuple, a.tolist())) == set(map(tuple, b.tolist())), name


def test_cli_global_compact_contract(tmp_path):
    """--contract global-compact (r4): same supports as the plain
    --global-mode run on a sparse frame (where auto also density-selects
    it), and the dense-frame overflow fallback matches too; without
    --global-mode the explicit contract errors out."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.io.supports import read_supports
    from opengpc_tpu.utils.scenes import make_sparse_pair

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = os.path.join(repo, "forests", "defaultZeroForest.txt")
    import contextlib
    import io

    for name, (l, r) in (
            ("sparse", make_sparse_pair(160, 256, 8, density=0.15)),
            ("dense", make_pair(160, 256, 8, seed=3))):
        lp = str(tmp_path / f"{name}_l.png")
        rp = str(tmp_path / f"{name}_r.png")
        write_png(lp, l)
        write_png(rp, r)
        base = [forest, lp, rp, "--disp-high", "32", "--global-mode",
                "--out", str(tmp_path / "d.png")]
        # baseline: EXPLICIT full-width segmented global — auto would
        # density-select global-compact on the sparse frame, which would
        # compare the compact path against itself (r4 review finding)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert cli_main(base + ["--contract", "global-rows",
                                    "--supports-out",
                                    str(tmp_path / f"{name}_a.txt")]) == 0
        assert "compact" not in err.getvalue(), err.getvalue()
        if name == "sparse":
            # auto's density probe must select the compacted contract on
            # the sparse frame (and its output must match the baseline)
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                assert cli_main(
                    base + ["--supports-out",
                            str(tmp_path / f"{name}_c.txt")]) == 0
            assert "chunk-compacted global contract" in err.getvalue()
            auto = read_supports(str(tmp_path / f"{name}_c.txt"))
            ref = read_supports(str(tmp_path / f"{name}_a.txt"))
            assert set(map(tuple, auto.tolist())) == set(
                map(tuple, ref.tolist()))
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert cli_main(base + ["--contract", "global-compact",
                                    "--supports-out",
                                    str(tmp_path / f"{name}_b.txt")]) == 0
        # the dense frame MUST trip the overflow guard and take the
        # full-width fallback; the sparse frame must not
        assert ("global-compact overflow" in err.getvalue()) == (
            name == "dense"), (name, err.getvalue())
        a = read_supports(str(tmp_path / f"{name}_a.txt"))
        b = read_supports(str(tmp_path / f"{name}_b.txt"))
        assert len(a) > 100, name
        assert set(map(tuple, a.tolist())) == set(map(tuple, b.tolist())), name

    # explicit global-compact without --global-mode is an error
    assert cli_main([forest, str(tmp_path / "sparse_l.png"),
                     str(tmp_path / "sparse_r.png"), "--disp-high", "32",
                     "--contract", "global-compact",
                     "--out", str(tmp_path / "d.png")]) == 1


def test_auto_compact_threshold_scales_with_chunk_capacity():
    """The auto-contract density cutoff must track the chosen contract's
    K/S chunk capacity ratio: wide-row global compact runs K/S=1/4, so a
    flat 0.30 cutoff would select it on frames that overflow nearly every
    dispatch (r4 review finding)."""
    from opengpc_tpu.cli.sparsematch import (_AUTO_COMPACT_FRACTION,
                                             _auto_compact_threshold)
    from opengpc_tpu.match import (MASKED_COMPACT_CHUNKS,
                                   global_compact_chunks)

    mc, mk = MASKED_COMPACT_CHUNKS
    assert _auto_compact_threshold(True, 1024) == \
        _AUTO_COMPACT_FRACTION * mk / mc
    for width in (256, 1024, 4096):
        gc, gk = global_compact_chunks(2 * width)
        thr = _auto_compact_threshold(False, width)
        assert thr == _AUTO_COMPACT_FRACTION * gk / gc
        # the cutoff must sit strictly below the overflow capacity
        assert thr < gk / gc


def test_cli_sequence_data_parallel(tmp_path, capfd):
    """Sequence --data-parallel N (r4): full dispatch groups shard over
    the first N mesh devices via the parallel batched builders; per-frame
    supports must equal a single-device run.  Covers the default-batch
    round-up (4 -> 8 at N=8), the dense masked-compact dispatch whose
    PER-SHARD overflow flag vector re-runs full-width, and the rejected
    flag combinations."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.io.supports import read_supports

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    frames = []
    for i in range(10):  # one full group of 8 at N=8, 2 leftover singles
        l, r = make_pair(64, 96, 3 + (i % 4), seed=300 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
        frames.append((l, r))
    forest = os.path.join(FORESTS, "defaultZeroForest.txt")

    def run(outdir, extra):
        rc = cli_main([forest, str(ldir), str(rdir), "--disp-high", "16",
                       "--out", str(tmp_path / outdir / "d.png")] + extra)
        assert rc == 0
        return [read_supports(str(tmp_path / outdir
                                  / f"supports_{i:04d}.txt"))
                for i in range(len(frames))]

    base = run("single", ["--contract", "masked"])
    dp = run("dp", ["--contract", "masked", "--data-parallel", "8"])
    assert sum(len(s) for s in base) > 200
    for i, (a, b) in enumerate(zip(base, dp)):
        assert set(map(tuple, a.tolist())) == set(
            map(tuple, b.tolist())), f"frame {i}"
    # dense frames + explicit masked-compact: the mesh builder's
    # (n_shards,) overflow vector must trip the full-width re-run
    capfd.readouterr()
    dpc = run("dpc", ["--contract", "masked-compact",
                      "--data-parallel", "2", "--batch", "4"])
    assert "overflow" in capfd.readouterr().err
    for i, (a, b) in enumerate(zip(base, dpc)):
        assert set(map(tuple, a.tolist())) == set(
            map(tuple, b.tolist())), f"frame {i}"
    # global-mode contract rides its mesh builder too
    gbase = run("gsingle", ["--global-mode", "--contract", "global-rows"])
    gdp = run("gdp", ["--global-mode", "--contract", "global-rows",
                      "--data-parallel", "2", "--batch", "4"])
    for i, (a, b) in enumerate(zip(gbase, gdp)):
        assert set(map(tuple, a.tolist())) == set(
            map(tuple, b.tolist())), f"global frame {i}"
    # rejections: single-pair mode, N > devices, indivisible --batch
    lp, rp = str(ldir / "f0000.png"), str(rdir / "f0000.png")
    assert cli_main([forest, lp, rp, "--data-parallel", "2"]) == 1
    assert cli_main([forest, str(ldir), str(rdir), "--out",
                     str(tmp_path / "x.png"),
                     "--data-parallel", "9"]) == 1
    assert cli_main([forest, str(ldir), str(rdir), "--out",
                     str(tmp_path / "x.png"), "--data-parallel", "2",
                     "--batch", "3"]) == 1


def test_cli_sequence_shard_frame(tmp_path, capfd):
    """Sequence --shard-frame M (r4): every dispatch group rides the 2-D
    (data x rows) mesh builder — frames over the data axis (when
    --data-parallel is also given), each frame's rows over M chips.
    Per-frame supports must equal a single-device run, including the
    --batch 1 path (a (1, H, W) stack still row-shards) and the
    masked-compact overflow re-run."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.io.supports import read_supports

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    n_frames = 6
    for i in range(n_frames):  # 64 rows -> 16 rows/shard at M=4
        l, r = make_pair(64, 96, 3 + (i % 4), seed=400 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
    forest = os.path.join(FORESTS, "defaultZeroForest.txt")

    def run(outdir, extra):
        rc = cli_main([forest, str(ldir), str(rdir), "--disp-high", "16",
                       "--out", str(tmp_path / outdir / "d.png")] + extra)
        assert rc == 0
        return [read_supports(str(tmp_path / outdir
                                  / f"supports_{i:04d}.txt"))
                for i in range(n_frames)]

    def check(a_frames, b_frames, label):
        for i, (a, b) in enumerate(zip(a_frames, b_frames)):
            assert set(map(tuple, a.tolist())) == set(
                map(tuple, b.tolist())), f"{label} frame {i}"

    base = run("single", ["--contract", "masked"])
    assert sum(len(s) for s in base) > 100
    # rows over 4 chips, default batch (4 full + 2 leftover singles)
    sf = run("sf", ["--contract", "masked", "--shard-frame", "4"])
    check(base, sf, "shard-frame")
    # composed: 2 frames x 4 row shards = all 8 devices per dispatch
    sfdp = run("sfdp", ["--contract", "masked", "--shard-frame", "4",
                        "--data-parallel", "2", "--batch", "2"])
    check(base, sfdp, "shard-frame+dp")
    # --batch 1: (1, H, W) stacks must still row-shard (stacked-flag path)
    sf1 = run("sf1", ["--contract", "masked", "--shard-frame", "4",
                      "--batch", "1"])
    check(base, sf1, "shard-frame batch1")
    # dense frames + masked-compact: the per-group overflow flag vector
    # re-runs the dispatch full-width
    capfd.readouterr()
    sfc = run("sfc", ["--contract", "masked-compact", "--shard-frame", "4",
                      "--data-parallel", "2", "--batch", "2"])
    assert "overflow" in capfd.readouterr().err
    check(base, sfc, "shard-frame compact")
    # rejections: global contract, indivisible height, too many devices
    assert cli_main([forest, str(ldir), str(rdir), "--out",
                     str(tmp_path / "x.png"), "--global-mode",
                     "--contract", "global-rows", "--shard-frame", "4"]) == 1
    assert cli_main([forest, str(ldir), str(rdir), "--out",
                     str(tmp_path / "x.png"), "--contract", "masked",
                     "--shard-frame", "5"]) == 1
    assert cli_main([forest, str(ldir), str(rdir), "--out",
                     str(tmp_path / "x.png"), "--contract", "masked",
                     "--shard-frame", "4", "--data-parallel", "3"]) == 1


def test_masked_compact_builders_follow_constant(monkeypatch):
    """Every public masked-compact builder must resolve its default
    (chunk, k) through match.MASKED_COMPACT_CHUNKS — retuning the constant
    (e.g. after a K/S ratio sweep) has to retune the builders AND the CLI
    auto threshold together, not just one of them (r4 review finding)."""
    from opengpc_tpu import match
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked_compact
    from opengpc_tpu.utils.scenes import make_pair

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(disp_high=32, epipolar_mode=True)
    left, right = make_pair(64, 128, 6)

    chunk, k = match.MASKED_COMPACT_CHUNKS
    nc = -(-2 * 128 // chunk)
    buf, _, _ = build_sparsematch_masked_compact(forest, settings)(
        left, right)
    # nc*k - 1 adjacent detect windows + 1 sentinel pad column
    assert buf.shape[1] == nc * k

    monkeypatch.setattr(match, "MASKED_COMPACT_CHUNKS", (64, 16))
    buf2, _, _ = build_sparsematch_masked_compact(forest, settings)(
        left, right)
    assert buf2.shape[1] == (2 * 128 // 64) * 16

    # the shared derivation rules
    assert match.resolve_masked_compact_chunks() == (64, 16)
    # single-parameter defaults keep the tuned K/S ratio (here 16/64 = 1/4)
    assert match.resolve_masked_compact_chunks(k=8) == (32, 8)
    assert match.resolve_masked_compact_chunks(chunk=32) == (32, 8)
    with pytest.raises(ValueError):
        match.resolve_masked_compact_chunks(chunk=8, k=16)


def test_cli_sequence_global_compact(tmp_path, capfd):
    """Global-mode sequences (r4): auto density-selects global-compact on
    a sparse sequence; a dense frame inside a --batch group trips a
    per-pair overflow flag and the whole dispatch re-runs through the
    full-width global builder — per-frame supports equal explicit
    full-width global runs either way."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.io.supports import read_supports
    from opengpc_tpu.utils.scenes import make_sparse_pair

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    frames = []
    for i in range(6):
        if i == 3:  # dense frame -> overflow -> full-width re-run
            l, r = make_pair(96, 144, 4, seed=50)
        else:
            l, r = make_sparse_pair(96, 144, 4, density=0.15, seed=60 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
        frames.append((l, r))
    out = tmp_path / "out" / "d.png"
    rc = cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                   "--disp-high", "32", "--global-mode", "--batch", "2",
                   "--out", str(out)])
    err = capfd.readouterr().err
    assert rc == 0
    assert "chunk-compacted global contract" in err, err
    assert "global-compact overflow" in err, err
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=False,
                                 capacity=1 << 16)
    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    flat = build_sparsematch(forest, settings)
    for i, (l, r) in enumerate(frames):
        got = read_supports(str(tmp_path / "out" / f"supports_{i:04d}.txt"))
        want = supports_to_numpy(*flat(l, r))
        assert len(want) > 50, i
        assert (set(map(tuple, got.tolist()))
                == set(map(tuple, want.tolist()))), f"frame {i}"


def test_cli_sequence_masked_compact(tmp_path, capfd):
    """Sequence mode with --contract masked-compact (r4): sparse frames
    ride the chunk-compacted dispatches; a dense frame inside a --batch
    group trips the ORed overflow flag and the whole dispatch re-runs
    full-width in the assembly worker — per-frame supports equal a plain
    auto-contract run either way."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.utils.scenes import make_sparse_pair

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    for i in range(8):
        if i == 5:  # dense frame -> overflow -> full-width re-run
            l, r = make_pair(96, 144, 4, seed=50)
        else:
            l, r = make_sparse_pair(96, 144, 4, density=0.15, seed=60 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
    outs = {}
    # explicit rows as the independent baseline: auto itself now
    # density-selects masked-compact on this sparse sequence (r4)
    for label, extra in (("compact", ["--contract", "masked-compact"]),
                         ("auto", ["--contract", "rows"])):
        out = tmp_path / f"out_{label}" / "d.png"
        rc = cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                       "--disp-high", "32", "--batch", "2",
                       "--out", str(out)] + extra)
        err = capfd.readouterr().err
        assert rc == 0, label
        if label == "compact":
            # the dense frame's group must actually take the fallback
            assert "masked-compact overflow" in err, err
        frames = []
        for i in range(8):
            sf = tmp_path / f"out_{label}" / f"supports_{i:04d}.txt"
            assert sf.exists(), (label, i)
            got = np.loadtxt(str(sf), dtype=np.int64).reshape(-1, 3)
            frames.append(sorted(map(tuple, got.tolist())))
        outs[label] = frames
    for i in range(8):
        assert outs["compact"][i] == outs["auto"][i], f"frame {i}"
    assert sum(len(f) for f in outs["auto"]) > 400


def test_cli_sequence_pyramid(tmp_path, capfd):
    """Sequence mode --pyramid (r5): full dispatch groups ride the batched
    HYBRID pyramid fold; per-frame supports equal single-pair --pyramid
    runs, including a mid-sequence shape change (dispatched through the
    same pyramid builder at the new shape, not downgraded to
    single-scale)."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    frames = []
    for i in range(7):
        if i == 4:  # shape change -> single dispatch via the pyramid
            l, r = make_pair(72, 112, 3, seed=90 + i)
        else:
            l, r = make_pair(96, 144, 2 + (i % 3), seed=90 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
        frames.append((l, r))
    out = tmp_path / "out" / "d.png"
    rc = cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                   "--disp-high", "32", "--pyramid", "2",
                   "--out", str(out)])
    assert rc == 0, capfd.readouterr().err
    for i, (l, r) in enumerate(frames):
        sp = str(tmp_path / f"single_{i}.txt")
        rc = cli_main(["forests/defaultZeroForest.txt",
                       str(ldir / f"f{i:04d}.png"),
                       str(rdir / f"f{i:04d}.png"),
                       "--disp-high", "32", "--pyramid", "2",
                       "--out", str(tmp_path / "sp.png"),
                       "--supports-out", sp])
        assert rc == 0
        want = set(map(tuple, np.loadtxt(sp, dtype=np.int64)
                       .reshape(-1, 3).tolist()))
        got = np.loadtxt(str(tmp_path / "out" / f"supports_{i:04d}.txt"),
                         dtype=np.int64).reshape(-1, 3)
        assert set(map(tuple, got.tolist())) == want, f"frame {i}"
        assert len(want) > 50

    # incompatible combos rejected with the friendly message
    rc = cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                   "--pyramid", "2", "--contract", "masked",
                   "--out", str(out)])
    assert rc == 1
    assert "sequence --pyramid" in capfd.readouterr().err


def test_cli_sequence_pyramid_multichip(tmp_path, capfd):
    """Sequence --pyramid composes with --data-parallel (batch over a
    1-D mesh) and with --shard-frame x --data-parallel (the 2-D mesh
    pyramid): per-frame supports equal single-pair --pyramid runs."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    frames = []
    for i in range(4):
        l, r = make_pair(112, 96, 2 + (i % 2), seed=130 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
        frames.append((l, r))
    singles = []
    for i, (l, r) in enumerate(frames):
        sp = str(tmp_path / f"s_{i}.txt")
        rc = cli_main(["forests/defaultZeroForest.txt",
                       str(ldir / f"f{i:04d}.png"),
                       str(rdir / f"f{i:04d}.png"), "--disp-high", "32",
                       "--pyramid", "2", "--out", str(tmp_path / "x.png"),
                       "--supports-out", sp])
        assert rc == 0
        singles.append(set(map(tuple, np.loadtxt(sp, dtype=np.int64)
                               .reshape(-1, 3).tolist())))
    for label, extra in (
            ("dp", ["--data-parallel", "2", "--batch", "2"]),
            ("2d", ["--data-parallel", "2", "--shard-frame", "4",
                    "--batch", "2"])):
        out = tmp_path / f"out_{label}" / "d.png"
        rc = cli_main(["forests/defaultZeroForest.txt", str(ldir),
                       str(rdir), "--disp-high", "32", "--pyramid", "2",
                       "--out", str(out)] + extra)
        assert rc == 0, (label, capfd.readouterr().err)
        for i in range(4):
            got = np.loadtxt(
                str(tmp_path / f"out_{label}" / f"supports_{i:04d}.txt"),
                dtype=np.int64).reshape(-1, 3)
            assert set(map(tuple, got.tolist())) == singles[i], \
                (label, i)
            assert len(singles[i]) > 50
    # misaligned height for the 2-D pyramid rejects up front
    for f in list(ldir.glob("*.png")) + list(rdir.glob("*.png")):
        f.unlink()
    l, r = make_pair(100, 96, 2, seed=140)  # 100 % (4*2) != 0
    write_png(str(ldir / "f0000.png"), l)
    write_png(str(rdir / "f0000.png"), r)
    rc = cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                   "--pyramid", "2", "--shard-frame", "4", "--out",
                   str(tmp_path / "y.png")])
    assert rc == 1 and "divide by 8" in capfd.readouterr().err


def test_cli_sequence_pyramid_density_adaptive(tmp_path, capfd):
    """A sparse pyramid sequence auto-selects the chunk-compacted pyramid
    (same probe/threshold as the flat contracts); a dense frame trips the
    overflow guard (re-run on the rows pyramid) and the hysteresis; all
    frames equal single-pair --pyramid runs."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.utils.scenes import make_sparse_pair

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    for i in range(6):
        if i == 3:  # dense frame -> compact-pyramid overflow
            l, r = make_pair(96, 144, 4, seed=100)
        else:
            l, r = make_sparse_pair(96, 144, 4, density=0.15, seed=110 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
    out = tmp_path / "out" / "d.png"
    rc = cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                   "--disp-high", "32", "--pyramid", "2", "--batch", "1",
                   "--out", str(out)])
    err = capfd.readouterr().err
    assert rc == 0, err
    assert "chunk-compacted pyramid" in err, err
    assert "pyramid-compact overflow" in err, err
    for i in range(6):
        sp = str(tmp_path / f"single_{i}.txt")
        rc = cli_main(["forests/defaultZeroForest.txt",
                       str(ldir / f"f{i:04d}.png"),
                       str(rdir / f"f{i:04d}.png"),
                       "--disp-high", "32", "--pyramid", "2",
                       "--out", str(tmp_path / "sp.png"),
                       "--supports-out", sp])
        assert rc == 0
        want = set(map(tuple, np.loadtxt(sp, dtype=np.int64)
                       .reshape(-1, 3).tolist()))
        got = np.loadtxt(str(tmp_path / "out" / f"supports_{i:04d}.txt"),
                         dtype=np.int64).reshape(-1, 3)
        assert set(map(tuple, got.tolist())) == want, f"frame {i}"


def test_cli_sequence_overflow_hysteresis(tmp_path, capfd):
    """Mid-sequence density drift (VERDICT r4 weak #3): a sequence that
    turns dense trips the overflow ONCE and then routes dense frames
    straight to the full-width builder via the per-frame density probe
    (no compact+full double dispatch per dense frame); the first sparse
    frame after the stretch resumes the compact contract.  Outputs equal
    an independent rows-contract run frame for frame."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.utils.scenes import make_sparse_pair

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    n, dense_frames = 14, set(range(4, 10))  # 6-frame dense stretch
    for i in range(n):
        if i in dense_frames:
            l, r = make_pair(96, 144, 4, seed=70 + i)
        else:
            l, r = make_sparse_pair(96, 144, 4, density=0.15, seed=80 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
    outs = {}
    for label, extra in (("compact", ["--contract", "masked-compact"]),
                         ("rows", ["--contract", "rows"])):
        out = tmp_path / f"out_{label}" / "d.png"
        rc = cli_main(["forests/defaultZeroForest.txt", str(ldir), str(rdir),
                       "--disp-high", "32", "--batch", "1",
                       "--out", str(out)] + extra)
        err = capfd.readouterr().err
        assert rc == 0, label
        if label == "compact":
            n_ovf = err.count("masked-compact overflow")
            # pipeline lag (<= 2 in-flight dispatches + the probe's own
            # dispatch) can let a couple of dense frames slip through
            # compact before the flag is observed; far fewer than the 6
            # dense frames proves the hysteresis engaged
            assert 1 <= n_ovf <= 4, err
            assert "resuming the compact contract" in err, err
        frames = []
        for i in range(n):
            sf = tmp_path / f"out_{label}" / f"supports_{i:04d}.txt"
            assert sf.exists(), (label, i)
            got = np.loadtxt(str(sf), dtype=np.int64).reshape(-1, 3)
            frames.append(sorted(map(tuple, got.tolist())))
        outs[label] = frames
    for i in range(n):
        assert outs["compact"][i] == outs["rows"][i], f"frame {i}"
    assert sum(len(f) for f in outs["rows"]) > 400


def test_cli_sequence_hysteresis_batched_data_parallel(tmp_path, capfd):
    """Drifting density under --batch 4 --data-parallel 2: when the
    overflow flag trips while a PARTIAL group is pending, the group must
    flush through the single-frame program (flush_group), not a stacked
    (k, H, W) dispatch — a k<batch stack would pay a fresh jit trace per
    distinct k and break shard_map's batch-divisibility contract (odd k
    over a 2-device mesh raised mid-sequence).  Outputs equal a rows run
    frame for frame across two dense stretches."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.utils.scenes import make_sparse_pair

    ldir = tmp_path / "left"
    rdir = tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    n = 20
    dense_frames = set(range(3, 9)) | set(range(12, 18))
    for i in range(n):
        if i in dense_frames:
            l, r = make_pair(96, 144, 4, seed=70 + i)
        else:
            l, r = make_sparse_pair(96, 144, 4, density=0.15, seed=80 + i)
        write_png(str(ldir / f"f{i:04d}.png"), l)
        write_png(str(rdir / f"f{i:04d}.png"), r)
    outs = {}
    for label, extra in (("compact", ["--contract", "masked-compact",
                                      "--data-parallel", "2"]),
                         ("rows", ["--contract", "rows"])):
        out = tmp_path / f"out_{label}" / "d.png"
        rc = cli_main(["forests/defaultZeroForest.txt", str(ldir),
                       str(rdir), "--disp-high", "32", "--batch", "4",
                       "--out", str(out)] + extra)
        err = capfd.readouterr().err
        assert rc == 0, (label, err)
        if label == "compact":
            assert err.count("masked-compact overflow") >= 1, err
        frames = []
        for i in range(n):
            sf = tmp_path / f"out_{label}" / f"supports_{i:04d}.txt"
            assert sf.exists(), (label, i)
            got = np.loadtxt(str(sf), dtype=np.int64).reshape(-1, 3)
            frames.append(sorted(map(tuple, got.tolist())))
        outs[label] = frames
    for i in range(n):
        assert outs["compact"][i] == outs["rows"][i], f"frame {i}"
    assert sum(len(f) for f in outs["rows"]) > 400


def test_probe_density_fn_cached():
    """The density probe's jitted reduce is cached per gradient threshold
    (r5 review finding): the hysteresis path probes EVERY frame of a
    dense stretch, so a fresh jax.jit(lambda) per call would retrace and
    recompile per frame, eroding the savings the probe exists to buy."""
    from opengpc_tpu.cli.sparsematch import _probe_fn

    assert _probe_fn(5) is _probe_fn(5)
    assert _probe_fn(5) is not _probe_fn(7)


def test_cli_sequence_auto_density_adaptive(tmp_path, capfd):
    """Auto contract in sequence mode (r4): a sparse sequence probes frame
    0's candidate density and rides the chunk-compacted masked contract
    without any flag; a dense sequence stays on the row-form contract.
    Outputs equal an explicit --contract rows run either way."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.utils.scenes import make_sparse_pair

    for kind, mk in (("sparse", lambda i: make_sparse_pair(
                          96, 144, 4, density=0.15, seed=80 + i)),
                     ("dense", lambda i: make_pair(96, 144, 4, seed=80 + i))):
        ldir = tmp_path / f"{kind}_left"
        rdir = tmp_path / f"{kind}_right"
        ldir.mkdir()
        rdir.mkdir()
        for i in range(4):
            l, r = mk(i)
            write_png(str(ldir / f"f{i:04d}.png"), l)
            write_png(str(rdir / f"f{i:04d}.png"), r)
        outs = {}
        for label, extra in (("auto", []), ("rows", ["--contract", "rows"])):
            out = tmp_path / f"{kind}_out_{label}" / "d.png"
            rc = cli_main(["forests/defaultZeroForest.txt", str(ldir),
                           str(rdir), "--disp-high", "32",
                           "--out", str(out)] + extra)
            err = capfd.readouterr().err
            assert rc == 0, (kind, label)
            if label == "auto":
                picked = "auto contract: candidate density" in err
                assert picked == (kind == "sparse"), (kind, err)
            frames = []
            for i in range(4):
                sf = tmp_path / f"{kind}_out_{label}" / f"supports_{i:04d}.txt"
                got = np.loadtxt(str(sf), dtype=np.int64).reshape(-1, 3)
                frames.append(sorted(map(tuple, got.tolist())))
            outs[label] = frames
        for i in range(4):
            assert outs["auto"][i] == outs["rows"][i], (kind, i)
        assert sum(len(f) for f in outs["rows"]) > 200, kind


def test_cli_single_pair_auto_density_adaptive(tmp_path, capfd):
    """Single-pair auto contract (r4): a sparse pair density-probes onto
    the chunk-compacted masked contract (same supports as explicit rows);
    a dense pair stays on row-form with no probe message."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.io.supports import read_supports
    from opengpc_tpu.utils.scenes import make_sparse_pair

    forest = os.path.join(FORESTS, "defaultZeroForest.txt")
    for name, (l, r) in (
            ("sparse", make_sparse_pair(160, 256, 8, density=0.15, seed=9)),
            ("dense", make_pair(160, 256, 8, seed=9))):
        lp, rp = str(tmp_path / f"{name}_l.png"), str(tmp_path / f"{name}_r.png")
        write_png(lp, l)
        write_png(rp, r)
        base = [forest, lp, rp, "--disp-high", "32",
                "--out", str(tmp_path / "d.png")]
        rc = cli_main(base + ["--supports-out",
                              str(tmp_path / f"{name}_auto.txt")])
        err = capfd.readouterr().err
        assert rc == 0, name
        assert ("auto contract: candidate density" in err) == (
            name == "sparse"), (name, err)
        rc = cli_main(base + ["--contract", "rows", "--supports-out",
                              str(tmp_path / f"{name}_rows.txt")])
        assert rc == 0, name
        a = read_supports(str(tmp_path / f"{name}_auto.txt"))
        b = read_supports(str(tmp_path / f"{name}_rows.txt"))
        assert len(a) > 100, name
        assert set(map(tuple, a.tolist())) == set(map(tuple, b.tolist())), name


def test_cli_sequence_densify_and_rejections(tmp_path):
    """Sequence mode --densify writes per-frame dense_{NNNN}.png into the
    given directory, byte-identical to the single-pair --densify output
    for the same frame; single-pair-only flags error out instead of being
    silently ignored (r4 review finding)."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png

    ld, rd = tmp_path / "ld", tmp_path / "rd"
    ld.mkdir(), rd.mkdir()
    frames = [make_pair(64, 96, 3, seed=80 + i) for i in range(3)]
    for i, (left, right) in enumerate(frames):
        write_png(str(ld / f"f{i}.png"), left)
        write_png(str(rd / f"f{i}.png"), right)

    base = [os.path.join(FORESTS, "defaultZeroForest.txt"), str(ld),
            str(rd), "--disp-high", "16",
            "--out", str(tmp_path / "seq" / "d.png")]
    dense_dir = tmp_path / "dense"
    assert cli_main(base + ["--densify", str(dense_dir)]) == 0
    for i in range(3):
        assert (dense_dir / f"dense_{i:04d}.png").exists(), i

    # same frame through the single-pair path -> byte-identical dense PNG
    single = tmp_path / "single_dense.png"
    assert cli_main([os.path.join(FORESTS, "defaultZeroForest.txt"),
                     str(ld / "f1.png"), str(rd / "f1.png"),
                     "--disp-high", "16", "--out", str(tmp_path / "s.png"),
                     "--densify", str(single)]) == 0
    assert single.read_bytes() == \
        (dense_dir / "dense_0001.png").read_bytes()

    # explicitly-requested single-pair-only features are rejected
    # (--pyramid is sequence-supported since r5 — covered by
    # test_cli_sequence_pyramid; its incompatible combos reject there)
    for extra in (["--matcher", "quirk"],
                  ["--repeats", "3"], ["--trace", str(tmp_path / "tr")]):
        assert cli_main(base + extra) == 1, extra


def test_examples_evaluate_smoke(capsys):
    """examples/evaluate.py (the fast-preset tradeoff table) runs through
    its real main at a reduced size: one row per truncation point, the
    1-op/2-op sort routing column matches match._pack_ok, and precision
    stays high at every point."""
    import importlib.util
    import os
    import re

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "evaluate", os.path.join(repo, "examples", "evaluate.py"))
    ev = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ev)
    rc = ev.main(["--height", "128", "--width", "256", "--disp-high", "32",
                  "--tests", "30,17"])
    assert rc == 0
    text = capsys.readouterr().out
    rows = re.findall(r"^\| (\d+) \| (\S+) \| (\d+) \| [\d.]+ \| ([\d.]+) ",
                      text, re.M)
    assert [(r[0], r[1]) for r in rows] == [("30", "2-op"), ("17", "1-op")]
    assert all(int(r[2]) > 1000 and float(r[3]) > 0.99 for r in rows), rows


def test_examples_demo_smoke(tmp_path, capsys):
    """examples/demo.py end-to-end at a reduced size: mine -> train ->
    match -> visualize runs through the real example main, the fresh
    forest reaches exact-disparity precision comparable to the pretrained
    one, and every advertised output file is written."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "demo", os.path.join(repo, "examples", "demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    out = str(tmp_path / "demo")
    demo.main(out, h=128, w=192, num_triplets=600)
    text = capsys.readouterr().out
    assert "mined 600 triplets" in text
    for f in ("left.png", "right.png", "fresh_forest.txt",
              "disparity_fresh.png", "disparity_pretrained.png"):
        assert os.path.exists(os.path.join(out, f)), f
    import re

    precs = [float(m) for m in re.findall(
        r"exact-disparity precision (\d\.\d+)", text)]
    assert len(precs) == 2 and all(p > 0.95 for p in precs), precs


def test_cli_sequence_randomized_policy_fuzz(tmp_path, capfd):
    """Randomized density pattern x batch size x data-parallel x pyramid
    through the sequence CLI's adaptive policy (probe -> compact ->
    overflow guard -> hysteresis -> resume): whatever route each frame
    takes, its supports file must equal an independent non-adaptive
    baseline (a --contract rows sequence run; for pyramid trials a
    single-pair --pyramid run per frame).  The fixed drift patterns in
    the tests above pin specific transitions; this draw covers arbitrary
    interleavings of them.  Seeded; OGPC_FUZZ_SEED / OGPC_FUZZ_TRIALS
    widen the draw for soaks."""
    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.utils.scenes import make_sparse_pair

    seed = int(os.environ.get("OGPC_FUZZ_SEED", 20260819))
    trials = int(os.environ.get("OGPC_FUZZ_TRIALS", 2))
    rng = np.random.default_rng(seed)
    forest = os.path.join(FORESTS, "defaultZeroForest.txt")
    for t in range(trials):
        n = int(rng.integers(5, 11))
        p_dense = float(rng.uniform(0.2, 0.8))
        dense = rng.random(n) < p_dense
        pyramid = bool(rng.integers(0, 2))
        dp = int(rng.choice([1, 2]))
        batch = int(rng.choice([2, 4]) if dp == 2 else rng.integers(1, 5))
        ldir = tmp_path / f"l{t}"
        rdir = tmp_path / f"r{t}"
        ldir.mkdir()
        rdir.mkdir()
        for i in range(n):
            if dense[i]:
                l, r = make_pair(96, 144, 4, seed=1000 * t + i)
            else:
                l, r = make_sparse_pair(
                    96, 144, 4, density=float(rng.uniform(0.08, 0.2)),
                    seed=5000 + 1000 * t + i)
            write_png(str(ldir / f"f{i:04d}.png"), l)
            write_png(str(rdir / f"f{i:04d}.png"), r)
        base = [forest, str(ldir), str(rdir), "--disp-high", "32",
                "--batch", str(batch)]
        if pyramid:
            base += ["--pyramid", "2"]
        if dp == 2:
            base += ["--data-parallel", "2"]
        out = tmp_path / f"out{t}" / "d.png"
        rc = cli_main(base + ["--out", str(out)]
                      + ([] if pyramid else ["--contract", "masked-compact"]))
        err = capfd.readouterr().err
        label = (t, n, p_dense, pyramid, dp, batch)
        assert rc == 0, (label, err)
        # baseline: non-adaptive, frame-for-frame
        want = []
        if pyramid:
            for i in range(n):
                sp = str(tmp_path / f"sp{t}_{i}.txt")
                rc = cli_main([forest, str(ldir / f"f{i:04d}.png"),
                               str(rdir / f"f{i:04d}.png"),
                               "--disp-high", "32", "--pyramid", "2",
                               "--out", str(tmp_path / "sp.png"),
                               "--supports-out", sp])
                capfd.readouterr()
                assert rc == 0, (label, i)
                want.append(sorted(map(tuple, np.loadtxt(
                    sp, dtype=np.int64).reshape(-1, 3).tolist())))
        else:
            rout = tmp_path / f"rows{t}" / "d.png"
            rc = cli_main([forest, str(ldir), str(rdir), "--disp-high",
                           "32", "--contract", "rows", "--out", str(rout)])
            capfd.readouterr()
            assert rc == 0, label
            for i in range(n):
                got = np.loadtxt(
                    str(tmp_path / f"rows{t}" / f"supports_{i:04d}.txt"),
                    dtype=np.int64).reshape(-1, 3)
                want.append(sorted(map(tuple, got.tolist())))
        total = 0
        for i in range(n):
            got = np.loadtxt(
                str(tmp_path / f"out{t}" / f"supports_{i:04d}.txt"),
                dtype=np.int64).reshape(-1, 3)
            assert sorted(map(tuple, got.tolist())) == want[i], (label, i)
            total += len(want[i])
        assert total > 50 * n, (label, total)


def test_cli_input_errors_report_cleanly(tmp_path, capfd):
    """Typed input errors (missing/corrupt files, malformed forests) exit
    1 with a one-line ``error:`` message through every console script
    instead of a raw traceback (the library raises them typed —
    tests/test_formats.py; OGPC_CLI_TRACEBACK=1 re-raises)."""
    import pytest

    from opengpc_tpu.cli.aot import main as aot_main
    from opengpc_tpu.cli.extract import main as ex_main
    from opengpc_tpu.cli.sparsematch import main as sm_main
    from opengpc_tpu.cli.train import main as tr_main
    from opengpc_tpu.io.png import write_png

    l, r = make_pair(64, 96, 4, seed=3)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(lp, l)
    write_png(rp, r)
    bad_forest = str(tmp_path / "bad.txt")
    open(bad_forest, "w").write("not a forest\n")
    bad_png = str(tmp_path / "bad.png")
    open(bad_png, "wb").write(b"\x89PNG\r\n\x1a\nnot really")
    out = str(tmp_path / "o.png")

    cases = [
        (sm_main, [str(tmp_path / "missing.txt"), lp, rp, "--out", out]),
        (sm_main, [bad_forest, lp, rp, "--out", out]),
        (sm_main, ["forests/defaultZeroForest.txt", bad_png, rp,
                   "--out", out]),
        (tr_main, [str(tmp_path / "missing.bin"), str(tmp_path / "f.txt")]),
        (ex_main, [str(tmp_path / "missing_root"), str(tmp_path / "o.bin")]),
        (aot_main, ["export", str(tmp_path / "missing.txt"),
                    str(tmp_path / "a.ogpcx"), "--height", "64",
                    "--width", "96"]),
        (aot_main, ["run", str(tmp_path / "missing.ogpcx"), lp, rp]),
    ]
    for main, argv in cases:
        rc = main(argv)
        err = capfd.readouterr().err
        assert rc == 1, (argv, err)
        assert "error:" in err and "Traceback" not in err, (argv, err)
    # debugging escape hatch: OGPC_CLI_TRACEBACK=1 re-raises
    os.environ["OGPC_CLI_TRACEBACK"] = "1"
    try:
        with pytest.raises(FileNotFoundError):
            sm_main([str(tmp_path / "missing.txt"), lp, rp, "--out", out])
    finally:
        del os.environ["OGPC_CLI_TRACEBACK"]
    capfd.readouterr()


def test_sparsematch_one_call_api():
    """opengpc_tpu.sparsematch (one-call convenience) routes to the
    fastest eligible contract per settings and returns the same support
    set as the flat pipeline on every route: masked (epipolar), segmented
    global (non-epipolar), and the flat fallback (packed keys ineligible
    via a huge disp_high).  Builders are LRU-cached per (forest,
    settings, backend)."""
    from opengpc_tpu import sparsematch
    from opengpc_tpu.infer import _MATCH_FN_CACHE, build_sparsematch

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    l, r = make_pair(72, 104, 4, seed=17)

    for name, settings in (
        ("masked", InferenceSettings(gradient_threshold=5,
                                     epipolar_mode=True, disp_high=32,
                                     capacity=8192)),
        ("global-rows", InferenceSettings(gradient_threshold=5,
                                          epipolar_mode=False, disp_high=32,
                                          capacity=8192)),
        # 2*disp_high needs 25 bits, bx(104)=7 -> bx+bd=32 > 30: flat
        ("flat", InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                   disp_high=1 << 23, capacity=8192)),
    ):
        got = sparsematch(l, r, forest, settings)
        # the route actually taken is recorded in the cache key's tail
        assert name in {k[-1] for k in _MATCH_FN_CACHE}, name
        want = supports_to_numpy(*build_sparsematch(
            forest, settings)(l, r))
        assert sorted(map(tuple, got.tolist())) == \
            sorted(map(tuple, want.tolist())), name
        assert len(want) > 20, name
        # second call reuses the cached builder (no retrace)
        n_cached = len(_MATCH_FN_CACHE)
        again = sparsematch(l, r, forest, settings)
        assert len(_MATCH_FN_CACHE) == n_cached, name
        np.testing.assert_array_equal(again, got)

    # flat fallback overflow is an error, never silent truncation
    tiny = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                             disp_high=1 << 23, capacity=8)
    import pytest

    with pytest.raises(ValueError, match="exceed settings.capacity"):
        sparsematch(l, r, forest, tiny)

    # mismatched shapes are a clear error
    with pytest.raises(ValueError, match="shapes differ"):
        sparsematch(l, r[:, :64], forest,
                    InferenceSettings(epipolar_mode=True))

    # a float imread must be rejected, not silently return garbage
    with pytest.raises(ValueError, match="uint8"):
        sparsematch(l.astype(np.float64) / 255.0, r.astype(np.float64),
                    forest, InferenceSettings(epipolar_mode=True))

    # rank-4 input is a clear error (batches themselves are supported —
    # test_sparsematch_one_call_batched)
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        sparsematch(np.stack([l, l])[None], np.stack([r, r])[None],
                    forest, InferenceSettings(epipolar_mode=True))


def test_sparsematch_one_call_pyramid():
    """sparsematch(levels=N) routes to the coarse-to-fine pyramid and
    returns the (n, 4) (x, y, d, level) rows of
    build_pyramid_sparsematch + pyramid_supports_to_numpy (finest-wins
    dedup, level-0 coordinates); the builder is LRU-cached like the
    single-scale routes."""
    import pytest

    from opengpc_tpu import sparsematch
    from opengpc_tpu.infer import _MATCH_FN_CACHE
    from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                     pyramid_supports_to_numpy)

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    l, r = make_pair(96, 128, 4, seed=23)
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 disp_high=32, capacity=16384)

    got = sparsematch(l, r, forest, settings, levels=3)
    assert got.shape[1] == 4 and got.dtype == np.int32
    assert "pyramid-3" in {k[-1] for k in _MATCH_FN_CACHE}
    want = pyramid_supports_to_numpy(*build_pyramid_sparsematch(
        forest, settings, num_levels=3)(l, r))
    assert sorted(map(tuple, got.tolist())) == \
        sorted(map(tuple, want.tolist()))
    # multi-scale adds coverage: some supports come from coarser levels
    assert set(np.unique(got[:, 3])) > {0}
    assert len(got) > 50
    # at most one support per (x, y): finest-level-wins dedup
    assert len({(x, y) for x, y, _, _ in got.tolist()}) == len(got)
    # cached on the second call
    n_cached = len(_MATCH_FN_CACHE)
    again = sparsematch(l, r, forest, settings, levels=3)
    assert len(_MATCH_FN_CACHE) == n_cached
    np.testing.assert_array_equal(again, got)
    # levels=1 keeps the (n, 3) single-scale contract, and its support
    # set is exactly the pyramid's level-0 rows (finest-wins never drops
    # a level-0 support)
    single = sparsematch(l, r, forest, settings)
    assert single.shape[1] == 3
    assert sorted(map(tuple, single.tolist())) == sorted(
        (x, y, d) for x, y, d, lv in got.tolist() if lv == 0)

    with pytest.raises(ValueError, match="levels"):
        sparsematch(l, r, forest, settings, levels=0)


def test_sparsematch_one_call_batched(tmp_path):
    """sparsematch() takes (B, H, W) stacks — or lists of paths/arrays,
    stacked for it — and returns a length-B list of per-pair support
    arrays, equal pair-for-pair to B single-pair calls on every route
    (masked / global-rows / flat fallback / pyramid).  One batched
    dispatch + one host fetch per output leaf instead of B round-trips."""
    import pytest

    from opengpc_tpu import sparsematch
    from opengpc_tpu.io import write_png

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    pairs = [make_pair(72, 104, 4, seed=s) for s in (41, 42, 43)]
    L = np.stack([p[0] for p in pairs])
    R = np.stack([p[1] for p in pairs])

    for name, settings, lv in (
        ("masked", InferenceSettings(gradient_threshold=5,
                                     epipolar_mode=True, disp_high=32,
                                     capacity=8192), 1),
        ("global-rows", InferenceSettings(gradient_threshold=5,
                                          epipolar_mode=False, disp_high=32,
                                          capacity=8192), 1),
        ("flat", InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                   disp_high=1 << 23, capacity=8192), 1),
        ("pyramid", InferenceSettings(gradient_threshold=5,
                                      epipolar_mode=True, disp_high=32,
                                      capacity=16384), 3),
        # global mode excludes the rows pyramid -> the lax.map'd lossless
        # flat fallback, batched (the one route combination the table
        # above misses)
        ("pyramid-global", InferenceSettings(gradient_threshold=5,
                                             epipolar_mode=False,
                                             disp_high=32,
                                             capacity=16384), 3),
    ):
        got = sparsematch(L, R, forest, settings,
                          levels=lv)
        assert isinstance(got, list) and len(got) == len(pairs), name
        for i, (l, r) in enumerate(pairs):
            want = sparsematch(l, r, forest, settings,
                               levels=lv)
            assert sorted(map(tuple, got[i].tolist())) == \
                sorted(map(tuple, want.tolist())), (name, i)
            assert len(got[i]) > 20, (name, i)

    # lists of paths (and mixed path/array lists) stack into the batch
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 disp_high=32, capacity=8192)
    lp, rp = str(tmp_path / "l0.png"), str(tmp_path / "r0.png")
    write_png(lp, pairs[0][0])
    write_png(rp, pairs[0][1])
    got = sparsematch([lp, pairs[1][0]], [rp, pairs[1][1]], forest,
                      settings)
    assert isinstance(got, list) and len(got) == 2
    for i in range(2):
        want = sparsematch(*pairs[i], forest, settings)
        np.testing.assert_array_equal(got[i], want)

    # per-pair flat overflow names the offending pair indices
    tiny = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                             disp_high=1 << 23, capacity=8)
    with pytest.raises(ValueError, match=r"pair\(s\) \[0, 1, 2\]"):
        sparsematch(L, R, forest, tiny)

    # mismatched frame shapes inside a list are a clear error
    with pytest.raises(ValueError, match="differing shapes"):
        sparsematch([pairs[0][0], pairs[1][0][:, :64]],
                    [pairs[0][1], pairs[1][1][:, :64]], forest, settings)


def test_builders_reject_non_uint8():
    """Builders share the one-call API's dtype guard: a float image
    through build_sparsematch_* used to SILENTLY return zero supports
    (sobel/box are uint8-exact reference semantics) — now every
    builder's preprocessing entry raises a typed trace-time error."""
    import pytest

    from opengpc_tpu.infer import (build_sparsematch,
                                   build_sparsematch_global_rows,
                                   build_sparsematch_masked)

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    l, r = make_pair(48, 72, 3, seed=9)
    fl, fr = l.astype(np.float32) / 255.0, r.astype(np.float32) / 255.0
    for build, st in (
        (build_sparsematch_masked,
         InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                           disp_high=32)),
        (build_sparsematch,
         InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                           disp_high=32)),
        (build_sparsematch_global_rows,
         InferenceSettings(gradient_threshold=5, epipolar_mode=False,
                           disp_high=32)),
    ):
        fn = build(forest, st)
        with pytest.raises(ValueError, match="uint8"):
            fn(fl, fr)
        # uint8 still flows (the guard is dtype-only)
        out = fn(l, r)
        assert out is not None


def test_sparsematch_one_call_thread_safety():
    """The one-call caches are shared process state and serving loops
    call sparsematch from worker threads: hammer the API from 8 threads
    with a cache bound small enough to force evictions mid-flight — an
    unlocked OrderedDict corrupts (move_to_end/popitem races), the
    _LruCache must return per-call arrays identical to serial calls."""
    from concurrent.futures import ThreadPoolExecutor

    from opengpc_tpu import sparsematch
    from opengpc_tpu.infer import _MATCH_FN_CACHE

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    l, r = make_pair(48, 72, 3, seed=55)
    settings = [InferenceSettings(gradient_threshold=g, epipolar_mode=True,
                                  disp_high=32, capacity=4096)
                for g in (3, 4, 5, 6, 7, 8)]
    want = [sparsematch(l, r, forest, s)
            for s in settings]
    old_max = _MATCH_FN_CACHE._max
    _MATCH_FN_CACHE._max = 2  # evictions + rebuilds under contention
    try:
        with ThreadPoolExecutor(max_workers=8) as ex:
            futs = [ex.submit(sparsematch, l, r, forest,
                              settings[i % len(settings)])
                    for i in range(48)]
            got = [f.result() for f in futs]
    finally:
        _MATCH_FN_CACHE._max = old_max
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, want[i % len(settings)])


def test_sparsematch_one_call_path_inputs(tmp_path):
    """sparsematch() accepts PNG paths for the images and a text path
    for the forest (the reference's samples/sparsematch.cpp workflow in
    one line); identical output to the array form, forest parse cached
    by (realpath, mtime, size)."""
    from pathlib import Path

    from opengpc_tpu import sparsematch
    from opengpc_tpu.infer import _FOREST_CACHE
    from opengpc_tpu.io import write_png

    fpath = os.path.join(FORESTS, "defaultZeroForest.txt")
    forest = load_forest(fpath)
    l, r = make_pair(64, 96, 3, seed=17)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(lp, l)
    write_png(rp, r)
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True)

    want = sparsematch(l, r, forest, settings)
    got = sparsematch(lp, rp, fpath, settings)
    np.testing.assert_array_equal(got, want)
    # pathlib.Path works too, and the forest parse is cached
    n_cached = len(_FOREST_CACHE)
    again = sparsematch(Path(lp), Path(rp), Path(fpath), settings)
    np.testing.assert_array_equal(again, want)
    assert len(_FOREST_CACHE) == n_cached
    # a missing file surfaces as the codec's own error, not a crash
    import pytest
    with pytest.raises((IOError, OSError)):
        sparsematch(str(tmp_path / "nope.png"), rp, fpath, settings)
    # a replaced forest file is picked up on the next call (the cache
    # keys on (realpath, mtime, size) — a stale entry would silently
    # keep matching with the OLD forest)
    import shutil

    other_path = os.path.join(FORESTS, "defaultTauForest.txt")
    other = load_forest(other_path)
    moved = str(tmp_path / "forest.txt")
    shutil.copyfile(fpath, moved)
    first = sparsematch(lp, rp, moved, settings)
    np.testing.assert_array_equal(first, want)
    shutil.copyfile(other_path, moved)
    swapped = sparsematch(lp, rp, moved, settings)
    want_other = sparsematch(l, r, other, settings)
    np.testing.assert_array_equal(swapped, want_other)
    # >=4 path entries take the 8-worker pool decode (the size gate in
    # infer._image_arg; below 4 the pool spawn costs more than the
    # decodes it overlaps) — same outputs as the array batch
    pairs4 = [make_pair(64, 96, 3, seed=100 + s) for s in range(4)]
    lps, rps = [], []
    for i, (li, ri) in enumerate(pairs4):
        lps.append(str(tmp_path / f"pl{i}.png"))
        rps.append(str(tmp_path / f"pr{i}.png"))
        write_png(lps[-1], li)
        write_png(rps[-1], ri)
    got4 = sparsematch(lps, rps, fpath, settings)
    want4 = sparsematch(np.stack([p[0] for p in pairs4]),
                        np.stack([p[1] for p in pairs4]),
                        forest, settings)
    assert len(got4) == 4
    for g, w in zip(got4, want4):
        np.testing.assert_array_equal(g, w)


def test_sparsematch_one_call_routing_fuzz():
    """Randomized routing fuzz for the one-call API: whatever contract
    the eligibility rules pick (masked / global-rows / flat), the
    decoded set must equal the flat fixed-capacity truth for the same
    settings.  This pins the ROUTE CHOICE logic — each contract's own
    correctness is oracle-gated elsewhere."""
    import dataclasses

    from opengpc_tpu import sparsematch
    from opengpc_tpu.infer import build_sparsematch

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    rng = np.random.default_rng(int(os.environ.get("OGPC_FUZZ_SEED", 99)))
    trials = int(os.environ.get("OGPC_FUZZ_TRIALS", 4))
    for t in range(trials):
        h = int(rng.integers(40, 120))
        w = int(rng.integers(64, 300))
        d = int(rng.integers(1, 8))
        l, r = make_pair(h, w, d, seed=1000 + t)
        settings = InferenceSettings(
            gradient_threshold=int(rng.integers(3, 12)),
            vertical_tolerance=int(rng.integers(0, 2)),
            disp_high=int(rng.choice([16, 64, 512, 1 << 23])),
            epipolar_mode=bool(rng.integers(0, 2)),
            capacity=1 << 17,
        )
        got = sparsematch(l, r, forest, settings)
        # flat truth: same settings, flat contract, ample capacity
        flat = build_sparsematch(
            forest, dataclasses.replace(settings, capacity=1 << 17))
        xs, ys, ds, count = flat(l, r)
        n = int(count)
        assert n <= 1 << 17
        want = sorted(zip(np.asarray(xs)[:n].tolist(),
                          np.asarray(ys)[:n].tolist(),
                          np.asarray(ds)[:n].tolist()))
        assert sorted(map(tuple, got.tolist())) == want, \
            (t, settings, len(got), n)


def test_sparsematch_pyramid_fallback_lossless():
    """The non-rows-eligible pyramid fallback (global mode) used to trim
    each level at settings.capacity while recomputing counts post-dedup —
    silent, undetectable truncation.  pyramid._pyramid_impl now sizes
    each level's dedup buffer at its one-support-per-source-pixel bound,
    so the one-call result is identical whether the caller passed a tiny
    or a huge capacity."""
    from opengpc_tpu import sparsematch
    from opengpc_tpu.forest import make_filter_mask
    from opengpc_tpu.pyramid import _rows_eligible

    forest = load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))
    l, r = make_pair(96, 128, 4, seed=31)
    tiny = InferenceSettings(gradient_threshold=5, epipolar_mode=False,
                             capacity=8)
    big = InferenceSettings(gradient_threshold=5, epipolar_mode=False,
                            capacity=96 * 128)
    # global mode is the fallback route
    assert _rows_eligible(make_filter_mask(forest), tiny, 96, 128, 2) \
        is None
    got_tiny = sparsematch(l, r, forest, tiny, levels=2)
    got_big = sparsematch(l, r, forest, big, levels=2)
    assert len(got_tiny) > 8  # capacity=8 did NOT truncate
    assert sorted(map(tuple, got_tiny.tolist())) == \
        sorted(map(tuple, got_big.tolist()))


def test_sparsematch_one_call_empty_batch_list():
    """An empty batch list (e.g. a glob that matched nothing) gets a
    clear empty-batch error, not the misleading 'differing shapes: []'
    message."""
    from opengpc_tpu import sparsematch

    fpath = os.path.join(FORESTS, "defaultZeroForest.txt")
    with pytest.raises(ValueError, match="empty batch"):
        sparsematch([], [], fpath,
                    InferenceSettings(gradient_threshold=5,
                                      epipolar_mode=True))


def test_forest_cache_swap_during_parse(tmp_path, monkeypatch):
    """_load_forest_cached's stat-then-parse TOCTOU: a swap landing
    between the stat and the read used to cache the NEW content under
    the OLD (mtime, size) key — a later restore of the original file
    with its mtime preserved (mv of a kept copy / rsync -a / copystat)
    would then silently serve the wrong forest.  The re-stat-after-parse
    retry must discard the suspect entry and serve the file's CURRENT
    content at every step."""
    import shutil

    import opengpc_tpu.forest as forest_mod
    from opengpc_tpu.forest import serialize_forest
    from opengpc_tpu.infer import _load_forest_cached

    a = os.path.join(FORESTS, "defaultZeroForest.txt")
    b = os.path.join(FORESTS, "defaultTauForest.txt")
    sa = serialize_forest(load_forest(a))
    sb = serialize_forest(load_forest(b))
    p = str(tmp_path / "f.txt")
    shutil.copyfile(a, p)
    st_a = os.stat(p)

    real_load = forest_mod.load_forest
    swapped = {"done": False}

    def swap_then_load(path):
        if not swapped["done"]:
            swapped["done"] = True
            shutil.copyfile(b, path)  # the swap lands mid-parse
        return real_load(path)

    monkeypatch.setattr(forest_mod, "load_forest", swap_then_load)
    got = _load_forest_cached(p)
    # the retry re-stats, sees the key changed, and returns the CURRENT
    # (post-swap) content
    assert serialize_forest(got) == sb
    # restore the original file with its exact pre-swap (mtime, size) —
    # a poisoned cache entry would serve forest B here
    shutil.copyfile(a, p)
    os.utime(p, ns=(st_a.st_atime_ns, st_a.st_mtime_ns))
    back = _load_forest_cached(p)
    assert serialize_forest(back) == sa

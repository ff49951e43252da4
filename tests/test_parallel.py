"""Multi-device sharding tests (8 virtual CPU devices, conftest.py)."""

import jax
import numpy as np

from opengpc_tpu.parallel import build_batched_sparsematch, make_mesh


def test_devices_available():
    assert len(jax.devices()) == 8
    assert jax.devices()[0].platform == "cpu"


def test_dryrun_multichip():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from __graft_entry__ import dryrun_multichip, entry

    fn, args = entry()
    out = jax.jit(fn)(*args)
    assert int(out[3]) > 0
    dryrun_multichip(8)


def test_sharded_matches_single_device():
    """Sharded batched run == per-pair single-device runs."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch, supports_to_numpy

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests", "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )

    rng = np.random.default_rng(3)
    b, h, w = 8, 48, 80
    small = rng.integers(0, 256, (b, h // 4 + 1, w // 4 + 1))
    lefts = np.stack(
        [np.kron(s, np.ones((4, 4)))[:h, :w] for s in small]
    ).astype(np.uint8)
    rights = np.roll(lefts, -3, axis=2)

    mesh = make_mesh()
    sharded = build_batched_sparsematch(forest, settings, mesh)
    bx, by, bd, bcount = sharded(lefts, rights)

    single = build_sparsematch(forest, settings)
    for k in range(b):
        xs, ys, ds, count = single(lefts[k], rights[k])
        want = set(map(tuple, supports_to_numpy(xs, ys, ds, count).tolist()))
        got = set(
            map(tuple, supports_to_numpy(bx[k], by[k], bd[k], bcount[k]).tolist())
        )
        assert got == want


def test_sharded_rows_matches_single_device():
    """Row-form sharded batched run == per-pair single-device flat runs."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch, row_supports_to_numpy,
                                   supports_to_numpy)
    from opengpc_tpu.parallel import build_batched_sparsematch_rows

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests", "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )

    rng = np.random.default_rng(4)
    b, h, w = 8, 48, 80
    small = rng.integers(0, 256, (b, h // 4 + 1, w // 4 + 1))
    lefts = np.stack(
        [np.kron(s, np.ones((4, 4)))[:h, :w] for s in small]
    ).astype(np.uint8)
    rights = np.roll(lefts, -3, axis=2)

    mesh = make_mesh()
    sharded = build_batched_sparsematch_rows(forest, settings, mesh)
    (bxs, bds), bcounts = sharded(lefts, rights)
    assert bxs.shape == (b, h, w) and bcounts.shape == (b, h)

    single = build_sparsematch(forest, settings)
    for k in range(b):
        want = set(map(tuple, supports_to_numpy(*single(lefts[k], rights[k])).tolist()))
        got = set(map(tuple, row_supports_to_numpy(
            bxs[k], bds[k], bcounts[k]).tolist()))
        assert got == want and len(want) > 0


def test_sharded_training_matches_single_device():
    """Sharded fern training selects identical splits to single-device."""
    import numpy as np

    from opengpc_tpu.config import zero_optimizer, tau_optimizer
    from opengpc_tpu.forest import SCALE_L
    from opengpc_tpu.train import sample_candidates, train_fern

    rng = np.random.default_rng(11)
    n = 200
    ref = rng.integers(0, 256, (n, 729)).astype(np.int16)
    pos = np.clip(ref + rng.integers(-8, 9, ref.shape), 0, 255)
    neg = rng.integers(0, 256, ref.shape)
    trips = np.stack([ref, pos, neg], axis=1).astype(np.uint8)

    opt = tau_optimizer(num_resamples=4)
    cands = [sample_candidates(rng, SCALE_L, 4) for _ in range(3)]
    fern_single, stats_single = train_fern(
        trips, SCALE_L, opt, 3, candidates=cands, verbose=False
    )
    fern_sharded, stats_sharded = train_fern(
        trips, SCALE_L, opt, 3, candidates=cands, verbose=False,
        mesh=make_mesh(),
    )
    assert fern_single == fern_sharded
    for a, b in zip(stats_single, stats_sharded):
        assert (a.i, a.j, a.tau, a.tp, a.fp, a.fn) == (b.i, b.j, b.tau, b.tp, b.fp, b.fn)


def test_sharded_global_rows_matches_single_device():
    """Sharded global segmented contract == single-device flat global."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch,
                                   global_row_supports_to_numpy,
                                   supports_to_numpy)
    from opengpc_tpu.parallel import build_batched_sparsematch_global_rows

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=False, disp_high=64,
        vertical_tolerance=1, capacity=8192,
    )
    rng = np.random.default_rng(6)
    b, h, w = 8, 48, 80
    small = rng.integers(0, 256, (b, h // 4 + 1, w // 4 + 1))
    lefts = np.stack(
        [np.kron(s, np.ones((4, 4)))[:h, :w] for s in small]
    ).astype(np.uint8)
    rights = np.roll(lefts, -3, axis=2)

    mesh = make_mesh()
    sharded = build_batched_sparsematch_global_rows(forest, settings, mesh)
    (bxs, bys, bds), bcounts = sharded(lefts, rights)
    single = build_sparsematch(forest, settings)
    for k in range(b):
        want = set(map(tuple, supports_to_numpy(
            *single(lefts[k], rights[k])).tolist()))
        got = set(map(tuple, global_row_supports_to_numpy(
            bxs[k], bys[k], bds[k], bcounts[k]).tolist()))
        assert got == want and len(want) > 0


def test_sharded_masked_matches_single_device():
    """Sharded masked sorted-order contract == single-device flat runs."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch,
                                   masked_supports_to_numpy,
                                   supports_to_numpy)
    from opengpc_tpu.parallel import build_batched_sparsematch_masked

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    rng = np.random.default_rng(7)
    b, h, w = 8, 48, 80
    small = rng.integers(0, 256, (b, h // 4 + 1, w // 4 + 1))
    lefts = np.stack(
        [np.kron(s, np.ones((4, 4)))[:h, :w] for s in small]
    ).astype(np.uint8)
    rights = np.roll(lefts, -3, axis=2)

    mesh = make_mesh()
    sharded = build_batched_sparsematch_masked(forest, settings, mesh)
    bufs, counts = sharded(lefts, rights)
    assert bufs.shape == (b, h, 2 * w) and counts.shape == (b, h)
    single = build_sparsematch(forest, settings)
    for k in range(b):
        want = set(map(tuple, supports_to_numpy(
            *single(lefts[k], rights[k])).tolist()))
        got = set(map(tuple, masked_supports_to_numpy(
            bufs[k], counts[k], settings.disp_high).tolist()))
        assert got == want and len(want) > 0


def test_multiprocess_mesh_e2e(tmp_path):
    """Simulated multi-HOST run: two separate processes (2 virtual CPU
    devices each) form one 4-device mesh via parallel.init_distributed
    (coordinator + cross-process collectives — the single-machine analog
    of a multi-host mesh).  The sharded batched matcher must
    produce per-shard supports identical to single-device runs in BOTH
    processes (each validates its local shards).  Also ships an AOT
    sharded-frame artifact exported HERE (a third, single-process "host")
    for the workers to serve over their multi-process mesh."""
    import os
    import socket
    import subprocess
    import sys

    import jax

    from opengpc_tpu.aot import export_sharded_frame, save_artifact
    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.parallel import make_mesh

    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=16, epipolar_mode=True,
                                 capacity=8192)
    forest = load_forest(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "forests", "defaultZeroForest.txt"))
    art = str(tmp_path / "pod.ogpcx")
    blob = export_sharded_frame(forest, settings, (64, 96),
                                make_mesh(jax.devices()[:4]),
                                contract="masked")
    save_artifact(art, blob, contract="masked", settings=settings,
                  shape=(64, 96), extra={"n_devices": 4})

    with socket.socket() as s:  # free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "multihost_worker.py")
    env = {**os.environ}
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen([sys.executable, worker, str(i), str(port), art],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i}:\n{out[-2000:]}"
        assert "supports identical" in out, f"proc {i}:\n{out[-2000:]}"
        assert "sharded-frame local rows identical" in out, \
            f"proc {i}:\n{out[-2000:]}"
        assert "cross-process sharded training identical" in out, \
            f"proc {i}:\n{out[-2000:]}"
        assert "AOT artifact served across processes identical" in out, \
            f"proc {i}:\n{out[-2000:]}"


def _frame_pair(seed, h, w):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1))
    left = np.kron(small, np.ones((4, 4)))[:h, :w].astype(np.uint8)
    return left, np.roll(left, -3, axis=1)


def test_sharded_frame_masked_matches_single_device():
    """ONE frame's rows sharded over 8 chips (masked contract) == the
    single-device masked matcher, bit for bit (VERDICT r3 item 1)."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    h, w = 128, 96  # 16 rows/shard on 8 devices — every shard hits halos
    left, right = _frame_pair(21, h, w)

    mesh = make_mesh()
    sharded = build_sharded_frame_sparsematch(forest, settings, mesh)
    buf, counts = sharded(left, right)
    single = build_sparsematch_masked(forest, settings)
    sbuf, scounts = single(left, right)
    assert int(np.asarray(counts).sum()) > 50
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(scounts))
    np.testing.assert_array_equal(np.asarray(buf), np.asarray(sbuf))


def test_sharded_frame_rows_matches_single_device():
    """Row-form sharded-frame contract == single-device row-form."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_rows
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultTauForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    h, w = 128, 120  # 16 rows/shard on 8 devices
    left, right = _frame_pair(22, h, w)

    mesh = make_mesh()
    sharded = build_sharded_frame_sparsematch(forest, settings, mesh,
                                              contract="rows")
    (xs, ds), counts = sharded(left, right)
    single = build_sparsematch_rows(forest, settings)
    (sxs, sds), scounts = single(left, right)
    assert int(np.asarray(counts).sum()) > 20
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(scounts))
    np.testing.assert_array_equal(np.asarray(xs), np.asarray(sxs))
    np.testing.assert_array_equal(np.asarray(ds), np.asarray(sds))


def test_sharded_frame_pallas_interpret_matches_jnp():
    """The slab key image (infer._key_image_jnp_slab) inside shard_map,
    at a shape whose shards are not tile-aligned, == single-device."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    h, w = 128, 80
    left, right = _frame_pair(23, h, w)

    mesh = make_mesh()
    sharded = build_sharded_frame_sparsematch(forest, settings, mesh)
    buf, counts = sharded(left, right)
    single = build_sparsematch_masked(forest, settings)
    sbuf, scounts = single(left, right)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(scounts))
    np.testing.assert_array_equal(np.asarray(buf), np.asarray(sbuf))


def test_sharded_frame_rejects_bad_inputs():
    import os

    import pytest

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    mesh = make_mesh()
    with pytest.raises(ValueError, match="contract"):
        build_sharded_frame_sparsematch(forest, settings, mesh,
                                        contract="global")
    run = build_sharded_frame_sparsematch(forest, settings, mesh)
    left, right = _frame_pair(24, 100, 64)  # 100 % 8 != 0
    with pytest.raises(ValueError, match="divide"):
        run(left, right)
    gsettings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=False, disp_high=64, capacity=8192
    )
    grun = build_sharded_frame_sparsematch(forest, gsettings, mesh)
    l2, r2 = _frame_pair(25, 128, 64)
    with pytest.raises(ValueError, match="epipolar"):
        grun(l2, r2)
    l3, r3 = _frame_pair(26, 64, 64)  # 8 rows/shard < the 14-row halo
    with pytest.raises(ValueError, match="halo"):
        run(l3, r3)


def _pyramid_forest_settings(disp_high=32, capacity=65536):
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, vertical_tolerance=0,
        disp_high=disp_high, capacity=capacity)
    return forest, settings


def test_sharded_frame_pyramid_matches_single_device():
    """ONE frame's rows sharded over 8 chips at EVERY pyramid level
    (VERDICT r4 #2c) == the single-device pyramid: identical support set
    and per-level counts.  2 levels on the 8-device mesh (coarsest slab
    14 rows == the 14-row halo minimum)."""
    from opengpc_tpu.parallel import build_sharded_frame_pyramid
    from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                     pyramid_supports_to_numpy)

    forest, settings = _pyramid_forest_settings()
    left, right = _frame_pair(41, 224, 96)
    mesh = make_mesh()
    sharded = build_sharded_frame_pyramid(forest, settings, mesh,
                                          num_levels=2)
    out = sharded(left, right)
    single = build_pyramid_sparsematch(forest, settings, num_levels=2)(left, right)
    got = set(map(tuple, pyramid_supports_to_numpy(*out).tolist()))
    want = set(map(tuple, pyramid_supports_to_numpy(*single).tolist()))
    assert len(want) > 100
    assert got == want
    np.testing.assert_array_equal(np.asarray(out[4]), np.asarray(single[4]))
    # the coarse level must actually contribute (otherwise this test
    # wouldn't exercise the cross-level alignment at all)
    assert int(np.asarray(out[4])[1]) > 0


def test_sharded_frame_pyramid_three_levels_four_devices():
    """3 levels on a 4-device mesh (coarsest slab 14 rows == the halo
    minimum) — exercises two rounds of slab downscaling + per-level
    halos."""
    from opengpc_tpu.parallel import build_sharded_frame_pyramid
    from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                     pyramid_supports_to_numpy)

    forest, settings = _pyramid_forest_settings()
    left, right = _frame_pair(42, 224, 80)
    mesh = make_mesh(jax.devices()[:4])
    sharded = build_sharded_frame_pyramid(forest, settings, mesh,
                                          num_levels=3)
    out = sharded(left, right)
    single = build_pyramid_sparsematch(forest, settings, num_levels=3)(left, right)
    got = set(map(tuple, pyramid_supports_to_numpy(*out).tolist()))
    want = set(map(tuple, pyramid_supports_to_numpy(*single).tolist()))
    assert got == want
    np.testing.assert_array_equal(np.asarray(out[4]), np.asarray(single[4]))


def test_sharded_frame_pyramid_pallas_interpret_matches_jnp():
    """The slab key image inside the sharded pyramid == the single-device
    pyramid: same per-level counts and support set (buffer order is
    per-chip, so it is compared as a set)."""
    from opengpc_tpu.parallel import build_sharded_frame_pyramid
    from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                     pyramid_supports_to_numpy)

    forest, settings = _pyramid_forest_settings()
    left, right = _frame_pair(43, 224, 96)
    mesh = make_mesh()
    a = build_sharded_frame_pyramid(forest, settings, mesh,
                                    num_levels=2)(left, right)
    b = build_pyramid_sparsematch(forest, settings,
                                  num_levels=2)(left, right)
    np.testing.assert_array_equal(np.asarray(a[4]), np.asarray(b[4]))
    got = set(map(tuple, pyramid_supports_to_numpy(*a).tolist()))
    want = set(map(tuple, pyramid_supports_to_numpy(*b).tolist()))
    assert got == want and len(want) > 0


def test_sharded_frame_pyramid_rejects_bad_inputs():
    import dataclasses

    import pytest

    from opengpc_tpu.parallel import build_sharded_frame_pyramid

    forest, settings = _pyramid_forest_settings()
    mesh = make_mesh()
    with pytest.raises(ValueError, match="epipolar"):
        build_sharded_frame_pyramid(
            forest, dataclasses.replace(settings, epipolar_mode=False,
                                        vertical_tolerance=1), mesh)
    run = build_sharded_frame_pyramid(forest, settings, mesh, num_levels=2)
    left, right = _frame_pair(44, 200, 64)  # 200 % (8*2) != 0
    with pytest.raises(ValueError, match="divide"):
        run(left, right)
    l2, r2 = _frame_pair(45, 128, 64)  # coarsest slab 8 < 14-row halo
    with pytest.raises(ValueError, match="halo"):
        run(l2, r2)


def test_cli_single_pair_sharded_pyramid(tmp_path, capfd):
    """--pyramid N --shard-frame 8 through the real argv main: supports
    file equal to the single-device pyramid run; misaligned heights and
    --global-mode are rejected with the friendly message."""
    import os

    import numpy as np

    from opengpc_tpu.cli.sparsematch import main as cli_main
    from opengpc_tpu.io.png import write_png

    left, right = _frame_pair(46, 224, 96)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(lp, left)
    write_png(rp, right)
    forest = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "forests", "defaultZeroForest.txt")
    outs = {}
    for label, extra in (("shard", ["--shard-frame", "8"]), ("single", [])):
        sp = str(tmp_path / f"s_{label}.txt")
        rc = cli_main([forest, lp, rp, "--disp-high", "32", "--pyramid",
                       "2", "--out", str(tmp_path / f"d_{label}.png"),
                       "--supports-out", sp] + extra)
        assert rc == 0, (label, capfd.readouterr().err)
        outs[label] = set(map(tuple, np.loadtxt(
            sp, dtype=int).reshape(-1, 3).tolist()))
    assert outs["shard"] == outs["single"] and len(outs["single"]) > 100

    rc = cli_main([forest, lp, rp, "--pyramid", "4", "--shard-frame", "8",
                   "--out", str(tmp_path / "x.png")])
    assert rc == 1 and "divisible by 64" in capfd.readouterr().err
    rc = cli_main([forest, lp, rp, "--pyramid", "2", "--shard-frame", "8",
                   "--global-mode", "--out", str(tmp_path / "x.png")])
    assert rc == 1 and "--global-mode" in capfd.readouterr().err


def test_sharded_masked_compact_matches_single_device():
    """Sharded chunk-compacted masked contract == single-device flat runs
    on a low-density batch (no overflow)."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch,
                                   masked_supports_to_numpy,
                                   supports_to_numpy)
    from opengpc_tpu.parallel import build_batched_sparsematch_masked_compact
    from opengpc_tpu.utils.scenes import make_sparse_pair

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    b, h, w = 8, 96, 128
    pairs = [make_sparse_pair(h, w, 3, density=0.15, seed=50 + i)
             for i in range(b)]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])

    mesh = make_mesh()
    sharded = build_batched_sparsematch_masked_compact(
        forest, settings, mesh)
    bufs, counts, ovf = sharded(lefts, rights)
    assert not bool(np.asarray(ovf).any())
    single = build_sparsematch(forest, settings)
    for i in range(b):
        want = set(map(tuple, supports_to_numpy(
            *single(lefts[i], rights[i])).tolist()))
        got = set(map(tuple, masked_supports_to_numpy(
            np.asarray(bufs)[i], np.asarray(counts)[i],
            settings.disp_high).tolist()))
        assert got == want and len(want) > 20, i


def test_sharded_global_compact_matches_single_device():
    """Sharded chunk-compacted GLOBAL contract (r4) == single-device flat
    global runs on a low-density batch; a dense pair in the batch flags
    only its own per-pair overflow."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch,
                                   global_row_supports_to_numpy,
                                   supports_to_numpy)
    from opengpc_tpu.parallel import build_batched_sparsematch_global_compact
    from opengpc_tpu.utils.scenes import make_pair, make_sparse_pair

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=False, disp_high=64,
        capacity=8192
    )
    b, h, w = 8, 96, 128
    pairs = [make_sparse_pair(h, w, 3, density=0.15, seed=70 + i)
             for i in range(b - 1)] + [make_pair(h, w, 3, seed=70)]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])

    mesh = make_mesh()
    sharded = build_batched_sparsematch_global_compact(
        forest, settings, mesh)
    (xs, ys, ds), counts, ovf = sharded(lefts, rights)
    ovf = np.asarray(ovf)
    # flags are PER PAIR: the dense pair must flag, most sparse pairs must
    # not (a locally patch-heavy sparse pair may legitimately flag at this
    # narrow width), and every unflagged pair must be exact
    assert bool(ovf[-1])
    assert (~ovf[:-1]).sum() >= (b - 1) // 2, ovf
    single = build_sparsematch(forest, settings)
    checked = 0
    for i in range(b - 1):
        if bool(ovf[i]):
            continue
        want = set(map(tuple, supports_to_numpy(
            *single(lefts[i], rights[i])).tolist()))
        got = set(map(tuple, global_row_supports_to_numpy(
            np.asarray(xs)[i], np.asarray(ys)[i], np.asarray(ds)[i],
            np.asarray(counts)[i]).tolist()))
        assert got == want and len(want) > 20, i
        checked += 1
    assert checked >= (b - 1) // 2


def test_sharded_frame_masked_compact_matches_single_device():
    """ONE frame's rows sharded over 8 chips on the chunk-compacted
    contract (r4): bit-equal buffers/counts to the single-device compact
    matcher on a low-density frame (replicated overflow False), and the
    replicated overflow flag trips on a dense frame."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked_compact
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch
    from opengpc_tpu.utils.scenes import make_sparse_pair

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    h, w = 128, 96  # 16 rows/shard on 8 devices — every shard hits halos
    left, right = make_sparse_pair(h, w, 3, density=0.15)

    mesh = make_mesh()
    sharded = build_sharded_frame_sparsematch(forest, settings, mesh,
                                              contract="masked-compact")
    buf, counts, ovf = sharded(left, right)
    assert not bool(np.asarray(ovf)), "sparse frame must not overflow"
    single = build_sparsematch_masked_compact(forest, settings)
    sbuf, scounts, sovf = single(left, right)
    assert not bool(np.asarray(sovf))
    assert int(np.asarray(counts).sum()) > 50
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(scounts))
    np.testing.assert_array_equal(np.asarray(buf), np.asarray(sbuf))

    # dense frame: any shard's chunk overflow taints the replicated flag
    dl, dr = _frame_pair(21, h, w)
    _, _, dovf = sharded(dl, dr)
    assert bool(np.asarray(dovf)), "dense frame must trip the flag"


def test_cli_train_data_parallel_byte_identical(tmp_path):
    """opengpc-train --data-parallel N (r4): the triplet axis shards over
    the mesh during level scoring and the exported forest file must be
    BYTE-identical to the single-device run — including an odd triplet
    count whose bootstrap subsample does not divide by the device count
    (integer TP/FP/FN psums are exact regardless of sharding)."""
    import numpy as np

    from opengpc_tpu.cli.train import main as train_main
    from opengpc_tpu.io.triplets import save_triplets

    rng = np.random.default_rng(23)
    n = 157  # odd on purpose: 157 * 0.7 = 109 -> uneven 8-way shards
    ref = rng.integers(0, 256, (n, 729)).astype(np.int16)
    pos = np.clip(ref + rng.integers(-8, 9, ref.shape), 0, 255)
    neg = rng.integers(0, 256, ref.shape)
    trips = np.stack([ref, pos, neg], axis=1).astype(np.uint8)
    tp = tmp_path / "trips.bin"
    save_triplets(trips, str(tp))

    args = [str(tp), "", "--num-s", "1", "--num-m", "1", "--num-l", "1",
            "--depth", "3", "--num-resamples", "4", "--seed", "7"]
    single, sharded = tmp_path / "single.txt", tmp_path / "sharded.txt"
    args[1] = str(single)
    assert train_main(list(args)) == 0
    args[1] = str(sharded)
    assert train_main(list(args) + ["--data-parallel", "8"]) == 0
    assert single.read_bytes() == sharded.read_bytes()
    # more devices than visible is rejected
    args[1] = str(tmp_path / "x.txt")
    assert train_main(list(args) + ["--data-parallel", "99"]) == 1


def _frame_batch(seed, b, h, w):
    pairs = [_frame_pair(seed + i, h, w) for i in range(b)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def test_batched_sharded_frame_masked_matches_single_device():
    """(B, H, W) pairs sharded over a 2-D (data, rows) mesh — every frame
    split over 'data', every frame's rows over 'rows' — == the
    single-device masked matcher per frame, bit for bit, on both mesh
    aspect ratios."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked
    from opengpc_tpu.parallel import (build_batched_sharded_frame_sparsematch,
                                      make_mesh_2d)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    b, h, w = 4, 64, 96
    lefts, rights = _frame_batch(31, b, h, w)
    single = build_sparsematch_masked(forest, settings)
    sing = [single(lefts[i], rights[i]) for i in range(b)]

    for n_data, n_rows in ((2, 4), (4, 2)):
        mesh = make_mesh_2d(n_data, n_rows)
        run = build_batched_sharded_frame_sparsematch(
            forest, settings, mesh)
        buf, counts = run(lefts, rights)
        assert buf.shape == (b, h, 2 * w) and counts.shape == (b, h)
        total = int(np.asarray(counts).sum())
        assert total > 100
        for i in range(b):
            np.testing.assert_array_equal(np.asarray(counts[i]),
                                          np.asarray(sing[i][1]))
            np.testing.assert_array_equal(np.asarray(buf[i]),
                                          np.asarray(sing[i][0]))


def test_batched_sharded_frame_rows_and_compact_match():
    """Row-form and chunk-compacted contracts on the 2-D mesh == the
    single-device builders per frame (compact gated on no overflow)."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch_masked_compact,
                                   build_sparsematch_rows)
    from opengpc_tpu.parallel import (build_batched_sharded_frame_sparsematch,
                                      make_mesh_2d)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultTauForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    b, h, w = 2, 64, 128
    lefts, rights = _frame_batch(41, b, h, w)
    mesh = make_mesh_2d(2, 4)

    run_rows = build_batched_sharded_frame_sparsematch(
        forest, settings, mesh, contract="rows")
    (xs, ds), counts = run_rows(lefts, rights)
    single_rows = build_sparsematch_rows(forest, settings)
    for i in range(b):
        (sxs, sds), scounts = single_rows(lefts[i], rights[i])
        np.testing.assert_array_equal(np.asarray(counts[i]),
                                      np.asarray(scounts))
        np.testing.assert_array_equal(np.asarray(xs[i]), np.asarray(sxs))
        np.testing.assert_array_equal(np.asarray(ds[i]), np.asarray(sds))
    assert int(np.asarray(counts).sum()) > 20

    run_c = build_batched_sharded_frame_sparsematch(
        forest, settings, mesh, contract="masked-compact")
    cbuf, ccounts, covf = run_c(lefts, rights)
    assert np.asarray(covf).shape == (2,)
    single_c = build_sparsematch_masked_compact(forest, settings)
    for i in range(b):
        sbuf, scounts, sovf = single_c(lefts[i], rights[i])
        if not (bool(np.asarray(covf)[i]) or bool(np.asarray(sovf))):
            np.testing.assert_array_equal(np.asarray(ccounts[i]),
                                          np.asarray(scounts))
            np.testing.assert_array_equal(np.asarray(cbuf[i]),
                                          np.asarray(sbuf))


def test_batched_sharded_frame_pyramid_matches_single_device():
    """(B, H, W) pyramids over the 2-D (data x rows) mesh (r5, the full
    composition matrix cell): per-frame support set and counts equal the
    single-device pyramid; rejections for bad batch/height."""
    import pytest

    from opengpc_tpu.parallel import (build_batched_sharded_frame_pyramid,
                                      make_mesh_2d)
    from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                     pyramid_supports_to_numpy)

    forest, settings = _pyramid_forest_settings()
    mesh = make_mesh_2d(2, 4)
    pairs = [_frame_pair(50 + b, 112, 96) for b in range(2)]
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    run = build_batched_sharded_frame_pyramid(forest, settings, mesh,
                                              num_levels=2)
    out = run(lb, rb)
    single = build_pyramid_sparsematch(forest, settings, num_levels=2)
    for b in range(2):
        got = set(map(tuple, pyramid_supports_to_numpy(
            *(np.asarray(o)[b] for o in out)).tolist()))
        sout = single(lb[b], rb[b])
        want = set(map(tuple, pyramid_supports_to_numpy(*sout).tolist()))
        assert got == want and len(want) > 50
        np.testing.assert_array_equal(np.asarray(out[4])[b],
                                      np.asarray(sout[4]))
    with pytest.raises(ValueError, match="batch"):
        run(lb[:1], rb[:1])
    l3, r3 = _frame_pair(60, 100, 96)  # 100 % (4*2) != 0
    with pytest.raises(ValueError, match="divide"):
        run(np.stack([l3, l3]), np.stack([r3, r3]))


def test_batched_sharded_frame_pallas_interpret_matches_jnp():
    """Slab key image inside the 2-D shard_map == single-device masked."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked
    from opengpc_tpu.parallel import (build_batched_sharded_frame_sparsematch,
                                      make_mesh_2d)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    b, h, w = 2, 64, 80
    lefts, rights = _frame_batch(51, b, h, w)
    mesh = make_mesh_2d(2, 4)
    run = build_batched_sharded_frame_sparsematch(forest, settings, mesh)
    buf, counts = run(lefts, rights)
    single = build_sparsematch_masked(forest, settings)
    for i in range(b):
        sbuf, scounts = single(lefts[i], rights[i])
        np.testing.assert_array_equal(np.asarray(counts[i]),
                                      np.asarray(scounts))
        np.testing.assert_array_equal(np.asarray(buf[i]), np.asarray(sbuf))


def test_batched_sharded_frame_rejects_bad_inputs():
    import os

    import pytest

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.parallel import (build_batched_sharded_frame_sparsematch,
                                      make_mesh_2d)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    with pytest.raises(ValueError, match="2-D"):
        build_batched_sharded_frame_sparsematch(forest, settings, make_mesh())
    mesh = make_mesh_2d(2, 4)
    run = build_batched_sharded_frame_sparsematch(forest, settings, mesh)
    lefts, rights = _frame_batch(61, 3, 64, 64)  # 3 % 2 != 0
    with pytest.raises(ValueError, match="divide"):
        run(lefts, rights)
    lefts, rights = _frame_batch(62, 2, 66, 64)  # 66 % 4 != 0
    with pytest.raises(ValueError, match="divide"):
        run(lefts, rights)
    lefts, rights = _frame_batch(63, 2, 48, 64)  # 12 rows/shard < 14 halo
    with pytest.raises(ValueError, match="halo"):
        run(lefts, rights)


def test_sharded_frame_small_forest_one_op_sort():
    """The single-operand small-forest sort (match._sort_key_pos) under
    shard_map: a 17-test mask rides the 1-op path inside every row shard
    and must stay bit-identical to the single-device masked matcher (the
    30-test forests of the other sharded tests always take the 2-op
    path)."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest, make_filter_mask
    from opengpc_tpu.infer import build_sparsematch_masked
    from opengpc_tpu.match import _pack_ok
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mask = make_filter_mask(
        load_forest(os.path.join(repo, "forests", "defaultTauForest.txt")),
        max_tests=17)
    assert _pack_ok(mask.num_tests, 2 * 96)
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64, capacity=8192
    )
    h, w = 128, 96
    left, right = _frame_pair(33, h, w)
    sharded = build_sharded_frame_sparsematch(mask, settings, make_mesh())
    buf, counts = sharded(left, right)
    sbuf, scounts = build_sparsematch_masked(mask, settings)(left, right)
    assert int(np.asarray(counts).sum()) > 50
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(scounts))
    np.testing.assert_array_equal(np.asarray(buf), np.asarray(sbuf))


def test_sharded_frame_global_compact_matches_single_device():
    """GLOBAL mode over the distributed bucket sort: one frame's rows
    sharded over 8 chips, chunk-compacted survivors exchanged by code
    range with ONE all_to_all, per-chip local uniqueness sorts — support
    set equal to the single-device global matcher on a realistic-density
    scene with no overflow (upgrades the r4 PARITY §2.10 won't-do)."""
    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch_global_rows,
                                   global_row_supports_to_numpy)
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch
    from opengpc_tpu.utils.scenes import make_sparse_pair
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=False, disp_high=64,
        vertical_tolerance=1, capacity=8192
    )
    left, right = make_sparse_pair(128, 96, 5, density=0.15, seed=31)

    sharded = build_sharded_frame_sparsematch(
        forest, settings, make_mesh(),
        contract="global-compact")
    (xs, ys, ds), counts, ovf = sharded(left, right)
    assert not bool(np.asarray(ovf))
    got = set(map(tuple, global_row_supports_to_numpy(xs, ys, ds, counts)))

    single = build_sparsematch_global_rows(forest, settings)
    (sxs, sys_, sds), scounts = single(left, right)
    want = set(map(tuple,
                   global_row_supports_to_numpy(sxs, sys_, sds, scounts)))
    assert len(want) > 50
    assert got == want


def test_sharded_frame_global_lossless_and_overflow():
    """k == chunk makes the chunk compaction lossless, so the distributed
    sort must be EXACT even on a dense frame (every candidate rides the
    exchange); default chunks on the same dense frame trip the overflow
    guard, whose contract is "discard and re-run full-width" — flagged
    output carries NO subset guarantee (truncating one copy of a
    3-occurrence code can leave a run of 2 that fabricates a pair), so
    the test only checks the flag fires and the output stays
    well-formed."""
    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch_global_rows,
                                   global_row_supports_to_numpy)
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=False, disp_high=64,
        vertical_tolerance=0, capacity=8192
    )
    left, right = _frame_pair(21, 128, 96)  # ~dense kron texture
    mesh = make_mesh()

    single = build_sparsematch_global_rows(forest, settings)
    (sxs, sys_, sds), scounts = single(left, right)
    want = set(map(tuple,
                   global_row_supports_to_numpy(sxs, sys_, sds, scounts)))
    assert len(want) > 1000

    lossless = build_sharded_frame_sparsematch(
        forest, settings, mesh,
        contract="global-compact", chunk=128, k=128)
    (xs, ys, ds), counts, ovf = lossless(left, right)
    assert not bool(np.asarray(ovf))
    got = set(map(tuple, global_row_supports_to_numpy(xs, ys, ds, counts)))
    assert got == want

    flagged = build_sharded_frame_sparsematch(
        forest, settings, mesh,
        contract="global-compact")
    (xs, ys, ds), counts, ovf = flagged(left, right)
    assert bool(np.asarray(ovf))
    flagged_sup = global_row_supports_to_numpy(xs, ys, ds, counts)
    # well-formed even when flagged: decodable, coordinates in range
    assert flagged_sup.shape[1] == 3
    if len(flagged_sup):
        assert flagged_sup[:, 0].min() >= 0
        assert flagged_sup[:, 0].max() < left.shape[1]
        assert flagged_sup[:, 1].min() >= 0
        assert flagged_sup[:, 1].max() < left.shape[0]
        assert np.abs(flagged_sup[:, 2]).max() <= settings.disp_high


def test_sharded_frame_global_rejects_epipolar_settings():
    import os

    import pytest

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64,
        capacity=8192
    )
    run = build_sharded_frame_sparsematch(
        forest, settings, make_mesh(),
        contract="global-compact")
    left, right = _frame_pair(27, 128, 64)
    with pytest.raises(ValueError, match="global"):
        run(left, right)


def test_sharded_frame_randomized_fuzz():
    """Randomized sharded-frame equality fuzz: random mesh size x (H, W) x
    contract x settings x forest vs the single-device builders.  The
    fixed-config tests above pin each contract at one shape; this draw
    walks the slab/halo arithmetic over arbitrary shard counts and shapes
    (where off-by-one row bugs hide).  Seeded; OGPC_FUZZ_SEED /
    OGPC_FUZZ_TRIALS widen the draw for soaks."""
    import os

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest, truncate_forest
    from opengpc_tpu.infer import (build_sparsematch_masked,
                                   build_sparsematch_masked_compact,
                                   build_sparsematch_rows)
    from opengpc_tpu.parallel import (build_sharded_frame_pyramid,
                                      build_sharded_frame_sparsematch)
    from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                     pyramid_supports_to_numpy)
    from opengpc_tpu.utils.scenes import make_sparse_pair

    seed = int(os.environ.get("OGPC_FUZZ_SEED", 20260819))
    trials = int(os.environ.get("OGPC_FUZZ_TRIALS", 3))
    rng = np.random.default_rng(seed + 7)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forests = {
        "zero": load_forest(
            os.path.join(repo, "forests", "defaultZeroForest.txt")),
        "tau": load_forest(
            os.path.join(repo, "forests", "defaultTauForest.txt")),
    }
    forests["small"] = truncate_forest(forests["zero"], 17)
    total = 0
    for t in range(trials):
        n = int(rng.choice([2, 4, 8]))
        contract = str(rng.choice(
            ["masked", "rows", "masked-compact", "pyramid"]))
        fname = str(rng.choice(sorted(forests)))
        forest = forests[fname]
        settings = InferenceSettings(
            gradient_threshold=int(rng.choice([3, 5, 9])),
            epipolar_mode=True,
            disp_high=int(rng.choice([16, 32, 64])),
            capacity=8192,
        )
        if contract == "pyramid":
            levels = int(rng.choice([2, 3]))
            h = n * (2 ** (levels - 1)) * int(rng.integers(14, 22))
        else:
            levels = 1
            h = n * int(rng.integers(14, 34))
        w = int(rng.integers(64, 200))
        sparse = bool(rng.integers(0, 2))
        if sparse:
            left, right = make_sparse_pair(
                h, w, 3, density=float(rng.uniform(0.08, 0.2)),
                seed=int(rng.integers(1 << 30)))
        else:
            left, right = _frame_pair(int(rng.integers(1 << 30)), h, w)
        mesh = make_mesh(jax.devices()[:n])
        label = (t, n, contract, fname, h, w, sparse)
        if contract == "pyramid":
            out = build_sharded_frame_pyramid(
                forest, settings, mesh, num_levels=levels)(left, right)
            single = build_pyramid_sparsematch(
                forest, settings, num_levels=levels)(left, right)
            got = set(map(tuple, pyramid_supports_to_numpy(*out).tolist()))
            want = set(map(tuple,
                           pyramid_supports_to_numpy(*single).tolist()))
            assert got == want, label
            np.testing.assert_array_equal(
                np.asarray(out[4]), np.asarray(single[4]),
                err_msg=str(label))
            total += len(want)
        elif contract == "masked-compact":
            buf, counts, ovf = build_sharded_frame_sparsematch(
                forest, settings, mesh,
                contract=contract)(left, right)
            sbuf, scounts, sovf = build_sparsematch_masked_compact(
                forest, settings)(left, right)
            assert bool(np.asarray(ovf)) == bool(np.asarray(sovf)), label
            if not bool(np.asarray(sovf)):
                np.testing.assert_array_equal(
                    np.asarray(counts), np.asarray(scounts),
                    err_msg=str(label))
                np.testing.assert_array_equal(
                    np.asarray(buf), np.asarray(sbuf), err_msg=str(label))
                total += int(np.asarray(scounts).sum())
        else:
            sharded = build_sharded_frame_sparsematch(
                forest, settings, mesh,
                contract=contract)
            if contract == "masked":
                buf, counts = sharded(left, right)
                sbuf, scounts = build_sparsematch_masked(
                    forest, settings)(left, right)
                np.testing.assert_array_equal(
                    np.asarray(counts), np.asarray(scounts),
                    err_msg=str(label))
                np.testing.assert_array_equal(
                    np.asarray(buf), np.asarray(sbuf), err_msg=str(label))
            else:
                (xs, ds), counts = sharded(left, right)
                (sxs, sds), scounts = build_sparsematch_rows(
                    forest, settings)(left, right)
                np.testing.assert_array_equal(
                    np.asarray(counts), np.asarray(scounts),
                    err_msg=str(label))
                np.testing.assert_array_equal(
                    np.asarray(xs), np.asarray(sxs), err_msg=str(label))
                np.testing.assert_array_equal(
                    np.asarray(ds), np.asarray(sds), err_msg=str(label))
            total += int(np.asarray(scounts).sum())
    assert total > 30 * trials, total


def test_sharded_frame_rejects_non_uint8():
    """The sharded slab path shares the builders' uint8 guard
    (ops/preprocess.require_u8 via infer._key_image_jnp_slab): a float
    pair through
    build_sharded_frame_sparsematch used to truncate to zeros in
    slab.astype(int32) and return an EMPTY support set silently, while
    the single-device builders raised — inconsistent guard coverage."""
    import os

    import pytest

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    forest = load_forest(os.path.join(repo, "forests",
                                      "defaultZeroForest.txt"))
    settings = InferenceSettings(
        gradient_threshold=5, epipolar_mode=True, disp_high=64,
        capacity=8192
    )
    left, right = _frame_pair(33, 128, 96)
    fl = left.astype(np.float32) / 255.0
    fr = right.astype(np.float32) / 255.0
    mesh = make_mesh()
    sharded = build_sharded_frame_sparsematch(forest, settings, mesh)
    with pytest.raises(ValueError, match="uint8"):
        sharded(fl, fr)
    # uint8 still flows (the guard is dtype-only)
    buf, counts = sharded(left, right)
    assert int(np.asarray(counts).sum()) > 0

"""AOT export / serving artifacts (opengpc_tpu.aot, jax.export).

The exported StableHLO module must reproduce the live builders' outputs
bit-for-bit after a serialize/deserialize round-trip, for every output
contract; the artifact file is self-describing (decode routing from
metadata alone) and the CLI export/run pair is the serving path.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.forest import load_forest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORESTS = os.path.join(REPO, "forests")


def make_pair(h, w, d, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w + d)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                + np.roll(base, 1, 1) + np.roll(base, -1, 1) + base) / 5
    scene = base.astype(np.uint8)
    return scene[:, :w].copy(), scene[:, d:].copy()


@pytest.fixture(scope="module")
def forest():
    return load_forest(os.path.join(FORESTS, "defaultZeroForest.txt"))


def _settings(epipolar=True):
    return InferenceSettings(gradient_threshold=5, epipolar_mode=epipolar,
                             disp_high=32, vertical_tolerance=0 if epipolar
                             else 1, capacity=8192)


@pytest.mark.parametrize("contract", ["flat", "rows", "masked",
                                      "masked-compact"])
def test_export_round_trip_equals_builder(forest, contract):
    """serialize -> deserialize -> call must equal the live builder's
    outputs exactly (same arrays, not just the same set)."""
    from opengpc_tpu.aot import export_sparsematch, load_sparsematch
    from opengpc_tpu.infer import (build_sparsematch,
                                   build_sparsematch_masked,
                                   build_sparsematch_masked_compact,
                                   build_sparsematch_rows)

    settings = _settings()
    h, w = 96, 144
    left, right = make_pair(h, w, 4, seed=11)
    blob = export_sparsematch(forest, settings, (h, w), contract=contract)
    assert isinstance(blob, bytes) and len(blob) > 1000
    call = load_sparsematch(blob)
    got = call(left, right)
    builder = {"flat": build_sparsematch,
               "rows": build_sparsematch_rows,
               "masked": build_sparsematch_masked,
               "masked-compact": build_sparsematch_masked_compact}[contract]
    want = builder(forest, settings)(left, right)
    got_flat, _ = __import__("jax").tree.flatten(got)
    want_flat, _ = __import__("jax").tree.flatten(want)
    assert len(got_flat) == len(want_flat) > 0
    for g, x in zip(got_flat, want_flat):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))


@pytest.mark.parametrize("contract", ["global-rows", "global-compact"])
def test_export_global_round_trip(forest, contract):
    from opengpc_tpu.aot import export_sparsematch, load_sparsematch
    from opengpc_tpu.infer import (build_sparsematch_global_compact,
                                   build_sparsematch_global_rows)
    import jax

    settings = _settings(epipolar=False)
    h, w = 96, 144
    left, right = make_pair(h, w, 4, seed=12)
    blob = export_sparsematch(forest, settings, (h, w),
                              contract=contract)
    got = load_sparsematch(blob)(left, right)
    builder = {"global-rows": build_sparsematch_global_rows,
               "global-compact": build_sparsematch_global_compact}[contract]
    want = builder(forest, settings)(left, right)
    for g, x in zip(jax.tree.flatten(got)[0], jax.tree.flatten(want)[0]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))


def test_export_validates_contract_and_platforms(forest):
    from opengpc_tpu.aot import export_sparsematch

    settings = _settings()
    with pytest.raises(ValueError, match="contract"):
        export_sparsematch(forest, settings, (96, 144), contract="bogus")
    with pytest.raises(ValueError, match="epipolar_mode=False"):
        export_sparsematch(forest, settings, (96, 144),
                           contract="global-rows")
    # non-epipolar settings make the row contracts ineligible
    with pytest.raises(ValueError, match="epipolar"):
        export_sparsematch(forest, _settings(epipolar=False), (96, 144),
                           contract="rows")


def test_export_cpu_cuda_artifact_runs_on_cpu(forest):
    """One artifact for the CPU and the NVIDIA GPU (JAX's export target
    ``cuda``): it lowers for both from a CPU-only host, and its CPU half
    runs bit-equal to the live builder."""
    from opengpc_tpu.aot import (_deserialize, export_sparsematch,
                                 load_sparsematch)
    from opengpc_tpu.infer import build_sparsematch_masked

    settings = _settings()
    blob = export_sparsematch(forest, settings, (96, 144),
                              contract="masked", platforms=("cpu", "cuda"))
    assert tuple(_deserialize(blob).platforms) == ("cpu", "cuda")
    left, right = make_pair(96, 144, 5, seed=4)
    got = load_sparsematch(blob)(left, right)
    want = build_sparsematch_masked(forest, settings)(left, right)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))
    assert int(np.asarray(got[1]).sum()) > 0


def test_artifact_needs_no_flatbuffers(tmp_path):
    """Export, save, load and run with the flatbuffers package unimportable
    (a serving host may lack it; jax.export's own serialize() needs it)."""
    script = tmp_path / "nofb.py"
    script.write_text(
        "import sys\n"
        "sys.modules['flatbuffers'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import numpy as np\n"
        "from opengpc_tpu import aot\n"
        "from opengpc_tpu.config import InferenceSettings\n"
        "from opengpc_tpu.forest import load_forest\n"
        f"f = load_forest({os.path.join(FORESTS, 'defaultZeroForest.txt')!r})\n"
        "s = InferenceSettings(gradient_threshold=5, disp_high=32,\n"
        "                      vertical_tolerance=0, epipolar_mode=True)\n"
        "blob = aot.export_sparsematch(f, s, (64, 96), contract='masked')\n"
        f"path = {str(tmp_path / 'm.ogpcx')!r}\n"
        "aot.save_artifact(path, blob, contract='masked', settings=s,\n"
        "                  shape=(64, 96))\n"
        "call, meta = aot.load_artifact(path)\n"
        "rng = np.random.default_rng(0)\n"
        "l = rng.integers(0, 256, (64, 96)).astype(np.uint8)\n"
        "print(len(aot.decode_outputs(meta, call(l, np.roll(l, -3, 1)))))\n")
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip().splitlines()[-1]) > 0


def test_jax_export_format_blob_still_loads(forest):
    """Blobs written in jax.export's own format (older artifacts) load
    through the same entry point where flatbuffers is installed."""
    import jax

    from opengpc_tpu.aot import _deserialize, load_sparsematch
    from opengpc_tpu.infer import build_sparsematch_masked

    settings = _settings()
    fn = jax.jit(lambda l, r: build_sparsematch_masked(forest, settings)(l, r))
    spec = jax.ShapeDtypeStruct((96, 144), np.uint8)
    old = bytes(jax.export.export(fn)(spec, spec).serialize())
    assert _deserialize(old).nr_devices == 1
    left, right = make_pair(96, 144, 5, seed=6)
    got = load_sparsematch(old)(left, right)
    want = build_sparsematch_masked(forest, settings)(left, right)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))


def test_artifact_file_round_trip(forest, tmp_path):
    """save_artifact/load_artifact: self-describing container routes
    decode from metadata alone; decoded supports equal the flat set."""
    from opengpc_tpu.aot import (decode_outputs, export_sparsematch,
                                 load_artifact, save_artifact)
    from opengpc_tpu.infer import build_sparsematch, supports_to_numpy

    settings = _settings()
    h, w = 96, 144
    left, right = make_pair(h, w, 4, seed=13)
    path = str(tmp_path / "m.ogpcx")
    blob = export_sparsematch(forest, settings, (h, w), contract="masked")
    save_artifact(path, blob, contract="masked", settings=settings,
                  shape=(h, w))
    call, meta = load_artifact(path)
    assert meta["contract"] == "masked" and meta["shape"] == [h, w]
    got = decode_outputs(meta, call(left, right))
    want = supports_to_numpy(
        *build_sparsematch(forest, settings)(left, right))
    assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))
    assert len(got) > 100

    with pytest.raises(ValueError, match="magic"):
        bad = tmp_path / "bad.ogpcx"
        bad.write_bytes(b"NOTANARTIFACT")
        load_artifact(str(bad))


def test_compact_artifact_overflow_raises(forest, tmp_path):
    """A dense frame through a masked-compact artifact must raise (the
    frozen program cannot fall back) with a clear serving hint."""
    from opengpc_tpu.aot import (decode_outputs, export_sparsematch,
                                 load_artifact, save_artifact)

    settings = _settings()
    h, w = 96, 144
    left, right = make_pair(h, w, 4, seed=14)  # 79%-density scene
    path = str(tmp_path / "c.ogpcx")
    save_artifact(path, export_sparsematch(forest, settings, (h, w),
                                           contract="masked-compact"),
                  contract="masked-compact", settings=settings, shape=(h, w))
    call, meta = load_artifact(path)
    with pytest.raises(OverflowError, match="full-width"):
        decode_outputs(meta, call(left, right))


@pytest.mark.parametrize("contract", ["pyramid", "pyramid-compact"])
def test_export_pyramid_round_trip(forest, contract, tmp_path):
    """Pyramid contracts (VERDICT r4 #2b): serialize -> deserialize ->
    call must equal the live pyramid builder bit-for-bit, and the
    artifact container must route the (x, y, d, level, counts) decode
    from its header alone."""
    import jax

    from opengpc_tpu.aot import (decode_outputs, export_sparsematch,
                                 load_artifact, load_sparsematch,
                                 save_artifact)
    from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                     build_pyramid_sparsematch_compact,
                                     pyramid_supports_to_numpy)

    settings = _settings()
    h, w = 96, 144
    # low-density texture so pyramid-compact stays under its chunk caps
    rng = np.random.default_rng(15)
    base = np.zeros((h, w + 4), np.float32)
    ys, xs = rng.integers(4, h - 4, 220), rng.integers(4, w - 4, 220)
    base[ys, xs] = rng.integers(64, 255, 220)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                + np.roll(base, 1, 1) + np.roll(base, -1, 1) + base) / 5
    scene = base.astype(np.uint8)
    left, right = scene[:, :w].copy(), scene[:, 4:].copy()

    blob = export_sparsematch(forest, settings, (h, w), contract=contract, num_levels=3)
    got = load_sparsematch(blob)(left, right)
    builder = (build_pyramid_sparsematch if contract == "pyramid"
               else build_pyramid_sparsematch_compact)
    want = builder(forest, settings, num_levels=3)(
        left, right)
    got_flat, _ = jax.tree.flatten(got)
    want_flat, _ = jax.tree.flatten(want)
    assert len(got_flat) == len(want_flat) > 0
    for g, x in zip(got_flat, want_flat):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))

    path = str(tmp_path / "p.ogpcx")
    save_artifact(path, blob, contract=contract, settings=settings,
                  shape=(h, w), extra={"num_levels": 3})
    call, meta = load_artifact(path)
    assert meta["contract"] == contract and meta["num_levels"] == 3
    rows = decode_outputs(meta, call(left, right))
    assert rows.shape[1] == 4
    want_rows = pyramid_supports_to_numpy(
        *(want[:-1] if contract == "pyramid-compact" else want))
    assert set(map(tuple, rows.tolist())) == set(
        map(tuple, want_rows.tolist()))
    assert len(rows) > 50
    assert (rows[:, 3] >= 1).any(), "no coarse-level supports in the scene"


def test_pyramid_compact_artifact_overflow_raises(forest, tmp_path):
    """A dense frame through a pyramid-compact artifact must raise with
    the serving hint (frozen programs cannot fall back)."""
    from opengpc_tpu.aot import (decode_outputs, export_sparsematch,
                                 load_artifact, save_artifact)

    settings = _settings()
    h, w = 96, 144
    left, right = make_pair(h, w, 4, seed=16)  # dense texture
    path = str(tmp_path / "pc.ogpcx")
    save_artifact(path, export_sparsematch(forest, settings, (h, w),
                                           contract="pyramid-compact"),
                  contract="pyramid-compact", settings=settings,
                  shape=(h, w))
    call, meta = load_artifact(path)
    with pytest.raises(OverflowError, match="pyramid"):
        decode_outputs(meta, call(left, right))


def test_cli_aot_export_run(forest, tmp_path, capfd):
    """The serving path end-to-end through the real argv mains: export an
    artifact, run a pair through it, supports equal a live CLI run."""
    from opengpc_tpu.cli.aot import main as aot_main
    from opengpc_tpu.cli.sparsematch import main as sm_main
    from opengpc_tpu.io.png import write_png

    h, w = 96, 144
    left, right = make_pair(h, w, 4, seed=15)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(lp, left)
    write_png(rp, right)
    fpath = os.path.join(FORESTS, "defaultZeroForest.txt")
    art = str(tmp_path / "m.ogpcx")
    rc = aot_main(["export", fpath, art, "--height", str(h), "--width",
                   str(w), "--contract", "masked", "--disp-high", "32"])
    assert rc == 0 and os.path.exists(art)
    sup = tmp_path / "s.txt"
    rc = aot_main(["run", art, lp, rp, "--supports-out", str(sup)])
    assert rc == 0
    got = np.loadtxt(str(sup), dtype=np.int64).reshape(-1, 3)
    ref_sup = tmp_path / "ref.txt"
    rc = sm_main([fpath, lp, rp, "--disp-high", "32",
                  "--out", str(tmp_path / "d.png"),
                  "--supports-out", str(ref_sup)])
    assert rc == 0
    want = np.loadtxt(str(ref_sup), dtype=np.int64).reshape(-1, 3)
    assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))
    assert len(got) > 100
    # shape mismatch is rejected
    l2, r2 = make_pair(64, 96, 4, seed=16)
    write_png(str(tmp_path / "l2.png"), l2)
    write_png(str(tmp_path / "r2.png"), r2)
    assert aot_main(["run", art, str(tmp_path / "l2.png"),
                     str(tmp_path / "r2.png")]) == 1


def test_export_sharded_frame_round_trip(forest):
    """Pod-scale serving artifact: the sharded-frame matcher (one pair's
    rows over the 8-device mesh) serializes and round-trips bit-exact;
    a wrong-size serving mesh is rejected."""
    import jax
    from jax.sharding import Mesh

    from opengpc_tpu.aot import export_sharded_frame, load_sharded_frame
    from opengpc_tpu.parallel import (build_sharded_frame_sparsematch,
                                      make_mesh)
    from opengpc_tpu.utils.scenes import make_sparse_pair

    settings = _settings()
    h, w = 128, 96
    left, right = make_sparse_pair(h, w, 3, density=0.15)
    mesh = make_mesh()
    blob = export_sharded_frame(forest, settings, (h, w), mesh,
                                contract="masked")
    assert isinstance(blob, bytes) and len(blob) > 1000
    call = load_sharded_frame(blob)  # fresh serving mesh, all devices
    buf, counts = call(left, right)
    want = build_sharded_frame_sparsematch(forest, settings, mesh)(left, right)
    np.testing.assert_array_equal(np.asarray(buf), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(want[1]))
    assert int(np.asarray(counts).sum()) > 20

    devs = np.array(jax.devices()[:4]).reshape(4)
    small = Mesh(devs, ("data",))
    with pytest.raises(ValueError, match="8 devices"):
        load_sharded_frame(blob, small)


def test_export_sharded_frame_pyramid_round_trip(forest, tmp_path):
    """The sharded PYRAMID matcher (VERDICT r4 #2b+c composed) freezes,
    round-trips bit-exact vs the live sharded builder, and the artifact
    container routes its (x, y, d, level, counts) decode from the header
    (same decoded set as the single-device pyramid)."""
    from opengpc_tpu.aot import (decode_outputs, export_sharded_frame,
                                 load_artifact, load_sharded_frame,
                                 save_artifact)
    from opengpc_tpu.parallel import build_sharded_frame_pyramid, make_mesh
    from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                     pyramid_supports_to_numpy)

    settings = _settings()
    h, w = 224, 96  # 8 devices x 2 levels: coarsest slab 14 == halo min
    left, right = make_pair(h, w, 4, seed=18)
    mesh = make_mesh()
    blob = export_sharded_frame(forest, settings, (h, w), mesh,
                                contract="pyramid",
                                num_levels=2)
    call = load_sharded_frame(blob)
    got = call(left, right)
    want = build_sharded_frame_pyramid(forest, settings, mesh,
                                       num_levels=2)(left, right)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))

    path = str(tmp_path / "sp.ogpcx")
    save_artifact(path, blob, contract="pyramid", settings=settings,
                  shape=(h, w), extra={"n_devices": 8, "num_levels": 2})
    call2, meta = load_artifact(path)
    rows = decode_outputs(meta, call2(left, right))
    single = build_pyramid_sparsematch(forest, settings, num_levels=2)(left, right)
    want_rows = pyramid_supports_to_numpy(*single)
    assert set(map(tuple, rows.tolist())) == set(
        map(tuple, want_rows.tolist()))
    assert len(rows) > 100


def test_sharded_artifact_container_round_trip(forest, tmp_path):
    """A sharded-frame blob saved with extra={"n_devices": N} must serve
    through the generic container API: load_artifact routes it to
    load_sharded_frame (r4 review finding — it used to route every blob
    single-device, making the documented pod-scale container unservable)."""
    from opengpc_tpu.aot import (decode_outputs, export_sharded_frame,
                                 load_artifact, save_artifact)
    from opengpc_tpu.infer import build_sparsematch_masked
    from opengpc_tpu.parallel import make_mesh
    from opengpc_tpu.utils.scenes import make_sparse_pair

    settings = _settings()
    h, w = 128, 96
    left, right = make_sparse_pair(h, w, 3, density=0.15)
    mesh = make_mesh()
    path = str(tmp_path / "pod.ogpcx")
    blob = export_sharded_frame(forest, settings, (h, w), mesh,
                                contract="masked")
    save_artifact(path, blob, contract="masked", settings=settings,
                  shape=(h, w), extra={"n_devices": mesh.devices.size})
    call, meta = load_artifact(path)
    assert meta["n_devices"] == mesh.devices.size
    got = decode_outputs(meta, call(left, right))
    want_buf, want_counts = build_sparsematch_masked(
        forest, settings)(left, right)
    from opengpc_tpu.infer import masked_supports_to_numpy

    want = masked_supports_to_numpy(want_buf, want_counts,
                                    settings.disp_high)
    assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))
    assert len(got) > 20


def test_examples_serve_loop(tmp_path):
    """examples/serve.py end-to-end: export-once artifact, per-frame
    zero-retrace serving, supports files equal the standard CLI pipeline,
    device-resident densify written; artifact reuse path covered."""
    import subprocess
    import sys

    from opengpc_tpu.io.png import write_png
    from opengpc_tpu.io.supports import read_supports
    from opengpc_tpu.utils.scenes import make_pair

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ld, rd, od = tmp_path / "l", tmp_path / "r", tmp_path / "out"
    ld.mkdir(), rd.mkdir()
    for i in range(2):
        left, right = make_pair(80, 112, 4, seed=70 + i)
        write_png(str(ld / f"f{i}.png"), left)
        write_png(str(rd / f"f{i}.png"), right)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    cmd = [sys.executable, os.path.join(repo, "examples", "serve.py"),
           os.path.join(repo, "forests", "defaultZeroForest.txt"),
           str(ld), str(rd), str(od), "--disp-high", "16", "--densify"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert (od / "matcher.ogpcx").exists()
    assert (od / "dense_f0.png").exists() and (od / "dense_f1.png").exists()

    from opengpc_tpu.cli.sparsematch import main as cli_main

    sup = tmp_path / "want.txt"
    assert cli_main([os.path.join(repo, "forests", "defaultZeroForest.txt"),
                     str(ld / "f0.png"), str(rd / "f0.png"),
                     "--disp-high", "16", "--out", str(tmp_path / "d.png"),
                     "--supports-out", str(sup)]) == 0
    got = read_supports(str(od / "f0.txt"))
    want = read_supports(str(sup))
    assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))

    # reuse path: second run loads the existing artifact, no re-export
    out2 = subprocess.run(cmd + ["--reuse-artifact",
                                 str(od / "matcher.ogpcx")],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert out2.returncode == 0, out2.stdout + out2.stderr
    assert "exported" not in out2.stdout


def test_export_batched_sharded_frame_round_trip(forest, tmp_path):
    """2-D (data x rows) mesh artifact: the composed batched+row-sharded
    matcher serializes, routes through the generic container API
    (mesh_shape metadata), and round-trips bit-exact vs the live builder;
    wrong-shape serving meshes are rejected."""
    from opengpc_tpu.aot import (export_batched_sharded_frame,
                                 load_artifact,
                                 load_batched_sharded_frame, save_artifact)
    from opengpc_tpu.parallel import (
        build_batched_sharded_frame_sparsematch, make_mesh_2d)
    from opengpc_tpu.utils.scenes import make_sparse_pair

    settings = _settings()
    b, h, w = 2, 64, 96
    lefts, rights = [], []
    for i in range(b):
        l, r = make_sparse_pair(h, w, 3, density=0.15)
        lefts.append(l)
        rights.append(r)
    lefts, rights = np.stack(lefts), np.stack(rights)
    mesh = make_mesh_2d(2, 4)
    blob = export_batched_sharded_frame(forest, settings, b, (h, w), mesh,
                                        contract="masked")
    assert isinstance(blob, bytes) and len(blob) > 1000
    path = str(tmp_path / "pod2d.ogpcx")
    save_artifact(path, blob, contract="masked", settings=settings,
                  shape=(h, w),
                  extra={"mesh_shape": [2, 4], "batch": b,
                         "n_devices": mesh.devices.size})
    call, meta = load_artifact(path)
    assert meta["mesh_shape"] == [2, 4]
    buf, counts = call(lefts, rights)
    want = build_batched_sharded_frame_sparsematch(
        forest, settings, mesh)(lefts, rights)
    np.testing.assert_array_equal(np.asarray(buf), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(want[1]))
    assert int(np.asarray(counts).sum()) > 20

    import pytest as _pytest
    with _pytest.raises(ValueError, match="mesh"):
        load_batched_sharded_frame(blob, (2, 4), make_mesh_2d(4, 2))


def test_export_batched_sharded_frame_pyramid_round_trip(forest):
    """The 2-D (data x rows) pyramid freezes and round-trips bit-exact vs
    the live builder; per-frame decoded sets equal the single-device
    pyramid."""
    from opengpc_tpu.aot import (export_batched_sharded_frame,
                                 load_batched_sharded_frame)
    from opengpc_tpu.parallel import (build_batched_sharded_frame_pyramid,
                                      make_mesh_2d)
    from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                     pyramid_supports_to_numpy)

    settings = _settings()
    b, h, w = 2, 112, 96  # 2 data x 4 rows, 2 levels: coarsest slab 14
    mesh = make_mesh_2d(2, 4)
    lefts = np.stack([make_pair(h, w, 3, seed=60 + i)[0] for i in range(b)])
    rights = np.stack([make_pair(h, w, 3, seed=60 + i)[1]
                       for i in range(b)])
    blob = export_batched_sharded_frame(forest, settings, b, (h, w), mesh,
                                        contract="pyramid", num_levels=2)
    call = load_batched_sharded_frame(blob, (2, 4))
    got = call(lefts, rights)
    want = build_batched_sharded_frame_pyramid(
        forest, settings, mesh, num_levels=2)(
        lefts, rights)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))
    single = build_pyramid_sparsematch(forest, settings, num_levels=2)
    for i in range(b):
        got_set = set(map(tuple, pyramid_supports_to_numpy(
            *(np.asarray(o)[i] for o in got)).tolist()))
        want_set = set(map(tuple, pyramid_supports_to_numpy(
            *single(lefts[i], rights[i])).tolist()))
        assert got_set == want_set and len(want_set) > 50


def test_cli_aot_export_sharded(forest, tmp_path, capfd):
    """AOT CLI sharded exports (r4): --shard-frame N freezes the
    row-sharded matcher (run-servable over an N-device mesh, supports
    equal the plain artifact); --shard-frame + --data-parallel/--batch
    freezes the 2-D variant (run rejects it with a pointer to the Python
    API); bad flag combinations error out."""
    from opengpc_tpu.cli.aot import main as aot_main
    from opengpc_tpu.io.png import write_png

    h, w = 128, 96
    left, right = make_pair(h, w, 3, seed=17)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(lp, left)
    write_png(rp, right)
    fpath = os.path.join(FORESTS, "defaultZeroForest.txt")

    # plain artifact for the supports reference
    plain = str(tmp_path / "plain.ogpcx")
    assert aot_main(["export", fpath, plain, "--height", str(h), "--width",
                     str(w), "--contract", "masked", "--disp-high", "32"]) == 0
    s_plain = tmp_path / "sp.txt"
    assert aot_main(["run", plain, lp, rp,
                     "--supports-out", str(s_plain)]) == 0

    # row-sharded over all 8 virtual devices
    pod = str(tmp_path / "pod.ogpcx")
    assert aot_main(["export", fpath, pod, "--height", str(h), "--width",
                     str(w), "--contract", "masked", "--disp-high", "32",
                     "--shard-frame", "8"]) == 0
    s_pod = tmp_path / "spod.txt"
    assert aot_main(["run", pod, lp, rp, "--supports-out", str(s_pod)]) == 0
    got = np.loadtxt(str(s_pod), dtype=np.int64).reshape(-1, 3)
    want = np.loadtxt(str(s_plain), dtype=np.int64).reshape(-1, 3)
    assert len(want) > 20
    assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))

    # 2-D export; run rejects the stacked artifact with a clear pointer
    pod2 = str(tmp_path / "pod2.ogpcx")
    assert aot_main(["export", fpath, pod2, "--height", "64", "--width",
                     str(w), "--contract", "masked", "--disp-high", "32",
                     "--shard-frame", "4",
                     "--data-parallel", "2", "--batch", "2"]) == 0
    capfd.readouterr()
    assert aot_main(["run", pod2, lp, rp]) == 1
    assert "serve it with" in capfd.readouterr().err

    # rejections: batch without shard-frame, indivisible batch, too many
    # devices
    x = str(tmp_path / "x.ogpcx")
    assert aot_main(["export", fpath, x, "--height", "64", "--width",
                     str(w), "--batch", "2"]) == 1
    assert aot_main(["export", fpath, x, "--height", "64", "--width",
                     str(w), "--shard-frame", "4", "--data-parallel", "2",
                     "--batch", "3"]) == 1
    assert aot_main(["export", fpath, x, "--height", "64", "--width",
                     str(w), "--shard-frame", "4", "--data-parallel", "3",
                     "--batch", "3"]) == 1


def test_sharded_artifact_serves_on_larger_host(forest, tmp_path):
    """A sharded-frame artifact exported for N devices must serve with
    mesh=None on a host with MORE than N devices: load_artifact builds the
    serving mesh over the first N visible devices from the metadata
    (r4 review finding — it used to mesh over ALL devices and raise)."""
    import jax

    from opengpc_tpu.aot import (decode_outputs, export_sharded_frame,
                                 load_artifact, save_artifact)
    from opengpc_tpu.infer import build_sparsematch_masked
    from opengpc_tpu.infer import masked_supports_to_numpy
    from opengpc_tpu.parallel import make_mesh
    from opengpc_tpu.utils.scenes import make_sparse_pair

    settings = _settings()
    h, w = 128, 96
    left, right = make_sparse_pair(h, w, 3, density=0.15)
    mesh4 = make_mesh(jax.devices()[:4])
    path = str(tmp_path / "pod4.ogpcx")
    blob = export_sharded_frame(forest, settings, (h, w), mesh4,
                                contract="masked")
    save_artifact(path, blob, contract="masked", settings=settings,
                  shape=(h, w), extra={"n_devices": 4})
    call, meta = load_artifact(path)  # 8-device host, 4-device artifact
    got = decode_outputs(meta, call(left, right))
    want_buf, want_counts = build_sparsematch_masked(
        forest, settings)(left, right)
    want = masked_supports_to_numpy(want_buf, want_counts,
                                    settings.disp_high)
    assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))
    assert len(got) > 20

    # the raw-blob API must apply the same first-N default (the fix lives
    # in load_sharded_frame itself, not just the container router)
    from opengpc_tpu.aot import load_sharded_frame

    raw_call = load_sharded_frame(blob)
    got_raw = decode_outputs(meta, raw_call(left, right))
    assert set(map(tuple, got_raw.tolist())) == set(map(tuple,
                                                        want.tolist()))


def test_cli_run_rejects_unservable_before_load(tmp_path, capfd):
    """The run command must route on the artifact HEADER: a stacked
    (mesh_shape) artifact — or a sharded one needing more chips than the
    host has — prints the friendly message without ever deserializing the
    module (r4 review finding: load_artifact used to build the mesh first,
    so hosts below D*R devices got a ValueError traceback instead)."""
    from opengpc_tpu.aot import save_artifact
    from opengpc_tpu.cli.aot import main as aot_main
    from opengpc_tpu.io.png import write_png

    h, w = 32, 48
    left, right = make_pair(h, w, 3, seed=3)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(lp, left)
    write_png(rp, right)
    settings = _settings()

    # the blob is garbage on purpose: rejection must happen header-only
    stacked = str(tmp_path / "stacked.ogpcx")
    save_artifact(stacked, b"not-a-module", contract="masked",
                  settings=settings, shape=(h, w),
                  extra={"mesh_shape": [4, 4], "batch": 4,
                         "n_devices": 16})
    capfd.readouterr()
    assert aot_main(["run", stacked, lp, rp]) == 1
    assert "serve it with" in capfd.readouterr().err

    big = str(tmp_path / "big.ogpcx")
    save_artifact(big, b"not-a-module", contract="masked",
                  settings=settings, shape=(h, w),
                  extra={"n_devices": 64})
    assert aot_main(["run", big, lp, rp]) == 1
    assert "64 devices" in capfd.readouterr().err


def test_cli_aot_export_batch1_is_stacked(tmp_path):
    """--shard-frame N --batch 1 freezes the STACKED (1, H, W) variant
    (mesh_shape [1, N]) — matching the sequence CLI, where --batch 1 with
    --shard-frame still dispatches stacks (r4 review finding: it used to
    silently drop --batch and export the unstacked single-pair module)."""
    from opengpc_tpu.aot import peek_artifact_meta
    from opengpc_tpu.cli.aot import main as aot_main

    fpath = os.path.join(FORESTS, "defaultZeroForest.txt")
    art = str(tmp_path / "b1.ogpcx")
    assert aot_main(["export", fpath, art, "--height", "64", "--width",
                     "96", "--contract", "masked", "--disp-high", "32",
                     "--shard-frame", "4",
                     "--batch", "1"]) == 0
    meta = peek_artifact_meta(art)
    assert meta["mesh_shape"] == [1, 4]
    assert meta["batch"] == 1

    # ... and the SAME explicit --batch 1 without --shard-frame must error
    # (not silently export the unstacked module)
    assert aot_main(["export", fpath, str(tmp_path / "x.ogpcx"),
                     "--height", "64", "--width", "96", "--batch", "1"]) == 1


def test_export_sharded_frame_global_round_trip(forest, tmp_path):
    """The distributed-bucket-sort global contract (r4) exports and
    serves unchanged: the all_to_all exchange serializes, the served
    outputs are bit-equal to the live builder, and the generic container
    API routes the contract to the global decoder."""
    from opengpc_tpu.aot import (decode_outputs, export_sharded_frame,
                                 load_artifact, save_artifact)
    from opengpc_tpu.infer import (build_sparsematch_global_rows,
                                   global_row_supports_to_numpy)
    from opengpc_tpu.parallel import (build_sharded_frame_sparsematch,
                                      make_mesh)
    from opengpc_tpu.utils.scenes import make_sparse_pair

    settings = _settings(epipolar=False)
    h, w = 128, 96
    left, right = make_sparse_pair(h, w, 3, density=0.15)
    mesh = make_mesh()
    blob = export_sharded_frame(forest, settings, (h, w), mesh,
                                contract="global-compact")
    path = str(tmp_path / "g.ogpcx")
    save_artifact(path, blob, contract="global-compact",
                  settings=settings, shape=(h, w), platforms=None, extra={"n_devices": 8})
    call, meta = load_artifact(path)
    out = call(left, right)
    live = build_sharded_frame_sparsematch(
        forest, settings, mesh,
        contract="global-compact")(left, right)
    np.testing.assert_array_equal(np.asarray(out[0][0]),
                                  np.asarray(live[0][0]))
    np.testing.assert_array_equal(np.asarray(out[1]),
                                  np.asarray(live[1]))
    assert bool(np.asarray(out[2])) == bool(np.asarray(live[2]))
    assert not bool(np.asarray(out[2]))
    supports = decode_outputs(meta, out)
    (wx, wy, wd), wc = build_sparsematch_global_rows(
        forest, settings)(left, right)
    want = global_row_supports_to_numpy(wx, wy, wd, wc)
    assert len(want) > 20
    assert (set(map(tuple, supports.tolist()))
            == set(map(tuple, want.tolist())))

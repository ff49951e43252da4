#!/usr/bin/env python3
"""On-card smoke run of the GPC matcher: the main path once, at real frame
sizes, through the entry points a user calls, every result checked.

    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # the multi-device paths, four GPUs

One process does everything (a second JAX process on the card would fail
for want of memory): the CLIs run in-process through their ``main``.  The
data are synthetic scenes made from ``--seed`` (``opengpc_tpu.utils.
scenes``); the reference is the native oracle (``cpp/oracle.cc``, built
here with ``make -C cpp build/oracle``), and where the oracle has no such
form, the same call on the CPU.

Phases (one GPU): ``cli`` the sparsematch CLI on a 436x1024 pair;
``contracts`` the one-call API and every builder contract; ``hd`` 1080p
and 4K masked pairs; ``densify`` the device densifier; ``train`` mining +
the train CLI on 1e5 triplets; ``aot`` an exported artifact served through
the AOT CLI.  ``--four-cards`` runs only the multi-device phases, each
against the single-device result.  Every matcher comparison is exact (the
pipeline is integer end to end); densify states its tolerance.

Exits non-zero, before any work and with no result line, when JAX finds no
GPU.  The last line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FORESTS = os.path.join(REPO, "forests")
ZERO = os.path.join(FORESTS, "defaultZeroForest.txt")
TAU = os.path.join(FORESTS, "defaultTauForest.txt")
H, W = 436, 1024            # Sintel frame size
DISP_HIGH = 128             # reference sample settings (sparsematch.cpp)
N_TRIPLETS = 100_000
HD_SIZES = ((1080, 1920), (2160, 3840))
# global-compact keeps K/S = 1/2 of each strided chunk: the default 1/4 is
# tuned for the ~15%-density scene on average, and patch-clustered rows
# of some seeds overflow it (the builders then ask for a full-width
# re-run); the smoke run compares the compacted result itself
GLOBAL_CHUNKS = {"chunk": 512, "k": 256}
FRAME_4K = (2160, 3840)     # four cards: 540 rows each

PHASES = ("cli", "contracts", "hd", "densify", "train", "aot")
FOUR_CARD_PHASES = ("batch_mesh", "sharded_frame", "global_compact",
                    "mesh_2d", "train_mesh")

# densify compares the card with the CPU within this many pixels of
# disparity: its float32 stencil sums run in another order on the GPU
# (and may contract into FMAs), and the seeding scatter-adds are atomics
# in no fixed order; diffusion averages, so rounding differences stay at
# float32 resolution of a <=128 px value instead of growing.
DENSIFY_ATOL = 1e-2


def select_phases(four_cards: bool):
    return FOUR_CARD_PHASES if four_cards else PHASES


def parse_smi(text: str):
    """[(name, power_limit)] from ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` output, one entry per card."""
    out = []
    for line in text.strip().splitlines():
        name, _, limit = line.rpartition(",")
        if name:
            out.append((name.strip(), limit.strip()))
    return out


def smi_text() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return r.stdout.strip()


def require_gpu():
    """The first thing main does: no GPU, no run."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX's default device is "
                         f"{dev.platform}); nothing was run")
    return dev


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

def build_oracle() -> str:
    subprocess.run(["make", "-s", "-C", os.path.join(REPO, "cpp"),
                    "build/oracle"], check=True)
    return os.path.join(REPO, "cpp", "build", "oracle")


class Oracle:
    def __init__(self, path: str, tmp: str):
        self.path = path
        self.tmp = tmp
        self.n = 0

    def supports(self, left, right, forest=ZERO, epipolar=True,
                 disp_high=DISP_HIGH, gradient=5, vertical=0):
        from opengpc_tpu.io.raw import write_raw

        self.n += 1
        lp, rp, op = (os.path.join(self.tmp, f"o{self.n}.{s}")
                      for s in ("l.raw", "r.raw", "txt"))
        write_raw(lp, left)
        write_raw(rp, right)
        subprocess.run([self.path, "sparsematch", forest, lp, rp, op,
                        str(gradient), str(vertical), str(disp_high),
                        str(int(epipolar)), "0"], check=True)
        return load_set(op)


def load_set(path: str) -> set:
    import numpy as np

    rows = np.loadtxt(path, dtype=np.int64, ndmin=2).reshape(-1, 3)
    return set(map(tuple, rows[:, :3].tolist()))


def as_set(arr) -> set:
    import numpy as np

    return set(map(tuple, np.asarray(arr)[:, :3].astype(np.int64).tolist()))


def expect_equal(label: str, got: set, want: set) -> int:
    if got != want:
        raise AssertionError(
            f"{label}: {len(got)} supports vs {len(want)} in the reference "
            f"({len(got - want)} extra, {len(want - got)} missing)")
    if not want:
        raise AssertionError(f"{label}: empty support set")
    return len(want)


def on_cpu():
    import jax

    return jax.default_device(jax.devices("cpu")[0])


def settings(epipolar=True, **kw):
    from opengpc_tpu.config import InferenceSettings

    return InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                             disp_high=DISP_HIGH, epipolar_mode=epipolar,
                             capacity=1 << 19, **kw)


def scene(seed, h=None, w=None):
    import numpy as np

    from opengpc_tpu.utils.scenes import make_scene

    return make_scene(np.random.default_rng(seed), h or H, w or W)


def masked_set(fn, left, right):
    from opengpc_tpu.infer import masked_supports_to_numpy

    buf, counts = fn(left, right)
    return as_set(masked_supports_to_numpy(buf, counts, DISP_HIGH))


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def phase_cli(ctx):
    from opengpc_tpu.cli.sparsematch import main as sm_main
    from opengpc_tpu.io.png import write_png

    left, right, _, _ = scene(ctx.seed)
    lp, rp = (os.path.join(ctx.tmp, f"cli_{s}.png") for s in "lr")
    write_png(lp, left)
    write_png(rp, right)
    sp = os.path.join(ctx.tmp, "cli_supports.txt")
    rc = sm_main([ZERO, lp, rp, "--supports-out", sp, "--capacity",
                  str(1 << 20),
                  "--out", os.path.join(ctx.tmp, "cli_disparity.png")])
    if rc != 0:
        raise AssertionError(f"sparsematch CLI exited {rc}")
    return expect_equal("cli", load_set(sp),
                        ctx.oracle.supports(left, right))


def phase_contracts(ctx):
    import numpy as np

    from opengpc_tpu import infer, sparsematch
    from opengpc_tpu.forest import (load_forest, make_filter_mask,
                                    save_forest, truncate_forest)
    from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                     pyramid_supports_to_numpy)
    from opengpc_tpu.utils.scenes import make_sparse_pair

    zero = load_forest(ZERO)
    st, gst = settings(), settings(epipolar=False)
    n = 0
    # ~15%-density scene: every epipolar contract and the one-call API
    sl, sr = make_sparse_pair(H, W, 16, density=0.15, seed=ctx.seed)
    want = ctx.oracle.supports(sl, sr)
    n += expect_equal("sparsematch()", as_set(sparsematch(sl, sr, ZERO, st)),
                      want)
    n += expect_equal("masked", masked_set(
        infer.build_sparsematch_masked(zero, st), sl, sr), want)
    (xs, ds), rc = infer.build_sparsematch_rows(zero, st)(sl, sr)
    n += expect_equal("rows", as_set(infer.row_supports_to_numpy(xs, ds, rc)),
                      want)
    xs, ys, ds, count = infer.build_sparsematch(zero, st)(sl, sr)
    if int(count) > st.capacity:
        raise AssertionError(f"flat: {int(count)} supports over capacity")
    n += expect_equal("flat", as_set(infer.supports_to_numpy(xs, ys, ds,
                                                             count)), want)
    buf, rc, ovf = infer.build_sparsematch_masked_compact(zero, st)(sl, sr)
    if bool(ovf):
        raise AssertionError("masked-compact overflowed on the sparse scene")
    n += expect_equal("masked-compact", as_set(
        infer.masked_supports_to_numpy(buf, rc, DISP_HIGH)), want)
    # global mode (the reference's default): segmented and compacted
    gwant = ctx.oracle.supports(sl, sr, epipolar=False)
    (xs, ys, ds), rc = infer.build_sparsematch_global_rows(zero, gst)(sl, sr)
    n += expect_equal("global-rows", as_set(
        infer.global_row_supports_to_numpy(xs, ys, ds, rc)), gwant)
    (xs, ys, ds), rc, ovf = infer.build_sparsematch_global_compact(
        zero, gst, **GLOBAL_CHUNKS)(sl, sr)
    if bool(ovf):
        raise AssertionError("global-compact overflowed on the sparse scene")
    n += expect_equal("global-compact", as_set(
        infer.global_row_supports_to_numpy(xs, ys, ds, rc)), gwant)
    # the tau forest and the 17-test single-operand sort, dense scene
    left, right, _, _ = scene(ctx.seed + 1)
    n += expect_equal("tau", masked_set(
        infer.build_sparsematch_masked(load_forest(TAU), st), left, right),
        ctx.oracle.supports(left, right, forest=TAU))
    f17 = os.path.join(ctx.tmp, "zero17.txt")
    save_forest(truncate_forest(zero, 17), f17)
    mask17 = make_filter_mask(load_forest(f17))
    from opengpc_tpu.match import _pack_ok

    if not _pack_ok(mask17.num_tests, 2 * W):
        raise AssertionError("17 tests should ride the one-operand sort")
    n += expect_equal("max-tests 17", masked_set(
        infer.build_sparsematch_masked(mask17, st), left, right),
        ctx.oracle.supports(left, right, forest=f17))
    # a B=4 batch folded into one (4*H, 2W) masked sort
    pairs = [scene(ctx.seed + 10 + i)[:2] for i in range(4)]
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    bufs, counts = infer.build_sparsematch_masked(zero, st)(lb, rb)
    bufs, counts = np.asarray(bufs), np.asarray(counts)
    for i, (l, r) in enumerate(pairs):
        n += expect_equal(f"batch[{i}]", as_set(infer.masked_supports_to_numpy(
            bufs[i], counts[i], DISP_HIGH)), ctx.oracle.supports(l, r))
    # 3-level pyramid, against the same builder on the CPU
    pyr = build_pyramid_sparsematch(zero, st, num_levels=3)
    got = [np.asarray(o) for o in pyr(left, right)]
    with on_cpu():
        ref = [np.asarray(o) for o in pyr(left, right)]
    if not np.array_equal(got[4], ref[4]):
        raise AssertionError(f"pyramid counts {got[4]} != cpu {ref[4]}")
    n += expect_equal("pyramid", set(map(tuple, pyramid_supports_to_numpy(
        *got).tolist())), set(map(tuple, pyramid_supports_to_numpy(
            *ref).tolist())))
    return n


def phase_hd(ctx):
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked

    fn = build_sparsematch_masked(load_forest(ZERO), settings())
    n = 0
    for h, w in HD_SIZES:
        left, right, _, _ = scene(ctx.seed + h, h, w)
        n += expect_equal(f"masked {w}x{h}", masked_set(fn, left, right),
                          ctx.oracle.supports(left, right))
    return n


def phase_densify(ctx):
    import numpy as np

    from opengpc_tpu.densify import densify_from_masked
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked

    left, right, _, _ = scene(ctx.seed)
    buf, counts = build_sparsematch_masked(load_forest(ZERO),
                                           settings())(left, right)
    buf, counts = np.asarray(buf), np.asarray(counts)
    val, filled = (np.asarray(a) for a in densify_from_masked(
        buf, counts, DISP_HIGH, width=W))
    with on_cpu():
        cval, cfilled = (np.asarray(a) for a in densify_from_masked(
            buf, counts, DISP_HIGH, width=W))
    if not np.array_equal(filled, cfilled):
        raise AssertionError("densify: filled masks differ from the CPU")
    err = float(np.abs(val - cval)[filled].max())
    print(f"  densify max |gpu - cpu| = {err!r} px over {int(filled.sum())} "
          f"filled pixels (tolerance {DENSIFY_ATOL})", flush=True)
    if not err <= DENSIFY_ATOL:
        raise AssertionError(f"densify differs from the CPU by {err} px")
    return int(counts.sum())


def mine(seed: int, n: int):
    """(n, 3, 729) uint8 triplets mined from synthetic scenes — the
    extract stage of the reference workflow, on the host."""
    import numpy as np

    from opengpc_tpu.mine import extract_triplets, mine_stereo_pair

    rng = np.random.default_rng(seed)
    out, got, i = [], 0, 0
    while got < n:
        left, right, disp, occ = scene(seed + 100 + i)
        kl, kr, kn = mine_stereo_pair(disp.astype(np.float64), occ,
                                      np.zeros_like(occ), 5000, 10, 20, rng)
        t = extract_triplets(left, right, kl, kr, kn)
        out.append(t)
        got += len(t)
        i += 1
    return np.concatenate(out)[:n]


def phase_train(ctx):
    from opengpc_tpu.cli.train import main as train_main
    from opengpc_tpu.io.triplets import save_triplets

    trips = mine(ctx.seed, N_TRIPLETS)
    ds = os.path.join(ctx.tmp, "triplets.bin")
    save_triplets(trips, ds)
    outs = {}
    for where in ("gpu", "cpu"):
        out = os.path.join(ctx.tmp, f"forest_{where}.txt")
        t0 = time.perf_counter()
        if where == "cpu":
            with on_cpu():
                rc = train_main([ds, out, "--seed", str(ctx.seed)])
        else:
            rc = train_main([ds, out, "--seed", str(ctx.seed)])
        if rc != 0:
            raise AssertionError(f"train CLI ({where}) exited {rc}")
        print(f"  train on {where}: {len(trips)} triplets, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        with open(out, "rb") as f:
            outs[where] = f.read()
    if outs["gpu"] != outs["cpu"]:
        raise AssertionError("trained forest differs from the CPU run")
    return len(trips)


def phase_aot(ctx):
    from opengpc_tpu.cli.aot import main as aot_main
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked
    from opengpc_tpu.io.png import write_png

    left, right, _, _ = scene(ctx.seed + 3)
    lp, rp = (os.path.join(ctx.tmp, f"aot_{s}.png") for s in "lr")
    write_png(lp, left)
    write_png(rp, right)
    art = os.path.join(ctx.tmp, "masked.ogpcx")
    sp = os.path.join(ctx.tmp, "aot_supports.txt")
    if aot_main(["export", ZERO, art, "--height", str(H), "--width", str(W),
                 "--contract", "masked"]) != 0:
        raise AssertionError("AOT export failed")
    if aot_main(["run", art, lp, rp, "--supports-out", sp]) != 0:
        raise AssertionError("AOT run failed")
    live = masked_set(build_sparsematch_masked(load_forest(ZERO),
                                               settings()), left, right)
    return expect_equal("aot", load_set(sp), live)


# ---------------------------------------------------------------------------
# four-card phases: each against the single-device result
# ---------------------------------------------------------------------------

def _single(fn, *args):
    import jax
    import numpy as np

    with jax.default_device(jax.devices()[0]):
        return jax.tree_util.tree_map(np.asarray, fn(*args))


def phase_batch_mesh(ctx):
    import numpy as np

    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked
    from opengpc_tpu.parallel import build_batched_sparsematch_masked, make_mesh

    zero, st = load_forest(ZERO), settings()
    pairs = [scene(ctx.seed + 20 + i)[:2] for i in range(8)]
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    buf, counts = (np.asarray(a) for a in build_batched_sparsematch_masked(
        zero, st, make_mesh())(lb, rb))
    sbuf, scounts = _single(build_sparsematch_masked(zero, st), lb, rb)
    if not (np.array_equal(buf, sbuf) and np.array_equal(counts, scounts)):
        raise AssertionError("batch mesh != single device")
    return int(counts.sum())


def phase_sharded_frame(ctx):
    import numpy as np

    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch, make_mesh

    zero, st = load_forest(ZERO), settings()
    left, right, _, _ = scene(ctx.seed + 2160, *FRAME_4K)
    buf, counts = (np.asarray(a) for a in build_sharded_frame_sparsematch(
        zero, st, make_mesh())(left, right))
    sbuf, scounts = _single(build_sparsematch_masked(zero, st), left, right)
    if not (np.array_equal(buf, sbuf) and np.array_equal(counts, scounts)):
        raise AssertionError("row-sharded 4K frame != single device")
    return int(counts.sum())


def phase_global_compact(ctx):
    import numpy as np

    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import (build_sparsematch_global_rows,
                                   global_row_supports_to_numpy)
    from opengpc_tpu.parallel import build_sharded_frame_sparsematch, make_mesh
    from opengpc_tpu.utils.scenes import make_sparse_pair

    zero, gst = load_forest(ZERO), settings(epipolar=False)
    sl, sr = make_sparse_pair(H, W, 16, density=0.15, seed=ctx.seed)
    (xs, ys, ds), counts, ovf = build_sharded_frame_sparsematch(
        zero, gst, make_mesh(), contract="global-compact",
        **GLOBAL_CHUNKS)(sl, sr)
    if bool(ovf):
        raise AssertionError("sharded global-compact overflowed")
    got = as_set(global_row_supports_to_numpy(
        np.asarray(xs), np.asarray(ys), np.asarray(ds), np.asarray(counts)))
    (wx, wy, wd), wc = _single(build_sparsematch_global_rows(zero, gst),
                               sl, sr)
    return expect_equal("global-compact (all_to_all)", got, as_set(
        global_row_supports_to_numpy(wx, wy, wd, wc)))


def phase_mesh_2d(ctx):
    import numpy as np

    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.infer import build_sparsematch_masked
    from opengpc_tpu.parallel import (build_batched_sharded_frame_sparsematch,
                                      make_mesh_2d)

    zero, st = load_forest(ZERO), settings()
    pairs = [scene(ctx.seed + 40 + i)[:2] for i in range(4)]
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    buf, counts = (np.asarray(a) for a in
                   build_batched_sharded_frame_sparsematch(
                       zero, st, make_mesh_2d(2, 2))(lb, rb))
    sbuf, scounts = _single(build_sparsematch_masked(zero, st), lb, rb)
    if not (np.array_equal(buf, sbuf) and np.array_equal(counts, scounts)):
        raise AssertionError("2x2 mesh != single device")
    return int(counts.sum())


def phase_train_mesh(ctx):
    import jax
    import numpy as np

    from opengpc_tpu.config import zero_optimizer
    from opengpc_tpu.forest import SCALE_L
    from opengpc_tpu.parallel import make_mesh
    from opengpc_tpu.train import train_fern

    trips = mine(ctx.seed, N_TRIPLETS)
    opt = zero_optimizer(num_resamples=10)

    def run(mesh):
        return train_fern(trips, SCALE_L, opt, 5,
                          rng=np.random.default_rng(ctx.seed),
                          verbose=False, mesh=mesh)

    got = run(make_mesh())
    with jax.default_device(jax.devices()[0]):
        want = run(None)
    if got != want:
        raise AssertionError("psum-sharded fern != single-device fern")
    return len(trips)


# ---------------------------------------------------------------------------

class Ctx:
    def __init__(self, seed, tmp, oracle):
        self.seed, self.tmp, self.oracle = seed, tmp, oracle


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-device phases, on four GPUs")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    dev = require_gpu()
    import jax

    from opengpc_tpu.utils.device import announce_device, setup_compile_cache

    cache = setup_compile_cache()
    print(smi_text(), flush=True)
    announce_device(sys.stdout)
    print(f"compile cache: {cache}", flush=True)
    n_dev = len(jax.devices())
    if args.four_cards and n_dev != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX sees {n_dev}")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Ctx(args.seed, tmp, Oracle(build_oracle(), tmp))
        for name in select_phases(args.four_cards):
            t0 = time.perf_counter()
            n = globals()[f"phase_{name}"](ctx)
            print(f"phase {name}: supports={n} "
                  f"wall={time.perf_counter() - t0:.2f}s (compile included) "
                  f"ok", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": n_dev if args.four_cards else 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Minimal AOT serving loop: freeze the matcher once, then serve a
directory of frame pairs with ZERO Python re-tracing per frame.

This is the analog of deploying the reference's compiled
sparsematch binary (/root/reference/samples/sparsematch.cpp): the forest,
settings, frame shape and output contract are burned into one StableHLO
artifact at export time; the serving side needs only jax + the artifact.

Usage:
    python examples/serve.py <forest.txt> <left_dir> <right_dir> <out_dir>
                             [--contract masked] [--disp-high 128]
                             [--densify] [--reuse-artifact path.ogpcx]

Demonstrates, end to end:
  1. `aot.export_sparsematch` + `save_artifact` — one-time freeze.
  2. `aot.load_artifact` + `decode_outputs` — the generic server side
     (routes device outputs by the artifact's self-describing metadata).
  3. `densify.densify_from_masked` — a device-resident consumer chained
     onto the artifact's outputs with no host decode/re-upload.
"""
import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("forest")
    p.add_argument("left_dir")
    p.add_argument("right_dir")
    p.add_argument("out_dir")
    p.add_argument("--contract", default="masked",
                   choices=("flat", "rows", "masked", "masked-compact"))
    p.add_argument("--disp-high", type=int, default=128)
    p.add_argument("--gradient-threshold", type=int, default=5)
    p.add_argument("--densify", action="store_true",
                   help="also write dense_<frame>.png via the "
                   "device-resident masked-buffer densifier")
    p.add_argument("--reuse-artifact", default=None, metavar="PATH",
                   help="load this artifact instead of exporting (the "
                   "forest argument is ignored; shape must match)")
    args = p.parse_args(argv)

    from opengpc_tpu import aot
    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest
    from opengpc_tpu.io.png import read_gray, write_png
    from opengpc_tpu.io.supports import write_supports
    from opengpc_tpu.utils.device import start

    start()
    lefts = sorted(f for f in os.listdir(args.left_dir)
                   if f.endswith(".png"))
    rights = sorted(f for f in os.listdir(args.right_dir)
                    if f.endswith(".png"))
    if not lefts or len(lefts) != len(rights):
        print(f"need equal non-empty frame lists, got {len(lefts)} left / "
              f"{len(rights)} right", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)

    probe = read_gray(os.path.join(args.left_dir, lefts[0]))
    settings = InferenceSettings(
        gradient_threshold=args.gradient_threshold,
        disp_high=args.disp_high, vertical_tolerance=0,
        epipolar_mode=True, capacity=262144)

    art = args.reuse_artifact or os.path.join(args.out_dir,
                                              "matcher.ogpcx")
    if args.reuse_artifact and not os.path.exists(art):
        # --reuse-artifact promises to serve an EXISTING artifact (the
        # forest argument is ignored); silently exporting a fresh one here
        # would serve a different matcher than the one asked for
        print(f"--reuse-artifact {art}: no such file", file=sys.stderr)
        return 1
    if not args.reuse_artifact:
        t0 = time.perf_counter()
        blob = aot.export_sparsematch(load_forest(args.forest), settings,
                                      probe.shape, contract=args.contract)
        aot.save_artifact(art, blob, contract=args.contract,
                          settings=settings, shape=probe.shape)
        print(f"exported {art} ({os.path.getsize(art)} B) "
              f"in {time.perf_counter() - t0:.1f} s")

    fn, meta = aot.load_artifact(art)
    if tuple(meta["shape"]) != probe.shape:
        print(f"artifact shape {meta['shape']} != frame {probe.shape}",
              file=sys.stderr)
        return 1

    masked = meta["contract"] in ("masked", "masked-compact")
    for i, (lf, rf) in enumerate(zip(lefts, rights)):
        left = read_gray(os.path.join(args.left_dir, lf))
        right = read_gray(os.path.join(args.right_dir, rf))
        t0 = time.perf_counter()
        out = fn(left, right)
        try:
            supports = aot.decode_outputs(meta, out)
        except OverflowError as e:
            # masked-compact artifact + a dense frame: the artifact is one
            # frozen program, so re-dispatch is impossible here — skip the
            # frame and keep serving (ship a full-width artifact alongside
            # for dense frames, see aot.decode_outputs)
            print(f"[{i + 1}/{len(lefts)}] {lf}: SKIPPED — {e}",
                  file=sys.stderr)
            continue
        stem = os.path.splitext(lf)[0]
        # pyramid artifacts decode to (n, 4) x/y/d/level; the text format
        # is the 3-column one (level-0 units), like the sparsematch CLI
        write_supports(os.path.join(args.out_dir, f"{stem}.txt"),
                       supports[:, :3])
        line = (f"[{i + 1}/{len(lefts)}] {lf}: {len(supports)} supports "
                f"in {1e3 * (time.perf_counter() - t0):.1f} ms")
        if args.densify and masked:
            from opengpc_tpu.densify import densify_from_masked
            from opengpc_tpu.viz import dense_disparity_visualization

            dense, filled = densify_from_masked(
                out[0], out[1], meta["disp_high"], width=left.shape[1])
            write_png(os.path.join(args.out_dir, f"dense_{stem}.png"),
                      dense_disparity_visualization(
                          left, np.asarray(dense), np.asarray(filled),
                          max_disparity=meta["disp_high"]))
            line += " +dense"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

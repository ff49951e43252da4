"""AOT artifact CLI: export a frozen matcher pipeline, run one for serving.

``export`` freezes forest + settings + frame shape + output contract into
one self-describing StableHLO artifact (see opengpc_tpu.aot) — the
analog of building the reference's sparsematch binary once per
deployment (/root/reference/samples/sparsematch.cpp).  ``run`` is the
serving side: deserialize, execute, decode, write supports — no forest
file, no pipeline re-trace.

    python -m opengpc_tpu.cli.aot export forest.txt matcher.ogpcx \\
        --height 436 --width 1024 --contract masked --disp-high 128
    python -m opengpc_tpu.cli.aot run matcher.ogpcx left.png right.png \\
        --supports-out supports.txt
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from opengpc_tpu.aot import (CONTRACTS, decode_outputs, export_sparsematch,
                             load_artifact, save_artifact)
from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.cli._errors import report_input_errors
from opengpc_tpu.utils.device import start


@report_input_errors
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="opengpc-aot", description=__doc__.splitlines()[0]
    )
    from opengpc_tpu import __version__
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="freeze a matcher into an artifact")
    pe.add_argument("forest", help="text forest path")
    pe.add_argument("artifact", help="output artifact path (.ogpcx)")
    pe.add_argument("--height", type=int, required=True)
    pe.add_argument("--width", type=int, required=True)
    pe.add_argument("--contract", choices=CONTRACTS, default="masked")
    pe.add_argument("--gradient-threshold", type=int, default=5)
    pe.add_argument("--disp-high", type=int, default=128)
    pe.add_argument("--vertical-tolerance", type=int, default=0)
    pe.add_argument("--global-mode", action="store_true")
    pe.add_argument("--capacity", type=int, default=65536,
                    help="flat-contract support capacity")
    pe.add_argument("--platforms", default=None,
                    help="comma-separated lowering targets, e.g. cpu,cuda "
                    "(default: current backend)")
    pe.add_argument("--shard-frame", type=int, default=0, metavar="N",
                    help="freeze the ROW-SHARDED matcher over N devices "
                    "(one pair's rows across the mesh, 14-row halo; "
                    "masked/rows/masked-compact only).  With "
                    "--data-parallel/--batch, freezes the 2-D (data x "
                    "rows) batched variant instead")
    pe.add_argument("--data-parallel", type=int, default=0, metavar="D",
                    help="with --shard-frame: 'data' axis of the 2-D mesh "
                    "(needs D*N devices and --batch)")
    pe.add_argument("--batch", type=int, default=0, metavar="B",
                    help="with --shard-frame: freeze a (B, H, W) stacked "
                    "input (required when --data-parallel > 1; B must "
                    "divide by D)")
    pe.add_argument("--levels", type=int, default=3, metavar="L",
                    help="pyramid levels for the pyramid contracts "
                    "(default 3)")
    pe.add_argument("--max-tests", type=int, default=None, metavar="T",
                    help="truncate the forest to its first T tests (file "
                    "order) before freezing — T + bit_length(2W-1) <= 30 "
                    "rides the single-operand packed sort")

    pr = sub.add_parser("run", help="serve one pair from an artifact")
    pr.add_argument("artifact")
    pr.add_argument("left")
    pr.add_argument("right")
    pr.add_argument("--supports-out", default=None,
                    help="write (x, y, d) supports here")
    pr.add_argument("--repeats", type=int, default=1,
                    help="re-run the call N times, report the best")

    args = p.parse_args(argv)
    start()
    return _export(args) if args.cmd == "export" else _run(args)


def _export(args) -> int:
    from opengpc_tpu.forest import load_forest, truncate_forest

    forest = load_forest(args.forest)
    if args.max_tests is not None:
        if not 1 <= args.max_tests <= forest.num_tests:
            print(f"--max-tests must be in [1, {forest.num_tests}] for "
                  "this forest", file=sys.stderr)
            return 1
        forest = truncate_forest(forest, args.max_tests)
    settings = InferenceSettings(
        gradient_threshold=args.gradient_threshold,
        disp_high=args.disp_high,
        vertical_tolerance=args.vertical_tolerance,
        epipolar_mode=not args.global_mode,
        capacity=args.capacity,
    )
    plats = tuple(args.platforms.split(",")) if args.platforms else None
    shape = (args.height, args.width)
    sf, dp, batch = args.shard_frame, args.data_parallel, args.batch
    extra = None
    try:
        if sf > 1:
            import jax

            from opengpc_tpu.aot import (export_batched_sharded_frame,
                                         export_sharded_frame)
            from opengpc_tpu.parallel import make_mesh, make_mesh_2d

            if plats:
                print("--shard-frame artifacts lower for the current "
                      "backend only; drop --platforms", file=sys.stderr)
                return 1
            devs = jax.devices()
            nd = max(dp, 1)
            if len(devs) < nd * sf:
                print(f"--shard-frame {sf} x --data-parallel {nd}: only "
                      f"{len(devs)} devices visible", file=sys.stderr)
                return 1
            if dp > 1 or batch >= 1:
                # any explicit --batch (including 1) freezes the STACKED
                # (B, H, W) variant — matching the sequence CLI, where
                # --batch 1 with --shard-frame still dispatches stacks
                if batch < 1 or batch % nd:
                    print(f"--batch {batch} must be a positive multiple "
                          f"of --data-parallel {nd}", file=sys.stderr)
                    return 1
                mesh = make_mesh_2d(nd, sf, devs[:nd * sf])
                blob = export_batched_sharded_frame(
                    forest, settings, batch, shape, mesh,
                    contract=args.contract, num_levels=args.levels)
                extra = {"mesh_shape": [nd, sf], "batch": batch,
                         "n_devices": nd * sf}
                if args.contract == "pyramid":
                    extra["num_levels"] = args.levels
            else:
                blob = export_sharded_frame(
                    forest, settings, shape, make_mesh(devs[:sf]),
                    contract=args.contract, num_levels=args.levels)
                extra = {"n_devices": sf}
                if args.contract == "pyramid":
                    extra["num_levels"] = args.levels
        elif dp > 1 or batch >= 1:
            # any explicit --batch (even 1) without --shard-frame must
            # error, mirroring the stacked semantics the sharded branch
            # gives it — not silently export the unstacked module
            print("--data-parallel/--batch exports need --shard-frame "
                  "(batch-axis scale-out has no frozen artifact; the "
                  "live parallel.build_batched_sparsematch_* builders "
                  "cover it)", file=sys.stderr)
            return 1
        else:
            blob = export_sparsematch(forest, settings, shape,
                                      contract=args.contract,
                                      platforms=plats,
                                      num_levels=args.levels)
            if args.contract.startswith("pyramid"):
                extra = {"num_levels": args.levels}
    except ValueError as e:
        print(f"export failed: {e}", file=sys.stderr)
        return 1
    save_artifact(args.artifact, blob, contract=args.contract,
                  settings=settings, shape=shape, platforms=plats,
                  extra=extra)
    print(f"wrote {args.artifact} ({len(blob)} byte module, contract "
          f"{args.contract}, shape {shape}, platforms "
          f"{','.join(plats) if plats else 'default'})")
    return 0


def _run(args) -> int:
    from opengpc_tpu.aot import peek_artifact_meta
    from opengpc_tpu.io.png import read_gray
    from opengpc_tpu.io.supports import write_supports

    # route on the header BEFORE deserializing: a stacked artifact (or a
    # sharded one needing more chips than this host has) must produce the
    # friendly message, not a mesh-construction traceback
    meta = peek_artifact_meta(args.artifact)
    if meta.get("mesh_shape"):
        print("this artifact freezes a (B, H, W) STACKED input over a "
              f"{meta['mesh_shape']} (data, rows) mesh — serve it with "
              "opengpc_tpu.aot.load_artifact in Python (see "
              "examples/serve.py) rather than the single-pair run command",
              file=sys.stderr)
        return 1
    if meta.get("n_devices", 1) > 1:
        import jax

        if len(jax.devices()) < meta["n_devices"]:
            print(f"this artifact row-shards one frame over "
                  f"{meta['n_devices']} devices; this host has "
                  f"{len(jax.devices())}", file=sys.stderr)
            return 1
    call, meta = load_artifact(args.artifact)
    left = read_gray(args.left)
    right = read_gray(args.right)
    want = tuple(meta["shape"])
    if left.shape != want or right.shape != want:
        print(f"artifact is frozen for shape {want}; got "
              f"{left.shape} / {right.shape}", file=sys.stderr)
        return 1
    try:
        t0 = time.perf_counter()
        out = call(left, right)
        supports = decode_outputs(meta, out)
        t_first = time.perf_counter() - t0
        best = t_first
        for _ in range(max(0, args.repeats - 1)):
            t0 = time.perf_counter()
            supports = decode_outputs(meta, call(left, right))
            best = min(best, time.perf_counter() - t0)
    except OverflowError as e:
        print(f"{e}", file=sys.stderr)
        return 1
    print(f"tTotal: {best * 1e3:.2f} ms (first call incl. compile: "
          f"{t_first * 1e3:.1f} ms; incl. host decode), "
          f"num matches: {len(supports)} (contract {meta['contract']})")
    if args.supports_out:
        # pyramid contracts decode to (n, 4) [x, y, d, level]; the text
        # format is the 3-column 'x y d' one (level-0 units), like the
        # sparsematch CLI's --pyramid output
        write_supports(args.supports_out, supports[:, :3])
        print(f"wrote {args.supports_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sparse stereo matching CLI.

Equivalent of the reference ``sparsematch`` sample
(/root/reference/samples/sparsematch.cpp): load a text forest and a
rectified stereo pair, run the matcher, print timing/counters, write
``disparity.png`` and (optionally) a ``supports.txt`` with one
``x y d`` line per support.

Defaults mirror the reference sample (sparsematch.cpp:29-34): gradient
threshold 5, vertical tolerance 0, dispHigh 128, epipolar mode on.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np

from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.forest import load_forest
from opengpc_tpu.infer import build_sparsematch, supports_to_numpy
from opengpc_tpu.io.png import read_gray, write_png
from opengpc_tpu.io.supports import write_supports
from opengpc_tpu.viz import disparity_visualization
from opengpc_tpu.cli._errors import report_input_errors
from opengpc_tpu.utils.device import start


# auto-contract density cutoff, as a fraction of the chosen contract's
# chunk capacity ratio K/S (masked: 64/128 -> cutoff 0.30; wide-row global:
# 128/512 -> 0.15).  Scaling with the actual per-chunk capacity matters —
# a flat 0.30 cutoff on wide-row global frames (K/S=1/4) would overflow on
# nearly every dispatch and pay compact + full-width device work.  A
# misprediction is still exact either way: the overflow guard re-runs the
# dispatch full-width.
_AUTO_COMPACT_FRACTION = 0.6


def _auto_compact_threshold(masked: bool, width: int) -> float:
    """Density at or below which auto mode rides the chunk-compacted
    contract for this frame width (see _AUTO_COMPACT_FRACTION)."""
    from opengpc_tpu.match import (MASKED_COMPACT_CHUNKS,
                                   global_compact_chunks)

    chunk, k = (MASKED_COMPACT_CHUNKS if masked
                else global_compact_chunks(2 * width))
    return _AUTO_COMPACT_FRACTION * (k / chunk)


@functools.lru_cache(maxsize=8)
def _probe_fn(gradient_threshold: int):
    """One cached jitted reduce per gradient threshold: the hysteresis
    path (dense stretches of a sequence) probes EVERY frame, so a fresh
    ``jax.jit(lambda ...)`` per call would retrace/recompile per frame —
    exactly the cost the probe exists to avoid."""
    import jax
    import jax.numpy as jnp

    from opengpc_tpu.ops.preprocess import candidate_mask, sobel3

    gt = gradient_threshold
    return jax.jit(
        lambda a, b: jnp.maximum(
            candidate_mask(sobel3(a, gt)).mean(),
            candidate_mask(sobel3(b, gt)).mean()))


def _probe_density(settings, left, right) -> float:
    """Candidate density of one pair under ``gradient_threshold``: max of
    the two images' candidate-mask means, computed by ONE tiny jitted
    program (one dispatch instead of one per eager jnp op; the jitted
    reduce is cached per threshold).  Drives the density-adaptive auto
    contract."""
    return float(np.asarray(
        _probe_fn(settings.gradient_threshold)(left, right)))


class _OverflowGuard:
    """Exactness guard shared by every chunk-compacted call site: the
    compacted matchers return ``(*outputs, overflow)``, and a True flag
    (any chunk held more candidates than its capacity — a dense frame)
    means the compacted outputs must be discarded and the dispatch re-run
    through the full-width builder.  The fallback builder is constructed
    lazily (one extra trace/compile, only ever paid on a misprediction)
    and cached for the run."""

    def __init__(self, make_fallback, notice: str):
        self._make = make_fallback
        self._fb = None
        self.notice = notice

    def fallback(self):
        if self._fb is None:
            self._fb = self._make()
        return self._fb

    def wrap(self, fast_match):
        """``(l, r) -> outputs`` that transparently re-runs overflows."""

        def match(l, r):
            out = fast_match(l, r)
            if bool(np.asarray(out[-1])):
                print(self.notice, file=sys.stderr)
                return self.fallback()(l, r)
            return out[:-1]

        return match


def _force(leaf) -> None:
    """Force device completion of a pipeline by fetching one small output
    (the counts leaf — everything else feeds it), so the phase split
    charges device time to the match phase and not to the first host
    transfer.  Costs one small-array roundtrip."""
    np.asarray(leaf)


@report_input_errors
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="opengpc-sparsematch", description=__doc__.splitlines()[0]
    )
    from opengpc_tpu import __version__
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("forest", help="text forest file")
    p.add_argument("left", help="left (source) image PNG")
    p.add_argument("right", help="right (target) image PNG")
    p.add_argument("--gradient-threshold", type=int, default=5)
    p.add_argument("--vertical-tolerance", type=int, default=0)
    p.add_argument("--disp-high", type=int, default=128)
    p.add_argument(
        "--global-mode",
        action="store_true",
        help="match codes globally instead of per-epipolar-line",
    )
    p.add_argument("--capacity", type=int, default=65536,
                   help="fixed support-buffer capacity")
    p.add_argument("--out", default="disparity.png", help="visualization PNG")
    p.add_argument("--supports-out", default=None,
                   help="optional text output, one 'x y d' line per support")
    p.add_argument("--repeats", type=int, default=1,
                   help="re-run the jitted matcher N times and report the best")
    p.add_argument("--batch", type=int, default=None, metavar="B",
                   help="sequence mode: stack B same-shape frame pairs per "
                   "dispatch (folded into one (B*H, 2W) segmented sort); "
                   "amortizes per-dispatch overhead, identical per-frame "
                   "outputs.  Default 4 on the fast contracts (1 disables)")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="sequence mode: shard each --batch dispatch "
                   "group's frames over the first N devices "
                   "(parallel.build_batched_sparsematch_* shard_map "
                   "builders; any contract but flat).  --batch must "
                   "divide by N (the default batch rounds itself up); "
                   "partial groups and mid-sequence shape changes still "
                   "dispatch singly")
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="capture a jax.profiler trace into LOGDIR")
    p.add_argument("--pyramid", type=int, default=1, metavar="LEVELS",
                   help="multi-scale matching over LEVELS pyramid levels. "
                   "Sequence mode rides the batched hybrid pyramid fold "
                   "(--contract auto, epipolar); single-pair mode also "
                   "composes with --shard-frame and --contract "
                   "masked-compact")
    p.add_argument("--densify", default=None, metavar="PNG",
                   help="also write a diffusion-densified disparity PNG")
    p.add_argument(
        "--viz-compat", choices=("canonical", "reference"),
        default="canonical",
        help="disparity.png colormap: canonical KITTI table (default) or "
        "the reference binary's rotated-by-one table + hardcoded [0,128] "
        "range (byte-identical to its output; buffer.hpp:960-963)",
    )
    p.add_argument(
        "--contract",
        choices=("auto", "flat", "rows", "masked", "masked-compact",
                 "global-rows", "global-compact"),
        default="auto",
        help="output contract for the on-device matcher: auto (default; "
        "row-form / segmented-global when eligible, and — in both "
        "single-pair and sequence mode — a candidate-density probe rides "
        "the chunk-compacted contracts on sparse frames), flat "
        "fixed-capacity buffers, row-form per-row packed buffers, the "
        "masked sorted-order buffer (peak device throughput; decode moves "
        "to the consumer), masked-compact (chunk-compacted masked — "
        "~27%% faster on low-candidate-density frames), global-rows "
        "(explicit full-width segmented global; needs --global-mode), or "
        "global-compact (chunk-compacted global mode, ~91%% faster on "
        "low-density frames; needs --global-mode).  The compacted "
        "contracts re-run full-width automatically when the overflow "
        "guard trips.  Identical support sets; rows/masked/masked-compact "
        "are epipolar-only; sequence mode supports everything but flat; "
        "--pyramid supports auto/masked-compact",
    )
    p.add_argument(
        "--shard-frame", type=int, default=0, metavar="N",
        help="shard each pair's ROWS over N devices (epipolar only, image "
        "height must divide by N and give each shard >= 14 rows).  "
        "Single-pair mode: parallel.build_sharded_frame_sparsematch; with "
        "--pyramid L the sharded multi-scale matcher (height must divide "
        "by N*2^(L-1)).  Sequence mode: composes with --data-parallel "
        "over a 2-D (data x rows) mesh "
        "(build_batched_sharded_frame_sparsematch, --data-parallel D x "
        "--shard-frame N <= devices; masked/rows/masked-compact "
        "contracts).  0 (default) = off",
    )
    p.add_argument(
        "--matcher", choices=("sort", "quirk", "hashmatch"), default="sort",
        help="sort: on-device clean unique-collision matcher (default); "
        "quirk: host-side bit-exact reference sweep incl. its edge quirks "
        "(useHashtable=false); hashmatch: host-side bit-exact reference "
        "hash-table matcher (useHashtable=true)",
    )
    p.add_argument(
        "--max-tests", type=int, default=None, metavar="N",
        help="truncate the forest to its first N tests in file order (the "
        "reference's own filter-mask cap rule applied at N instead of 32). "
        "N + bit_length(2W-1) <= 30 (17 at W=1024) rides the single-operand "
        "packed matcher sort (fewer supports, one sort operand less)",
    )
    args = p.parse_args(argv)
    start()

    import os

    # single-pair host latency: the reference
    # workflow (samples/sparsematch.cpp) reads two PNGs and a forest
    # serially; for LARGE frames both decodes start on a 2-thread pool
    # immediately and the forest parse overlaps them.  Size-gated because
    # the measured host crossover is real: at Sintel
    # size (~0.4 MB files, ~1-3 ms native decode) the pool spawn costs
    # more than it saves (8.2 -> 8.8 ms), at 4K (~1 MB) it wins
    # (179 -> 169 ms).  Joined right where the serial reads used to
    # happen — errors surface identically via Future.result.
    rd_futs = None
    if (not os.path.isdir(args.left) and os.path.isfile(args.left)
            and os.path.isfile(args.right)
            and min(os.path.getsize(args.left),
                    os.path.getsize(args.right)) > (512 << 10)):
        from concurrent.futures import ThreadPoolExecutor

        _rdpool = ThreadPoolExecutor(max_workers=2)
        rd_futs = (_rdpool.submit(read_gray, args.left),
                   _rdpool.submit(read_gray, args.right))
        _rdpool.shutdown(wait=False)

    forest = load_forest(args.forest)
    if args.max_tests is not None:
        from opengpc_tpu.forest import truncate_forest

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
    # the native PNG writer does not create directories; make every output
    # parent up front so a missing dir fails here, not mid-run
    for out in (args.out, args.densify, args.supports_out):
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)) or ".",
                        exist_ok=True)

    if os.path.isdir(args.left):
        if args.contract == "flat":
            print("--contract flat is not supported in sequence "
                  "(directory) mode — auto falls back to the flat "
                  "pipeline per frame only when no fast contract is "
                  "eligible", file=sys.stderr)
            return 1
        # reject explicitly-requested single-pair-only features instead of
        # silently ignoring them (same rule as the explicit-contract
        # handling: an option the user typed either works or errors)
        if args.pyramid > 1 and (args.contract != "auto"
                                 or args.global_mode):
            print("sequence --pyramid rides the batched rows pyramid "
                  "(--contract auto, epipolar mode only; the compact "
                  "pyramid engages via the auto density probe)",
                  file=sys.stderr)
            return 1
        unsupported = [name for name, on in (
            (f"--matcher {args.matcher}", args.matcher != "sort"),
            ("--repeats", args.repeats > 1),
            ("--trace", bool(args.trace)),
        ) if on]
        if unsupported:
            print("sequence (directory) mode does not support: "
                  f"{', '.join(unsupported)}", file=sys.stderr)
            return 1
        if args.supports_out:
            print("sequence mode writes per-frame supports_NNNN.txt next "
                  "to --out; --supports-out is ignored", file=sys.stderr)
        return _run_sequence(args, forest, settings)
    if args.batch is not None and args.batch > 1:
        print("--batch applies to sequence (directory) mode only",
              file=sys.stderr)
        return 1
    if args.data_parallel > 1:
        print("--data-parallel applies to sequence (directory) mode only "
              "(single-pair multi-chip is --shard-frame)", file=sys.stderr)
        return 1
    if rd_futs is not None:
        left = rd_futs[0].result()
        right = rd_futs[1].result()
    else:
        left = read_gray(args.left)
        right = read_gray(args.right)
    if left.shape != right.shape:
        print(f"image shapes differ: {left.shape} vs {right.shape}", file=sys.stderr)
        return 1

    if args.contract != "auto" and args.matcher != "sort":
        print("--contract applies to the on-device matcher only "
              "(not host --matcher modes)", file=sys.stderr)
        return 1
    if args.pyramid > 1 and args.contract not in ("auto", "masked-compact"):
        # masked-compact lifts to the pyramid (chunk-compacted per-level
        # matchers + rows-pyramid overflow fallback); the other contracts
        # describe single-scale output layouts and don't
        print("--pyramid supports --contract auto (rows when eligible) or "
              "masked-compact only", file=sys.stderr)
        return 1
    if args.matcher != "sort":
        dropped = [
            name for name, on in (
                ("--pyramid", args.pyramid > 1),
                ("--densify", bool(args.densify)),
                ("--trace", bool(args.trace)),
                ("--repeats", args.repeats > 1),
            ) if on
        ]
        if dropped:
            print(
                f"--matcher {args.matcher} (host-side reference matcher) "
                f"does not support: {', '.join(dropped)}",
                file=sys.stderr,
            )
            return 1
        return _run_host_matcher(args, forest, settings, left, right)

    row_form = False
    global_rows = False
    masked_form = False
    if args.shard_frame > 1:
        import jax

        from opengpc_tpu.forest import make_filter_mask
        from opengpc_tpu.infer import (_rows_ok, masked_supports_to_numpy,
                                       row_supports_to_numpy)
        from opengpc_tpu.ops.codes import PAD
        from opengpc_tpu.parallel import (build_sharded_frame_sparsematch,
                                          make_mesh)

        n = args.shard_frame
        gmode = args.global_mode
        ok_contracts = (("auto", "global-compact") if gmode
                        else ("auto", "rows", "masked", "masked-compact"))
        bad = [name for name, on in (
            ("--pyramid (with --global-mode)",
             args.pyramid > 1 and gmode),
            ("--pyramid (with an explicit --contract)",
             args.pyramid > 1 and args.contract != "auto"),
            (f"--matcher {args.matcher}", args.matcher != "sort"),
            (f"--contract {args.contract} (with "
             + ("--global-mode" if gmode else "epipolar mode") + ")",
             args.contract not in ok_contracts),
        ) if on]
        if bad:
            print(f"--shard-frame does not support: {', '.join(bad)}",
                  file=sys.stderr)
            return 1
        devs = jax.devices()
        if len(devs) < n:
            print(f"--shard-frame {n}: only {len(devs)} devices visible",
                  file=sys.stderr)
            return 1
        fmask = make_filter_mask(forest)
        if gmode:
            from opengpc_tpu.infer import _global_rows_ok

            eligible = _global_rows_ok(fmask, left.shape, settings)
        else:
            eligible = _rows_ok(fmask, left.shape, settings)
        if not eligible or left.shape[0] % n \
                or left.shape[0] // n < PAD:
            print(f"--shard-frame {n} needs a <=30-test forest, packable "
                  f"{'(y, x, d)' if gmode else '(x, d)'} keys, and an "
                  f"image height divisible by {n} with >= {PAD} rows per "
                  f"shard (got {left.shape})", file=sys.stderr)
            return 1
        mesh = make_mesh(devs[:n])
        if args.pyramid > 1:
            # sharded multi-scale (r5): one pair's rows over the mesh at
            # every level; stricter alignment than the flat contracts
            from opengpc_tpu.parallel import build_sharded_frame_pyramid
            from opengpc_tpu.pyramid import (_rows_eligible,
                                             pyramid_supports_to_numpy)

            align = n << (args.pyramid - 1)
            if left.shape[0] % align or \
                    (left.shape[0] // n) >> (args.pyramid - 1) < PAD:
                print(f"--shard-frame {n} --pyramid {args.pyramid} needs "
                      f"an image height divisible by {align} with the "
                      f"coarsest slab >= {PAD} rows (got {left.shape}); "
                      "pad the pair or reduce levels", file=sys.stderr)
                return 1
            if _rows_eligible(fmask, settings, left.shape[0],
                              left.shape[1], args.pyramid) is None:
                # _rows_ok passed above, so the extra clause that failed is
                # the (pixel, level, d) dedup-key budget — surface it as a
                # CLI message instead of the builder's in-trace ValueError
                print(f"--shard-frame {n} --pyramid {args.pyramid}: the "
                      f"finest-wins dedup key for {left.shape[0]}x"
                      f"{left.shape[1]} x {args.pyramid} levels exceeds "
                      "int32 packing; reduce levels or the image size",
                      file=sys.stderr)
                return 1
            match = build_sharded_frame_pyramid(
                fmask, settings, mesh, num_levels=args.pyramid)
        elif gmode:
            # distributed bucket sort (one all_to_all); dense frames trip
            # the replicated chunk/bucket overflow flag and re-run on one
            # device at full width (cross-shard uniqueness has no exact
            # full-width sharded form)
            from opengpc_tpu.infer import (build_sparsematch_global_rows,
                                           global_row_supports_to_numpy)

            global_rows = True
            smatch = build_sharded_frame_sparsematch(
                fmask, settings, mesh, contract="global-compact")
            match = _OverflowGuard(
                lambda: build_sparsematch_global_rows(fmask, settings),
                "global-compact overflow: dense frame, re-ran the "
                "single-device full-width global matcher").wrap(smatch)
        else:
            contract = (args.contract if args.contract in ("rows",
                                                           "masked-compact")
                        else "masked")
            masked_form = contract in ("masked", "masked-compact")
            row_form = contract == "rows"
            smatch = build_sharded_frame_sparsematch(
                fmask, settings, mesh, contract=contract)

            if contract == "masked-compact":
                # any shard's dense chunk trips the pmax-replicated flag
                match = _OverflowGuard(
                    lambda: build_sharded_frame_sparsematch(
                        fmask, settings, mesh, contract="masked"),
                    "masked-compact overflow: dense frame, re-ran the "
                    "sharded full-width masked matcher").wrap(smatch)
            else:
                match = smatch

        def run():
            out = match(left, right)
            _force(out[1])
            return out
    elif args.pyramid > 1:
        from opengpc_tpu.pyramid import (
            build_pyramid_sparsematch,
            pyramid_supports_to_numpy,
        )

        if args.contract == "masked-compact":
            from opengpc_tpu.forest import make_filter_mask
            from opengpc_tpu.infer import _rows_ok
            from opengpc_tpu.pyramid import build_pyramid_sparsematch_compact

            if not _rows_ok(make_filter_mask(forest), left.shape, settings):
                print("--contract masked-compact needs epipolar mode, a "
                      "<=30-test forest and packable (x, d) keys for this "
                      "image size", file=sys.stderr)
                return 1
            cpmatch = build_pyramid_sparsematch_compact(
                forest, settings, args.pyramid)
            pmatch = _OverflowGuard(
                lambda: build_pyramid_sparsematch(forest, settings,
                                                  args.pyramid),
                "masked-compact overflow: dense frame, re-ran the rows "
                "pyramid").wrap(cpmatch)
        else:
            pmatch = build_pyramid_sparsematch(forest, settings,
                                               args.pyramid)
            if args.contract == "auto" and settings.epipolar_mode \
                    and settings.disp_high >= 1:
                # density-adaptive auto, same rule as sequence mode (r5):
                # sparse frames ride the chunk-compacted pyramid, the
                # overflow guard re-runs dense mispredictions on the rows
                # pyramid (exact either way)
                from opengpc_tpu.forest import make_filter_mask
                from opengpc_tpu.pyramid import (
                    _rows_eligible, build_pyramid_sparsematch_compact)

                if _rows_eligible(make_filter_mask(forest), settings,
                                  left.shape[0], left.shape[1],
                                  args.pyramid):
                    dens = _probe_density(settings, left, right)
                    if dens <= _auto_compact_threshold(True, left.shape[1]):
                        rows_pyr = pmatch
                        pmatch = _OverflowGuard(
                            lambda: rows_pyr,
                            "pyramid-compact overflow: dense frame, re-ran "
                            "the rows pyramid").wrap(
                            build_pyramid_sparsematch_compact(
                                forest, settings, args.pyramid))
                        print(f"auto contract: candidate density "
                              f"{dens:.2f} — riding the chunk-compacted "
                              "pyramid (overflow-guarded)", file=sys.stderr)

        def run():
            out = pmatch(left, right)
            _force(out[-1])
            return out
    else:
        # fast output contracts when available (<=30-test forests, packable
        # keys): epipolar rides the masked/row-form matchers (no flat
        # compaction sort, identical support set); global mode rides the
        # segmented global row-form contract (skips the flat compaction
        # sort).  --contract forces a specific one.
        from opengpc_tpu.forest import make_filter_mask
        from opengpc_tpu.infer import _global_rows_ok, _rows_ok

        fmask = make_filter_mask(forest)
        eligible = _rows_ok(fmask, left.shape, settings)
        geligible = (not settings.epipolar_mode
                     and _global_rows_ok(fmask, left.shape, settings))
        if args.contract in ("rows", "masked", "masked-compact") \
                and not eligible:
            print(f"--contract {args.contract} needs epipolar mode, a "
                  "<=30-test forest and packable (x, d) keys for this "
                  "image size", file=sys.stderr)
            return 1
        if args.contract in ("global-rows", "global-compact") \
                and not geligible:
            print(f"--contract {args.contract} needs --global-mode, a "
                  "<=30-test forest and packable (y, x, d) keys for this "
                  "image size", file=sys.stderr)
            return 1
        contract = args.contract
        if contract == "auto" and (eligible or geligible):
            # density-adaptive auto, same probe as sequence mode: sparse
            # frames ride the chunk-compacted contracts (+27% epipolar /
            # +91% global device throughput at ~15% density); the overflow
            # guard re-runs a dense misprediction full-width, so this is
            # exact either way
            dens = _probe_density(settings, left, right)
            if dens <= _auto_compact_threshold(eligible, left.shape[1]):
                contract = ("masked-compact" if eligible
                            else "global-compact")
                print(f"auto contract: candidate density {dens:.2f} — "
                      f"riding the chunk-compacted "
                      f"{'masked' if eligible else 'global'} contract "
                      "(overflow-guarded)", file=sys.stderr)
        masked_form = eligible and contract in ("masked",
                                                "masked-compact")
        row_form = eligible and contract in ("auto", "rows")
        if eligible and contract == "masked-compact":
            from opengpc_tpu.infer import (build_sparsematch_masked,
                                           build_sparsematch_masked_compact,
                                           masked_supports_to_numpy)

            cmatch = build_sparsematch_masked_compact(fmask, settings)
            match = _OverflowGuard(
                lambda: build_sparsematch_masked(fmask, settings),
                "masked-compact overflow: dense frame, re-ran the "
                "full-width masked matcher").wrap(cmatch)
        elif masked_form:
            from opengpc_tpu.infer import (build_sparsematch_masked,
                                           masked_supports_to_numpy)

            match = build_sparsematch_masked(fmask, settings)
        elif row_form:
            from opengpc_tpu.infer import (build_sparsematch_rows,
                                           row_supports_to_numpy)

            match = build_sparsematch_rows(fmask, settings)
        elif geligible and contract == "global-compact":
            from opengpc_tpu.infer import (build_sparsematch_global_compact,
                                           build_sparsematch_global_rows,
                                           global_row_supports_to_numpy)

            global_rows = True
            gmatch = build_sparsematch_global_compact(fmask, settings)
            match = _OverflowGuard(
                lambda: build_sparsematch_global_rows(fmask, settings),
                "global-compact overflow: dense frame, re-ran the "
                "full-width global matcher").wrap(gmatch)
        elif geligible and contract in ("auto", "global-rows"):
            from opengpc_tpu.infer import (build_sparsematch_global_rows,
                                           global_row_supports_to_numpy)

            global_rows = True
            match = build_sparsematch_global_rows(fmask, settings)
        else:
            match = build_sparsematch(fmask, settings)

        def run():
            out = match(left, right)
            _force(out[1] if (row_form or global_rows or masked_form)
                   else out[-1])
            return out

    t0 = time.perf_counter()
    result = run()
    t_first = time.perf_counter() - t0

    from opengpc_tpu.utils import trace

    best = t_first
    with trace(args.trace):
        for _ in range(max(0, args.repeats - 1)):
            t0 = time.perf_counter()
            result = run()
            best = min(best, time.perf_counter() - t0)

    from opengpc_tpu.utils.timing import PhaseTimer

    pt = PhaseTimer()
    pt.totals["match"] = best  # device pipeline (preprocess+match fused)
    with pt.phase("assemble"):
        if args.pyramid > 1:
            rows = pyramid_supports_to_numpy(*result)
            count = rows.shape[0]
            supports = rows[:, :3]
        elif masked_form:
            mbuf, mcounts = result
            supports = masked_supports_to_numpy(mbuf, mcounts,
                                                settings.disp_high)
            count = supports.shape[0]
            if count > args.capacity:
                print(
                    f"WARNING: {count} matches exceed --capacity "
                    f"{args.capacity}; {count - args.capacity} dropped",
                    file=sys.stderr,
                )
                supports = supports[: args.capacity]
        elif global_rows:
            (gxs, gys, gds), gcounts = result
            supports = global_row_supports_to_numpy(gxs, gys, gds, gcounts)
            count = supports.shape[0]
            if count > args.capacity:
                print(
                    f"WARNING: {count} matches exceed --capacity "
                    f"{args.capacity}; {count - args.capacity} dropped",
                    file=sys.stderr,
                )
                supports = supports[: args.capacity]
        elif row_form:
            (rxs, rds), rcounts = result
            supports = row_supports_to_numpy(rxs, rds, rcounts)
            count = supports.shape[0]
            if count > args.capacity:
                # honor --capacity like the flat contract (first `capacity`
                # supports in output order), with the same overflow warning
                print(
                    f"WARNING: {count} matches exceed --capacity "
                    f"{args.capacity}; {count - args.capacity} dropped",
                    file=sys.stderr,
                )
                supports = supports[: args.capacity]
        else:
            xs, ys, ds, count = result
            supports = supports_to_numpy(xs, ys, ds, count)
            if int(count) > xs.shape[0]:
                print(
                    f"WARNING: support buffer overflow — {int(count)} matches, "
                    f"capacity {xs.shape[0]}; {int(count) - xs.shape[0]} dropped. "
                    f"Re-run with --capacity {1 << (int(count) - 1).bit_length()}",
                    file=sys.stderr,
                )
    h, w = left.shape
    mpix_s = (2 * h * w / 1e6) / best if best > 0 else float("inf")
    print(
        f"tTotal: {best * 1e3:.2f} ms (first call incl. compile: "
        f"{t_first * 1e3:.1f} ms), num matches: {len(supports)}"
        f" (count={int(count)}), throughput: {mpix_s:.1f} Mpix/s"
    )

    with pt.phase("visualize"):
        write_png(args.out, _viz(left, supports, args))
    # per-phase report, the analog of the reference's tPreprocess/tMatch
    # lines (samples/sparsematch.cpp:53-57) — our preprocess+match are one
    # fused device program, so the split here is device/host instead
    print(pt.report())
    print(f"wrote {args.out}")
    if args.densify:
        from opengpc_tpu.densify import densify_supports
        from opengpc_tpu.viz import dense_disparity_visualization

        if masked_form and count <= args.capacity:
            # masked contract: densify DEVICE-RESIDENT from the packed
            # buffer (no decode/re-upload roundtrip — densify_from_masked,
            # bit-identical to the host path, tests/test_densify.py).
            # A capacity-trimmed
            # support list falls back to the host path so --capacity
            # semantics stay identical across contracts
            from opengpc_tpu.densify import densify_from_masked

            dense_d, filled_d = densify_from_masked(
                mbuf, mcounts, settings.disp_high, width=w)
            dense, filled = np.asarray(dense_d), np.asarray(filled_d)
        else:
            dense, filled = densify_supports(supports, left.shape)
        write_png(args.densify,
                  dense_disparity_visualization(left, dense, filled,
                                                max_disparity=args.disp_high))
        print(f"wrote {args.densify}")
    if args.supports_out:
        write_supports(args.supports_out, supports)
        print(f"wrote {args.supports_out}")
    return 0


def _viz(left, supports, args):
    """disparity.png pixels per --viz-compat: canonical KITTI colors scaled
    to --disp-high, or the reference binary's exact bytes (rotated table,
    hardcoded [0, 128] range; buffer.hpp:949-1014)."""
    if args.viz_compat == "reference":
        return disparity_visualization(left, supports, 0.0, 128.0,
                                       compat="reference")
    return disparity_visualization(left, supports,
                                   max_disparity=args.disp_high)


def _run_host_matcher(args, forest, settings, left, right) -> int:
    """Bit-exact reference matcher modes: descriptors are extracted on
    device (same dense pipeline), matched host-side with the reference's
    exact sweep (``--matcher quirk``; inference.hpp:227-254) or its
    hash-table matcher (``--matcher hashmatch``; hashmatch.hpp:42-273),
    then filtered like rectifiedMatch (inference.hpp:384-391)."""
    from opengpc_tpu.infer import extract_descriptors
    from opengpc_tpu.match import match_hashmatch, match_reference_quirk

    t0 = time.perf_counter()
    desc_l = extract_descriptors(left, forest, settings)
    desc_r = extract_descriptors(right, forest, settings)
    matcher = (
        match_reference_quirk if args.matcher == "quirk" else match_hashmatch
    )
    pairs = matcher(desc_l, desc_r, epipolar=settings.epipolar_mode)
    dt = time.perf_counter() - t0
    if len(pairs):
        d = pairs[:, 0] - pairs[:, 2]
        keep = (np.abs(pairs[:, 1] - pairs[:, 3]) <= settings.vertical_tolerance) & (
            np.abs(d) <= settings.disp_high
        )
        supports = np.stack(
            [pairs[keep, 0], pairs[keep, 1], d[keep]], axis=1
        ).astype(np.int32)
    else:
        supports = np.zeros((0, 3), np.int32)
    print(
        f"tTotal: {dt * 1e3:.2f} ms (host-side {args.matcher} matcher, "
        f"incl. compile), num matches: {len(supports)}"
    )
    write_png(args.out, _viz(left, supports, args))
    print(f"wrote {args.out}")
    if args.supports_out:
        write_supports(args.supports_out, supports)
        print(f"wrote {args.supports_out}")
    return 0


def _run_sequence(args, forest, settings) -> int:
    """Directory mode (BASELINE config 2): match every left/right frame
    pair of a rectified stereo sequence, write per-frame supports next to
    ``--out``, report aggregate throughput."""
    import glob
    import os

    lefts = sorted(glob.glob(os.path.join(args.left, "*.png")))
    rights = sorted(glob.glob(os.path.join(args.right, "*.png")))
    if len(lefts) != len(rights) or not lefts:
        print(f"sequence mismatch: {len(lefts)} left vs {len(rights)} right",
              file=sys.stderr)
        return 1
    from opengpc_tpu.forest import make_filter_mask
    from opengpc_tpu.infer import _rows_ok

    probe = read_gray(lefts[0])
    fmask = make_filter_mask(forest)
    eligible = _rows_ok(fmask, probe.shape, settings)
    from opengpc_tpu.infer import _global_rows_ok

    geligible = (not settings.epipolar_mode
                 and _global_rows_ok(fmask, probe.shape, settings))
    if args.contract in ("rows", "masked", "masked-compact") and not eligible:
        # honor an explicit contract choice instead of silently riding the
        # flat fallback (auto mode still falls back per frame)
        print(f"--contract {args.contract} needs epipolar mode, a <=30-test "
              f"forest and packable (x, d) keys for frame shape "
              f"{probe.shape}", file=sys.stderr)
        return 1
    if args.contract in ("global-rows", "global-compact") and not geligible:
        print(f"--contract {args.contract} needs --global-mode, a <=30-test "
              "forest and packable (y, x, d) keys for frame shape "
              f"{probe.shape}", file=sys.stderr)
        return 1
    contract = args.contract
    right0 = None  # decoded by the density probe; reused for pair 0 below
    if args.pyramid > 1:
        # sequence multi-scale (r5): every full dispatch group rides the
        # batched HYBRID pyramid fold (per-level (B*hs, 2W_l) row sorts +
        # per-pair lax.map dedup — build_pyramid_sparsematch's native
        # (B, H, W) path);
        # ineligible shapes fall back internally to the flat per-level
        # path, so any frame shape works (one recompile per new shape)
        contract = "pyramid"
    if contract == "auto" and (eligible or geligible):
        # density-adaptive auto (r4): probe frame 0's candidate density and
        # ride the chunk-compacted contracts on sparse sequences (+27%
        # epipolar / +91% global device throughput at ~15% density,
        # exp_lowdens.py / exp_global_compact.py)
        right0 = read_gray(rights[0])
        dens = _probe_density(settings, probe, right0)
        if dens <= _auto_compact_threshold(eligible, probe.shape[1]):
            contract = "masked-compact" if eligible else "global-compact"
            print(f"auto contract: candidate density {dens:.2f} — riding "
                  f"the chunk-compacted {'masked' if eligible else 'global'}"
                  " contract (overflow-guarded)", file=sys.stderr)
    pyramid_mode = contract == "pyramid"
    compact_form = (not pyramid_mode and eligible
                    and contract == "masked-compact")
    masked_form = not pyramid_mode and eligible and contract == "masked"
    row_form = (not pyramid_mode and eligible
                and not (masked_form or compact_form))
    gcompact_form = geligible and contract == "global-compact"
    global_rows = False
    ovf_guard = None  # lazy full-width fallback for compact overflows
    pyramid_compact = False
    if pyramid_mode:
        from opengpc_tpu.pyramid import (_rows_eligible,
                                         build_pyramid_sparsematch,
                                         build_pyramid_sparsematch_compact,
                                         pyramid_supports_to_numpy)

        rows_pyr = build_pyramid_sparsematch(forest, settings, args.pyramid)
        match = rows_pyr
        # density-adaptive compact pyramid (r5): same probe/threshold as
        # the flat contracts (the compact pyramid rides masked-compact
        # chunks per level, +26% at 15% density — exp_pyr.py); the
        # overflow guard + mid-sequence hysteresis make it exact.
        # Skipped under --data-parallel/--shard-frame (the mesh pyramid
        # builders are rows-only; sharded dispatches stay lossless)
        if (settings.disp_high >= 1
                and args.data_parallel <= 1 and args.shard_frame <= 1
                and _rows_eligible(fmask, settings, probe.shape[0],
                                   probe.shape[1], args.pyramid)):
            if right0 is None:
                right0 = read_gray(rights[0])
            dens = _probe_density(settings, probe, right0)
            if dens <= _auto_compact_threshold(True, probe.shape[1]):
                pyramid_compact = True
                match = build_pyramid_sparsematch_compact(
                    forest, settings, args.pyramid)
                ovf_guard = _OverflowGuard(
                    lambda: rows_pyr,
                    "pyramid-compact overflow: re-ran the rows pyramid")
                print(f"auto contract: candidate density {dens:.2f} — "
                      "riding the chunk-compacted pyramid "
                      "(overflow-guarded)", file=sys.stderr)
    elif compact_form:
        from opengpc_tpu.infer import (build_sparsematch_masked,
                                       build_sparsematch_masked_compact,
                                       masked_supports_to_numpy)

        match = build_sparsematch_masked_compact(fmask, settings)
        ovf_guard = _OverflowGuard(
            lambda: build_sparsematch_masked(fmask, settings),
            "masked-compact overflow: re-ran the full-width masked "
            "matcher")
    elif masked_form:
        from opengpc_tpu.infer import (build_sparsematch_masked,
                                       masked_supports_to_numpy)

        match = build_sparsematch_masked(fmask, settings)
    elif row_form:
        from opengpc_tpu.infer import (build_sparsematch_rows,
                                       row_supports_to_numpy)

        match = build_sparsematch_rows(fmask, settings)
    elif gcompact_form:
        from opengpc_tpu.infer import (build_sparsematch_global_compact,
                                       build_sparsematch_global_rows,
                                       global_row_supports_to_numpy)

        match = build_sparsematch_global_compact(fmask, settings)
        ovf_guard = _OverflowGuard(
            lambda: build_sparsematch_global_rows(fmask, settings),
            "global-compact overflow: re-ran the full-width global "
            "matcher")
    elif geligible:
        # --global-mode sequences ride the segmented global contract
        # (same auto selection as the single-pair path)
        from opengpc_tpu.infer import (build_sparsematch_global_rows,
                                       global_row_supports_to_numpy)

        global_rows = True
        match = build_sparsematch_global_rows(fmask, settings)
    else:
        match = build_sparsematch(fmask, settings)
    out_dir = os.path.dirname(os.path.abspath(args.out)) or "."
    os.makedirs(out_dir, exist_ok=True)
    total_px = 0
    total_matches = 0
    fast = (pyramid_mode or row_form or masked_form or compact_form
            or gcompact_form or global_rows)
    mode = ("pyramid-compact" if pyramid_compact
            else "pyramid" if pyramid_mode
            else "masked-compact" if compact_form
            else "masked" if masked_form else "rows" if row_form
            else "global-compact" if gcompact_form
            else "global_rows" if global_rows else "flat")
    # overflow re-run inputs
    needs_frames = compact_form or gcompact_form or pyramid_compact
    # sequence --densify: per-frame dense_{NNNN}.png into this DIRECTORY
    # (single-pair mode's PNG path becomes a dir here, one file per frame)
    dense_dir = args.densify or None
    if dense_dir:
        os.makedirs(dense_dir, exist_ok=True)
    keep_frames = needs_frames or dense_dir is not None
    flat_match = match if mode == "flat" else None
    # default: stack 4 frames per dispatch on the fast contracts (folded
    # batches are exact; 4x fewer dispatch roundtrips);
    # an explicit --batch 1 disables
    batch = max(1, args.batch if args.batch is not None else 4) \
        if fast else 1
    if args.batch is not None and args.batch > 1 and not fast:
        print(
            f"--batch {args.batch} ignored: batched dispatch needs the "
            "row-form/masked/global-rows contracts (<=30-test forest, "
            "packable keys for this image size); frames dispatch singly",
            file=sys.stderr,
        )
    # --data-parallel N: full dispatch groups shard over the first N
    # devices (the mesh builders emit the SAME stacked pytrees as the
    # single-device batch fold, so assembly is unchanged); partial groups
    # and shape-change singles keep riding the single-device `match`
    match_batched = match
    dp = args.data_parallel
    sf = args.shard_frame
    sf_single = False  # sf>1 without dp: B=1 groups still row-shard
    if dp > 1 or sf > 1:
        if not fast:
            print("--data-parallel/--shard-frame need a fast stacked "
                  "contract (rows/masked/masked-compact/global) — this "
                  "forest/shape only supports the flat pipeline",
                  file=sys.stderr)
            return 1
        import jax

        from opengpc_tpu import parallel as par

        devs = jax.devices()
        nd = max(dp, 1)
        if sf > 1:
            # COMPOSED parallelism (r4): frames over a "data" axis AND
            # each frame's rows over a "rows" axis — the 2-D mesh builder
            if mode not in ("masked", "rows", "masked-compact", "pyramid"):
                print(f"--shard-frame with the {mode} contract is not "
                      "supported in sequence mode (the global distributed "
                      "bucket sort is single-pair only — use the "
                      "single-pair CLI for one big global frame, or "
                      "--data-parallel to scale global sequences over "
                      "the batch axis)", file=sys.stderr)
                return 1
            if len(devs) < nd * sf:
                print(f"--shard-frame {sf} x --data-parallel {nd}: only "
                      f"{len(devs)} devices visible", file=sys.stderr)
                return 1
            align_sf = (sf << (args.pyramid - 1) if mode == "pyramid"
                        else sf)
            if probe.shape[0] % align_sf \
                    or (probe.shape[0] // sf) >> (
                        args.pyramid - 1 if mode == "pyramid" else 0) < 14:
                print(f"--shard-frame {sf}: frame height {probe.shape[0]} "
                      f"must divide by {align_sf} with >= 14 rows per "
                      "shard at the coarsest level", file=sys.stderr)
                return 1
            if mode == "pyramid":
                from opengpc_tpu.pyramid import \
                    _rows_eligible as _pyr_eligible

                if _pyr_eligible(fmask, settings, probe.shape[0],
                                 probe.shape[1], args.pyramid) is None:
                    # same in-trace ValueError the single-pair path
                    # guards: the (pixel, level, d) dedup key must fit
                    # int32 (the flat-contract _rows_ok check alone
                    # doesn't cover it)
                    print(f"--shard-frame {sf} --pyramid {args.pyramid}: "
                          f"the finest-wins dedup key for "
                          f"{probe.shape[0]}x{probe.shape[1]} x "
                          f"{args.pyramid} levels exceeds int32 packing; "
                          "reduce levels or the frame size",
                          file=sys.stderr)
                    return 1
        elif len(devs) < dp:
            print(f"--data-parallel {dp}: only {len(devs)} devices "
                  "visible", file=sys.stderr)
            return 1
        if dp > 1:
            if args.batch is not None and batch % dp:
                print(f"--batch {batch} must divide by --data-parallel "
                      f"{dp} (shard_map splits the stacked batch axis "
                      "evenly)", file=sys.stderr)
                return 1
            batch = -(-batch // dp) * dp  # round the default batch up
        if sf > 1:
            mesh2 = par.make_mesh_2d(nd, sf, devs[:nd * sf])
            if mode == "pyramid":
                match_batched = par.build_batched_sharded_frame_pyramid(
                    forest, settings, mesh2, num_levels=args.pyramid)
            else:
                match_batched = par.build_batched_sharded_frame_sparsematch(
                    forest, settings, mesh2, contract=mode)
            sf_single = nd == 1
        elif mode == "pyramid":
            match_batched = par.build_batched_pyramid(
                forest, settings, par.make_mesh(devs[:dp]),
                num_levels=args.pyramid)
        else:
            builder = {
                "rows": par.build_batched_sparsematch_rows,
                "masked": par.build_batched_sparsematch_masked,
                "masked-compact":
                    par.build_batched_sparsematch_masked_compact,
                "global_rows": par.build_batched_sparsematch_global_rows,
                "global-compact":
                    par.build_batched_sparsematch_global_compact,
            }[mode]
            match_batched = builder(forest, settings,
                                    par.make_mesh(devs[:dp]))
        # a compact-contract overflow under --data-parallel/--shard-frame
        # re-runs the whole dispatch through the single-device full-width
        # builder (exact; mispredictions are rare by the auto density
        # probe); partial/leftover groups always dispatch singly on one
        # device (one reusable compile)

    # Mid-sequence density hysteresis:
    # the auto probe runs on frame 0 only, so a sequence that drifts
    # dense would pay compact + full-width on EVERY dense dispatch.
    # Policy: the first overflow
    # trips this flag; while tripped, each incoming frame is density-
    # probed (one tiny jitted reduce — only paid during dense stretches)
    # and dense frames dispatch straight through the full-width builder
    # (single misprediction cost per density TRANSITION, not per frame);
    # the first sparse probe clears the flag and compact grouping
    # resumes.  Exactness never depends on this — the overflow flag
    # remains the guard either way.
    ovf_state = {"tripped": False}
    compact_seq = mode in ("masked-compact", "global-compact",
                           "pyramid-compact")
    fallback_mode = {"masked-compact": "masked",
                     "global-compact": "global_rows",
                     "pyramid-compact": "pyramid"}.get(mode)

    def write_frame(i, supports, gray=None):
        nonlocal total_matches
        total_matches += len(supports)
        write_supports(
            os.path.join(out_dir, f"supports_{i:04d}.txt"), supports
        )
        if dense_dir is not None and gray is not None:
            from opengpc_tpu.densify import densify_supports
            from opengpc_tpu.viz import dense_disparity_visualization

            dense, filled = densify_supports(supports, gray.shape)
            write_png(os.path.join(dense_dir, f"dense_{i:04d}.png"),
                      dense_disparity_visualization(
                          gray, dense, filled,
                          max_disparity=args.disp_high))

    def assemble(pending):
        """Fetch one dispatch's device outputs (one frame, or a --batch
        stack of frames) and write the per-frame supports files."""
        # ``stacked``: outputs carry a leading batch axis (k can be 1 —
        # a --shard-frame (1, H, W) stack still rides the 2-D mesh)
        i0, dmode, out, k, frames, stacked = pending

        def gray(j):
            if frames is None:
                return None
            return frames[0][j] if stacked else frames[0]
        if dmode == "masked-compact":
            # overflow guard: a dense dispatch (any frame of the stack)
            # trips the ORed flag — a (n_shards,) vector under
            # --data-parallel — and re-runs the whole dispatch through
            # the full-width masked matcher (exact either way); jax
            # dispatch from the assembly thread is safe
            if bool(np.asarray(out[2]).any()):
                print(f"{ovf_guard.notice} (frames {i0}..{i0 + k - 1})",
                      file=sys.stderr)
                ovf_state["tripped"] = True
                out = ovf_guard.fallback()(*frames)
            mbuf, mcounts = np.asarray(out[0]), np.asarray(out[1])
            for j in range(k):
                write_frame(i0 + j, masked_supports_to_numpy(
                    mbuf[j] if stacked else mbuf,
                    mcounts[j] if stacked else mcounts, settings.disp_high),
                    gray(j))
        elif dmode in ("global_rows", "global-compact"):
            if dmode == "global-compact" and bool(np.asarray(out[2]).any()):
                # any frame of the dispatch (lax.map gives per-pair flags)
                # overflowed: re-run the whole dispatch full-width
                print(f"{ovf_guard.notice} (frames {i0}..{i0 + k - 1})",
                      file=sys.stderr)
                ovf_state["tripped"] = True
                out = ovf_guard.fallback()(*frames)
            (gxs, gys, gds), gcounts = out[0], out[1]
            gxs, gys, gds = np.asarray(gxs), np.asarray(gys), np.asarray(gds)
            gcounts = np.asarray(gcounts)
            for j in range(k):
                write_frame(i0 + j, global_row_supports_to_numpy(
                    gxs[j] if stacked else gxs, gys[j] if stacked else gys,
                    gds[j] if stacked else gds,
                    gcounts[j] if stacked else gcounts), gray(j))
        elif dmode in ("pyramid", "pyramid-compact"):
            if dmode == "pyramid-compact":
                # per-pair overflow flags (the hybrid fold attributes
                # chunk overflow back to each pair); any flagged frame
                # re-runs the whole dispatch on the rows pyramid (exact
                # either way)
                if bool(np.asarray(out[-1]).any()):
                    print(f"{ovf_guard.notice} (frames {i0}..{i0 + k - 1})",
                          file=sys.stderr)
                    ovf_state["tripped"] = True
                    out = ovf_guard.fallback()(*frames)
                else:
                    out = out[:-1]
            arrs = [np.asarray(o) for o in out]
            for j in range(k):
                rows = pyramid_supports_to_numpy(
                    *((a[j] for a in arrs) if stacked else arrs))
                # supports files stay 3-column x/y/d (level-0 units),
                # like single-pair --pyramid
                write_frame(i0 + j, rows[:, :3], gray(j))
        elif dmode == "masked":
            mbuf, mcounts = np.asarray(out[0]), np.asarray(out[1])
            for j in range(k):
                write_frame(i0 + j, masked_supports_to_numpy(
                    mbuf[j] if stacked else mbuf,
                    mcounts[j] if stacked else mcounts, settings.disp_high),
                    gray(j))
        elif dmode == "rows" and stacked:
            (rxs, rds), rcounts = out
            rxs, rds = np.asarray(rxs), np.asarray(rds)
            rcounts = np.asarray(rcounts)
            for j in range(k):
                write_frame(i0 + j,
                            row_supports_to_numpy(rxs[j], rds[j],
                                                  rcounts[j]), gray(j))
        elif dmode == "rows":
            (rxs, rds), rcounts = out
            write_frame(i0, row_supports_to_numpy(rxs, rds, rcounts),
                        gray(0))
        else:
            write_frame(i0, supports_to_numpy(*out), gray(0))

    def dispatch_group(group):
        """One jit dispatch for a FULL same-shape group: a stacked
        (B, H, W) batch folds into ONE (B*H, 2W) segmented sort on device
        (infer._sparsematch_rows_batched_impl / the masked impl's native
        batch fold) — per-dispatch overhead is paid once per B frames,
        with per-frame outputs identical to single-frame dispatches
        (pinned by test_cli_sequence_mode_batched)."""
        i0 = group[0][0]
        if len(group) == 1 and not sf_single:
            # --batch 1: plain 2-D single-frame dispatch (with
            # --shard-frame and no data axis, a (1, H, W) stack still
            # row-shards through the 2-D mesh builder instead)
            l, r = group[0][1], group[0][2]
            return (i0, mode, match(l, r), 1,
                    (l, r) if keep_frames else None, False)
        lb = np.stack([g[1] for g in group])
        rb = np.stack([g[2] for g in group])
        return (i0, mode, match_batched(lb, rb), len(group),
                (lb, rb) if keep_frames else None, True)

    def flush_group(group):
        """Dispatch a partial (flushed or leftover) group as SINGLE frames:
        a (k, H, W) stack for each distinct k < B would trigger its own jit
        trace and compile to save a few dispatches — the single-frame
        program is one compile reused by every partial group."""
        for i, l, r in group:
            submit((i, mode, match(l, r), 1,
                    (l, r) if keep_frames else None, False))

    # software pipeline: jax dispatch is async, assembly (device->host
    # fetch + supports write — numpy and the native writer both release
    # the GIL) runs on its own worker thread, and frame READS run on a
    # read-ahead prefetcher (below) — so PNG decode, device work, and
    # output fetch/write all genuinely overlap instead of serializing
    # (the analog of the reference streaming frames through one pipeline).
    # Before the prefetcher, ~2x15 ms of synchronous PNG decode per pair
    # sat in series with far shorter device work.
    import collections
    from concurrent.futures import Future, ThreadPoolExecutor

    ex = ThreadPoolExecutor(max_workers=1)
    futures = collections.deque()

    def submit(pending):
        futures.append(ex.submit(assemble, pending))
        while len(futures) > 2:  # bound in-flight device output buffers
            futures.popleft().result()

    # bounded read-ahead: decode the next PREFETCH pairs on worker threads
    # while the current pair dispatches (libpng + the pure-numpy fallback
    # both release the GIL for the heavy part).  OGPC_SEQ_PREFETCH=0
    # restores the synchronous reads (the A/B knob)
    PREFETCH = max(0, int(os.environ.get("OGPC_SEQ_PREFETCH", "4")))
    rd = ThreadPoolExecutor(max_workers=2)
    pairs = list(zip(lefts, rights))
    reads = collections.deque()
    start = 0
    if PREFETCH and right0 is not None:
        # the density probe already decoded pair 0 — hand it to the
        # pipeline instead of re-decoding ~2x15 ms synchronously
        f0 = Future()
        f0.set_result((probe, right0))
        reads.append(f0)
        start = 1
    reads.extend(
        rd.submit(lambda l, r: (read_gray(l), read_gray(r)), lp, rp)
        for lp, rp in pairs[start:PREFETCH]
    )

    group = []
    t0 = time.perf_counter()
    t_half = None
    px_half = 0
    try:
        for i in range(len(pairs)):
            if i == len(pairs) // 2 and i > 0:
                # steady-state marker: by mid-sequence the first dispatch's
                # compile is long done
                t_half = time.perf_counter()
                px_half = total_px
            if PREFETCH:
                left, right = reads.popleft().result()
                if i + PREFETCH < len(pairs):
                    reads.append(rd.submit(
                        lambda l, r: (read_gray(l), read_gray(r)),
                        *pairs[i + PREFETCH]))
            elif i == 0 and right0 is not None:
                left, right = probe, right0
            else:
                left = read_gray(pairs[i][0])
                right = read_gray(pairs[i][1])
            total_px += 2 * left.size
            if (compact_seq and ovf_state["tripped"]
                    and left.shape == probe.shape):
                dens = _probe_density(settings, left, right)
                if dens > _auto_compact_threshold(
                        mode in ("masked-compact", "pyramid-compact"),
                        left.shape[1]):
                    # dense stretch: skip the compact attempt entirely
                    if group:
                        # the pending group is PARTIAL (k < batch): route it
                        # through the single-frame program like every other
                        # flush — a (k, H, W) stacked dispatch would pay a
                        # fresh jit trace per distinct k and break the
                        # --data-parallel divisibility contract
                        flush_group(group)
                        group = []
                    submit((i, fallback_mode,
                            ovf_guard.fallback()(left, right), 1,
                            (left, right) if keep_frames else None, False))
                    continue
                print(f"frame {i}: density {dens:.2f} back under the "
                      "compact threshold — resuming the compact contract",
                      file=sys.stderr)
                ovf_state["tripped"] = False
            if fast and left.shape == probe.shape:
                group.append((i, left, right))
                if len(group) < batch:
                    continue
                submit(dispatch_group(group))
                group = []
            else:
                # shape change mid-sequence: flush any batched group first
                if group:
                    flush_group(group)
                    group = []
                if pyramid_mode:
                    # the ROWS pyramid builder handles any frame shape
                    # (internal flat fallback when not packable) — dispatch
                    # the odd-shaped frame through it instead of silently
                    # downgrading to single-scale (one compile per shape;
                    # the compact pyramid would raise on ineligible shapes,
                    # so shape changes always take the rows builder)
                    submit((i, "pyramid", rows_pyr(left, right), 1,
                            (left, right) if keep_frames else None, False))
                    continue
                if fast and args.contract != "auto":
                    # EXPLICIT fast contract: honor it for the new shape
                    # (jit's per-shape cache pays one extra compile) or
                    # error out — never silently downgrade to the
                    # capacity-bounded flat pipeline the user didn't ask
                    # for (r4 review finding).  Eligibility is checked
                    # with the contract's OWN rule: the global contracts
                    # need packable (y, x, d) keys, not the epipolar-only
                    # _rows_ok gate
                    if args.contract in ("global-rows", "global-compact"):
                        ok = _global_rows_ok(fmask, left.shape, settings)
                        keyname = "(y, x, d)"
                    else:
                        ok = _rows_ok(fmask, left.shape, settings)
                        keyname = "(x, d)"
                    if ok:
                        submit((i, mode, match(left, right), 1,
                                (left, right) if keep_frames else None,
                                False))
                        continue
                    print(
                        f"--contract {args.contract}: frame {i} shape "
                        f"{left.shape} has no packable {keyname} key — "
                        "cannot honor the explicit contract; re-run with "
                        "--contract auto to allow the flat fallback",
                        file=sys.stderr,
                    )
                    # drain pending assembles so worker-thread failures on
                    # already-dispatched frames surface instead of being
                    # discarded by the early exit (review finding)
                    while futures:
                        futures.popleft().result()
                    return 1
                # auto mode: fall back to the flat pipeline (eligibility
                # was probed on the first frame).  ONE flat matcher is
                # built lazily and reused — jit's per-shape cache then
                # makes repeated fallback shapes free, instead of paying a
                # fresh trace/compile per mismatched frame
                if flat_match is None:
                    flat_match = build_sparsematch(fmask, settings)
                submit((i, "flat", flat_match(left, right), 1,
                        (left, right) if keep_frames else None, False))
        if group:
            flush_group(group)
        while futures:
            futures.popleft().result()
    finally:
        rd.shutdown(wait=False, cancel_futures=True)
        ex.shutdown(wait=True)
    t_end = time.perf_counter()
    dt = t_end - t0
    print(
        f"{len(lefts)} pairs, {total_matches} supports, "
        f"{dt * 1e3:.1f} ms total (incl. first-call compile + host IO), "
        f"{total_px / 1e6 / dt:.1f} Mpix/s end-to-end"
    )
    if t_half is not None and t_end > t_half:
        sdt = t_end - t_half
        spx = total_px - px_half
        print(
            f"steady-state (2nd half, compile excluded): {sdt * 1e3:.1f} ms, "
            f"{spx / 1e6 / sdt:.1f} Mpix/s end-to-end"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())

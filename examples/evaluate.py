"""Quality/speed evaluation harness: the fast-preset tradeoff table.

Measures, over a ground-truth synthetic scene (utils.scenes.make_scene —
textured warp with occlusion map), what truncating a forest to its first N
tests (`truncate_forest` / CLI `--max-tests`) costs in support density and
precision, and what it buys in device throughput.  Small forests
(num_tests + bit_length(2W-1) <= 30) ride the single-operand packed
matcher sort (one operand less).

The reference has no evaluation tool at all (SURVEY §4/§6: it publishes no
numbers and judges quality by its training-time P/R table); this is the
match-time analog built on `opengpc_tpu.metrics`.

Usage:
    python examples/evaluate.py [forest.txt] [--height H] [--width W]
        [--tests 30,20,17,15] [--device-time] [--seed S]

`--device-time` times the masked pipeline per row (device_time_per_iter);
omit it on the CPU for a quality-only table.
"""

import argparse
import os
import sys

# importable from any cwd (ADVICE r4), like data/validate_real_sintel.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("forest", nargs="?", default="forests/defaultZeroForest.txt")
    p.add_argument("--height", type=int, default=436)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--tests", default="30,20,17,15,10",
                   help="comma-separated max-tests truncation points")
    p.add_argument("--disp-high", type=int, default=128)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device-time", action="store_true",
                   help="also device-time the masked pipeline per point")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest, make_filter_mask
    from opengpc_tpu.infer import (_sparsematch_masked_impl,
                                   build_sparsematch_masked,
                                   masked_supports_to_numpy)
    from opengpc_tpu.match import _pack_ok
    from opengpc_tpu.metrics import support_precision
    from opengpc_tpu.utils import device_time_per_iter
    from opengpc_tpu.utils.scenes import make_scene

    rng = np.random.default_rng(args.seed)
    h, w = args.height, args.width
    left, right, disp, occ = make_scene(rng, h, w)
    settings = InferenceSettings(
        gradient_threshold=5, vertical_tolerance=0,
        disp_high=args.disp_high, epipolar_mode=True, capacity=1 << 19)
    forest = load_forest(args.forest)
    points = [int(t) for t in args.tests.split(",")]

    def rdep(s, ab):
        a, b = ab
        upd = (s.astype(jnp.int32) & 1).astype(jnp.uint8).reshape(1, 1)
        return (jax.lax.dynamic_update_slice(a, upd, (0, 0)), b)

    print(f"scene {h}x{w} seed={args.seed}  forest={args.forest} "
          f"({forest.num_tests} tests)  backend={jax.default_backend()}")
    hdr = "| tests | sort | supports | density | prec tol0 | prec tol1 |"
    if args.device_time:
        hdr += " ms/pair | Mpix/s |"
    print(hdr)
    print("|" + "---|" * (len(hdr.split("|")) - 2))

    # density is "supports relative to the LEAST-truncated run", so rows
    # are processed largest-n first regardless of the --tests order (a
    # first-listed small n would otherwise become the baseline and print
    # inverted >1.0 densities for the stronger forests)
    base_n = None
    for n in sorted(set(points), reverse=True):
        if n > forest.num_tests:
            continue
        mask = make_filter_mask(forest, max_tests=n)
        mfn = build_sparsematch_masked(mask, settings)
        buf, counts = mfn(left, right)
        supp = masked_supports_to_numpy(buf, counts, settings.disp_high)
        if base_n is None:
            base_n = max(1, len(supp))
        p0, _ = support_precision(supp, disp, valid=(occ == 0), tol=0)
        p1, _ = support_precision(supp, disp, valid=(occ == 0), tol=1)
        sort = "1-op" if _pack_ok(mask.num_tests, 2 * w) else "2-op"
        row = (f"| {n} | {sort} | {len(supp)} | {len(supp)/base_n:.3f} "
               f"| {p0:.4f} | {p1:.4f} |")
        if args.device_time:
            def step(a, b, _mask=mask):
                bb, cc = _sparsematch_masked_impl(
                    a, b, mask=_mask, settings=settings)
                return bb.sum(dtype=jnp.int32) + cc.sum(dtype=jnp.int32)
            # wide iteration spread: the per-iter estimate differences two
            # wall-clocks, and (203-3) iters divides their noise down
            sec = device_time_per_iter(step, (left, right), rdep, 3, 203,
                                       repeats=5)
            row += f" {sec*1e3:.3f} | {2*h*w/1e6/sec:.0f} |"
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Forest training CLI.

Equivalent of the reference ``train`` sample (/root/reference/samples/
train.cpp): load a binary triplet dataset, train a fern forest with the
greedy split optimizer, export the text forest.

Defaults mirror the reference (train.cpp:24-41): zero optimizer with 10
resamples and w1=0.5, FernFactory(2, 2, 2, 5), sample fraction 0.7.  Unlike
the reference (unseeded std::random_device), training takes an explicit
``--seed`` and is fully reproducible.
"""

from __future__ import annotations

import argparse
import sys

from opengpc_tpu.config import fern_factory, tau_optimizer, zero_optimizer
from opengpc_tpu.forest import save_forest
from opengpc_tpu.io.triplets import load_triplets
from opengpc_tpu.train import train_forest
from opengpc_tpu.cli._errors import report_input_errors
from opengpc_tpu.utils.device import start


@report_input_errors
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="opengpc-train", description=__doc__.splitlines()[0]
    )
    from opengpc_tpu import __version__
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("dataset", help="binary triplet dataset (extract output)")
    p.add_argument("forest_out", help="output text forest path")
    p.add_argument("--fern-type", choices=["zero", "tau"], default="zero",
                   help="zero: tau fixed to 0; tau: tau searched in [-10,10)")
    p.add_argument("--num-s", type=int, default=2, help="ferns at 7x7 scale")
    p.add_argument("--num-m", type=int, default=2, help="ferns at 17x17 scale")
    p.add_argument("--num-l", type=int, default=2, help="ferns at 27x27 scale")
    p.add_argument("--depth", type=int, default=5, help="tests per fern")
    p.add_argument("--num-resamples", type=int, default=10)
    p.add_argument("--sample-fraction", type=float, default=0.7)
    p.add_argument("--w1", type=float, default=0.5,
                   help="precision weight in the harmonic-mean score")
    p.add_argument("--only-score-non-split", action="store_true",
                   help="exclude already-true-positive triplets per level")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None,
                   help="write the partial forest here after each fern")
    p.add_argument("--no-batch-ferns", action="store_true",
                   help="force the fern-at-a-time training loop instead of "
                   "the level-synchronous batched trainer (same forest "
                   "byte-for-byte; batched is the multi-fern default and "
                   "dispatches F x fewer device programs)")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="shard the triplet axis over the first N devices "
                   "during level scoring (each level's TP/FP/FN reduction "
                   "becomes one psum; selected splits are "
                   "IDENTICAL — integer counts are exact regardless of "
                   "sharding, tests/test_parallel.py)")
    args = p.parse_args(argv)
    start()

    triplets = load_triplets(args.dataset)
    print(f"Loaded {triplets.shape[0]} triplets from {args.dataset}")

    make_opt = zero_optimizer if args.fern_type == "zero" else tau_optimizer
    optimizer = make_opt(
        num_resamples=args.num_resamples,
        only_score_non_split_samples=args.only_score_non_split,
        w1=args.w1,
    )
    settings = fern_factory(args.num_s, args.num_m, args.num_l, args.depth)
    settings = type(settings)(
        ferns=settings.ferns,
        max_depth=settings.max_depth,
        sample_fraction=args.sample_fraction,
    )
    mesh = None
    if args.data_parallel > 1:
        import jax

        from opengpc_tpu.parallel import make_mesh

        devs = jax.devices()
        if len(devs) < args.data_parallel:
            print(f"--data-parallel {args.data_parallel}: only "
                  f"{len(devs)} devices visible", file=sys.stderr)
            return 1
        mesh = make_mesh(devs[:args.data_parallel])
    forest = train_forest(triplets, settings, optimizer, seed=args.seed,
                          checkpoint_path=args.checkpoint, mesh=mesh,
                          batch_ferns=False if args.no_batch_ferns else None)
    save_forest(forest, args.forest_out)
    print(f"Exported forest to {args.forest_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

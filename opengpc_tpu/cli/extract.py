"""Training-dataset extraction CLI.

Equivalent of the reference ``extract`` sample
(/root/reference/samples/extract.cpp): mine ground-truth patch triplets
from an MPI-Sintel dataset into the binary triplet format.

Defaults mirror the reference (extract.cpp:31-33): 1000 triplets per frame
pair, negative annulus radius [20, 40].  ``--mode stereo`` walks the
Sintel stereo layout instead of optical flow (SintelStereo datasource).
"""

from __future__ import annotations

import argparse
import sys

from opengpc_tpu.io.triplets import save_triplets
from opengpc_tpu.mine import extract_flow_dataset, extract_stereo_dataset
from opengpc_tpu.cli._errors import report_input_errors
from opengpc_tpu.utils.device import start


@report_input_errors
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="opengpc-extract", description=__doc__.splitlines()[0]
    )
    from opengpc_tpu import __version__
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("sintel_root", help="Sintel dataset root (contains training/)")
    p.add_argument("out", help="output binary triplet dataset")
    p.add_argument("--mode", choices=["flow", "stereo"], default="flow")
    p.add_argument("--triplets-per-pair", type=int, default=1000)
    p.add_argument("--radius-lower", type=int, default=20)
    p.add_argument("--radius-upper", type=int, default=40)
    p.add_argument("--num-scenes", type=int, default=20,
                   help="cap on scenes walked (reference uses 20)")
    p.add_argument("--image-pass", default="clean", choices=["clean", "final"],
                   help="flow mode: which render pass to read frames from")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    start()

    if args.mode == "flow":
        data = extract_flow_dataset(
            args.sintel_root, args.triplets_per_pair, args.radius_lower,
            args.radius_upper, args.num_scenes, args.seed, args.image_pass,
        )
    else:
        data = extract_stereo_dataset(
            args.sintel_root, args.triplets_per_pair, args.radius_lower,
            args.radius_upper, args.num_scenes, args.seed,
        )
    save_triplets(data, args.out)
    print(f"Stored {data.shape[0]} triplets to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

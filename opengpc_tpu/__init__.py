"""opengpc_tpu — a data-parallel Global Patch Collider framework.

A from-scratch JAX/XLA reimplementation of the capabilities of
bamert/openGPC (sparse stereo/flow correspondence via learned fern
forests), designed for an accelerator:

* dense masked compute instead of index-list sparsity,
* one key-image stencil (box + sobel + shifted compares) that XLA fuses,
  instead of SSE intrinsics,
* sort + segmented unique-collision matching instead of hash tables,
* ``vmap`` over stereo pairs and ``shard_map`` over device meshes instead
  of ``std::thread`` row partitioning,
* vectorized greedy fern training over the whole triplet tensor.

Persistent artifacts (text forest format, binary triplet datasets, sparse
disparity outputs) are bit-compatible with the reference.
"""

from opengpc_tpu.forest import (
    Forest,
    Fern,
    Test,
    FilterMask,
    load_forest,
    save_forest,
    parse_forest,
    serialize_forest,
    truncate_forest,
    make_filter_mask,
)
from opengpc_tpu.config import (
    InferenceSettings,
    OptimizerSettings,
    ForestSettings,
    fern_factory,
    tau_optimizer,
    zero_optimizer,
)
from opengpc_tpu.infer import (
    build_sparsematch,
    build_sparsematch_global_compact,
    build_sparsematch_global_rows,
    build_sparsematch_masked,
    build_sparsematch_masked_compact,
    build_sparsematch_rows,
    build_stereomatch,
    extract_descriptors,
    global_row_supports_to_numpy,
    masked_supports_to_numpy,
    row_supports_to_numpy,
    sparsematch,
    supports_to_numpy,
)
from opengpc_tpu.aot import (
    export_batched_sharded_frame,
    export_sharded_frame,
    export_sparsematch,
    load_artifact,
    load_batched_sharded_frame,
    load_sharded_frame,
    load_sparsematch,
    peek_artifact_meta,
    save_artifact,
)
from opengpc_tpu.densify import densify_from_masked, densify_supports
from opengpc_tpu.types import Correspondence, Descriptor, Point, Support

__version__ = "0.5.0"

"""Multi-process (simulated multi-host) worker: 2 CPU processes x 2
virtual devices each = a 4-device global mesh with cross-process
collectives — the closest a single machine gets to a multi-host mesh
(parallel.init_distributed / README "Scaling out").  Launched by
tests/test_parallel.py::test_multiprocess_mesh_e2e; argv: <proc_id>
<coordinator_port>."""
import os
import sys

proc = int(sys.argv[1])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))))

import jax

from opengpc_tpu.parallel import init_distributed

port = int(sys.argv[2])
n = init_distributed(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=proc)
assert n == 2, n
import numpy as np

from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.forest import load_forest
from opengpc_tpu.parallel import build_batched_sparsematch, make_mesh
from opengpc_tpu.infer import build_sparsematch, supports_to_numpy
from opengpc_tpu.utils.scenes import make_pair

assert len(jax.devices()) == 4, jax.devices()
forest = load_forest(__import__("os").path.join(__import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))), "forests", "defaultZeroForest.txt"))
settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                             disp_high=16, epipolar_mode=True, capacity=8192)
pairs = [make_pair(64, 96, 3, seed=40 + b) for b in range(4)]
lb = np.stack([p[0] for p in pairs])
rb = np.stack([p[1] for p in pairs])

mesh = make_mesh()
run = build_batched_sparsematch(forest, settings, mesh)
xs, ys, ds, counts = run(lb, rb)

single = build_sparsematch(forest, settings)
# each process can only fetch its LOCAL shards of the global batch
checked = 0

def by_b(arr):
    return {(s.index[0].start or 0): np.asarray(s.data)
            for s in arr.addressable_shards}

xs_l, ys_l, ds_l, ct_l = by_b(xs), by_b(ys), by_b(ds), by_b(counts)
for b0, xs_d in xs_l.items():
    for k in range(xs_d.shape[0]):
        b = b0 + k
        want = set(map(tuple,
                       supports_to_numpy(*single(lb[b], rb[b])).tolist()))
        got = set(map(tuple, supports_to_numpy(
            xs_d[k], ys_l[b0][k], ds_l[b0][k], ct_l[b0][k]).tolist()))
        assert got == want and len(want) > 50, (proc, b, len(got), len(want))
        checked += 1
assert checked == 2, checked  # 2 of the 4 batch elements live here
print(f"proc {proc}: local shards ({checked} pairs) supports identical",
      flush=True)

# SINGLE-FRAME row sharding across the process boundary (r4): the 14-row
# halo ppermute between devices 1 and 2 crosses processes — the
# cross-host analog of the sharded-frame path.  Each process validates its local row shards
# against a single-device masked run.
from opengpc_tpu.infer import build_sparsematch_masked
from opengpc_tpu.parallel import build_sharded_frame_sparsematch

fl, fr = make_pair(64, 96, 3, seed=77)  # 16 rows/shard on the 4-device mesh
frun = build_sharded_frame_sparsematch(forest, settings, mesh)
fbuf, fcounts = frun(fl, fr)
wbuf, wcounts = build_sparsematch_masked(forest, settings)(fl, fr)
wbuf, wcounts = np.asarray(wbuf), np.asarray(wcounts)
fchecked = 0
for s in fbuf.addressable_shards:
    r0 = s.index[0].start or 0
    rows = np.asarray(s.data)
    assert (rows == wbuf[r0:r0 + rows.shape[0]]).all(), (proc, r0)
    fchecked += rows.shape[0]
for s in fcounts.addressable_shards:
    r0 = s.index[0].start or 0
    c = np.asarray(s.data)
    assert (c == wcounts[r0:r0 + c.shape[0]]).all(), (proc, r0)
assert fchecked == 32, fchecked  # 2 of the 4 row shards live here
print(f"proc {proc}: sharded-frame local rows identical", flush=True)

# TRIPLET-AXIS-SHARDED TRAINING across the process boundary (r4): each
# level's TP/FP/FN psum crosses the 2-process mesh; the selected splits
# and every per-level stat must equal an unsharded local run (integer
# counts are exact regardless of sharding).  n=157 is deliberately not
# divisible by 4: exercises the pre-excluded padding path.
from opengpc_tpu.config import tau_optimizer
from opengpc_tpu.parallel import sharded_train_fern
from opengpc_tpu.train import train_fern

rng_t = np.random.default_rng(31)
n_t = 157
ref_p = rng_t.integers(0, 256, (n_t, 729)).astype(np.int16)
pos_p = np.clip(ref_p + rng_t.integers(-8, 9, ref_p.shape), 0, 255)
neg_p = rng_t.integers(0, 256, ref_p.shape)
trips = np.stack([ref_p, pos_p, neg_p], axis=1).astype(np.uint8)

fern_s, stats_s = sharded_train_fern(
    trips, 1, tau_optimizer(num_resamples=4), 3, mesh, seed=9)
fern_1, stats_1 = train_fern(
    trips, 1, tau_optimizer(num_resamples=4), 3,
    rng=np.random.default_rng(9), verbose=False)
assert fern_s.tests == fern_1.tests, (proc, fern_s.tests, fern_1.tests)
assert stats_s == stats_1, (proc, stats_s[0], stats_1[0])
print(f"proc {proc}: cross-process sharded training identical", flush=True)

# 2-D (data x rows) MESH with a CROSS-PROCESS halo (r4): column-major
# device order puts each frame's row-neighbors in DIFFERENT processes, so
# the 14-row halo ppermute crosses the (simulated) host boundary.  Each process
# validates its local (frame, row-block) shards against single-device runs.
from opengpc_tpu.parallel import (build_batched_sharded_frame_sparsematch,
                                  make_mesh_2d)

devs = jax.devices()
mesh2 = make_mesh_2d(2, 2, [devs[0], devs[2], devs[1], devs[3]])
pairs2 = [make_pair(64, 96, 3, seed=90 + i) for i in range(2)]
bl2 = np.stack([p[0] for p in pairs2])
br2 = np.stack([p[1] for p in pairs2])
run2 = build_batched_sharded_frame_sparsematch(forest, settings, mesh2)
b2buf, b2counts = run2(bl2, br2)
single_m = build_sparsematch_masked(forest, settings)
want2 = [np.asarray(single_m(bl2[i], br2[i])[0]) for i in range(2)]
checked2 = 0
for s in b2buf.addressable_shards:
    bi = s.index[0].start or 0
    r0 = s.index[1].start or 0
    rows = np.asarray(s.data)[0]
    assert (rows == want2[bi][r0:r0 + rows.shape[0]]).all(), (proc, bi, r0)
    checked2 += 1
assert checked2 == 2, checked2  # one shard of each frame lives here
print(f"proc {proc}: 2-D mesh cross-process halo shards identical",
      flush=True)

# BATCHED-FERN TRAINING over the cross-process mesh (r4): all ferns'
# level scoring in one dispatch, triplet axis sharded over both
# processes; the exported forest must be byte-identical to a local
# unsharded sequential run.
from opengpc_tpu.config import fern_factory
from opengpc_tpu.forest import serialize_forest
from opengpc_tpu.train import train_forest

settings_f = fern_factory(1, 1, 0, 2)
f_batched = train_forest(trips, settings_f, tau_optimizer(num_resamples=3),
                         seed=5, verbose=False, batch_ferns=True, mesh=mesh)
f_seq = train_forest(trips, settings_f, tau_optimizer(num_resamples=3),
                     seed=5, verbose=False, batch_ferns=False)
assert serialize_forest(f_batched) == serialize_forest(f_seq), proc
print(f"proc {proc}: cross-process batched-fern forest identical",
      flush=True)

# SHARDED PYRAMID across the process boundary (r5): rows over the
# 4-device 2-process mesh at EVERY level, so the per-level halo
# ppermutes (and nothing else) cross the simulated host boundary.  Each chip's
# dedup block holds exactly its level-0 row range, so each process
# validates its local blocks against the single-device pyramid's
# supports restricted to those rows.
from opengpc_tpu.parallel import build_sharded_frame_pyramid
from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                 pyramid_supports_to_numpy)

ph, pw = 112, 96  # 4 chips x 2 levels: slab 28, coarsest 14 == halo min
pl, pr = make_pair(ph, pw, 3, seed=101)
prun = build_sharded_frame_pyramid(forest, settings, mesh, num_levels=2)
pout = prun(pl, pr)
sout = build_pyramid_sparsematch(forest, settings, num_levels=2)(pl, pr)
srows = pyramid_supports_to_numpy(*sout)
assert (np.asarray(pout[4]) == np.asarray(sout[4])).all(), proc
K = pout[0].shape[0] // 4  # per-chip dedup block length
pchecked = 0
pxs, pys, pds, plv = pout[:4]
for s in pxs.addressable_shards:
    i0 = s.index[0].start or 0
    chip = i0 // K
    sh = ph // 4
    blk = [np.asarray(a.addressable_shards[[t.index[0].start or 0
           for t in a.addressable_shards].index(i0)].data)
           for a in (pxs, pys, pds, plv)]
    got = set()
    lv_b = blk[3]
    keep = lv_b >= 0
    got = set(zip(blk[0][keep].tolist(), blk[1][keep].tolist(),
                  blk[2][keep].tolist(), lv_b[keep].tolist()))
    in_range = srows[(srows[:, 1] >= chip * sh)
                     & (srows[:, 1] < (chip + 1) * sh)]
    want = set(map(tuple, in_range.tolist()))
    assert got == want and len(want) > 10, (proc, chip, len(got),
                                            len(want))
    pchecked += 1
assert pchecked == 2, pchecked  # 2 of the 4 chip blocks live here
print(f"proc {proc}: cross-process sharded pyramid blocks identical",
      flush=True)

# AOT ARTIFACT SERVED ACROSS PROCESSES (r4): the artifact was exported by
# the PARENT pytest process (a different "host" with its own
# single-process 4-virtual-device mesh) and handed over as a file — the
# export-on-one-host / serve-on-a-pod story.  Both worker processes
# deserialize it over the global 2-process mesh and serve the SAME frame
# pair; local row shards must match the live single-device masked run.
if len(sys.argv) > 3:
    from opengpc_tpu.aot import load_artifact, peek_artifact_meta

    meta = peek_artifact_meta(sys.argv[3])
    assert meta["n_devices"] == 4, meta
    amesh = make_mesh()
    acall, _ = load_artifact(sys.argv[3], amesh)
    # multi-process jit rejects raw numpy for non-trivial shardings; build
    # global row-sharded arrays from the (identical) per-process host data
    from jax.sharding import NamedSharding, PartitionSpec as P

    from opengpc_tpu.parallel import DATA_AXIS

    ash = NamedSharding(amesh, P(DATA_AXIS))
    gl = jax.make_array_from_callback(fl.shape, ash, lambda idx: fl[idx])
    gr = jax.make_array_from_callback(fr.shape, ash, lambda idx: fr[idx])
    abuf, acounts = acall(gl, gr)
    achecked = 0
    for s in abuf.addressable_shards:
        r0 = s.index[0].start or 0
        rows = np.asarray(s.data)
        assert (rows == wbuf[r0:r0 + rows.shape[0]]).all(), (proc, r0)
        achecked += rows.shape[0]
    for s in acounts.addressable_shards:
        r0 = s.index[0].start or 0
        c = np.asarray(s.data)
        assert (c == wcounts[r0:r0 + c.shape[0]]).all(), (proc, r0)
    assert achecked == 32, achecked
    print(f"proc {proc}: AOT artifact served across processes identical",
          flush=True)

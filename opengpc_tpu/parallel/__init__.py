"""Multi-device scale-out.

The problem is embarrassingly parallel over stereo pairs (inference) and
over training triplets (training) — the reference's only parallelism was
SIMD lanes + row-partitioned threads (/root/reference/lib/gpc/filter.hpp:
128-145); the recast here is ``vmap`` within a device and sharding of
the batch/triplet axis over a ``jax.sharding.Mesh`` (SPMD; XLA hands the
collectives to NCCL, over NVLink between the cards of one host).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.forest import Forest, make_filter_mask
from opengpc_tpu.infer import _sparsematch_impl

DATA_AXIS = "data"
ROWS_AXIS = "rows"


def init_distributed(**kwargs) -> int:
    """Initialize multi-process JAX when launched under a multi-process
    runtime; harmless no-op in a single process.

    Returns the process count.  After this, ``make_mesh()`` spans all
    processes' devices and batch/triplet sharding spans them with no
    further code changes (SPMD).  Without a cluster runtime, pass
    ``coordinator_address``, ``num_processes`` and ``process_id``."""
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError) as e:
        # single-process / already initialized — but say what happened so a
        # genuine multi-host misconfiguration isn't silently masked
        import logging

        logging.getLogger(__name__).info(
            "jax.distributed.initialize skipped: %s", e
        )
    return jax.process_count()


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (DATA_AXIS,))


def make_mesh_2d(n_data: int, n_rows: int,
                 devices: Optional[Sequence] = None) -> Mesh:
    """2-D ("data", "rows") mesh: ``n_data`` independent frame groups, each
    row-sharding its frames over ``n_rows`` chips.  Devices fill row-major,
    so consecutive devices form one frame group (the halo ppermutes ride
    the "rows" axis; on an all-to-all NVLink host any order is as good)."""
    devices = list(devices if devices is not None else jax.devices())
    if len(devices) < n_data * n_rows:
        raise ValueError(
            f"need {n_data * n_rows} devices for a {n_data}x{n_rows} mesh, "
            f"have {len(devices)}")
    arr = np.array(devices[: n_data * n_rows]).reshape(n_data, n_rows)
    return Mesh(arr, (DATA_AXIS, ROWS_AXIS))


def build_batched_sparsematch(forest: Forest, settings: InferenceSettings,
                              mesh: Mesh):
    """Jitted (B, H, W) x2 -> per-pair supports, batch sharded over the mesh.

    Per-pair work is independent, so the batch axis is split with
    ``shard_map``: every chip runs the complete per-shard program (vmap
    over its local pairs) and no collectives are inserted.  shard_map —
    not jit-with-shardings — keeps every device on its own single-device
    program: the partitioner never has to split a sort.

    B must be divisible by the mesh size.  Outputs keep the batch
    sharding (supports stay device-resident for downstream consumers).
    """
    mask = make_filter_mask(forest)
    _one = functools.partial(
        _sparsematch_impl, mask=mask, settings=settings
    )

    def local(ls, rs):
        # sequential scan over the per-device shard, not vmap (see
        # infer.build_sparsematch); devices still run shards in parallel
        return jax.lax.map(lambda ab: _one(*ab), (ls, rs))
    spec = P(DATA_AXIS)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, spec, spec, spec),
        check_vma=False,
    )
    return jax.jit(fn)


def build_batched_sparsematch_rows(forest: Forest, settings: InferenceSettings,
                                   mesh: Mesh):
    """Row-form variant of build_batched_sparsematch — the maximum-
    throughput contract sharded over the mesh: (B, H, W) x2 ->
    ((xs, ds) (B, H, W) each, row_counts (B, H)), batch axis split with
    shard_map like the flat variant.  Epipolar, <=30-test forests only
    (infer.build_sparsematch_rows)."""
    from opengpc_tpu.infer import _sparsematch_rows_batched_impl

    mask = make_filter_mask(forest)
    # stacked batch per shard: each chip folds its local pairs into ONE
    # (B_local*H, 2W) segmented sort (infer._sparsematch_rows_batched_impl)
    local = functools.partial(
        _sparsematch_rows_batched_impl, mask=mask, settings=settings,
    )

    spec = P(DATA_AXIS)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec),
        out_specs=((spec, spec), spec),
        check_vma=False,
    )
    return jax.jit(fn)


def build_batched_sparsematch_masked(forest: Forest,
                                     settings: InferenceSettings,
                                     mesh: Mesh):
    """Masked sorted-order contract over a device mesh: (B, H, W) x2 ->
    (buf (B, H, 2W), row_counts (B, H)), batch split with shard_map; each
    chip folds its local pairs into one (B_local*H, 2W) sort (the masked
    impl handles the batched fold natively)."""
    from opengpc_tpu.infer import _sparsematch_masked_impl

    mask = make_filter_mask(forest)
    local = functools.partial(
        _sparsematch_masked_impl, mask=mask, settings=settings,
    )
    spec = P(DATA_AXIS)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, spec),
        check_vma=False,
    )
    return jax.jit(fn)


def build_batched_sparsematch_masked_compact(forest: Forest,
                                             settings: InferenceSettings,
                                             mesh: Mesh,
                                             chunk=None, k=None):
    """Chunk-compacted masked contract over a device mesh (the r4
    low-density fast path): (B, H, W) x2 -> (buf (B, H, C), row_counts
    (B, H), overflow (n_shards,) bool).  Batch split with shard_map; each
    shard folds its local pairs into one compacted sort and reports its
    own overflow flag — re-run the full-width masked builder when
    ``overflow.any()`` (exactness contract of
    infer.build_sparsematch_masked_compact)."""
    from opengpc_tpu.infer import _sparsematch_masked_compact_impl

    mask = make_filter_mask(forest)

    def local(ls, rs):
        buf, counts, ovf = _sparsematch_masked_compact_impl(
            ls, rs, mask=mask, settings=settings, chunk=chunk, k=k,
        )
        return buf, counts, ovf.reshape(1)

    spec = P(DATA_AXIS)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, spec, spec),
        check_vma=False,
    )
    return jax.jit(fn)


def build_batched_sparsematch_global_rows(forest: Forest,
                                          settings: InferenceSettings,
                                          mesh: Mesh):
    """Global-mode variant of build_batched_sparsematch_rows: (B, H, W) x2
    -> ((xs, ys, ds) (B, R, C) each, counts (B, R)), batch axis split with
    shard_map (segmented global contract, infer.build_sparsematch_global_rows).
    Per-pair global sorts stay independent, so the shard-local batch runs
    under lax.map (vmap would turn them into one batched flat sort)."""
    from opengpc_tpu.infer import _sparsematch_global_rows_impl

    mask = make_filter_mask(forest)
    _one = functools.partial(
        _sparsematch_global_rows_impl, mask=mask, settings=settings,
    )

    def local(ls, rs):
        return jax.lax.map(lambda ab: _one(*ab), (ls, rs))

    spec = P(DATA_AXIS)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec),
        out_specs=((spec, spec, spec), spec),
        check_vma=False,
    )
    return jax.jit(fn)


def build_batched_sparsematch_global_compact(forest: Forest,
                                             settings: InferenceSettings,
                                             mesh: Mesh,
                                             chunk=None, k=None):
    """Chunk-compacted GLOBAL contract over a device mesh (the
    low-density global fast path): (B, H, W) x2 -> ((xs, ys, ds)
    (B, R, C) each, counts (B, R), overflow (B,) bool).  Batch axis split
    with shard_map; the shard-local batch runs under lax.map (per-pair
    flat sorts, like the single-device builder), giving PER-PAIR overflow
    flags: re-run overflowing pairs through the full-width global builder
    (exactness contract of
    infer.build_sparsematch_global_compact)."""
    from opengpc_tpu.infer import _sparsematch_global_compact_impl

    mask = make_filter_mask(forest)
    _one = functools.partial(
        _sparsematch_global_compact_impl, mask=mask, settings=settings,
        chunk=chunk, k=k,
    )

    def local(ls, rs):
        return jax.lax.map(lambda ab: _one(*ab), (ls, rs))

    spec = P(DATA_AXIS)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec),
        out_specs=((spec, spec, spec), spec, spec),
        check_vma=False,
    )
    return jax.jit(fn)


def build_sharded_frame_sparsematch(forest_or_mask,
                                    settings: InferenceSettings,
                                    mesh: Mesh,
                                    contract: str = "masked",
                                    chunk=None, k=None, bucket_cap=None):
    """SINGLE-FRAME multi-chip matcher: shard ONE (H, W) pair's ROWS over
    the mesh — the direct multi-chip recast of the reference's only
    intra-image parallelism, parFor row partitioning
    (/root/reference/lib/gpc/filter.hpp:128-145, used by the hot kernel at
    filter.hpp:601-604).  Epipolar rows are independent, so the result is
    exact by construction with ZERO matcher collectives; the only
    communication is a 14-row halo exchange (two ``ppermute``s)
    so each shard's preprocessing/code windows see real neighbor rows.

    Each chip receives H/n rows (H must divide by the mesh size), swaps
    halos, builds its slab's key image (infer._key_image_jnp_slab —
    global-coordinate margin math from a traced row offset) plus the matcher
    on its slab, and emits its row block of the full-image result:

    * ``contract="masked"`` (default): (buf (H, 2W), row_counts (H,)) —
      identical to build_sparsematch_masked on the whole frame.
    * ``contract="rows"``: ((xs, ds) (H, W) each, row_counts (H,)) —
      identical to build_sparsematch_rows.
    * ``contract="masked-compact"``: (buf (H, 2W/chunk*k), row_counts,
      overflow bool[]) — identical to build_sparsematch_masked_compact
      (the r4 low-density fast path).  Each shard's per-chunk overflow
      flag is pmax-reduced over the mesh axis into ONE replicated flag;
      when True the caller must re-run a full-width contract (the CLI's
      ``--shard-frame --contract masked-compact`` re-runs the sharded
      masked builder).
    * ``contract="global-compact"`` (requires ``epipolar_mode=False``):
      ((xs, ys, ds) (H, C) each, counts (H,), overflow bool[]) — same
      support set as build_sparsematch_global_compact /
      build_sparsematch_global_rows whenever ``overflow`` is False,
      decoded with infer.global_row_supports_to_numpy (segment layout
      differs: segments follow the distributed bucket order, which the
      global contract explicitly leaves arbitrary).  Global mode's
      uniqueness domain spans the whole image pair, so this contract is a
      DISTRIBUTED SORT: each chip chunk-compacts its slab's candidates
      (match._strided_chunk_compact, 2HW -> 2HW*(K/S) survivors), assigns
      each survivor to the chip owning its code range (fern codes are
      hash-uniform, so a static equal-width partition of [0, 2^30)
      balances), exchanges buckets with ONE ``all_to_all``
      (fixed per-destination capacity ``bucket_cap``), and detects
      duplicate collisions with a LOCAL sort of its own bucket — equal
      codes land on the same chip by construction, so cross-shard
      uniqueness needs no further collective and no boundary halo.
      Sentinel/pad survivors don't ride the exchange at all — they can
      never pair (unique keys, or same-image runs the cross check
      rejects, the match_global_rows_compact argument), and dropping
      non-equal neighbors never changes the equal-run structure of the
      valid keys that remain.  Exactness is overflow-guarded
      twice (chunk capacity k and bucket capacity), pmax-combined into
      one replicated flag: when True, re-run the single-device
      full-width global matcher.  This replaces the r4 "collective cost
      ~= re-centralizing" won't-do: the flat uniqueness sort — the
      dominant global-mode stage — now runs n-way parallel on
      ~2HW*(K/S)/n elements per chip.

    Shards at the image's top/bottom see zero halos (``ppermute`` fills
    non-received edges with zeros), which is exactly the zero padding a
    single-device run applies outside the frame.  The interior-row slicing
    optimization of the single-chip path (sorting only rows [13, H-13))
    is skipped here — margin rows land in the edge shards only and cost
    <3% of their sort at realistic H (documented deviation).
    """
    from opengpc_tpu.infer import (_global_rows_ok, _key_image_jnp_slab,
                                   _rows_ok)
    from opengpc_tpu.match import (SENTINEL_BASE, _global_rows_core,
                                   _strided_chunk_compact,
                                   match_epipolar_masked,
                                   match_epipolar_masked_compact,
                                   match_epipolar_rows,
                                   resolve_global_compact_chunks)
    from opengpc_tpu.ops.codes import PAD

    if contract not in ("masked", "rows", "masked-compact",
                        "global-compact"):
        raise ValueError(
            f"contract must be 'masked', 'rows', 'masked-compact' or "
            f"'global-compact', got {contract!r}")
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    n = int(np.prod(mesh.devices.shape))
    axis = DATA_AXIS
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]

    def local(l_slab, r_slab):
        sh, w = l_slab.shape
        h_total = n * sh
        if sh < PAD:
            raise ValueError(
                f"shards of {sh} rows are below the {PAD}-row halo (one "
                f"ppermute hop exchanges at most a full shard); use a "
                f"smaller mesh for images under {PAD * n} rows"
            )
        if contract == "global-compact":
            if settings.epipolar_mode:
                raise ValueError(
                    "contract='global-compact' is for global mode "
                    "(epipolar_mode=False); use the masked/rows contracts "
                    "for epipolar settings"
                )
            if not _global_rows_ok(mask, (h_total, w), settings):
                raise ValueError(
                    "sharded global matching needs <=30-test forests and "
                    "packable (y, x, d) keys; see infer._global_rows_ok"
                )
        else:
            if not settings.epipolar_mode:
                raise ValueError(
                    "epipolar sharded-frame contracts need "
                    "epipolar_mode=True; global mode rides "
                    "contract='global-compact' (distributed bucket sort)"
                )
            if not _rows_ok(mask, (h_total, w), settings):
                raise ValueError(
                    "sharded-frame matching needs <=30-test forests and a "
                    "packable (x, d) key; see infer._rows_ok"
                )
        y0 = jax.lax.axis_index(axis).astype(jnp.int32) * sh

        def with_halo(x):
            if n == 1:
                zeros = jnp.zeros((PAD, w), x.dtype)
                return jnp.concatenate([zeros, x, zeros], axis=0)
            top = jax.lax.ppermute(x[-PAD:], axis, fwd)
            bot = jax.lax.ppermute(x[:PAD], axis, bwd)
            return jnp.concatenate([top, x, bot], axis=0)

        hl = with_halo(l_slab)
        hr = with_halo(r_slab)
        key = _key_image_jnp_slab(hl, hr, mask, settings, y0, h_total)
        if contract == "global-compact":
            w2 = 2 * w
            ch, kk = resolve_global_compact_chunks(w2, chunk, k)
            pos = ((y0 + jnp.arange(sh, dtype=jnp.int32))[:, None] * w2
                   + jnp.arange(w2, dtype=jnp.int32)[None, :])
            ks, ps, ovf_c = _strided_chunk_compact(
                key, pos, ch, kk, pos_never=h_total * w2)
            m = int(ks.shape[0])
            cap = bucket_cap
            if cap is None:
                # hash-uniform codes put ~m/n survivors in each bucket
                # (deviation is a few sigma of binomial(m, 1/n)); 2x slack
                # absorbs real-image code skew, the overflow flag guards
                # the rest
                cap = max(1024, -(-2 * m // (n * 128)) * 128)
            cap = min(cap, m)
            # int32 headroom (static trace-time guard): exchange pads live
            # in [SENTINEL_BASE, 2^31), unique per (source chip, slot)
            if n * m >= (1 << 30):
                raise ValueError(
                    f"exchange pads overflow int32: n*m = {n * m} >= 2^30")
            my = jax.lax.axis_index(axis).astype(jnp.int32)
            # owner chip of a valid code = its equal-width range of
            # [0, 2^30); sentinel/pad survivors DON'T ride the exchange at
            # all — they can never pair (see docstring), and removing
            # non-equal neighbors never changes the equal-run structure of
            # the valid keys that remain
            div = -(-SENTINEL_BASE // n)
            bkt = jnp.where(ks < SENTINEL_BASE, ks // div, jnp.int32(n))
            dest = jnp.arange(n, dtype=jnp.int32)[:, None]
            pads = (SENTINEL_BASE + my * jnp.int32(m)
                    + jnp.arange(m, dtype=jnp.int32))[None, :]
            mine = bkt[None, :] == dest
            tk = jnp.where(mine, ks[None, :], pads)
            tp = jnp.where(mine, ps[None, :], jnp.int32(h_total * w2))
            cnt = jnp.sum(mine, axis=1, dtype=jnp.int32)
            ovf_b = jnp.any(cnt > cap)
            # per-destination left-pack: real keys (< pad base) sort left,
            # the first `cap` columns ride the exchange
            sk, sp = jax.lax.sort((tk, tp), dimension=1, num_keys=1,
                                  is_stable=False)
            send = jnp.stack([sk[:, :cap], sp[:, :cap]], axis=-1)
            recv = jax.lax.all_to_all(send, axis, split_axis=0,
                                      concat_axis=0, tiled=True)
            (xs, ys, ds), counts = _global_rows_core(
                recv[..., 0].reshape(-1), recv[..., 1].reshape(-1),
                w, w2, h_total, settings.disp_high,
                settings.vertical_tolerance, sh, 0)
            ovf = jax.lax.pmax((ovf_c | ovf_b).astype(jnp.int32), axis) > 0
            return (xs, ys, ds), counts, ovf
        if contract == "masked-compact":
            buf, counts, ovf = match_epipolar_masked_compact(
                key, settings.disp_high, chunk, k,
                num_tests=mask.num_tests)
            # one replicated frame-level flag: any shard's chunk overflow
            # taints the whole frame (the fallback re-runs it whole)
            ovf = jax.lax.pmax(ovf.astype(jnp.int32), axis) > 0
            return buf, counts, ovf
        if contract == "masked":
            return match_epipolar_masked(None, None, None, None,
                                         settings.disp_high, key=key,
                                         num_tests=mask.num_tests)
        return match_epipolar_rows(None, None, None, None,
                                   settings.disp_high, key=key,
                                   num_tests=mask.num_tests)

    spec = P(DATA_AXIS)
    out_specs = ((spec, spec) if contract == "masked"
                 else (spec, spec, P()) if contract == "masked-compact"
                 else ((spec, spec, spec), spec, P())
                 if contract == "global-compact"
                 else ((spec, spec), spec))
    fn = shard_map(
        local, mesh=mesh, in_specs=(spec, spec), out_specs=out_specs,
        check_vma=False,
    )

    @jax.jit
    def run(left, right):
        if left.ndim != 2:
            raise ValueError(
                "sharded-frame matching takes ONE (H, W) pair (that is the "
                "point); use build_batched_sparsematch_* for batches"
            )
        if left.shape[0] % n:
            raise ValueError(
                f"image height {left.shape[0]} must divide by the mesh "
                f"size {n} (pad the pair or pick a divisor mesh)"
            )
        return fn(left, right)

    return run


def build_sharded_frame_pyramid(forest_or_mask,
                                settings: InferenceSettings,
                                mesh: Mesh, num_levels: int = 3):
    """SINGLE-FRAME multi-chip PYRAMID matcher: shard one
    (H, W) pair's rows over the mesh at EVERY pyramid level, so the
    multi-scale path composes with the same intra-image parallelism the
    flat contracts got (``build_sharded_frame_sparsematch``).

    Design: every chip owns the SAME level-0 row range at every level —
    chip c holds level-L slab rows [c*sh/2^L, (c+1)*sh/2^L), which scale
    back to exactly its level-0 rows [c*sh, (c+1)*sh).  The finest-wins
    dedup groups by level-0 pixel, so with this alignment the dedup is
    PER-CHIP LOCAL: one small packed sort per chip, no cross-chip
    collective beyond (a) the per-level 14-row halo ``ppermute``s (the
    preprocessing windows, same as the flat sharded contracts) and (b)
    one ``psum`` for the per-level counts.  Downscaling is row-local
    (2x2 means never cross the slab boundary because slab heights stay
    even), so each chip builds its own coarse slabs from its level-0
    slab — the coarse images are never materialized whole anywhere.

    Requires ``H % (n * 2^(num_levels-1)) == 0`` (every level's slab is
    exact) and the coarsest slab to clear the 14-row halo; pad the pair
    to a suitable height otherwise (the result then matches the
    single-device pyramid on the SAME padded pair — padding changes the
    margin semantics near the original bottom edge, as it does for any
    contract).

    Output contract: (xs, ys, ds, lv, counts) exactly like
    ``build_pyramid_sparsematch`` with dedup (decode with
    ``pyramid_supports_to_numpy``); buffer ORDER differs (per-chip
    blocks), the support set is identical — pinned on the 8-virtual-
    device mesh in tests/test_parallel.py.

    Reference analog: multi-scale is the GPC paper's pipeline; row
    partitioning is filter.hpp:128-145 — composed, which the reference
    never does."""
    from opengpc_tpu.infer import _key_image_jnp_slab, _rows_ok
    from opengpc_tpu.match import match_epipolar_rows
    from opengpc_tpu.ops.codes import PAD
    from opengpc_tpu.pyramid import _dedup_unpack, _pack_params, downscale2

    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    if not settings.epipolar_mode:
        raise ValueError("the sharded pyramid is epipolar-only (like "
                         "build_pyramid_sparsematch's fast path)")
    n = int(np.prod(mesh.devices.shape))
    axis = DATA_AXIS
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    mult, nbd = _pack_params(settings, num_levels)
    align = n << (num_levels - 1)

    def local(l_slab, r_slab):
        sh0, w0 = l_slab.shape
        h_total = n * sh0
        if not _rows_ok(mask, (h_total, w0), settings):
            raise ValueError(
                "sharded pyramid needs <=30-test forests and a packable "
                "(x, d) key; see infer._rows_ok")
        if (h_total * w0 * mult) << nbd >= 0x7FFFFFFF:
            raise ValueError(
                f"pyramid dedup keys for {h_total}x{w0} x {num_levels} "
                "levels exceed int32 packing")
        if (sh0 >> (num_levels - 1)) < PAD:
            raise ValueError(
                f"coarsest-level slabs of {sh0 >> (num_levels - 1)} rows "
                f"are below the {PAD}-row halo; use fewer levels or a "
                "smaller mesh")
        sent = jnp.int32(0x7FFFFFFF)
        my = jax.lax.axis_index(axis).astype(jnp.int32)

        def with_halo(x):
            w = x.shape[1]
            if n == 1:
                zeros = jnp.zeros((PAD, w), x.dtype)
                return jnp.concatenate([zeros, x, zeros], axis=0)
            top = jax.lax.ppermute(x[-PAD:], axis, fwd)
            bot = jax.lax.ppermute(x[:PAD], axis, bwd)
            return jnp.concatenate([top, x, bot], axis=0)

        keys = []
        l_s, r_s = l_slab, r_slab
        for level in range(num_levels):
            shl, wl = l_s.shape
            h_l = n * shl
            y0 = my * shl
            hl = with_halo(l_s)
            hr = with_halo(r_s)
            key = _key_image_jnp_slab(hl, hr, mask, settings, y0, h_l)
            (xs, ds), counts = match_epipolar_rows(
                None, None, None, None, settings.disp_high, key=key,
                num_tests=mask.num_tests)
            scale = 1 << level
            yy = ((y0 + jnp.arange(shl, dtype=jnp.int32)) * scale)[:, None]
            valid = (jnp.arange(wl, dtype=jnp.int32)[None, :]
                     < counts[:, None])
            pix = yy * w0 + xs * scale
            keys.append(jnp.where(
                valid,
                ((pix * mult + level) << nbd) | (ds + settings.disp_high),
                sent,
            ).reshape(-1))
            if level + 1 < num_levels:
                l_s = downscale2(l_s)
                r_s = downscale2(r_s)
        xs, ys, ds, lv, counts = _dedup_unpack(
            jnp.concatenate(keys), mult, nbd, w0, settings.disp_high,
            num_levels)
        return xs, ys, ds, lv, jax.lax.psum(counts, axis)

    spec = P(DATA_AXIS)
    fn = shard_map(
        local, mesh=mesh, in_specs=(spec, spec),
        out_specs=(spec, spec, spec, spec, P()),
        check_vma=False,
    )

    @jax.jit
    def run(left, right):
        if left.ndim != 2:
            raise ValueError("the sharded pyramid takes ONE (H, W) pair")
        if left.shape[0] % align:
            raise ValueError(
                f"image height {left.shape[0]} must divide by mesh size x "
                f"2^(levels-1) = {align} (pad the pair; the result then "
                "matches the single-device pyramid on the padded pair)")
        return fn(left, right)

    return run


def build_batched_sharded_frame_sparsematch(forest_or_mask,
                                            settings: InferenceSettings,
                                            mesh: Mesh,
                                            contract: str = "masked",
                                            chunk=None, k=None):
    """(B, H, W) pairs sharded BOTH ways over a 2-D ("data", "rows") mesh
    (``make_mesh_2d``): the batch axis splits over "data" (independent
    frames, zero collectives — build_batched_sparsematch_*'s axis) and
    every frame's ROWS split over "rows" with the same 14-row ppermute
    halo exchange as build_sharded_frame_sparsematch.  This composes the
    framework's two inference parallelism axes — the throughput axis
    (frames) and the latency axis (one frame's rows, the reference's
    parFor partitioning, /root/reference/lib/gpc/filter.hpp:128-145) — so
    a pod can stream a sequence of frames too large for single-chip
    latency budgets.

    Each chip holds (B/n_data) frame slabs of (H/n_rows) rows; after the
    halo exchange its local slabs fold into ONE (B_local*sh, 2W) segmented
    sort (epipolar rows are independent across frames AND row blocks, so
    the fold is exact — same argument as the batched masked fold).

    Contracts (epipolar only — global mode's uniqueness domain spans whole
    frames, see build_sharded_frame_sparsematch):

    * ``"masked"`` (default): (buf (B, H, 2W), row_counts (B, H)) —
      bit-identical to build_sparsematch_masked per frame.
    * ``"rows"``: ((xs, ds) (B, H, W) each, row_counts (B, H)).
    * ``"masked-compact"``: (buf (B, H, C), row_counts (B, H), overflow
      (n_data,) bool) — one pmax-reduced flag per frame GROUP (the "rows"
      axis collapses); re-run that group's frames full-width on overflow.
    """
    from opengpc_tpu.infer import _key_image_jnp_slab, _rows_ok
    from opengpc_tpu.match import (match_epipolar_masked,
                                   match_epipolar_masked_compact,
                                   match_epipolar_rows)
    from opengpc_tpu.ops.codes import PAD

    if contract not in ("masked", "rows", "masked-compact"):
        raise ValueError(
            f"contract must be 'masked', 'rows' or 'masked-compact', "
            f"got {contract!r}")
    if set(mesh.axis_names) != {DATA_AXIS, ROWS_AXIS}:
        raise ValueError(
            f"need a 2-D ('{DATA_AXIS}', '{ROWS_AXIS}') mesh "
            f"(make_mesh_2d), got axes {mesh.axis_names}")
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    n_rows = mesh.shape[ROWS_AXIS]
    n_data = mesh.shape[DATA_AXIS]
    fwd = [(i, i + 1) for i in range(n_rows - 1)]
    bwd = [(i + 1, i) for i in range(n_rows - 1)]

    def local(l_slabs, r_slabs):
        bl, sh, w = l_slabs.shape
        h_total = n_rows * sh
        if sh < PAD:
            raise ValueError(
                f"row shards of {sh} rows are below the {PAD}-row halo; "
                f"use fewer '{ROWS_AXIS}' shards for images under "
                f"{PAD * n_rows} rows")
        if not settings.epipolar_mode:
            raise ValueError("sharded-frame matching is epipolar-only")
        if not _rows_ok(mask, (h_total, w), settings):
            raise ValueError(
                "sharded-frame matching needs <=30-test forests and a "
                "packable (x, d) key; see infer._rows_ok")
        y0 = jax.lax.axis_index(ROWS_AXIS).astype(jnp.int32) * sh

        def with_halo(x):
            if n_rows == 1:
                zeros = jnp.zeros((bl, PAD, w), x.dtype)
                return jnp.concatenate([zeros, x, zeros], axis=1)
            top = jax.lax.ppermute(x[:, -PAD:], ROWS_AXIS, fwd)
            bot = jax.lax.ppermute(x[:, :PAD], ROWS_AXIS, bwd)
            return jnp.concatenate([top, x, bot], axis=1)

        hl = with_halo(l_slabs)
        hr = with_halo(r_slabs)
        keys = jax.vmap(
            lambda a, b: _key_image_jnp_slab(a, b, mask, settings,
                                             y0, h_total)
        )(hl, hr)
        flat = keys.reshape(bl * sh, 2 * w)
        if contract == "masked-compact":
            buf, counts, ovf = match_epipolar_masked_compact(
                flat, settings.disp_high, chunk, k,
                num_tests=mask.num_tests)
            ovf = jax.lax.pmax(ovf.astype(jnp.int32), ROWS_AXIS) > 0
            return (buf.reshape(bl, sh, -1), counts.reshape(bl, sh),
                    ovf.reshape(1))
        if contract == "masked":
            buf, counts = match_epipolar_masked(
                None, None, None, None, settings.disp_high, key=flat,
                num_tests=mask.num_tests)
            return buf.reshape(bl, sh, 2 * w), counts.reshape(bl, sh)
        (xs, ds), counts = match_epipolar_rows(
            None, None, None, None, settings.disp_high, key=flat,
            num_tests=mask.num_tests)
        return ((xs.reshape(bl, sh, w), ds.reshape(bl, sh, w)),
                counts.reshape(bl, sh))

    spec = P(DATA_AXIS, ROWS_AXIS, None)
    cspec = P(DATA_AXIS, ROWS_AXIS)
    out_specs = (
        (spec, cspec) if contract == "masked"
        else (spec, cspec, P(DATA_AXIS)) if contract == "masked-compact"
        else ((spec, spec), cspec))
    fn = shard_map(
        local, mesh=mesh, in_specs=(spec, spec), out_specs=out_specs,
        check_vma=False,
    )

    @jax.jit
    def run(lefts, rights):
        if lefts.ndim != 3:
            raise ValueError(
                "batched sharded-frame matching takes (B, H, W) pairs; use "
                "build_sharded_frame_sparsematch for a single pair")
        b, h, _ = lefts.shape
        if b % n_data:
            raise ValueError(
                f"batch {b} must divide by the '{DATA_AXIS}' axis {n_data}")
        if h % n_rows:
            raise ValueError(
                f"image height {h} must divide by the '{ROWS_AXIS}' axis "
                f"{n_rows} (pad the pairs or pick a divisor mesh)")
        return fn(lefts, rights)

    return run


def build_batched_pyramid(forest_or_mask, settings: InferenceSettings,
                          mesh: Mesh, num_levels: int = 3):
    """(B, H, W) pyramids batch-sharded over a 1-D mesh: each chip runs
    the batched HYBRID pyramid fold on its local frames (per-level folded
    row sorts + per-pair lax.map dedup — build_pyramid_sparsematch's
    (B, H, W) path), no collectives.  B must divide by the mesh size.
    Outputs keep the stacked per-pair layout (counts (B, num_levels))."""
    from opengpc_tpu.pyramid import (_pyramid_impl,
                                     _pyramid_rows_batched_impl,
                                     _rows_eligible)

    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    n = int(np.prod(mesh.devices.shape))

    def local(ls, rs):
        el = _rows_eligible(mask, settings, ls.shape[1], ls.shape[2],
                            num_levels)
        if el is not None:
            return _pyramid_rows_batched_impl(
                ls, rs, mask, settings, num_levels, *el)
        return jax.lax.map(
            lambda ab: _pyramid_impl(ab[0], ab[1], mask, settings,
                                     num_levels, True),
            (ls, rs))

    spec = P(DATA_AXIS)
    fn = shard_map(
        local, mesh=mesh, in_specs=(spec, spec), out_specs=(spec,) * 5,
        check_vma=False,
    )

    @jax.jit
    def run(lefts, rights):
        if lefts.ndim != 3:
            raise ValueError("build_batched_pyramid takes (B, H, W) pairs")
        if lefts.shape[0] % n:
            raise ValueError(
                f"batch {lefts.shape[0]} must divide by the mesh size {n}")
        return fn(lefts, rights)

    return run


def build_batched_sharded_frame_pyramid(forest_or_mask,
                                        settings: InferenceSettings,
                                        mesh: Mesh, num_levels: int = 3):
    """(B, H, W) PYRAMIDS sharded both ways over a 2-D ("data", "rows")
    mesh — the full composition matrix cell (r5): frames over "data"
    (independent, zero collectives), every frame's rows over "rows" at
    EVERY pyramid level (build_sharded_frame_pyramid's per-level halos and
    chip-local finest-wins dedup; each chip owns the same level-0 row
    range of its frames throughout, so dedup groups (frame, pixel) never
    cross chips).  Per level, a chip folds ALL its local frame-slabs into
    ONE (B_local*sh_l, 2W_l) segmented row sort; the dedup runs per local
    frame under ``lax.map`` (the hybrid rule of
    pyramid._pyramid_rows_batched_impl).

    Output contract: (xs, ys, ds, lv (B, n_rows*K_local) each, counts
    (B, num_levels)) — per-frame support set identical to the
    single-device pyramid (decode frame i with
    ``pyramid_supports_to_numpy(xs[i], ys[i], ds[i], lv[i], counts[i])``).

    Requires ``B % n_data == 0``, ``H % (n_rows * 2^(levels-1)) == 0``,
    and coarsest slabs >= the 14-row halo."""
    from opengpc_tpu.infer import _key_image_jnp_slab, _rows_ok
    from opengpc_tpu.match import match_epipolar_rows
    from opengpc_tpu.ops.codes import PAD
    from opengpc_tpu.pyramid import _dedup_unpack, _pack_params, downscale2

    if set(mesh.axis_names) != {DATA_AXIS, ROWS_AXIS}:
        raise ValueError(
            f"need a 2-D ('{DATA_AXIS}', '{ROWS_AXIS}') mesh "
            f"(make_mesh_2d), got axes {mesh.axis_names}")
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    if not settings.epipolar_mode:
        raise ValueError("the sharded pyramid is epipolar-only")
    n_rows = mesh.shape[ROWS_AXIS]
    n_data = mesh.shape[DATA_AXIS]
    fwd = [(i, i + 1) for i in range(n_rows - 1)]
    bwd = [(i + 1, i) for i in range(n_rows - 1)]
    mult, nbd = _pack_params(settings, num_levels)
    align = n_rows << (num_levels - 1)

    def local(l_slabs, r_slabs):
        bl, sh0, w0 = l_slabs.shape
        h_total = n_rows * sh0
        if not _rows_ok(mask, (h_total, w0), settings):
            raise ValueError(
                "sharded pyramid needs <=30-test forests and a packable "
                "(x, d) key; see infer._rows_ok")
        if (h_total * w0 * mult) << nbd >= 0x7FFFFFFF:
            raise ValueError(
                f"pyramid dedup keys for {h_total}x{w0} x {num_levels} "
                "levels exceed int32 packing")
        if (sh0 >> (num_levels - 1)) < PAD:
            raise ValueError(
                f"coarsest-level slabs of {sh0 >> (num_levels - 1)} rows "
                f"are below the {PAD}-row halo; use fewer levels or fewer "
                f"'{ROWS_AXIS}' shards")
        sent = jnp.int32(0x7FFFFFFF)
        my = jax.lax.axis_index(ROWS_AXIS).astype(jnp.int32)

        def with_halo(x):
            w = x.shape[2]
            if n_rows == 1:
                zeros = jnp.zeros((bl, PAD, w), x.dtype)
                return jnp.concatenate([zeros, x, zeros], axis=1)
            top = jax.lax.ppermute(x[:, -PAD:], ROWS_AXIS, fwd)
            bot = jax.lax.ppermute(x[:, :PAD], ROWS_AXIS, bwd)
            return jnp.concatenate([top, x, bot], axis=1)

        keys = []
        l_s, r_s = l_slabs, r_slabs
        for level in range(num_levels):
            _, shl, wl = l_s.shape
            h_l = n_rows * shl
            y0 = my * shl
            hl = with_halo(l_s)
            hr = with_halo(r_s)
            kimg = jax.vmap(
                lambda a, b, y0=y0, h_l=h_l: _key_image_jnp_slab(
                    a, b, mask, settings, y0, h_l)
            )(hl, hr)
            (xs, ds), counts = match_epipolar_rows(
                None, None, None, None, settings.disp_high,
                key=kimg.reshape(bl * shl, 2 * wl),
                num_tests=mask.num_tests)
            xs = xs.reshape(bl, shl, wl)
            ds = ds.reshape(bl, shl, wl)
            counts = counts.reshape(bl, shl)
            scale = 1 << level
            yy = ((y0 + jnp.arange(shl, dtype=jnp.int32))
                  * scale)[None, :, None]
            valid = (jnp.arange(wl, dtype=jnp.int32)[None, None, :]
                     < counts[:, :, None])
            pix = yy * w0 + xs * scale
            keys.append(jnp.where(
                valid,
                ((pix * mult + level) << nbd) | (ds + settings.disp_high),
                sent,
            ).reshape(bl, shl * wl))
            if level + 1 < num_levels:
                l_s = downscale2(l_s)
                r_s = downscale2(r_s)
        kc = jnp.concatenate(keys, axis=1)
        xs, ys, ds, lv, counts = jax.lax.map(
            lambda k: _dedup_unpack(k, mult, nbd, w0, settings.disp_high,
                                    num_levels), kc)
        return xs, ys, ds, lv, jax.lax.psum(counts, ROWS_AXIS)

    bspec = P(DATA_AXIS, ROWS_AXIS)
    fn = shard_map(
        local, mesh=mesh, in_specs=(P(DATA_AXIS, ROWS_AXIS, None),) * 2,
        out_specs=(bspec, bspec, bspec, bspec, P(DATA_AXIS, None)),
        check_vma=False,
    )

    @jax.jit
    def run(lefts, rights):
        if lefts.ndim != 3:
            raise ValueError(
                "the batched sharded pyramid takes (B, H, W) pairs; use "
                "build_sharded_frame_pyramid for a single pair")
        b, h, _ = lefts.shape
        if b % n_data:
            raise ValueError(
                f"batch {b} must divide by the '{DATA_AXIS}' axis {n_data}")
        if h % align:
            raise ValueError(
                f"image height {h} must divide by '{ROWS_AXIS}' axis x "
                f"2^(levels-1) = {align} (pad the pairs)")
        return fn(lefts, rights)

    return run


def sharded_train_fern(
    triplets, scale, optimizer, max_depth, mesh: Mesh, seed: int = 0,
    verbose: bool = False,
):
    """Train one fern with the triplet axis sharded over the mesh.

    Each level's TP/FP/FN count reduction becomes an XLA psum;
    everything else is per-shard local.  Selection semantics are identical
    to the single-device trainer (integer counts are exact regardless of
    sharding)."""
    import numpy as np

    from opengpc_tpu.train import train_fern

    return train_fern(
        triplets, scale, optimizer, max_depth,
        rng=np.random.default_rng(seed), verbose=verbose, mesh=mesh,
    )


def sharded_sparsematch_step(n_devices: int) -> None:
    """Dry-run: one sharded batched sparsematch step on tiny shapes.

    Requires n_devices visible jax devices (real chips or
    ``--xla_force_host_platform_device_count`` fakes).
    """
    import os

    from opengpc_tpu.forest import load_forest

    devices = jax.devices()
    if len(devices) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(devices)} "
            f"(set XLA_FLAGS=--xla_force_host_platform_device_count={n_devices})"
        )
    mesh = make_mesh(devices[:n_devices])
    forest = load_forest(
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "forests", "defaultZeroForest.txt")
    )
    settings = InferenceSettings(
        gradient_threshold=5, vertical_tolerance=0, disp_high=32,
        epipolar_mode=True, capacity=1024,
    )
    run = build_batched_sparsematch(forest, settings, mesh)

    rng = np.random.default_rng(0)
    b, h, w = n_devices, 64, 128
    lefts = rng.integers(0, 256, (b, h, w)).astype(np.uint8)
    rights = np.roll(lefts, -2, axis=2)
    xs, ys, ds, count = run(lefts, rights)
    count.block_until_ready()
    assert count.shape == (b,)
    assert all(int(c) > 0 for c in np.asarray(count)), "no matches in dryrun"

    # the flagship ROW-FORM contract, sharded over the same mesh (driver
    # exercises the maximum-throughput path multi-device)
    run_rows = build_batched_sparsematch_rows(forest, settings, mesh)
    (rxs, rds), rcounts = run_rows(lefts, rights)
    rcounts.block_until_ready()
    assert rcounts.shape == (b, h)
    total = np.asarray(rcounts).sum(axis=1)
    assert (total == np.asarray(count)).all(), (
        "row-form sharded counts != flat sharded counts"
    )

    # the segmented GLOBAL contract (the reference's default-settings path)
    import dataclasses

    gsettings = dataclasses.replace(settings, epipolar_mode=False)
    run_glob = build_batched_sparsematch_global_rows(forest, gsettings, mesh)
    (_, _, _), gcounts = run_glob(lefts, rights)
    gcounts.block_until_ready()
    assert gcounts.shape[0] == b
    assert (np.asarray(gcounts).sum(axis=1) > 0).all(), (
        "no global-mode matches in dryrun"
    )

    # the chunk-compacted GLOBAL contract (r4: +91% at low density) —
    # per-pair overflow flags; non-overflowing pairs match the full
    # global contract's counts
    run_gcomp = build_batched_sparsematch_global_compact(forest, gsettings,
                                                         mesh)
    (_, _, _), gc_counts, gc_ovf = run_gcomp(lefts, rights)
    gc_counts.block_until_ready()
    assert np.asarray(gc_ovf).shape == (b,)
    for bi in range(b):
        if not bool(np.asarray(gc_ovf)[bi]):
            assert int(np.asarray(gc_counts)[bi].sum()) == int(
                np.asarray(gcounts)[bi].sum()), (
                "global-compact sharded counts != global sharded counts")

    # the MASKED sorted-order contract (the r3 headline path)
    run_masked = build_batched_sparsematch_masked(forest, settings, mesh)
    _, mcounts = run_masked(lefts, rights)
    mcounts.block_until_ready()
    assert (np.asarray(mcounts).sum(axis=1) == np.asarray(count)).all(), (
        "masked sharded counts != flat sharded counts"
    )

    # the CHUNK-COMPACTED masked contract (the r4 low-density fast path) —
    # per-shard overflow flags reduce into one replicated bool
    run_compact = build_batched_sparsematch_masked_compact(forest, settings,
                                                           mesh)
    _, ccounts, covf = run_compact(lefts, rights)
    ccounts.block_until_ready()
    assert np.asarray(covf).shape == (b,)
    for bi in range(b):
        if not bool(np.asarray(covf)[bi]):
            assert int(np.asarray(ccounts)[bi].sum()) == int(
                np.asarray(count)[bi]), (
                "compact sharded counts != flat sharded counts")

    # SINGLE-FRAME row sharding (r4): one pair's rows split over the mesh,
    # 14-row halo exchange via ppermute — must equal the whole-frame result
    fh, fw = 16 * n_devices, 128
    fl = rng.integers(0, 256, (fh, fw)).astype(np.uint8)
    fr = np.roll(fl, -2, axis=1)
    run_frame = build_sharded_frame_sparsematch(forest, settings, mesh)
    fbuf, fcounts = run_frame(fl, fr)
    fcounts.block_until_ready()
    assert fbuf.shape == (fh, 2 * fw) and fcounts.shape == (fh,)
    from opengpc_tpu.infer import build_sparsematch_masked

    wbuf, wcounts = build_sparsematch_masked(forest, settings)(fl, fr)
    assert (np.asarray(fcounts) == np.asarray(wcounts)).all(), (
        "sharded-frame row counts != whole-frame masked counts"
    )
    assert (np.asarray(fbuf) == np.asarray(wbuf)).all(), (
        "sharded-frame masked buffer != whole-frame masked buffer"
    )
    # same single-frame sharding on the chunk-compacted contract
    run_frame_c = build_sharded_frame_sparsematch(
        forest, settings, mesh, contract="masked-compact")
    cfbuf, cfcounts, cfovf = run_frame_c(fl, fr)
    cfcounts.block_until_ready()
    if not bool(np.asarray(cfovf)):
        assert int(np.asarray(cfcounts).sum()) == int(
            np.asarray(wcounts).sum()), (
            "sharded-frame compact counts != whole-frame masked counts")

    # single-frame GLOBAL sharding (r4: distributed bucket sort over one
    # all_to_all) — k=chunk makes the chunk compaction lossless, so the
    # support set must equal the single-device global matcher exactly
    from opengpc_tpu.infer import (build_sparsematch_global_rows,
                                   global_row_supports_to_numpy)

    run_frame_g = build_sharded_frame_sparsematch(
        forest, gsettings, mesh, contract="global-compact", chunk=64, k=64)
    (gx, gy, gd), gfcounts, gfovf = run_frame_g(fl, fr)
    gfcounts.block_until_ready()
    assert not bool(np.asarray(gfovf)), (
        "lossless (k=chunk) sharded global run reported overflow")
    gotg = set(map(tuple, global_row_supports_to_numpy(
        np.asarray(gx), np.asarray(gy), np.asarray(gd),
        np.asarray(gfcounts))))
    (wgx, wgy, wgd), wgcounts = build_sparsematch_global_rows(
        forest, gsettings)(fl, fr)
    wantg = set(map(tuple, global_row_supports_to_numpy(
        np.asarray(wgx), np.asarray(wgy), np.asarray(wgd),
        np.asarray(wgcounts))))
    assert gotg == wantg and len(wantg) > 0, (
        "sharded-frame global support set != single-device global")

    # single-frame PYRAMID sharding (r5): one pair's rows split over the
    # mesh at every pyramid level (per-level halos, chip-local dedup) —
    # support set and per-level counts must equal the single-device
    # pyramid
    from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                     pyramid_supports_to_numpy)

    ph = 32 * n_devices  # coarsest 2-level slab = 16 rows >= the 14 halo
    pl = rng.integers(0, 256, (ph, fw)).astype(np.uint8)
    pr = np.roll(pl, -2, axis=1)
    run_pyr = build_sharded_frame_pyramid(forest, settings, mesh,
                                          num_levels=2)
    pout = run_pyr(pl, pr)
    pout[4].block_until_ready()
    wout = build_pyramid_sparsematch(forest, settings, num_levels=2)(pl, pr)
    assert (np.asarray(pout[4]) == np.asarray(wout[4])).all(), (
        "sharded pyramid per-level counts != single-device pyramid")
    gotp = set(map(tuple, pyramid_supports_to_numpy(*pout).tolist()))
    wantp = set(map(tuple, pyramid_supports_to_numpy(*wout).tolist()))
    assert gotp == wantp and len(wantp) > 0, (
        "sharded pyramid support set != single-device pyramid")

    # 2-D (data, rows) mesh (r4): the batch axis AND each frame's rows
    # sharded together — per-frame results must equal the whole-frame run
    if n_devices >= 4 and n_devices % 2 == 0:
        n_rows2 = n_devices // 2
        mesh2 = make_mesh_2d(2, n_rows2, devices[:n_devices])
        bh2 = 16 * n_rows2
        bl2 = rng.integers(0, 256, (2, bh2, fw)).astype(np.uint8)
        br2 = np.roll(bl2, -2, axis=2)
        run_2d = build_batched_sharded_frame_sparsematch(forest, settings,
                                                         mesh2)
        b2buf, b2counts = run_2d(bl2, br2)
        b2counts.block_until_ready()
        assert b2buf.shape == (2, bh2, 2 * fw)
        whole = build_sparsematch_masked(forest, settings)
        for bi in range(2):
            w2buf, w2counts = whole(bl2[bi], br2[bi])
            assert (np.asarray(b2counts[bi]) == np.asarray(w2counts)).all(), (
                "2-D-mesh sharded counts != whole-frame masked counts")
            assert (np.asarray(b2buf[bi]) == np.asarray(w2buf)).all(), (
                "2-D-mesh sharded buffer != whole-frame masked buffer")

        # 2-D mesh PYRAMID (r5): frames over "data", rows over "rows" at
        # every level — per-frame sets equal the single-device pyramid
        ph2 = 28 * n_rows2  # 2 levels: coarsest slab 14 == the halo min
        pl2 = rng.integers(0, 256, (2, ph2, fw)).astype(np.uint8)
        pr2 = np.roll(pl2, -2, axis=2)
        run_2dp = build_batched_sharded_frame_pyramid(forest, settings,
                                                      mesh2, num_levels=2)
        p2out = run_2dp(pl2, pr2)
        p2out[4].block_until_ready()
        single_pyr = build_pyramid_sparsematch(forest, settings,
                                               num_levels=2)
        for bi in range(2):
            sp = single_pyr(pl2[bi], pr2[bi])
            assert (np.asarray(p2out[4])[bi] == np.asarray(sp[4])).all(), (
                "2-D pyramid counts != single-device pyramid counts")
            g2 = set(map(tuple, pyramid_supports_to_numpy(
                *(np.asarray(o)[bi] for o in p2out)).tolist()))
            w2 = set(map(tuple, pyramid_supports_to_numpy(*sp).tolist()))
            assert g2 == w2, (
                "2-D pyramid support set != single-device pyramid")

    # full training step, triplet axis sharded over the same mesh
    from opengpc_tpu.config import zero_optimizer
    from opengpc_tpu.forest import SCALE_L

    trip_rng = np.random.default_rng(1)
    ref = trip_rng.integers(0, 256, (8 * n_devices, 729)).astype(np.int16)
    pos = np.clip(ref + trip_rng.integers(-6, 7, ref.shape), 0, 255)
    neg = trip_rng.integers(0, 256, ref.shape)
    triplets = np.stack([ref, pos, neg], axis=1).astype(np.uint8)
    fern, stats = sharded_train_fern(
        triplets, SCALE_L, zero_optimizer(num_resamples=2), 2, mesh
    )
    assert len(fern.tests) == 2

"""Sparse-matching inference pipeline.

The on-device equivalent of the reference inference layer
(/root/reference/lib/gpc/inference.hpp:184-393):

    preprocess (box + sobel + margin mask)
      -> dense leaf codes (forest baked in as static offsets)
      -> on-device unique-collision matcher
      -> fixed-capacity support buffer (x, y, d) + count

Everything from raw uint8 images to supports is one jitted function with
static shapes; multi-pair batching folds the batch into the row-form
matcher's segmented sort where eligible (one (B*H, 2W) sort — the analog
of the reference's parFor row partitioning, filter.hpp:128-145) and falls
back to ``jax.lax.map`` on the flat contract; multi-device scale-out shards
the batch axis (opengpc_tpu.parallel).
"""

from __future__ import annotations

import collections
import functools
import os
import threading
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.forest import FilterMask, Forest, make_filter_mask
from opengpc_tpu.match import match_epipolar, match_global
from opengpc_tpu.ops.codes import leaf_codes
from opengpc_tpu.ops.preprocess import (CANDIDATE_MARGIN, box3, sobel3,
                                         candidate_mask,
                                         require_u8 as _require_u8)


# the dtype guard lives in ops/preprocess.require_u8 (imported above as
# _require_u8) so the slab key image can share it without importing infer


def preprocess(img: jnp.ndarray, gradient_threshold: int):
    """Smooth + candidate mask for one uint8 image (inference.hpp:302-333).

    Sobel runs on the *raw* image, codes on the *smoothed* one, exactly
    like the reference (inference.hpp:308-313 vs 276-280).
    """
    _require_u8(img)
    smooth = box3(img)
    grad = sobel3(img, gradient_threshold)
    return smooth, candidate_mask(grad)


def _codes_and_candidates(img, mask: FilterMask, settings: InferenceSettings):
    smooth, cand = preprocess(img, settings.gradient_threshold)
    return leaf_codes(smooth, mask), cand


def _packed_ok(mask: FilterMask, shape) -> bool:
    """Sentinel-packed sorting needs codes < 2^30 (<= 30 tests) and all
    descriptor positions below the sentinel base."""
    h, w = shape
    return mask.num_tests <= 30 and 2 * h * w < (1 << 30)


# Key-image rows inside the candidate margin (the reference filters
# candidates to y, x in [13, dim-13), inference.hpp:318-325) carry only
# unique sentinel keys and can never produce a collision, so the matcher
# sorts run on the interior rows only — exact (pinned by the
# contract-equality tests).
_MARGIN = CANDIDATE_MARGIN


def _interior_rows(key):
    """Slice a (..., H, 2W) key image to its candidate rows [13, H-13).
    Returns (sliced, margin); margin is 0 when H is too small to slice."""
    h = key.shape[-2]
    if h > 2 * _MARGIN + 1:
        return key[..., _MARGIN:h - _MARGIN, :], _MARGIN
    return key, 0


def _pad_rows(arr, m, axis, value=0):
    """Undo an interior-row slice: pad ``m`` rows of ``value`` back on both
    sides of ``axis`` (no-op for m=0)."""
    if not m:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (m, m)
    return jnp.pad(arr, pad, constant_values=value)


def _rows_ok(mask: FilterMask, shape, settings: InferenceSettings) -> bool:
    """Full row-form eligibility: epipolar mode, sentinel-packable codes,
    AND the (x, d) row-pack key fitting 30 bits (match._row_pack) — a very
    wide image combined with a huge disp_high overflows the packed key, in
    which case callers must ride the flat pipeline (whose compaction has a
    generic >30-bit fallback)."""
    h, w = shape
    bx = max(1, int(w - 1).bit_length())
    bd = max(1, int(2 * settings.disp_high).bit_length())
    return (
        settings.epipolar_mode
        and _packed_ok(mask, shape)
        and bx + bd <= 30
    )


def _sparsematch_impl(left, right, mask: FilterMask,
                      settings: InferenceSettings):
    codes_l, cand_l = _codes_and_candidates(left, mask, settings)
    codes_r, cand_r = _codes_and_candidates(right, mask, settings)
    if settings.epipolar_mode:
        (xs, ys, ds), count = match_epipolar(
            codes_l, codes_r, cand_l, cand_r, settings.disp_high,
            settings.capacity, packed=_packed_ok(mask, left.shape),
            num_tests=mask.num_tests,
        )
    else:
        (xs, ys, ds), count = match_global(
            codes_l,
            codes_r,
            cand_l,
            cand_r,
            settings.disp_high,
            settings.vertical_tolerance,
            settings.capacity,
            packed=_packed_ok(mask, left.shape),
        )
    return xs, ys, ds, count


def build_sparsematch(
    forest_or_mask, settings: InferenceSettings
) -> Callable[[jnp.ndarray, jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """Build a jitted ``(left, right) -> (x, y, d, count)`` matcher.

    The forest is baked into the computation as static constants (the
    analog of readForest producing a width-specific FilterMask,
    inference.hpp:404-446 — but width-independent here).  Works on single
    images (H, W) and on batches (B, H, W) (sequential lax.map — see run()).
    """
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    fn = functools.partial(
        _sparsematch_impl, mask=mask, settings=settings
    )

    @jax.jit
    def run(left: jnp.ndarray, right: jnp.ndarray):
        if left.ndim == 3:
            # lax.map, not vmap: vmap turns the flat compaction sort into
            # one (B, 893k) batched-row sort; B independent sorts were
            # faster where this was last measured (not yet re-measured on
            # the GPU).  Outputs are identical.
            return jax.lax.map(lambda ab: fn(*ab), (left, right))
        return fn(left, right)

    return run


def _sparsematch_rows_impl(left, right, mask: FilterMask,
                           settings: InferenceSettings):
    """Row-form pipeline: ((xs, ds) (H, W) each, row_counts (H,))."""
    from opengpc_tpu.match import match_epipolar_rows

    if not settings.epipolar_mode:
        raise ValueError("row-form output is epipolar-only")
    if not _packed_ok(mask, left.shape):
        raise ValueError("row-form output needs <=30-test forests")
    if not _rows_ok(mask, left.shape, settings):
        raise ValueError(
            "row-form output needs the (x, d) pack key to fit 30 bits "
            f"(width {left.shape[1]} with disp_high {settings.disp_high} "
            "does not); use build_sparsematch"
        )
    key, m = _interior_rows(_key_image_jnp(left, right, mask, settings))
    (xs, ds), counts = match_epipolar_rows(None, None, None, None,
                                           settings.disp_high, key=key,
                                           num_tests=mask.num_tests)
    return ((_pad_rows(xs, m, -2), _pad_rows(ds, m, -2)),
            _pad_rows(counts, m, -1))


def _key_image_jnp(left, right, mask: FilterMask, settings: InferenceSettings):
    """(H, 2W) sentinel-packed matcher key image — the one key-image
    builder every sorted-contract impl shares (vmap-friendly: pure
    pad/slice/where chains that XLA fuses into a few loop fusions)."""
    from opengpc_tpu.match import SENTINEL_BASE

    codes_l, cand_l = _codes_and_candidates(left, mask, settings)
    codes_r, cand_r = _codes_and_candidates(right, mask, settings)
    h, w = left.shape
    code = jnp.concatenate([codes_l, codes_r], axis=1)
    valid = jnp.concatenate([cand_l, cand_r], axis=1)
    pos = jnp.broadcast_to(jnp.arange(2 * w, dtype=jnp.int32)[None, :],
                           (h, 2 * w))
    return jnp.where(valid, code, SENTINEL_BASE + pos)


def _key_image_jnp_slab(slab_l, slab_r, mask: FilterMask,
                        settings: InferenceSettings, y0, h_total: int):
    """(sh, 2W) sentinel-packed key image for one ROW SLAB of a larger
    frame (ops/codes.tile_codes_and_cand called with the slab as one big
    "tile").

    ``slab_*``: (sh + 2*PAD, W) with PAD rows of halo context on both
    sides (zeros outside the image); ``y0`` (traced ok) is the global row
    of the slab's first output row, ``h_total`` the full-image height.
    Bit-equal to rows [y0, y0+sh) of _key_image_jnp on the full frame."""
    from opengpc_tpu.match import SENTINEL_BASE
    from opengpc_tpu.ops.codes import PAD, mask_tests, tile_codes_and_cand

    _require_u8(slab_l)
    _require_u8(slab_r)
    sh = slab_l.shape[0] - 2 * PAD
    w = slab_l.shape[1]
    tests = mask_tests(mask)
    thr2 = int(settings.gradient_threshold) ** 2

    def one(slab, pos_base):
        x32 = jnp.pad(slab.astype(jnp.int32), ((0, 0), (PAD, PAD)))
        code, cand = tile_codes_and_cand(x32, y0, h_total, w, sh, tests, thr2)
        xx = jnp.arange(w, dtype=jnp.int32)[None, :]
        return jnp.where(cand, code, SENTINEL_BASE + pos_base + xx)

    return jnp.concatenate([one(slab_l, 0), one(slab_r, w)], axis=1)


def _batched_key_images(lefts, rights, mask: FilterMask,
                        settings: InferenceSettings):
    """(B, H, 2W) sentinel-packed key images for a batch of pairs (vmap'd
    _key_image_jnp).  Shared by the stacked row-form and masked batched
    pipelines."""
    return jax.vmap(
        lambda l, r: _key_image_jnp(l, r, mask, settings)
    )(lefts, rights)


def _sparsematch_rows_batched_impl(lefts, rights, mask: FilterMask,
                                   settings: InferenceSettings):
    """Batched row-form pipeline that AGGREGATES: per-pair key images are
    stacked into one (B*H, 2W) image and matched with ONE segmented row
    sort + row pack, instead of lax.map over B sequential pipelines.

    Rows are independent in the epipolar matcher, so stacking the batch
    into the row axis is exact (per-row results identical to per-pair
    runs); the key images themselves are computed per pair (the
    preprocessing windows must not cross pair boundaries).  The reference
    analog is parFor row partitioning (filter.hpp:128-145) — here the
    "partitioning" is just a reshape and the device sees B*H rows of sort
    work at once.
    """
    from opengpc_tpu.match import match_epipolar_rows

    b, h, w = lefts.shape
    if not settings.epipolar_mode:
        raise ValueError("row-form output is epipolar-only")
    if not _rows_ok(mask, (h, w), settings):
        raise ValueError(
            "row-form output needs <=30-test forests and a packable "
            "(x, d) key; use build_sparsematch"
        )
    keys = _batched_key_images(lefts, rights, mask, settings)
    keys, m = _interior_rows(keys)
    hs = h - 2 * m
    (xs, ds), counts = match_epipolar_rows(
        None, None, None, None, settings.disp_high,
        key=keys.reshape(b * hs, 2 * w), num_tests=mask.num_tests
    )
    return ((_pad_rows(xs.reshape(b, hs, w), m, -2),
             _pad_rows(ds.reshape(b, hs, w), m, -2)),
            _pad_rows(counts.reshape(b, hs), m, -1))


def build_sparsematch_rows(
    forest_or_mask, settings: InferenceSettings,
) -> Callable:
    """Jitted ``(left, right) -> ((xs, ds), row_counts)`` ROW-FORM matcher
    — the maximum-throughput output contract.

    Instead of one flat fixed-capacity support buffer, supports stay in
    per-row left-packed (H, W) buffers with a per-row count: row y emits
    (xs[y, :c], y, ds[y, :c]).  This skips the flat compaction sort — the
    single costliest stage of the flat pipeline — and transfers less.
    Convert with :func:`row_supports_to_numpy`; the resulting (n, 3) array
    equals build_sparsematch's output SET exactly, in row-major x-ascending
    order (which also matches the flat pipeline's order whenever that
    pipeline uses its packed compaction, i.e. coordinates fit 30 bits; the
    flat >30-bit generic fallback emits flat-mask order instead).  Epipolar
    mode with <=30-test forests only.
    """
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    fn = functools.partial(
        _sparsematch_rows_impl, mask=mask, settings=settings,
    )
    fnb = functools.partial(
        _sparsematch_rows_batched_impl, mask=mask, settings=settings,
    )

    @jax.jit
    def run(left, right):
        if left.ndim == 3:
            # stacked batch: ONE (B*H, 2W) segmented sort aggregates the
            # whole batch (vs lax.map's B sequential pipelines)
            return fnb(left, right)
        return fn(left, right)

    return run


def _sparsematch_masked_impl(left, right, mask: FilterMask,
                             settings: InferenceSettings):
    """Masked sorted-order pipeline: (buf (H, 2W) int32, row_counts (H,))
    — see match.match_epipolar_masked.  Accepts (B, H, W) batches by
    folding them into the row axis like the row-form batched path."""
    from opengpc_tpu.match import match_epipolar_masked

    batched = left.ndim == 3
    shape = left.shape[-2:]
    if not settings.epipolar_mode:
        raise ValueError("masked output is epipolar-only")
    if not _rows_ok(mask, shape, settings):
        raise ValueError(
            "masked output needs <=30-test forests and a packable (x, d) "
            "key; use build_sparsematch"
        )
    from opengpc_tpu.match import MASKED_SENTINEL

    if batched:
        b, h, w = left.shape
        keys = _batched_key_images(left, right, mask, settings)
        keys, m = _interior_rows(keys)
        hs = h - 2 * m
        buf, counts = match_epipolar_masked(
            None, None, None, None, settings.disp_high,
            key=keys.reshape(b * hs, 2 * w), num_tests=mask.num_tests,
        )
        return (_pad_rows(buf.reshape(b, hs, 2 * w), m, -2,
                          value=MASKED_SENTINEL),
                _pad_rows(counts.reshape(b, hs), m, -1))
    key, m = _interior_rows(_key_image_jnp(left, right, mask, settings))
    buf, counts = match_epipolar_masked(None, None, None, None,
                                        settings.disp_high, key=key,
                                        num_tests=mask.num_tests)
    return (_pad_rows(buf, m, -2, value=MASKED_SENTINEL),
            _pad_rows(counts, m, -1))


def build_sparsematch_masked(
    forest_or_mask, settings: InferenceSettings,
) -> Callable:
    """Jitted ``(left, right) -> (buf, row_counts)`` MASKED sorted-order
    epipolar matcher — the minimum-device-work contract (the row-form
    contract without its packing sort; the per-row left-packing moves
    to the consumer).  ``buf`` is (H, 2W) int32 with
    ``(x << bd) | (d + disp_high)`` at detected supports and
    match.MASKED_SENTINEL elsewhere; decode with
    :func:`masked_supports_to_numpy`.  Same support SET as every other
    contract.  Batches fold into the row axis like build_sparsematch_rows.
    """
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    fn = functools.partial(
        _sparsematch_masked_impl, mask=mask, settings=settings,
    )
    return jax.jit(fn)


def _sparsematch_masked_compact_impl(left, right, mask: FilterMask,
                                     settings: InferenceSettings,
                                     chunk: int, k: int):
    """Chunk-compacted masked pipeline: (buf (H, C) int32, row_counts (H,),
    overflow bool[]) — see match.match_epipolar_masked_compact.  Batches
    fold into the row axis like the masked pipeline."""
    from opengpc_tpu.match import (MASKED_SENTINEL,
                                   match_epipolar_masked_compact)

    batched = left.ndim == 3
    shape = left.shape[-2:]
    if not settings.epipolar_mode:
        raise ValueError("masked output is epipolar-only")
    if not _rows_ok(mask, shape, settings):
        raise ValueError(
            "masked output needs <=30-test forests and a packable (x, d) "
            "key; use build_sparsematch"
        )
    if batched:
        b, h, w = left.shape
        keys = _batched_key_images(left, right, mask, settings)
        keys, m = _interior_rows(keys)
        hs = h - 2 * m
        buf, counts, ovf = match_epipolar_masked_compact(
            keys.reshape(b * hs, 2 * w), settings.disp_high, chunk, k,
            num_tests=mask.num_tests)
        return (_pad_rows(buf.reshape(b, hs, buf.shape[1]), m, -2,
                          value=MASKED_SENTINEL),
                _pad_rows(counts.reshape(b, hs), m, -1), ovf)
    key, m = _interior_rows(_key_image_jnp(left, right, mask, settings))
    buf, counts, ovf = match_epipolar_masked_compact(
        key, settings.disp_high, chunk, k, num_tests=mask.num_tests)
    return (_pad_rows(buf, m, -2, value=MASKED_SENTINEL),
            _pad_rows(counts, m, -1), ovf)


def build_sparsematch_masked_compact(
    forest_or_mask, settings: InferenceSettings, chunk: Optional[int] = None,
    k: Optional[int] = None,
) -> Callable:
    """Jitted ``(left, right) -> (buf, row_counts, overflow)`` LOW-DENSITY
    masked matcher: strided chunked pre-compaction shrinks the matcher
    sort at realistic (~15%) candidate density.  EXACT same support
    set as build_sparsematch_masked whenever ``overflow`` is False; when
    True (a chunk exceeded ``k`` candidates — dense frames) the result is
    incomplete and the caller must re-run the full-width masked matcher.
    ``buf`` is narrower ((H, 2W/chunk*k)) but decodes with
    :func:`masked_supports_to_numpy` unchanged."""
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    fn = functools.partial(
        _sparsematch_masked_compact_impl, mask=mask, settings=settings,
        chunk=chunk, k=k,
    )
    return jax.jit(fn)


def masked_supports_to_numpy(buf, row_counts, disp_high: int) -> np.ndarray:
    """Decode one pair's masked sorted-order buffer into the (n, 3) int
    (x, y, d) support array (row-major; code-sorted within each row —
    the same SET as the other contracts).

    The scan rides the native helper (cpp/decode.cc, ~1 ms at Sintel
    scale) when built, else a flat-nonzero numpy pass (~5 ms; both
    measured — the 2-D nonzero formulation costs ~12 ms)."""
    from opengpc_tpu.io.png import masked_decode_native
    from opengpc_tpu.match import MASKED_SENTINEL

    if np.ndim(buf) != 2:
        raise ValueError(
            "masked_supports_to_numpy takes one pair's (H, 2W) buffer; "
            "index the batch axis first"
        )
    buf = np.asarray(buf)
    row_counts = np.asarray(row_counts)
    n = int(row_counts.sum())
    out = masked_decode_native(buf, n, disp_high, MASKED_SENTINEL,
                               row_counts=row_counts)
    if out is not None:
        return out
    bd = max(1, int(2 * disp_high).bit_length())
    flat = buf.ravel()
    pos = np.flatnonzero(flat != MASKED_SENTINEL)
    v = flat[pos]
    out = np.empty((len(pos), 3), np.int32)
    out[:, 0] = v >> bd
    out[:, 1] = (pos // buf.shape[1]).astype(np.int32)
    out[:, 2] = (v & ((1 << bd) - 1)) - disp_high
    if out.shape[0] != n:  # same error contract as the native path
        raise ValueError(
            f"masked buffer holds {out.shape[0]} supports, row counts "
            f"say {n}"
        )
    return out


def _global_rows_ok(mask: FilterMask, shape, settings: InferenceSettings) -> bool:
    """Eligibility for the segmented global row-form contract: packable
    codes plus the (y, x, d) pack key fitting 30 bits."""
    h, w = shape
    bx = max(1, int(w - 1).bit_length())
    by = max(1, int(h - 1).bit_length())
    bd = max(1, int(2 * settings.disp_high).bit_length())
    return _packed_ok(mask, shape) and by + bx + bd <= 30


def _sparsematch_global_rows_impl(left, right, mask: FilterMask,
                                  settings: InferenceSettings):
    """Global-mode segmented row-form pipeline:
    ((xs, ys, ds) (R, C) each, counts (R,)) — see match.match_global_rows."""
    from opengpc_tpu.match import match_global_rows

    if settings.epipolar_mode:
        raise ValueError("global row-form output is for global mode; use "
                         "build_sparsematch_rows for epipolar")
    if not _global_rows_ok(mask, left.shape, settings):
        raise ValueError(
            "global row-form needs <=30-test forests and packable (y, x, d) "
            "keys; use build_sparsematch"
        )
    key, m = _interior_rows(_key_image_jnp(left, right, mask, settings))
    return match_global_rows(key, left.shape[1], settings.disp_high,
                             settings.vertical_tolerance, y_offset=m)


def build_sparsematch_global_rows(
    forest_or_mask, settings: InferenceSettings,
) -> Callable:
    """Jitted ``(left, right) -> ((xs, ys, ds), counts)`` GLOBAL-mode
    matcher with segmented row-form output — the maximum-throughput
    contract for the reference's default (non-epipolar) settings
    (inference.hpp:75): same support set as build_sparsematch with
    ``epipolar_mode=False``, but the flat compaction sort is replaced by a
    cheap segmented pack (match.match_global_rows).  Supports arrive
    grouped into R code-sorted segments; assemble with
    :func:`global_row_supports_to_numpy`.  Batched via lax.map.
    """
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    fn = functools.partial(
        _sparsematch_global_rows_impl, mask=mask, settings=settings,
    )

    @jax.jit
    def run(left, right):
        if left.ndim == 3:
            return jax.lax.map(lambda ab: fn(*ab), (left, right))
        return fn(left, right)

    return run


def _sparsematch_global_compact_impl(left, right, mask: FilterMask,
                                     settings: InferenceSettings,
                                     chunk: int, k: int):
    """Chunk-compacted global pipeline: ((xs, ys, ds), counts, overflow)
    — see match.match_global_rows_compact."""
    from opengpc_tpu.match import match_global_rows_compact

    if settings.epipolar_mode:
        raise ValueError("global compact output is for global mode; use "
                         "build_sparsematch_masked_compact for epipolar")
    if not _global_rows_ok(mask, left.shape, settings):
        raise ValueError(
            "global compact needs <=30-test forests and packable (y, x, d) "
            "keys; use build_sparsematch"
        )
    key, m = _interior_rows(_key_image_jnp(left, right, mask, settings))
    return match_global_rows_compact(
        key, left.shape[1], settings.disp_high,
        settings.vertical_tolerance, chunk=chunk, k=k, y_offset=m)


def build_sparsematch_global_compact(
    forest_or_mask, settings: InferenceSettings, chunk: Optional[int] = None,
    k: Optional[int] = None,
) -> Callable:
    """Jitted ``(left, right) -> ((xs, ys, ds), counts, overflow)``
    LOW-DENSITY global matcher: strided chunked pre-compaction shrinks the
    flat global uniqueness sort from 2HW to 2HW*(K/S) elements.  EXACT
    same support set as build_sparsematch_global_rows whenever
    ``overflow`` is False; when True (a chunk exceeded ``k`` candidates —
    dense frames) the result is incomplete and the caller must re-run the
    full-width global matcher.  Segments are narrower but decode with
    :func:`global_row_supports_to_numpy` unchanged.  Batched via lax.map
    (per-pair overflow flags; one vmap'd batched global sort instead of B
    per-pair sorts is not yet measured on the GPU).  ``chunk``/``k``
    default by row width (match.global_compact_chunks): K/S=1/4 on wide rows,
    the masked-compact K/S=1/2 rule on narrow ones."""
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    fn = functools.partial(
        _sparsematch_global_compact_impl, mask=mask, settings=settings,
        chunk=chunk, k=k,
    )

    @jax.jit
    def run(left, right):
        if left.ndim == 3:
            return jax.lax.map(lambda ab: fn(*ab), (left, right))
        return fn(left, right)

    return run


def global_row_supports_to_numpy(xs, ys, ds, counts) -> np.ndarray:
    """Assemble global segmented row-form outputs into an (n, 3) int
    (x, y, d) array — same support set as the flat global pipeline, in
    packed (y, x, d)-ascending order."""
    if np.ndim(xs) != 2:
        raise ValueError(
            "global_row_supports_to_numpy takes one pair's (R, C) buffers; "
            "index the batch axis first"
        )
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    ds = np.asarray(ds)
    c = np.asarray(counts)
    sel = np.arange(xs.shape[1])[None, :] < c[:, None]
    out = np.stack([xs[sel], ys[sel], ds[sel]], axis=1).astype(np.int32)
    return out[np.lexsort((out[:, 2], out[:, 0], out[:, 1]))]


def row_supports_to_numpy(xs_rows, ds_rows, row_counts) -> np.ndarray:
    """Assemble row-form outputs into the (n, 3) int (x, y, d) array —
    identical content/order to the flat pipeline's supports_to_numpy."""
    if np.ndim(xs_rows) != 2:
        raise ValueError(
            "row_supports_to_numpy takes one pair's (H, W) buffers; index "
            "the batch axis first (e.g. row_supports_to_numpy(xs[i], "
            "ds[i], counts[i]))"
        )
    xs = np.asarray(xs_rows)
    ds = np.asarray(ds_rows)
    c = np.asarray(row_counts)
    sel = np.arange(xs.shape[1])[None, :] < c[:, None]
    ys = np.broadcast_to(
        np.arange(xs.shape[0], dtype=np.int32)[:, None], xs.shape
    )
    return np.stack([xs[sel], ys[sel], ds[sel]], axis=1).astype(np.int32)


def build_stereomatch(
    forest_or_mask, settings: InferenceSettings
) -> Callable:
    """Jitted ``(left, right) -> (sx, sy, tx, ty, count)`` correspondence
    matcher — the reference's stereoMatch surface (inference.hpp:344-361):
    global unique-collision correspondences with *no* epipolar/disparity
    filtering.  Batched via lax.map like build_sparsematch."""
    from opengpc_tpu.match import match_correspondences

    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )

    def fn(left, right):
        codes_l, cand_l = _codes_and_candidates(left, mask, settings)
        codes_r, cand_r = _codes_and_candidates(right, mask, settings)
        (sx, sy, tx, ty), count = match_correspondences(
            codes_l, codes_r, cand_l, cand_r, settings.capacity,
            packed=_packed_ok(mask, left.shape),
        )
        return sx, sy, tx, ty, count

    @jax.jit
    def run(left, right):
        if left.ndim == 3:
            return jax.lax.map(lambda ab: fn(*ab), (left, right))
        return fn(left, right)

    return run


class _LruCache:
    """Thread-safe bounded LRU for the per-frame convenience surfaces
    (sparsematch / extract_descriptors): serving loops call these from
    worker threads, and a bare OrderedDict's move_to_end/popitem from
    two threads corrupts it.  ``make`` runs OUTSIDE the lock (jit
    wrapping / a forest text parse shouldn't serialize unrelated
    callers); a lost race discards the duplicate and returns the
    first-written value, so concurrent callers of a live key share one
    fn.  (If the first-written entry is EVICTED between a loser's
    make() and its re-check, that caller inserts and returns its own
    duplicate — correct but a redundant build; only sustained churn of
    >max_entries distinct keys can hit this.)"""

    def __init__(self, max_entries: int):
        self._d = collections.OrderedDict()
        self._max = max_entries
        self._lock = threading.Lock()

    def get_or_add(self, key, make):
        with self._lock:
            val = self._d.get(key)
            if val is not None:
                self._d.move_to_end(key)
                return val
        val = make()
        with self._lock:
            cur = self._d.get(key)
            if cur is not None:
                self._d.move_to_end(key)
                return cur
            self._d[key] = val
            if len(self._d) > self._max:
                self._d.popitem(last=False)
            return val

    # the introspection surface the tests use (route asserts, cache-size
    # no-retrace checks): len / iteration over keys / membership
    def __len__(self):
        with self._lock:
            return len(self._d)

    def __iter__(self):
        with self._lock:
            return iter(list(self._d))

    def __contains__(self, key):
        with self._lock:
            return key in self._d

    def discard(self, key):
        with self._lock:
            self._d.pop(key, None)


_CODES_FN_CACHE = _LruCache(32)  # forests/thresholds cycled in one process


def _cached_codes_fn(mask: FilterMask, settings: InferenceSettings):
    """Memoize the jitted codes+candidates function so repeated
    extract_descriptors calls (e.g. per frame of a sequence) don't retrace.

    Keyed only on what code extraction reads (mask + gradient threshold)
    — other settings fields don't force a recompile.
    LRU-bounded so long-running processes that cycle through many forests
    don't grow without bound (jitted fns pin their compiled executables)."""
    key = (
        tuple(map(tuple, np.asarray(mask.i_off))),
        tuple(map(tuple, np.asarray(mask.j_off))),
        tuple(np.asarray(mask.tau)),
        mask.type, settings.gradient_threshold,
    )
    return _CODES_FN_CACHE.get_or_add(key, lambda: jax.jit(
        functools.partial(_codes_and_candidates, mask=mask,
                          settings=settings)))


def extract_descriptors(
    img: jnp.ndarray,
    forest_or_mask,
    settings: InferenceSettings,
) -> np.ndarray:
    """Per-image descriptor list — the evalFastMaskOnSubsetSSE surface
    (inference.hpp:266-292): an (n, 3) int array of (x, y, state) rows for
    every candidate pixel, in row-major scan order.  Host-side trim of the
    dense device outputs (states as unsigned 32-bit values)."""
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    codes, cand = _cached_codes_fn(mask, settings)(img)
    cand = np.asarray(cand)
    ys, xs = np.nonzero(cand)
    states = np.asarray(codes).astype(np.uint32)[ys, xs]
    return np.stack([xs, ys, states.astype(np.int64)], axis=1)


def supports_to_numpy(xs, ys, ds, count) -> np.ndarray:
    """Trim a fixed-capacity support buffer to an (n, 3) int array of
    (x, y, d) rows.  Overflow beyond capacity is dropped with a warning
    count available to the caller via ``count``."""
    if np.ndim(xs) != 1:
        raise ValueError(
            "supports_to_numpy takes one pair's buffers; index the batch "
            "axis first (e.g. supports_to_numpy(xs[i], ys[i], ds[i], count[i]))"
        )
    n = min(int(count), xs.shape[0])
    out = np.stack(
        [np.asarray(xs)[:n], np.asarray(ys)[:n], np.asarray(ds)[:n]], axis=1
    ).astype(np.int32)
    return out


_MATCH_FN_CACHE = _LruCache(16)  # same rationale as _CODES_FN_CACHE

_FOREST_CACHE = _LruCache(8)


def _load_forest_cached(path: str) -> Forest:
    """load_forest keyed by (realpath, mtime, size): per-frame
    sparsematch(path) calls skip the text re-parse, an edited/replaced
    file is picked up on the next call.

    The key is re-stat'ed AFTER the parse and the call retried if it
    changed: stat-then-parse alone is a TOCTOU — a concurrent swap
    between the stat and the read would cache the NEW content under the
    OLD (mtime, size) key, and a later restore of the original file
    (mtime preserved: mv/rsync -a/copystat) would then silently serve
    the wrong forest forever."""
    from opengpc_tpu.forest import load_forest

    real = os.path.realpath(path)
    for _ in range(8):
        st = os.stat(real)
        key = (real, st.st_mtime_ns, st.st_size)
        forest = _FOREST_CACHE.get_or_add(key, lambda: load_forest(real))
        st2 = os.stat(real)
        if (st2.st_mtime_ns, st2.st_size) == (st.st_mtime_ns, st.st_size):
            return forest
        # the cached entry may hold post-swap content under the pre-swap
        # key — drop it so a later restore of the original file can't be
        # served the wrong forest
        _FOREST_CACHE.discard(key)
    # the file keeps changing under us; serve the freshest parse uncached
    return load_forest(real)


def _mask_cache_key(mask: FilterMask):
    return (
        tuple(map(tuple, np.asarray(mask.i_off))),
        tuple(map(tuple, np.asarray(mask.j_off))),
        tuple(np.asarray(mask.tau)),
        mask.type,
    )


def _image_arg(x) -> np.ndarray:
    """Resolve one sparsematch image argument: a PNG path decodes via
    io.read_gray, a list/tuple of paths/arrays stacks into a (B, H, W)
    batch (every frame must share one shape), arrays pass through."""
    if isinstance(x, (str, os.PathLike)):
        from opengpc_tpu.io import read_gray
        return read_gray(os.fspath(x))
    if isinstance(x, (list, tuple)):
        if not x:
            raise ValueError(
                "sparsematch got an empty batch list (e.g. a glob that "
                "matched no files)")
        if (len(x) >= 4
                and all(isinstance(f, (str, os.PathLike)) for f in x)):
            # pool decode amortizes over the batch; below 4 files the
            # spawn costs more than the ~1.3 ms native decodes it
            # overlaps (a host measurement)
            from opengpc_tpu.io import read_gray_batch
            frames = read_gray_batch([os.fspath(f) for f in x])
        else:
            frames = [_image_arg(f) for f in x]
        shapes = {f.shape for f in frames}
        if len(shapes) != 1:
            raise ValueError(
                f"batch frames have differing shapes: {sorted(shapes)}; "
                "sparsematch batches one resolution per call")
        return np.stack(frames)
    return np.asarray(x)


def sparsematch(left, right, forest_or_mask,
                settings: Optional[InferenceSettings] = None,
                levels: int = 1):
    """One-call sparse match: a rectified (H, W) uint8 pair -> the
    (n, 3) int32 (x, y, d) support array, d = x_src - x_tar.

    ``left``/``right`` may also be PNG file paths (read via
    ``opengpc_tpu.io.read_gray`` — 8/16-bit, palette, RGB collapse) and
    ``forest_or_mask`` a forest text-file path (parsed once and cached
    by (realpath, mtime, size), so per-frame calls don't re-read it):

    >>> supports = sparsematch("left.png", "right.png", "forest.txt")

    Batches are one call too: (B, H, W) uint8 stacks — or lists of
    paths/arrays, stacked for you — return a length-B list of per-pair
    support arrays, dispatched through the batched builders (the masked
    route folds the whole batch into one (B*H, 2W) segmented sort; see
    ``_sparsematch_rows_batched_impl``) with ONE device round-trip for
    the batch instead of B:

    >>> per_pair = sparsematch(["l0.png", "l1.png"],
    ...                        ["r0.png", "r1.png"], "forest.txt")

    The "just give me matches" entry point — the analog of the
    reference's preprocess + match call pair
    (/root/reference/lib/gpc/inference.hpp:302-393, driven by
    samples/sparsematch.cpp:42-55).  Picks the fastest EXACT contract the
    settings allow — the masked sorted-order matcher in epipolar mode,
    the segmented global matcher otherwise, the flat fixed-capacity
    pipeline when the packed-key eligibility rules exclude both — and
    decodes on the host.  Same support set whichever route runs (the
    parity contract every builder shares).  Jitted builders are cached
    per (forest, settings, contract) with the same LRU discipline as
    extract_descriptors, so calling this per frame does not retrace.

    ``levels > 1`` runs the coarse-to-fine pyramid instead (the CLI's
    ``--pyramid N``): supports from every scale, finest-level-wins dedup,
    returned as an (n, 4) int32 (x, y, d, level) array in level-0
    coordinates.  Lossless on every route: packed-key-eligible settings
    ride the rows pyramid (capacity-independent, see
    ``pyramid.build_pyramid_sparsematch``), and the fallback (global
    mode / unpackable keys) gets its per-level buffers sized to the
    one-support-per-source-pixel bound so ``settings.capacity`` can
    never silently truncate it.

    For serving loops that want device-resident outputs, batching,
    sharding, density-adaptive compact contracts, or AOT artifacts, use
    the ``build_sparsematch_*`` builders / ``opengpc_tpu.aot`` directly.
    """
    settings = settings if settings is not None else InferenceSettings()
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    if isinstance(forest_or_mask, (str, os.PathLike)):
        forest_or_mask = _load_forest_cached(os.fspath(forest_or_mask))
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    left = _image_arg(left)
    right = _image_arg(right)
    # same guard as every builder's preprocessing entry, raised here
    # before any tracing so the error points at the user's arrays
    _require_u8(left)
    _require_u8(right)
    if left.shape != right.shape:
        raise ValueError(
            f"image shapes differ: {left.shape} vs {right.shape}")
    if left.ndim not in (2, 3):
        raise ValueError(
            f"sparsematch takes one (H, W) pair or a (B, H, W) batch, "
            f"got shape {left.shape}")
    batched = left.ndim == 3
    frame_shape = left.shape[-2:]
    if levels > 1:
        # both pyramid routes are lossless: rows when eligible, and the
        # flat fallback sizes each level's buffer at the
        # one-support-per-source-pixel bound (pyramid._pyramid_impl)
        contract = f"pyramid-{levels}"
    elif settings.epipolar_mode and _rows_ok(mask, frame_shape, settings):
        contract = "masked"
    elif (not settings.epipolar_mode
          and _global_rows_ok(mask, frame_shape, settings)):
        contract = "global-rows"
    else:
        contract = "flat"
    key = (_mask_cache_key(mask), settings, contract)

    def _build():
        if levels > 1:
            # lazy import: pyramid.py imports infer.py at module scope
            from opengpc_tpu.pyramid import build_pyramid_sparsematch
            return build_pyramid_sparsematch(
                mask, settings, num_levels=levels)
        build = {"masked": build_sparsematch_masked,
                 "global-rows": build_sparsematch_global_rows,
                 "flat": build_sparsematch}[contract]
        return build(mask, settings)

    fn = _MATCH_FN_CACHE.get_or_add(key, _build)
    # one host fetch per output leaf, not per pair: batched decode slices
    # numpy views of whole buffers
    out = jax.tree_util.tree_map(np.asarray, fn(left, right))
    if levels > 1:
        from opengpc_tpu.pyramid import pyramid_supports_to_numpy
        if batched:
            xs, ys, ds, lv, counts = out
            return [pyramid_supports_to_numpy(xs[i], ys[i], ds[i], lv[i],
                                              counts[i])
                    for i in range(left.shape[0])]
        return pyramid_supports_to_numpy(*out)
    if contract == "masked":
        buf, rc = out
        if batched:
            return [masked_supports_to_numpy(buf[i], rc[i],
                                             settings.disp_high)
                    for i in range(left.shape[0])]
        return masked_supports_to_numpy(buf, rc, settings.disp_high)
    if contract == "global-rows":
        (xs, ys, ds), counts = out
        if batched:
            return [global_row_supports_to_numpy(xs[i], ys[i], ds[i],
                                                 counts[i])
                    for i in range(left.shape[0])]
        return global_row_supports_to_numpy(xs, ys, ds, counts)
    xs, ys, ds, count = out
    over = np.flatnonzero(np.atleast_1d(count) > settings.capacity)
    if over.size:
        which = (f"pair(s) {over.tolist()} of the batch"
                 if batched else f"{int(count)} supports")
        raise ValueError(
            f"{which} exceed settings.capacity="
            f"{settings.capacity} on the flat-contract fallback; raise "
            "capacity (these settings are outside the packed-key "
            "contracts' eligibility — width/disp_high beyond the 30-bit "
            "budget, a >30-test forest, or an image beyond the packed "
            "pixel-index range)")
    if batched:
        return [supports_to_numpy(xs[i], ys[i], ds[i], count[i])
                for i in range(left.shape[0])]
    return supports_to_numpy(xs, ys, ds, count)

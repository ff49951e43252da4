"""Multi-scale pyramid sparse matching (BASELINE.json config 3).

The reference operates at a single scale; the GPC paper and the BASELINE
configs call for multi-scale matching: run the same forest at each level
of a mean-pooled image pyramid and merge the supports, scaling coordinates
and disparities back to level 0.  Coarse levels see disparities beyond
``disp_high`` and add coverage in low-texture regions; all levels execute
inside one jitted program (each level is just a smaller dense pipeline —
no data-dependent shapes).

Downscale: exact 2x2 mean with floor((a+b+c+d)/4) on uint8 — deterministic
integer semantics, testable bit-for-bit.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.forest import FilterMask, Forest, make_filter_mask
from opengpc_tpu.infer import _sparsematch_impl


def downscale2(img: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) uint8 -> (..., H//2, W//2) uint8 by 2x2 mean (floor);
    leading axes (a batch) pass through.

    Implemented with ``lax.reduce_window`` rather than strided slices
    (``x[0::2, 0::2] + ...``): one windowed reduction instead of four
    strided gathers."""
    h, w = img.shape[-2], img.shape[-1]
    h2, w2 = h // 2, w // 2
    window = (1,) * (img.ndim - 2) + (2, 2)
    s = jax.lax.reduce_window(
        img[..., : 2 * h2, : 2 * w2].astype(jnp.int32), 0, jax.lax.add,
        window, window, "VALID",
    )
    return (s // 4).astype(jnp.uint8)


def _dedup_unpack(key_c, mult, nbd, w0, disp_high, num_levels):
    """Finest-level-wins dedup + unpack of concatenated packed keys
    ((pix*mult + level) << nbd | d+disp_high; empty slots carry the int32
    sentinel).  ONE 1-operand sort over the LAST axis; a (B, L) batch of
    key rows runs as one segmented sort (each pair's keys are a row, like
    the (B*H, 2W) matcher fold).  Returns (xs, ys, ds, lv, counts) in the
    pyramid output contract (counts gains a leading batch axis)."""
    sent = jnp.int32(0x7FFFFFFF)
    key_s = jax.lax.sort((key_c,), dimension=key_c.ndim - 1, num_keys=1,
                         is_stable=False)[0]
    grp = key_s >> nbd  # pix * mult + level
    pixg = grp // mult
    first = jnp.concatenate(
        [jnp.ones(key_c.shape[:-1] + (1,), bool),
         pixg[..., 1:] != pixg[..., :-1]], axis=-1)
    keep = first & (key_s != sent)
    lv_c = jnp.where(keep, grp % mult, -1)
    xs_c = jnp.where(keep, pixg % w0, 0)
    ys_c = jnp.where(keep, pixg // w0, 0)
    ds_c = jnp.where(keep, (key_s & ((1 << nbd) - 1)) - disp_high, 0)
    # scale per-level disparities to level-0 units
    ds_c = jnp.where(lv_c >= 0, ds_c << jnp.maximum(lv_c, 0), 0)
    counts = jnp.stack(
        [jnp.sum(lv_c == level, axis=-1) for level in range(num_levels)],
        axis=-1,
    )
    return xs_c, ys_c, ds_c, lv_c, counts


def _pyramid_rows_impl(left, right, mask: FilterMask,
                       settings: InferenceSettings, num_levels: int,
                       mult: int, nbd: int):
    """Fast pyramid: every level rides the ROW-FORM matcher (no per-level
    flat compaction — the costliest stage of the flat pipeline), and the
    per-row buffers convert straight into the packed dedup keys.  Output
    contract identical to the flat path with dedup=True."""
    from opengpc_tpu.infer import _sparsematch_rows_impl

    h0, w0 = left.shape
    sent = jnp.int32(0x7FFFFFFF)
    keys = []
    l_img, r_img = left, right
    for level in range(num_levels):
        (xs, ds), counts = _sparsematch_rows_impl(
            l_img, r_img, mask=mask, settings=settings
        )
        hl, wl = l_img.shape
        scale = 1 << level
        yy = jnp.arange(hl, dtype=jnp.int32)[:, None]
        valid = jnp.arange(wl, dtype=jnp.int32)[None, :] < counts[:, None]
        pix = (yy * scale) * w0 + xs * scale
        keys.append(jnp.where(
            valid,
            ((pix * mult + level) << nbd) | (ds + settings.disp_high),
            sent,
        ).reshape(-1))
        if level + 1 < num_levels:
            l_img = downscale2(l_img)
            r_img = downscale2(r_img)
    return _dedup_unpack(jnp.concatenate(keys), mult, nbd, w0,
                         settings.disp_high, num_levels)


def _pyramid_batched_keys(lefts, rights, mask: FilterMask,
                          settings: InferenceSettings, num_levels: int,
                          mult: int, nbd: int):
    """(B, K) packed finest-wins dedup keys for a batch of pairs, with
    every level's matcher work folded into ONE (B*hs, 2W_l) segmented row
    sort (infer._sparsematch_rows_batched_impl's fold, per level).

    Margin rows are skipped instead of padded back (they can only carry
    sentinels), so K = sum_l (H_l - 2*margin_l) * W_l — smaller than the
    single-pair contract's sum_l H_l * W_l; consumers index by the lv/
    counts contract, not by position."""
    from opengpc_tpu.infer import _batched_key_images, _interior_rows
    from opengpc_tpu.match import match_epipolar_rows

    b, h0, w0 = lefts.shape
    sent = jnp.int32(0x7FFFFFFF)
    keys = []
    l_imgs, r_imgs = lefts, rights
    for level in range(num_levels):
        hl, wl = l_imgs.shape[-2:]
        kimg = _batched_key_images(l_imgs, r_imgs, mask, settings)
        kimg, m = _interior_rows(kimg)
        hs = hl - 2 * m
        (xs, ds), counts = match_epipolar_rows(
            None, None, None, None, settings.disp_high,
            key=kimg.reshape(b * hs, 2 * wl), num_tests=mask.num_tests)
        xs = xs.reshape(b, hs, wl)
        ds = ds.reshape(b, hs, wl)
        counts = counts.reshape(b, hs)
        scale = 1 << level
        yy = ((jnp.arange(hs, dtype=jnp.int32) + m) * scale)[None, :, None]
        valid = (jnp.arange(wl, dtype=jnp.int32)[None, None, :]
                 < counts[:, :, None])
        pix = yy * w0 + xs * scale
        keys.append(jnp.where(
            valid,
            ((pix * mult + level) << nbd) | (ds + settings.disp_high),
            sent,
        ).reshape(b, hs * wl))
        if level + 1 < num_levels:
            l_imgs = downscale2(l_imgs)
            r_imgs = downscale2(r_imgs)
    return jnp.concatenate(keys, axis=1)


def _pyramid_rows_batched_impl(lefts, rights, mask: FilterMask,
                               settings: InferenceSettings, num_levels: int,
                               mult: int, nbd: int,
                               map_dedup: bool = True):
    """Batched fast pyramid that AGGREGATES: at each
    level the B pairs' key images stack into ONE (B*hs, 2W_l) segmented
    row sort — no lax.map of B sequential pyramids.  Rows are independent
    in the epipolar matcher, so per-pair outputs are identical to
    single-pair runs (set equality pinned in tests/test_pyramid.py).

    ``map_dedup`` (the default): the final finest-wins dedup runs as B
    sequential per-pair sorts under ``lax.map``; ``map_dedup=False`` folds
    it into one (B, K~574k) segmented sort instead (5x faster on the CPU;
    not yet measured on the GPU, ROADMAP Speed 5)."""
    keys = _pyramid_batched_keys(lefts, rights, mask, settings, num_levels,
                                 mult, nbd)
    w0 = lefts.shape[-1]
    if map_dedup:
        return jax.lax.map(
            lambda k: _dedup_unpack(k, mult, nbd, w0, settings.disp_high,
                                    num_levels), keys)
    return _dedup_unpack(keys, mult, nbd, w0, settings.disp_high,
                         num_levels)


def _pyramid_compact_impl(left, right, mask: FilterMask,
                          settings: InferenceSettings, num_levels: int,
                          mult: int, nbd: int, chunk: int, k: int):
    """Low-density fast pyramid: every level rides the CHUNK-COMPACTED
    masked matcher (match_epipolar_masked_compact) — no per-level pack
    sort AND W-width dedup keys.  The per-level masked
    buffers convert elementwise into the packed finest-wins dedup keys:
    buf's low ``bd`` bits already hold d + disp_high, so they OR straight
    into the dedup key's disparity field.

    EXACT (identical support set to the rows pyramid) whenever the
    returned ``overflow`` flag is False; any level's chunk exceeding
    ``k`` candidates sets it and the caller MUST re-run the rows pyramid
    (dense frames — the 79%-density bench scene trips it)."""
    from opengpc_tpu.infer import _interior_rows, _key_image_jnp
    from opengpc_tpu.match import (MASKED_SENTINEL,
                                   match_epipolar_masked_compact)

    h0, w0 = left.shape
    sent = jnp.int32(0x7FFFFFFF)
    disp_high = settings.disp_high
    # the masked buffer packs (x << bd) | (d + disp_high); for any
    # disp_high >= 1, 2d and 2d+1 share a bit_length so bd == nbd and the
    # low bits transfer into the dedup key unchanged
    bd = max(1, int(2 * disp_high).bit_length())
    assert bd == nbd, (bd, nbd)
    keys = []
    ovf = jnp.bool_(False)
    l_img, r_img = left, right
    for level in range(num_levels):
        key, m = _interior_rows(_key_image_jnp(l_img, r_img, mask, settings))
        buf, _counts, o = match_epipolar_masked_compact(
            key, disp_high, chunk, k, num_tests=mask.num_tests)
        ovf = ovf | o
        scale = 1 << level
        valid = buf != MASKED_SENTINEL
        x = buf >> bd
        yy = (jnp.arange(buf.shape[0], dtype=jnp.int32) + m)[:, None]
        pix = (yy * scale) * w0 + x * scale
        keys.append(jnp.where(
            valid,
            ((pix * mult + level) << nbd) | (buf & ((1 << bd) - 1)),
            sent,
        ).reshape(-1))
        if level + 1 < num_levels:
            l_img = downscale2(l_img)
            r_img = downscale2(r_img)
    out = _dedup_unpack(jnp.concatenate(keys), mult, nbd, w0,
                        disp_high, num_levels)
    return out + (ovf,)


def _pack_params(settings: InferenceSettings, num_levels: int):
    """(mult, nbd) of the packed finest-wins dedup key."""
    mult = 1
    while mult < num_levels:
        mult <<= 1
    nbd = int(2 * settings.disp_high + 1).bit_length()
    return mult, nbd


def _rows_eligible(mask: FilterMask, settings: InferenceSettings,
                   h0: int, w0: int, num_levels: int):
    """(mult, nbd) when the fast rows-pyramid path applies for this shape
    (epipolar, <=30-test packable forest, 31-bit packable dedup keys),
    else None.  Level-0 eligibility covers the coarser levels — shrinking
    shapes only shrink the bit budgets."""
    from opengpc_tpu.infer import _rows_ok

    mult, nbd = _pack_params(settings, num_levels)
    if (settings.epipolar_mode
            and (h0 * w0 * mult) << nbd < 0x7FFFFFFF
            and _rows_ok(mask, (h0, w0), settings)):
        return mult, nbd
    return None


def _pyramid_compact_batched_impl(lefts, rights, mask: FilterMask,
                                  settings: InferenceSettings,
                                  num_levels: int, mult: int, nbd: int,
                                  chunk, k):
    """Batched chunk-compacted pyramid (r5): every level's compacted
    matcher folds the batch into one (B*hs, 2W_l) call — the same native
    fold the flat masked-compact contract uses — and the finest-wins
    dedup runs per pair under ``lax.map`` (the adopted hybrid rule).
    Returns the single-pair contract plus PER-PAIR (B,) overflow flags:
    the compacted matcher reports overflow per folded row
    (``row_overflow=True``), which reduces back to the pair each row came
    from, ORed across levels — so API consumers can re-run only the
    flagged pairs (the CLI re-runs the whole dispatch via ``.any()``)."""
    from opengpc_tpu.infer import _batched_key_images, _interior_rows
    from opengpc_tpu.match import (MASKED_SENTINEL,
                                   match_epipolar_masked_compact)

    b, h0, w0 = lefts.shape
    sent = jnp.int32(0x7FFFFFFF)
    disp_high = settings.disp_high
    bd = max(1, int(2 * disp_high).bit_length())
    assert bd == nbd, (bd, nbd)
    keys = []
    ovf = jnp.zeros((b,), dtype=jnp.bool_)
    l_imgs, r_imgs = lefts, rights
    for level in range(num_levels):
        hl, wl = l_imgs.shape[-2:]
        kimg = _batched_key_images(l_imgs, r_imgs, mask, settings)
        kimg, m = _interior_rows(kimg)
        hs = hl - 2 * m
        buf, _counts, o = match_epipolar_masked_compact(
            kimg.reshape(b * hs, 2 * wl), disp_high, chunk, k,
            num_tests=mask.num_tests, row_overflow=True)
        ovf = ovf | o.reshape(b, hs).any(axis=1)
        buf = buf.reshape(b, hs, buf.shape[1])
        scale = 1 << level
        valid = buf != MASKED_SENTINEL
        x = buf >> bd
        yy = ((jnp.arange(hs, dtype=jnp.int32) + m) * scale)[None, :, None]
        pix = yy * w0 + x * scale
        keys.append(jnp.where(
            valid,
            ((pix * mult + level) << nbd) | (buf & ((1 << bd) - 1)),
            sent,
        ).reshape(b, -1))
        if level + 1 < num_levels:
            l_imgs = downscale2(l_imgs)
            r_imgs = downscale2(r_imgs)
    kc = jnp.concatenate(keys, axis=1)
    out = jax.lax.map(
        lambda kk: _dedup_unpack(kk, mult, nbd, w0, disp_high, num_levels),
        kc)
    return out + (ovf,)


def _pyramid_impl(left, right, mask: FilterMask, settings: InferenceSettings,
                  num_levels: int, dedup: bool):
    import dataclasses

    h0, w0 = left.shape
    if dedup:
        el = _rows_eligible(mask, settings, h0, w0, num_levels)
        if el is not None:
            return _pyramid_rows_impl(left, right, mask, settings,
                                      num_levels, *el)

    xs_all, ys_all, ds_all, lv_all = [], [], [], []
    l_img, r_img = left, right
    for level in range(num_levels):
        # a level can never emit more supports than it has pixels (one
        # support per unique source pixel), so the pixel count is a hard
        # per-level bound: with dedup (the exact contract) size each
        # level's buffer AT that bound — settings.capacity cannot
        # silently truncate this fallback.  (The per-level true count
        # from the flat matcher is discarded below and the output counts
        # are recomputed post-dedup from the emitted buffers, so a trim
        # here would be undetectable by the caller.)  The buffers stay
        # the same order as the dense (H, W) code images the matcher
        # already materializes.  Without dedup keep the documented
        # capacity-trimmed flat buffers
        pix = l_img.shape[0] * l_img.shape[1]
        lvl_settings = dataclasses.replace(
            settings,
            capacity=pix if dedup else min(settings.capacity, pix),
        )
        xs, ys, ds, count = _sparsematch_impl(
            l_img, r_img, mask=mask, settings=lvl_settings
        )
        scale = 1 << level
        xs_all.append(xs.astype(jnp.int32) * scale)
        ys_all.append(ys.astype(jnp.int32) * scale)
        ds_all.append(ds.astype(jnp.int32))  # UNSCALED; scaled at the end
        lv_all.append(jnp.full_like(xs, level))
        # zero out slots beyond this level's count so merged buffers carry
        # no stale coordinates
        valid = jnp.arange(xs.shape[0]) < count
        xs_all[-1] = jnp.where(valid, xs_all[-1], 0)
        ys_all[-1] = jnp.where(valid, ys_all[-1], 0)
        ds_all[-1] = jnp.where(valid, ds_all[-1], 0)
        lv_all[-1] = jnp.where(valid, lv_all[-1], -1)
        if level + 1 < num_levels:
            l_img = downscale2(l_img)
            r_img = downscale2(r_img)
    xs_c = jnp.concatenate(xs_all)
    ys_c = jnp.concatenate(ys_all)
    ds_c = jnp.concatenate(ds_all)  # per-level (unscaled) disparities
    lv_c = jnp.concatenate(lv_all)
    h0, w0 = left.shape
    if dedup:
        # cross-level merge policy: FINEST LEVEL WINS.  A level-0 pixel can
        # also match (with scaled coordinates landing on the same (x, y))
        # at coarser levels with a conflicting disparity; keep only the
        # lowest-level support per pixel.
        #
        # Implementation: pack (pixel, level, unscaled d) into ONE int32
        # sort key and emit the buffers in sorted order: no gather/scatter
        # to un-sort, and one sort operand (every extra operand is real
        # comparator work).  The unscaled |d| <= disp_high fits the low
        # bits regardless of pyramid depth; x/y/level unpack from the key.
        mult = 1
        while mult < num_levels:
            mult <<= 1
        nbd = int(2 * settings.disp_high + 1).bit_length()
        sent = jnp.int32(0x7FFFFFFF)
        packable = (h0 * w0 * mult) << nbd < 0x7FFFFFFF
        valid = lv_c >= 0
        pix = ys_c * w0 + xs_c
        if packable:
            key = jnp.where(
                valid,
                ((pix * mult + lv_c) << nbd) | (ds_c + settings.disp_high),
                sent,
            )
            return _dedup_unpack(key, mult, nbd, w0, settings.disp_high,
                                 num_levels)
        else:
            # images/settings too large for the 31-bit packing: sort all
            # payloads together (sorted output, still no gather/scatter).
            # The grouping key pix*mult + level must itself fit int31 —
            # beyond ~2^28 pixels (x mult) it would wrap negative and the
            # finest-wins grouping would silently pick wrong entries
            if h0 * w0 * mult >= 0x7FFFFFFF:
                raise ValueError(
                    f"pyramid dedup key overflow: {h0}x{w0} image with "
                    f"{num_levels} levels exceeds int32 packing; disable "
                    "dedup or reduce levels"
                )
            key = jnp.where(valid, pix * mult + lv_c, sent)
            key_s, xs_c, ys_c, ds_c, lv_c = jax.lax.sort(
                (key, xs_c, ys_c, ds_c, lv_c), dimension=0, num_keys=1,
                is_stable=False,
            )
            pixg = key_s // mult
            first = jnp.concatenate(
                [jnp.ones((1,), bool), pixg[1:] != pixg[:-1]]
            )
            keep = first & (key_s != sent)
            xs_c = jnp.where(keep, xs_c, 0)
            ys_c = jnp.where(keep, ys_c, 0)
            ds_c = jnp.where(keep, ds_c, 0)
            lv_c = jnp.where(keep, lv_c, -1)
    # scale per-level disparities to level-0 units
    ds_c = jnp.where(lv_c >= 0, ds_c << jnp.maximum(lv_c, 0), 0)
    # per-level counts of the supports actually emitted (post-dedup)
    counts = jnp.stack(
        [jnp.sum(lv_c == level) for level in range(num_levels)]
    )
    return xs_c, ys_c, ds_c, lv_c, counts


def build_pyramid_sparsematch(
    forest_or_mask,
    settings: InferenceSettings,
    num_levels: int = 3,
    dedup: bool = True,
) -> Callable:
    """Jitted ``(left, right) -> (x, y, d, level, counts)`` pyramid matcher.

    Outputs are level-0 coordinates/disparities; ``level[i]`` tells which
    pyramid level produced support i (-1 marks empty slots), ``counts`` is
    the per-level count of emitted supports.  With ``dedup`` (default) the
    merge policy is finest-level-wins: at most one support per (x, y), and
    a level-0 support is never overridden by a coarser level.  Works on
    (H, W) images and (B, H, W) batches (lax.map), like build_sparsematch.

    With dedup on eligible settings (epipolar, <=30-test forest, packable
    keys) every level rides the row-form matcher — LOSSLESS regardless of
    ``settings.capacity`` and skips the per-level flat compaction sorts.
    The dedup non-eligible fallback (global mode / unpackable keys) is
    ALSO lossless: each level's flat buffer is sized at its
    one-support-per-source-pixel bound, so ``capacity`` never trims it
    (its clamped counts would make a trim silent).  Only dedup=False
    keeps the capacity-trimmed flat per-level buffers.
    """
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    fn = functools.partial(
        _pyramid_impl, mask=mask, settings=settings,
        num_levels=num_levels, dedup=dedup,
    )

    @jax.jit
    def run(left, right):
        if left.ndim == 3:
            if dedup:
                el = _rows_eligible(mask, settings, left.shape[1],
                                    left.shape[2], num_levels)
                if el is not None:
                    # batched FOLD: per-level (B*hs, 2W_l) row sorts +
                    # per-pair dedup — no lax.map of B pyramids
                    return _pyramid_rows_batched_impl(
                        left, right, mask, settings, num_levels, *el)
            # lax.map for the same reason as build_sparsematch
            return jax.lax.map(lambda ab: fn(*ab), (left, right))
        return fn(left, right)

    return run


def build_pyramid_sparsematch_compact(
    forest_or_mask,
    settings: InferenceSettings,
    num_levels: int = 3,
    chunk: Optional[int] = None,
    k: Optional[int] = None,
) -> Callable:
    """Jitted ``(left, right) -> (x, y, d, level, counts, overflow)``
    LOW-DENSITY pyramid matcher: every level rides the chunk-compacted
    masked matcher (the masked-compact contract lifted to the pyramid, for
    realistic ~15% candidate density).

    Same output contract and finest-level-wins dedup as
    ``build_pyramid_sparsematch(dedup=True)`` plus a trailing ``overflow``
    bool: EXACT identical support set whenever it is False; when True (a
    chunk at some level exceeded ``k`` candidates — dense frames) the
    result is incomplete and the caller must re-run the rows pyramid
    (the CLI's ``--pyramid --contract masked-compact`` does exactly
    that).  Works on (H, W) pairs and (B, H, W) batches; batched
    ``overflow`` is per-pair (B,) — the hybrid fold attributes each
    folded row's chunk overflow back to its pair (ORed across levels),
    so callers may re-run only the flagged pairs (the CLI re-runs the
    dispatch via ``.any()``).

    Eligibility (checked at trace time, ValueError otherwise) matches the
    rows pyramid: epipolar mode, <=30-test packable forest, 31-bit
    packable dedup keys, disp_high >= 1.
    """
    mask = (
        make_filter_mask(forest_or_mask)
        if isinstance(forest_or_mask, Forest)
        else forest_or_mask
    )
    if settings.disp_high < 1:
        raise ValueError("compact pyramid needs disp_high >= 1")

    def fn(left, right):
        h0, w0 = left.shape
        # the ONE eligibility rule (shared with the rows pyramid and the
        # sharded builders) — epipolar, packable forest, 31-bit dedup keys
        el = _rows_eligible(mask, settings, h0, w0, num_levels)
        if el is None:
            raise ValueError(
                "compact pyramid needs epipolar mode, a <=30-test "
                "packable forest, and 31-bit packable dedup keys for "
                f"{h0}x{w0} x {num_levels} levels; use "
                "build_pyramid_sparsematch instead"
            )
        return _pyramid_compact_impl(
            left, right, mask, settings, num_levels, *el, chunk, k)

    @jax.jit
    def run(left, right):
        if left.ndim == 3:
            # batched HYBRID fold (r5): per-level (B*hs, 2W_l) compacted
            # matcher calls + per-pair lax.map dedup; per-pair (B,)
            # overflow flags (row_overflow attribution through the fold)
            el = _rows_eligible(mask, settings, left.shape[1],
                                left.shape[2], num_levels)
            if el is not None:
                return _pyramid_compact_batched_impl(
                    left, right, mask, settings, num_levels, *el, chunk, k)
            return jax.lax.map(lambda ab: fn(*ab), (left, right))
        return fn(left, right)

    return run


def pyramid_supports_to_numpy(xs, ys, ds, levels, counts) -> np.ndarray:
    """Trim merged pyramid buffers to an (n, 4) int array of
    (x, y, d, level) rows (empty slots dropped).  With the default dedup
    policy the rows contain at most one support per (x, y)."""
    lv = np.asarray(levels)
    keep = lv >= 0
    return np.stack(
        [np.asarray(xs)[keep], np.asarray(ys)[keep], np.asarray(ds)[keep],
         lv[keep]],
        axis=1,
    ).astype(np.int32)

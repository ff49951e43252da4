"""Sparse-to-dense disparity densification.

The GPC method emits sparse supports; downstream consumers often want a
dense map (the paper pipelines supports into an edge-preserving
interpolator).  This is a simple data-parallel densifier: seed a dense grid
with the supports and run a fixed number of masked Jacobi diffusion
sweeps — unknown pixels take the mean of their already-filled 4-neighbors,
known support pixels stay pinned.  Static shapes, ``lax.fori_loop``, no
data-dependent control flow.

Not a reference component (the reference leaves refinement hooks unused,
buffer.hpp:104-119); provided as an extra, clearly separated from the
parity surface.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("shape", "num_iters", "method"))
def _densify(xs, ys, ds, count, shape: Tuple[int, int], num_iters: int,
             method: str = "multigrid"):
    h, w = shape
    idx = jnp.arange(xs.shape[0])
    valid = idx < count
    flat = jnp.where(valid, ys.astype(jnp.int32) * w + xs.astype(jnp.int32), h * w)

    seed_sum = jnp.zeros((h * w + 1,), jnp.float32).at[flat].add(
        jnp.where(valid, ds.astype(jnp.float32), 0.0), mode="drop"
    )
    seed_cnt = jnp.zeros((h * w + 1,), jnp.float32).at[flat].add(
        valid.astype(jnp.float32), mode="drop"
    )
    known = (seed_cnt[: h * w] > 0).reshape(h, w)
    value = jnp.where(
        known, (seed_sum[: h * w] / jnp.maximum(seed_cnt[: h * w], 1.0)).reshape(h, w), 0.0
    )
    if method == "multigrid":
        return _diffuse_multigrid(value, known, num_iters)
    return _diffuse(value, known, num_iters)


def _diffuse(value, known, num_iters: int, filled0=None):
    """The masked-Jacobi sweep loop shared by the flat-supports and the
    masked-contract densifiers (seeding differs; diffusion is identical).
    ``filled0`` optionally marks extra already-filled (but NOT pinned)
    pixels — the multigrid path seeds fine levels with the upsampled
    coarse solution this way."""

    def sweep(_, carry):
        val, filled = carry
        f = filled.astype(jnp.float32)
        vsum = (
            jnp.pad(val * f, ((0, 1), (0, 0)))[1:, :]
            + jnp.pad(val * f, ((1, 0), (0, 0)))[:-1, :]
            + jnp.pad(val * f, ((0, 0), (0, 1)))[:, 1:]
            + jnp.pad(val * f, ((0, 0), (1, 0)))[:, :-1]
        )
        nsum = (
            jnp.pad(f, ((0, 1), (0, 0)))[1:, :]
            + jnp.pad(f, ((1, 0), (0, 0)))[:-1, :]
            + jnp.pad(f, ((0, 0), (0, 1)))[:, 1:]
            + jnp.pad(f, ((0, 0), (1, 0)))[:, :-1]
        )
        grown = nsum > 0
        upd = vsum / jnp.maximum(nsum, 1.0)
        # support (seed) pixels stay pinned; every other filled-or-grown
        # pixel RELAXES each sweep (true masked Jacobi — the filled set
        # grows by one ring per sweep and keeps diffusing behind the front)
        new_val = jnp.where(known, val, jnp.where(grown, upd, 0.0))
        return new_val, filled | grown

    value, filled = jax.lax.fori_loop(
        0, num_iters, sweep, (value, known if filled0 is None else filled0))
    return value, filled


def _diffuse_multigrid(value, known, sweeps_per_level: int):
    """Coarse-to-fine masked diffusion: restrict the seeds
    down a 2x2-box pyramid (weighted sums, so coarse seeds are the exact
    means of their fine seeds), solve the coarsest grid with a few Jacobi
    sweeps, then repeatedly upsample (nearest) and relax ``sweeps_per_
    level`` sweeps with the original seeds pinned.  Fill radius is
    unbounded (the coarsest grid is a few cells wide, so any hole closes
    there) and total work is a geometric series ~4/3 of the finest level,
    vs O(diameter) sweeps for plain Jacobi.  Constant seed fields are
    reproduced exactly (means of constants); smooth fields approach the
    same harmonic interpolation Jacobi converges to (bounded-diff tested
    in tests/test_densify.py)."""
    f = known.astype(jnp.float32)
    pyr = [(value * f, f)]
    while max(pyr[-1][0].shape) > 8:
        wsum, cnt = pyr[-1]
        h, w = wsum.shape
        wsum = jnp.pad(wsum, ((0, h % 2), (0, w % 2)))
        cnt = jnp.pad(cnt, ((0, h % 2), (0, w % 2)))
        pyr.append(tuple(
            jax.lax.reduce_window(a, 0.0, jax.lax.add, (2, 2), (2, 2),
                                  "VALID") for a in (wsum, cnt)))
    wsum, cnt = pyr[-1]
    k = cnt > 0
    sol, filled = _diffuse(jnp.where(k, wsum / jnp.maximum(cnt, 1.0), 0.0),
                           k, sweeps_per_level)
    for wsum, cnt in reversed(pyr[:-1]):
        h, w = wsum.shape
        up = jnp.repeat(jnp.repeat(sol, 2, axis=0), 2, axis=1)[:h, :w]
        upf = jnp.repeat(jnp.repeat(filled, 2, axis=0), 2, axis=1)[:h, :w]
        k = cnt > 0
        seed = jnp.where(k, wsum / jnp.maximum(cnt, 1.0), 0.0)
        v0 = jnp.where(k, seed, jnp.where(upf, up, 0.0))
        sol, filled = _diffuse(v0, k, sweeps_per_level, filled0=k | upf)
    return sol, filled


def _masked_seed_scatter(buf, disp_high: int, w: int):
    """Scatter seeding of the dense grid from a masked buffer, kept for
    the A/B against the sort-merge seeding below (the production path;
    which is faster on the GPU is not yet measured, ROADMAP Speed 4)."""
    from opengpc_tpu.match import MASKED_SENTINEL

    h = buf.shape[0]
    bd = max(1, int(2 * disp_high).bit_length())
    valid = buf != MASKED_SENTINEL
    x = buf >> bd
    d = (buf & ((1 << bd) - 1)) - disp_high
    y = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[:, None], buf.shape)
    flat = jnp.where(valid, y * w + x, h * w).ravel()
    # one scatter-SET each (no add+mean: a source pixel pairs at most once,
    # so (y, x) seeds are unique by construction — same values the flat
    # path's add/mean seeding produces)
    seed = jnp.zeros((h * w + 1,), jnp.float32).at[flat].set(
        jnp.where(valid, d, 0).astype(jnp.float32).ravel(), mode="drop"
    )
    kn = jnp.zeros((h * w + 1,), jnp.bool_).at[flat].set(
        valid.ravel(), mode="drop"
    )
    known = kn[: h * w].reshape(h, w)
    value = jnp.where(known, seed[: h * w].reshape(h, w), 0.0)
    return value, known


def _masked_seed_sortmerge(buf, disp_high: int, w: int):
    """Sort-merge seeding: place masked-buffer entries into the dense grid
    with TWO row sorts instead of a scatter (same trade as
    match.compact).

    Merge trick: per row, sort candidate keys ``2x`` (unique — a source
    pixel pairs at most once) together with one placeholder key ``2x+1``
    per output column; after the sort each placeholder's LEFT NEIGHBOR is
    its column's candidate iff one exists (equal x, even key).  A second
    sort by placeholder-x left-packs the W per-column results into the
    dense row."""
    from opengpc_tpu.match import MASKED_SENTINEL

    h = buf.shape[0]
    bd = max(1, int(2 * disp_high).bit_length())
    valid = buf != MASKED_SENTINEL
    x = buf >> bd
    dpk = buf & ((1 << bd) - 1)  # d + disp_high, >= 0
    big = jnp.int32(0x7FFFFFFE)  # even: never mistaken for a placeholder
    ckey = jnp.where(valid, x << 1, big)
    cpay = jnp.where(valid, dpk, 0)
    pkey = jnp.broadcast_to(
        (jnp.arange(w, dtype=jnp.int32) * 2 + 1)[None, :], (h, w))
    key = jnp.concatenate([ckey, pkey], axis=1)          # (H, 2W + W)
    pay = jnp.concatenate([cpay, jnp.zeros((h, w), jnp.int32)], axis=1)
    key_s, pay_s = jax.lax.sort((key, pay), dimension=1, num_keys=1,
                                is_stable=False)
    prev_key = jnp.pad(key_s[:, :-1], ((0, 0), (1, 0)), constant_values=-2)
    prev_pay = jnp.pad(pay_s[:, :-1], ((0, 0), (1, 0)))
    is_ph = (key_s & 1) == 1
    found = is_ph & (prev_key == key_s - 1)
    # second sort: placeholders keyed by their column, everything else big;
    # payload packs (found, d) so one operand carries both outputs
    key2 = jnp.where(is_ph, key_s >> 1, jnp.int32(0x7FFFFFFF))
    pay2 = jnp.where(found, (1 << bd) | prev_pay, 0)
    _, pay2_s = jax.lax.sort((key2, pay2), dimension=1, num_keys=1,
                             is_stable=False)
    row = pay2_s[:, :w]
    known = (row >> bd) == 1
    value = jnp.where(known,
                      (row & ((1 << bd) - 1)).astype(jnp.float32) - disp_high,
                      0.0)
    return value, known


@functools.partial(jax.jit, static_argnames=("disp_high", "num_iters",
                                             "seed_impl", "width", "method"))
def _densify_from_masked(buf, disp_high: int, num_iters: int,
                         seed_impl: str = "sortmerge",
                         width: int = 0, method: str = "multigrid"):
    seed = (_masked_seed_sortmerge if seed_impl == "sortmerge"
            else _masked_seed_scatter)
    value, known = seed(buf, disp_high, width or buf.shape[1] // 2)
    if method == "multigrid":
        return _diffuse_multigrid(value, known, num_iters)
    return _diffuse(value, known, num_iters)


def densify_from_masked(buf, row_counts, disp_high: int,
                        num_iters: Optional[int] = None,
                        width: int = 0, method: str = "multigrid"):
    """DEVICE-RESIDENT masked-contract consumer: dense float32 disparity
    straight from ``build_sparsematch_masked``'s (buf, row_counts) with NO
    host decode/re-upload — the proof of match.py's "device-resident
    consumers can reduce over the masked buffer directly" (the subsystem
    supersedes the reference's unused refinement hooks,
    buffer.hpp:104-119).

    Decodes (x, d) from the packed buffer on device, seeds the dense grid
    with one scatter, and runs the same masked-Jacobi diffusion as
    :func:`densify_supports` — outputs are bit-identical to
    ``densify_supports(masked_supports_to_numpy(buf, row_counts, dh))``
    (pinned in tests/test_densify.py).  Returns DEVICE arrays
    (disparity (H, W) float32, filled (H, W) bool); ``row_counts`` is
    accepted for contract symmetry (the buffer alone determines the
    result).  ``width``: the image width W — REQUIRED for the
    chunk-compacted contract's narrower buffers (defaults to
    buf.shape[1] // 2, correct only for the full-width masked contract).

    ``method``: "multigrid" (default, r5) runs the coarse-to-fine solver —
    unbounded fill radius at O(log) cost, ``num_iters`` = sweeps PER LEVEL
    (default 10); "jacobi" keeps the r4 single-level sweep loop —
    ``num_iters`` total sweeps (default 64) bound the fill radius."""
    del row_counts
    if num_iters is None:
        num_iters = 10 if method == "multigrid" else 64
    return _densify_from_masked(buf, int(disp_high), int(num_iters),
                                width=int(width), method=method)


def densify_supports(
    supports: np.ndarray,
    shape: Tuple[int, int],
    num_iters: Optional[int] = None,
    method: str = "multigrid",
):
    """Dense float32 disparity map from (n, 3) supports (x, y, d).

    Returns (disparity (H, W) float32, filled (H, W) bool).

    ``method="multigrid"`` (default, r5): coarse-to-fine masked diffusion
    — any hole fills regardless of width (the coarsest grid is a few
    cells wide) at O(log) total sweeps; ``num_iters`` is the sweeps PER
    LEVEL (default 10).  ``method="jacobi"``: the r4 single-level sweep
    loop; pixels farther than ``num_iters`` (default 64) steps from a
    support stay unfilled (each sweep grows the filled region by one
    4-neighborhood ring) — kept as the measured A/B baseline and for
    strictly-local fill semantics.
    """
    if num_iters is None:
        num_iters = 10 if method == "multigrid" else 64
    supports = np.asarray(supports).reshape(-1, 3)
    n = max(1, len(supports))
    xs = jnp.asarray(np.resize(supports[:, 0], n).astype(np.int32))
    ys = jnp.asarray(np.resize(supports[:, 1], n).astype(np.int32))
    ds = jnp.asarray(np.resize(supports[:, 2], n).astype(np.int32))
    value, filled = _densify(xs, ys, ds, len(supports), tuple(shape),
                             num_iters, method)
    return np.asarray(value), np.asarray(filled)

"""Dense leaf-code extraction.

The reference's hot kernel (gpcFilter/gpcFilterTau,
/root/reference/lib/gpc/filter.hpp:237-282, 547-683) evaluates <=32
pixel-pair tests per candidate pixel and packs the bits into a 32-bit
leaf code.  Data-parallel recast: compute codes for *every* pixel as 2*T
statically shifted image slices (offsets are compile-time constants baked
from the forest, like the reference's width-specific FilterMask), compare,
and shift-accumulate.  Invalid pixels are masked downstream — dense masked
compute beats a gather, and XLA fuses the whole chain into a few loops.

Bit order follows the scalar contract (gpcFilterNaive filter.hpp:243-251):
test 0 lands at the MSB of the T-bit code.  Tau semantics are the naive
integer form ``img[p+i] > img[p+j] - tau`` (filter.hpp:274-279), *not* the
SSE path's saturating-subtract variant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from opengpc_tpu.forest import FilterMask, PATCH_HALF
from opengpc_tpu.ops.preprocess import CANDIDATE_MARGIN

PAD = PATCH_HALF + 1       # 13-px code halo + 1-px box/sobel halo
MARGIN = CANDIDATE_MARGIN  # candidate interior margin (inference.hpp:318-325)


def leaf_codes(smooth: jnp.ndarray, mask: FilterMask) -> jnp.ndarray:
    """Compute the (h, w) int32 leaf-code image of a smoothed uint8 image.

    Codes are meaningful where the 27x27 patch fits (margin >= 13);
    callers combine with :func:`opengpc_tpu.ops.candidate_mask`.
    """
    h, w = smooth.shape
    pad = PATCH_HALF
    padded = jnp.pad(smooth.astype(jnp.int16), pad)

    def window(dy: int, dx: int) -> jnp.ndarray:
        return jax.lax.slice(padded, (pad + dy, pad + dx), (pad + dy + h, pad + dx + w))

    code = jnp.zeros((h, w), jnp.int32)
    i_off = np.asarray(mask.i_off)
    j_off = np.asarray(mask.j_off)
    tau = np.asarray(mask.tau)
    for t in range(mask.num_tests):
        a = window(int(i_off[t, 0]), int(i_off[t, 1]))
        b = window(int(j_off[t, 0]), int(j_off[t, 1]))
        bit = (a > b - jnp.int16(tau[t])).astype(jnp.int32)
        code = code * 2 + bit  # test t at bit (T-1-t): test 0 ends at MSB
    return code


def mask_tests(mask: FilterMask):
    """The forest's tests as a static tuple of python ints
    (iy, ix, jy, jx, tau) — the compile-time constants the slab key image
    bakes in (the analog of readForest's FilterMask,
    inference.hpp:404-446)."""
    i_off = np.asarray(mask.i_off)
    j_off = np.asarray(mask.j_off)
    tau = np.asarray(mask.tau)
    return tuple(
        (int(i_off[t, 0]), int(i_off[t, 1]), int(j_off[t, 0]),
         int(j_off[t, 1]), int(tau[t]))
        for t in range(mask.num_tests)
    )


def tile_codes_and_cand(x32, y0, h, w, th, tests, thr2):
    """(codes int32, cand bool) of shape (th, w) for one (th+28, w+28)
    int32 row slab, zero-padded, whose first output row is image row y0.

    The contract math of the row-slab key image (infer._key_image_jnp_slab):
    box 3x3 + zeroed boundary, <=32 code tests MSB-first, binary sobel +
    margin-13 candidates, all in GLOBAL image coordinates so a slab's rows
    equal the same rows of a whole-image run.  ``y0`` may be traced.
    tests: tuple of (iy, ix, jy, jx, tau) python ints.
    """
    hc, wc = th + 26, w + 26  # code-support region of this slab

    # --- box 3x3 on the code-support region -----------------------------
    # region coord (r, c) = image (y0 + r - 13, c - 13)
    #                     = slab-local padded (r + 1, c + 1)
    total = jnp.zeros((hc, wc), jnp.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            total = total + jax.lax.slice(
                x32, (1 + dy, 1 + dx), (1 + dy + hc, 1 + dx + wc)
            )
    blurred = total // 9
    # valid box region (boxNaive + clearBoundary): 1 <= y <= h-3, 2 <= x <= w-2
    rr = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 0) + y0
    cc = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 1)
    box_valid = (rr >= 14) & (rr <= h + 10) & (cc >= 15) & (cc <= w + 11)
    smooth = jnp.where(box_valid, blurred, jnp.int32(0))  # (hc, wc)

    # --- leaf codes (gpcFilter[Tau] naive semantics) ---------------------
    code = jnp.zeros((th, w), jnp.int32)
    for iy, ix, jy, jx, tau in tests:
        a = jax.lax.slice(smooth, (13 + iy, 13 + ix), (13 + iy + th, 13 + ix + w))
        b = jax.lax.slice(smooth, (13 + jy, 13 + jx), (13 + jy + th, 13 + jx + w))
        bit = (a > b - jnp.int32(tau)).astype(jnp.int32)
        code = code * 2 + bit

    # --- sobel 3x3 on the raw image + margin -> candidate mask ----------
    def raw(dy, dx):
        return jax.lax.slice(
            x32, (PAD + dy, PAD + dx), (PAD + dy + th, PAD + dx + w)
        )

    sx_num = raw(-1, -1) + raw(1, -1) + 2 * raw(0, -1) \
        - raw(-1, 1) - 2 * raw(0, 1) - raw(1, 1)
    sy_num = raw(-1, -1) + raw(-1, 1) + 2 * raw(-1, 0) \
        - raw(1, -1) - 2 * raw(1, 0) - raw(1, 1)
    # C-style truncation toward zero (lax.div), not python floor
    sx = jax.lax.div(sx_num, jnp.int32(9))
    sy = jax.lax.div(sy_num, jnp.int32(9))
    grad = sx * sx + sy * sy > jnp.int32(thr2)

    yy = jax.lax.broadcasted_iota(jnp.int32, (th, w), 0) + y0
    xx = jax.lax.broadcasted_iota(jnp.int32, (th, w), 1)
    interior = (yy >= MARGIN) & (yy < h - MARGIN) & (xx >= MARGIN) & (xx < w - MARGIN)
    return code, grad & interior

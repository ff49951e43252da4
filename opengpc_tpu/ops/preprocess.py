"""Image preprocessing ops.

Data-parallel recast of the reference's SIMD kernels
(/root/reference/lib/gpc/filter.hpp): dense masked compute on the whole
image instead of row loops + index-list sparsity.  Semantics follow the
*naive* scalar paths, which are the parity contract (SURVEY.md §7):

* box:   3x3 mean with floor division by 9 (filter.hpp:198-223), valid on
  y in [1, h-3], x in [2, w-2], zero elsewhere — the net region left by
  boxNaive + clearBoundary (buffer.hpp:630-654).
* sobel: per-axis kernels, each sum divided by 9 with C truncation, then
  binarized by (sx^2 + sy^2) > threshold^2 (filter.hpp:157-188).
* candidates: gradient pixels with a 13-px interior margin
  (inference.hpp:318-325).

These are elementwise shift/add chains that XLA fuses into a handful of
loop fusions together with the leaf-code compares (ops/codes.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def require_u8(img) -> None:
    """Trace-time dtype guard shared by every preprocessing entry — the
    whole-image and slab key images (incl. the sharded paths) and the
    one-call API: a float image (matplotlib/skimage imread
    returns float64 in [0, 1]) silently produces ZERO candidates —
    sobel/box carry the reference's uint8-exact semantics — so reject it
    with a typed error instead of returning an empty support set.  dtype
    is static under jit, so this costs nothing in the compiled program."""
    if img.dtype != jnp.uint8:
        raise ValueError(
            f"expected uint8 grayscale image(s), got {img.dtype}; convert "
            "explicitly (e.g. (img * 255).astype(np.uint8) for float "
            "images in [0, 1])")


def _shifted(padded: jnp.ndarray, dy: int, dx: int, h: int, w: int, pad: int) -> jnp.ndarray:
    """Static window of a pad-`pad` image shifted by (dy, dx)."""
    return jax.lax.slice(padded, (pad + dy, pad + dx), (pad + dy + h, pad + dx + w))


def box3(img: jnp.ndarray) -> jnp.ndarray:
    """3x3 box blur, uint8 -> uint8.

    out(y, x) = floor(sum_{3x3} img / 9) for 1 <= y <= h-3, 2 <= x <= w-2;
    0 elsewhere (boxNaive filter.hpp:216-222 + clearBoundary).
    """
    h, w = img.shape
    x16 = img.astype(jnp.int16)
    padded = jnp.pad(x16, 1)
    total = jnp.zeros((h, w), jnp.int16)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            total = total + _shifted(padded, dy, dx, h, w, 1)
    blurred = (total // 9).astype(jnp.uint8)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    valid = (ys >= 1) & (ys <= h - 3) & (xs >= 2) & (xs <= w - 2)
    return jnp.where(valid, blurred, jnp.uint8(0))


def sobel3(img: jnp.ndarray, threshold: int) -> jnp.ndarray:
    """Binary 3x3 sobel gradient mask, uint8 -> uint8 (0 / 255).

    sx = (a00 + a20 + 2*a10 - a02 - 2*a12 - a22) / 9   (C trunc division)
    sy = (a00 + a02 + 2*a01 - a20 - 2*a21 - a22) / 9
    out = (sx^2 + sy^2) > threshold^2 ? 255 : 0
    Valid on y, x in [1, dim-2]; 0 elsewhere (sobelNaive filter.hpp:157-188;
    callers apply the margin-13 candidate filter on top).
    """
    h, w = img.shape
    x32 = img.astype(jnp.int32)
    padded = jnp.pad(x32, 1)

    def s(dy, dx):
        return _shifted(padded, dy, dx, h, w, 1)

    sx_num = s(-1, -1) + s(1, -1) + 2 * s(0, -1) - s(-1, 1) - 2 * s(0, 1) - s(1, 1)
    sy_num = s(-1, -1) + s(-1, 1) + 2 * s(-1, 0) - s(1, -1) - 2 * s(1, 0) - s(1, 1)
    # C-style truncation toward zero (lax.div), not python floor
    sx = jax.lax.div(sx_num, jnp.int32(9))
    sy = jax.lax.div(sy_num, jnp.int32(9))
    val = sx * sx + sy * sy
    mask = val > jnp.int32(threshold) * jnp.int32(threshold)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (ys >= 1) & (ys <= h - 2) & (xs >= 1) & (xs <= w - 2)
    return jnp.where(mask & interior, jnp.uint8(255), jnp.uint8(0))


# The candidate interior margin (inference.hpp:318-325): the single source
# of truth — ops/codes.MARGIN and infer._interior_rows derive from it, so
# the slab mask and the interior-row slice can never desync.
CANDIDATE_MARGIN = 13


def candidate_mask(grad: jnp.ndarray,
                   margin: int = CANDIDATE_MARGIN) -> jnp.ndarray:
    """Bool mask of candidate pixels: gradient nonzero with an interior
    margin (inference.hpp:318-325)."""
    h, w = grad.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
    return (grad != 0) & interior

"""Synthetic rectified-stereo scene generators shared by tests, bench, demo.

Real Sintel frames are not downloadable in this environment (SURVEY.md §6),
so correctness gates run on reproducible synthetic scenes with known
ground-truth disparity:

- :func:`make_pair` — trivially easy constant-disparity scene (every support
  must hit the single true d); good for throughput smoke gates.
- :func:`make_scene` — textured multi-plane scene with three disparity
  layers and a proper left-indexed occlusion map; a matcher that only works
  for constant-disparity inputs fails its gate.
"""

import numpy as np


def make_pair(h, w, d, seed=42):
    """Textured scene shifted by exactly ``d`` px: left(x) == right(x - d)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w + d)).astype(np.float32)
    for _ in range(2):
        base = (
            np.roll(base, 1, 0) + np.roll(base, -1, 0)
            + np.roll(base, 1, 1) + np.roll(base, -1, 1) + base
        ) / 5
    scene = base.astype(np.uint8)
    left = scene[:, :w].copy()   # feature at scene col c -> left x = c
    right = scene[:, d:].copy()  # -> right x = c - d; disparity = +d
    return left, right


def make_sparse_pair(h, w, d, density=0.15, seed=42, patch=24):
    """Constant-disparity pair with REALISTIC candidate density: a smooth
    (sub-threshold gradient) background with sharp texture patches covering
    roughly ``density`` of the area — the kind of frame gradientThreshold 5
    actually produces on real footage (~10-20% of pixels pass), unlike
    :func:`make_pair`'s ~79%-dense texture.

    The smooth background is a heavily blurred low-contrast field (its
    sobel response stays under the threshold); texture patches are the
    same high-frequency noise as make_pair.  Returns (left, right,
    measured candidate density estimate is up to the caller — bench
    reports the true fraction from the pipeline's own candidate mask).
    """
    rng = np.random.default_rng(seed)
    ws = w + d
    # smooth background: tiny-amplitude blurred noise, sobel-quiet
    bg = rng.integers(118, 138, (h, ws)).astype(np.float32)
    for _ in range(6):
        bg = (np.roll(bg, 1, 0) + np.roll(bg, -1, 0)
              + np.roll(bg, 1, 1) + np.roll(bg, -1, 1) + bg) / 5
    scene = bg
    # textured patches: place until the target area fraction is covered
    tex_mask = np.zeros((h, ws), bool)
    target = density * h * ws
    while tex_mask.sum() < target:
        py = int(rng.integers(0, max(1, h - patch)))
        px = int(rng.integers(0, max(1, ws - patch)))
        tex = rng.integers(0, 256, (patch, patch)).astype(np.float32)
        for _ in range(2):
            tex = (np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
                   + np.roll(tex, 1, 1) + np.roll(tex, -1, 1) + tex) / 5
        # clip to the scene for images smaller than one patch
        ph, pw = min(patch, h - py), min(patch, ws - px)
        scene[py:py + ph, px:px + pw] = tex[:ph, :pw]
        tex_mask[py:py + ph, px:px + pw] = True
    scene = scene.astype(np.uint8)
    return scene[:, :w].copy(), scene[:, d:].copy()


def make_scene(rng, h, w, max_disp=24):
    """Textured multi-plane scene with LEFT-indexed ground-truth disparity.

    The right image is built by forward-warping left pixels (right[x-d] =
    left[x]) painting planes in ascending-d order so nearer surfaces win,
    exactly the convention the miner and the precision metric assume
    (x_r = x_l - d(x_l)); ``occ`` marks left pixels whose right-image
    target was overwritten by a nearer surface or fell out of frame.

    Returns ``(left, right, disp, occ)`` with ``occ`` in {0, 255} uint8.
    """
    base = rng.integers(0, 256, (h, w + max_disp)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                + np.roll(base, 1, 1) + np.roll(base, -1, 1) + base) / 5
    left = base[:, :w].astype(np.uint8)

    disp = np.zeros((h, w), np.int32) + 6
    disp[:, w // 3:] = 12
    disp[h // 4: h // 2, w // 2: 3 * w // 4] = 20  # raised block

    right = rng.integers(0, 256, (h, w)).astype(np.uint8)  # bg noise
    owner_d = np.full((h, w), -1, np.int32)  # per right pixel: painter's d
    for d in sorted(np.unique(disp)):
        sel = disp == d
        ys, xs = np.nonzero(sel)
        xr = xs - d
        ok = xr >= 0
        right[ys[ok], xr[ok]] = left[ys[ok], xs[ok]]
        owner_d[ys[ok], xr[ok]] = d
    # left pixel occluded iff its right target is owned by a different d
    # (or fell out of frame)
    xr_all = np.arange(w)[None, :] - disp
    occ = (xr_all < 0) | (
        np.take_along_axis(owner_d, np.clip(xr_all, 0, w - 1), axis=1) != disp
    )
    return left, right, disp, occ.astype(np.uint8) * 255

"""Ground-truth correspondence mining and patch-triplet extraction.

Equivalent of the reference datasources' mining
(/root/reference/lib/gpc/SintelOpticalFlow.hpp:478-558,
SintelStereo.hpp:390-462) and Feature::extractAllTriplets
(Feature.hpp:191-245), recast as *vectorized batched rejection sampling*:
draw a whole block of random pixels, evaluate every validity predicate and
the small-motion rejection draw as array ops, keep the survivors, repeat
until enough — instead of the reference's one-pixel-at-a-time while loop.

Semantics preserved:
* safe patch centers: x, y > 20 and x < w-21, y < h-21
  (SintelOpticalFlow.hpp:269-274);
* flow targets: tar = src + int(round(flow at src)) with C ``round()``
  halves-away-from-zero semantics (``_round_ref``;
  SintelOpticalFlow.hpp:514-517 — pinned against the real code by
  cpp/refmine.cc on exact-.5 fixture flows);
* small-motion rejection: accept iff U(0,1) > (15 - min(|d|, 15)) / 15 * 0.5
  with d the rounded flow norm / the ground-truth disparity
  (SintelOpticalFlow.hpp:515-519);
* negatives: positive + per-axis offset r * s, r ~ U{radius_lo..radius_hi},
  s ~ U{-1, +1}, redrawn until safe (SintelOpticalFlow.hpp:536-553);
* patches: 27x27 crops of the *box-blurred* images, stored X-MAJOR
  (linear index (dx+13)*27 + (dy+13)) exactly like the reference's
  transposed getPatch buffers (buffer.hpp:534-544, Feature.hpp:254-263) —
  this is what makes the binary triplet format interchangeable;
* triplet record: ref(left, t) | pos(right/t+1) | neg(right/t+1), 729 bytes
  each.

Deliberate deviations (the reference's RNG is unseeded so parity is
distributional only; these are documented divergences from its quirks):
* occlusion/invalid maps of the *target* frame are sampled at the target
  coordinate (the reference reads all four maps at the source coordinate,
  SintelOpticalFlow.hpp:525-528);
* the stereo rejection ramp uses real division (the reference's
  ``(15 - min(|d|,15)) / 15`` is integer division that zeroes the ramp for
  every d != 0, SintelStereo.hpp:427);
* the stereo negative's sign draw excludes 0 (the reference's
  ``signum(rng)`` can emit 0, making the "negative" equal the positive,
  SintelStereo.hpp:449-450);
* image sizes are taken from the data, not hardcoded 1024x436.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from opengpc_tpu.forest import PATCH, PATCH_HALF

SAFE_MARGIN = 20  # isSafePatchCenter: x,y > 20 and < dim-21


def _keypoints_interior(k, h, w):
    """Vectorized isSafePatchCenter over an (n, 2) keypoint array (shared
    by the host and device extractors so the margin rule cannot desync)."""
    return (
        (k[:, 0] > SAFE_MARGIN) & (k[:, 1] > SAFE_MARGIN)
        & (k[:, 0] < w - SAFE_MARGIN) & (k[:, 1] < h - SAFE_MARGIN)
    )
REJECTION_ALPHA = 0.5
REJECTION_KNEE = 15.0


def safe_center(x: np.ndarray, y: np.ndarray, w: int, h: int) -> np.ndarray:
    return (x > SAFE_MARGIN) & (y > SAFE_MARGIN) & (x < w - 21) & (y < h - 21)


def _round_ref(a: np.ndarray) -> np.ndarray:
    """C ``round()``: halves round AWAY from zero — the reference's
    ``int(round(u))`` (SintelOpticalFlow.hpp:514-517).  np.rint would round
    halves to even (2.5 -> 2 instead of 3)."""
    a = np.asarray(a, dtype=np.float64)
    return np.copysign(np.floor(np.abs(a) + 0.5), a).astype(np.int64)


def _rejection_keep(dist: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Small-motion rejection: keep iff U(0,1) > (15-min(d,15))/15 * alpha."""
    p = (REJECTION_KNEE - np.minimum(np.abs(dist), REJECTION_KNEE)) \
        / REJECTION_KNEE * REJECTION_ALPHA
    return p < rng.random(dist.shape)


def _draw_negatives(
    px: np.ndarray, py: np.ndarray, radius_lo: int, radius_hi: int,
    w: int, h: int, rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Annulus negatives around positives, redrawn until safe (vectorized)."""
    n = px.shape[0]
    nx = np.zeros(n, np.int64)
    ny = np.zeros(n, np.int64)
    todo = np.ones(n, bool)
    while todo.any():
        k = int(todo.sum())
        r = rng.integers(radius_lo, radius_hi + 1, size=(k, 2))
        s = rng.integers(0, 2, size=(k, 2)) * 2 - 1
        cand_x = px[todo] + r[:, 0] * s[:, 0]
        cand_y = py[todo] + r[:, 1] * s[:, 1]
        ok = safe_center(cand_x, cand_y, w, h)
        idx = np.flatnonzero(todo)[ok]
        nx[idx] = cand_x[ok]
        ny[idx] = cand_y[ok]
        todo[idx] = False
    return nx, ny


def mine_flow_pair(
    u: np.ndarray,
    v: np.ndarray,
    occ_src: np.ndarray,
    occ_tar: np.ndarray,
    inv_src: np.ndarray,
    inv_tar: np.ndarray,
    num: int,
    radius_lo: int,
    radius_hi: int,
    rng: np.random.Generator,
    max_draws: int = 1000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mine ``num`` (ref, pos, neg) keypoints from one flow-annotated frame
    pair.  Returns three (num, 2) int arrays of (x, y).

    (SintelOpticalFlow.hpp:478-558 vectorized; see module docstring.)
    """
    h, w = u.shape
    out_l: List[np.ndarray] = []
    out_r: List[np.ndarray] = []
    got = 0
    for _ in range(max_draws):
        m = max(4 * (num - got), 256)
        x = rng.integers(0, w, size=m)
        y = rng.integers(0, h, size=m)
        du = _round_ref(u[y, x])
        dv = _round_ref(v[y, x])
        x2 = x + du
        y2 = y + dv
        dist = np.sqrt(du.astype(np.float64) ** 2 + dv.astype(np.float64) ** 2)

        ok = safe_center(x, y, w, h) & safe_center(x2, y2, w, h)
        x2c = np.clip(x2, 0, w - 1)
        y2c = np.clip(y2, 0, h - 1)
        ok &= (occ_src[y, x] == 0) & (inv_src[y, x] == 0)
        ok &= (occ_tar[y2c, x2c] == 0) & (inv_tar[y2c, x2c] == 0)
        ok &= _rejection_keep(dist, rng)

        out_l.append(np.stack([x[ok], y[ok]], axis=1))
        out_r.append(np.stack([x2[ok], y2[ok]], axis=1))
        got += int(ok.sum())
        if got >= num:
            break
    else:
        raise RuntimeError(
            f"mining stalled: {got}/{num} keypoints after {max_draws} blocks "
            f"(too much occlusion/invalid area?)"
        )

    kl = np.concatenate(out_l)[:num]
    kr = np.concatenate(out_r)[:num]
    nx, ny = _draw_negatives(kr[:, 0], kr[:, 1], radius_lo, radius_hi, w, h, rng)
    return kl, kr, np.stack([nx, ny], axis=1)


def mine_stereo_pair(
    disparity: np.ndarray,
    occ: np.ndarray,
    oof: np.ndarray,
    num: int,
    radius_lo: int,
    radius_hi: int,
    rng: np.random.Generator,
    max_draws: int = 1000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mine ``num`` (ref, pos, neg) keypoints from one stereo frame: the
    positive is (x - d, y) on the same row (SintelStereo.hpp:390-462)."""
    h, w = disparity.shape
    out_l: List[np.ndarray] = []
    out_r: List[np.ndarray] = []
    got = 0
    for _ in range(max_draws):
        m = max(4 * (num - got), 256)
        x = rng.integers(0, w, size=m)
        y = rng.integers(0, h, size=m)
        d = disparity[y, x].astype(np.int64)
        xr = x - d

        ok = safe_center(x, y, w, h) & safe_center(xr, y, w, h)
        ok &= (occ[y, x] == 0) & (oof[y, x] == 0)
        ok &= _rejection_keep(d.astype(np.float64), rng)

        out_l.append(np.stack([x[ok], y[ok]], axis=1))
        out_r.append(np.stack([xr[ok], y[ok]], axis=1))
        got += int(ok.sum())
        if got >= num:
            break
    else:
        raise RuntimeError(
            f"mining stalled: {got}/{num} keypoints after {max_draws} blocks"
        )

    kl = np.concatenate(out_l)[:num]
    kr = np.concatenate(out_r)[:num]
    nx, ny = _draw_negatives(kr[:, 0], kr[:, 1], radius_lo, radius_hi, w, h, rng)
    return kl, kr, np.stack([nx, ny], axis=1)


def _blur(img: np.ndarray) -> np.ndarray:
    """Box-blur with exactly the inference path's semantics (parity with
    extractAllTriplets, Feature.hpp:199-207: training patches come from
    blurred images, matching what inference codes see).

    Pure numpy, element-identical to ops.preprocess.box3 (pinned by
    tests/test_mine.py::test_blur_matches_box3) — the host mining pipeline
    does not dispatch to a device (one blur would cost a transfer and a
    compile)."""
    h, w = img.shape
    x = img.astype(np.int32)
    sv = x[:-2, :] + x[1:-1, :] + x[2:, :]
    sums = sv[:, :-2] + sv[:, 1:-1] + sv[:, 2:]  # 3x3 sums at centers
    out = np.zeros_like(img)
    # valid region after boxNaive + clearBoundary: y in [1, h-3], x in [2, w-2]
    out[1:h - 2, 2:w - 1] = (sums[0:h - 3, 1:w - 2] // 9).astype(img.dtype)
    return out


def extract_patches_xmajor(img: np.ndarray, kpts: np.ndarray) -> np.ndarray:
    """(K, 729) uint8 27x27 patches in the reference's X-MAJOR layout:
    element (dx+13)*27 + (dy+13) is img[y+dy, x+dx] (buffer.hpp:534-544)."""
    offs = np.arange(-PATCH_HALF, PATCH_HALF + 1)
    x, y = kpts[:, 0], kpts[:, 1]
    # axis 1 = dx (row of the transposed patch), axis 2 = dy
    yy = y[:, None, None] + offs[None, None, :]
    xx = x[:, None, None] + offs[None, :, None]
    return img[yy, xx].reshape(len(kpts), PATCH * PATCH)


def extract_triplets(
    img_l: np.ndarray,
    img_r: np.ndarray,
    kl: np.ndarray,
    kr: np.ndarray,
    kn: np.ndarray,
) -> np.ndarray:
    """Box-blur both images and crop (ref, pos, neg) patches at keypoints
    >20 px from the border (extractAllTriplets, Feature.hpp:191-245).
    Returns (K, 3, 729) uint8."""
    h, w = img_l.shape
    blur_l = _blur(img_l)
    blur_r = _blur(img_r)

    keep = (_keypoints_interior(kl, h, w) & _keypoints_interior(kr, h, w)
            & _keypoints_interior(kn, h, w))
    kl, kr, kn = kl[keep], kr[keep], kn[keep]
    return np.stack(
        [
            extract_patches_xmajor(blur_l, kl),
            extract_patches_xmajor(blur_r, kr),
            extract_patches_xmajor(blur_r, kn),
        ],
        axis=1,
    )


def extract_triplets_device(
    img_l: np.ndarray,
    img_r: np.ndarray,
    kl: np.ndarray,
    kr: np.ndarray,
    kn: np.ndarray,
) -> np.ndarray:
    """Device-path extract_triplets: box blur + 27x27 patch gathers as one
    jitted program; bit-identical output to :func:`extract_triplets`
    (pinned by tests/test_mine.py).

    The host numpy path remains the default: the triplets must land on the
    host to be written/shuffled anyway, so the device path pays upload +
    gather + download for work the host does in ~1 ms per frame.  Use this
    path to keep a training pipeline entirely device-resident.
    """
    import jax
    import jax.numpy as jnp

    from opengpc_tpu.ops.preprocess import box3

    h, w = img_l.shape

    keep = (_keypoints_interior(kl, h, w) & _keypoints_interior(kr, h, w)
            & _keypoints_interior(kn, h, w))
    kl, kr, kn = kl[keep], kr[keep], kn[keep]

    @jax.jit
    def run(il, ir, a, b, c):
        bl = box3(il)
        br = box3(ir)
        offs = jnp.arange(-PATCH_HALF, PATCH_HALF + 1)

        def patches(img, k):
            yy = k[:, 1][:, None, None] + offs[None, None, :]
            xx = k[:, 0][:, None, None] + offs[None, :, None]
            return img[yy, xx].reshape(k.shape[0], PATCH * PATCH)

        return jnp.stack(
            [patches(bl, a), patches(br, b), patches(br, c)], axis=1
        )

    return np.asarray(run(
        jnp.asarray(img_l), jnp.asarray(img_r),
        jnp.asarray(kl.astype(np.int32)), jnp.asarray(kr.astype(np.int32)),
        jnp.asarray(kn.astype(np.int32)),
    )).astype(np.uint8)


def extract_flow_dataset(
    root: str,
    triplets_per_pair: int = 1000,
    radius_lo: int = 20,
    radius_hi: int = 40,
    num_scenes: Optional[int] = 20,
    seed: int = 0,
    image_pass: str = "clean",
    verbose: bool = True,
) -> np.ndarray:
    """Walk the Sintel optical-flow training set and mine a triplet dataset
    (extractTrainingData, SintelOpticalFlow.hpp:112-162).  Frame pairs that
    fail to load are skipped, like the reference's try/catch."""
    from opengpc_tpu.io.sintel import SintelFlow

    ds = SintelFlow(root, image_pass)
    rng = np.random.default_rng(seed)
    chunks: List[np.ndarray] = []
    for scene in ds.scenes(limit=num_scenes):
        n = ds.num_frames(scene)
        for idx in range(1, n):
            try:
                u, v = ds.flow(scene, idx)
                img_l, img_r = ds.images(scene, idx)
                occ_s, occ_t = ds.occlusion(scene, idx), ds.occlusion(scene, idx + 1)
                inv_s, inv_t = ds.invalid(scene, idx), ds.invalid(scene, idx + 1)
            except (FileNotFoundError, IOError):
                continue
            kl, kr, kn = mine_flow_pair(
                u, v, occ_s, occ_t, inv_s, inv_t,
                triplets_per_pair, radius_lo, radius_hi, rng,
            )
            chunks.append(extract_triplets(img_l, img_r, kl, kr, kn))
        if verbose:
            total = sum(len(c) for c in chunks)
            print(f"scene {scene}: {total} triplets so far")
    if not chunks:
        raise RuntimeError(f"no triplets mined under {root}")
    data = np.concatenate(chunks)
    rng.shuffle(data, axis=0)
    return data


def extract_stereo_dataset(
    root: str,
    triplets_per_pair: int = 1000,
    radius_lo: int = 20,
    radius_hi: int = 40,
    num_scenes: Optional[int] = 20,
    seed: int = 0,
    verbose: bool = True,
) -> np.ndarray:
    """Walk the Sintel stereo training set and mine a triplet dataset
    (SintelStereo.hpp:121-160 equivalent)."""
    from opengpc_tpu.io.sintel import SintelStereo

    ds = SintelStereo(root)
    rng = np.random.default_rng(seed)
    chunks: List[np.ndarray] = []
    for scene in ds.scenes(limit=num_scenes):
        n = ds.num_frames(scene)
        for idx in range(1, n + 1):
            try:
                img_l, img_r = ds.images(scene, idx)
                disp = ds.disparity(scene, idx)
                occ = ds.occlusion(scene, idx)
                oof = ds.outofframe(scene, idx)
            except (FileNotFoundError, IOError):
                continue
            kl, kr, kn = mine_stereo_pair(
                disp, occ, oof, triplets_per_pair, radius_lo, radius_hi, rng
            )
            chunks.append(extract_triplets(img_l, img_r, kl, kr, kn))
        if verbose:
            total = sum(len(c) for c in chunks)
            print(f"scene {scene}: {total} triplets so far")
    if not chunks:
        raise RuntimeError(f"no triplets mined under {root}")
    data = np.concatenate(chunks)
    rng.shuffle(data, axis=0)
    return data

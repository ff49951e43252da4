"""The key image and the matcher sort against the native oracle and numpy.

The sentinel-packed key image (infer._key_image_jnp, and its row-slab
form infer._key_image_jnp_slab used by the sharded paths) is the one
key-image path; these tests pin it against the oracle's ``codes`` command
at awkward shapes, the slab form against the whole image, the census
transform against ``oracle census``, the matcher row sort
(match._sort_key_pos) against numpy, and the masked pipeline against
``oracle sparsematch`` at narrow, wide and tall frames.
"""

import os
import subprocess

import numpy as np
import pytest

from opengpc_tpu import forest as forest_mod
from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.io.raw import read_raw, write_raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORESTS = os.path.join(REPO, "forests")


def structured_image(rng, h, w):
    small = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2))
    img = np.kron(small, np.ones((4, 4)))[:h, :w]
    return np.clip(img + rng.integers(-12, 13, (h, w)), 0, 255).astype(np.uint8)


def _mask(forest_file):
    return forest_mod.make_filter_mask(
        forest_mod.load_forest(os.path.join(FORESTS, forest_file)))


def _oracle_codes(oracle_path, tmp_path, img, forest_file, thr, tag):
    from opengpc_tpu.ops.preprocess import box3, sobel3

    sm, gr, out = (str(tmp_path / f"{tag}_{n}.raw") for n in "sgc")
    write_raw(sm, np.asarray(box3(img)))
    write_raw(gr, np.asarray(sobel3(img, thr)))
    subprocess.run([oracle_path, "codes", sm, gr,
                    os.path.join(FORESTS, forest_file), out], check=True)
    return read_raw(out)


@pytest.mark.parametrize(
    "shape",
    [
        (64, 96), (100, 250), (436, 1024),
        (37, 130),    # barely taller than the two 13-px margins
        (129, 1023),  # odd height, width just under a power of two
    ],
)
@pytest.mark.parametrize(
    "forest_file", ["defaultZeroForest.txt", "defaultTauForest.txt"]
)
def test_key_image_matches_oracle_codes(oracle_path, tmp_path, shape,
                                        forest_file):
    """Both halves of the (H, 2W) key image: the oracle's leaf code at
    every candidate pixel, the unique per-position sentinel elsewhere."""
    from opengpc_tpu.infer import _key_image_jnp
    from opengpc_tpu.match import SENTINEL_BASE
    from opengpc_tpu.ops.preprocess import candidate_mask, sobel3

    rng = np.random.default_rng(sum(shape))
    h, w = shape
    left = structured_image(rng, h, w)
    right = structured_image(rng, h, w)
    thr = 5
    settings = InferenceSettings(gradient_threshold=thr)
    key = np.asarray(_key_image_jnp(left, right, _mask(forest_file),
                                    settings))
    assert key.shape == (h, 2 * w) and key.dtype == np.int32
    pos = np.arange(2 * w)[None, :]
    for half, img in ((0, left), (1, right)):
        k = key[:, half * w:(half + 1) * w]
        cand = np.asarray(candidate_mask(sobel3(img, thr)))
        assert cand.sum() > 0
        np.testing.assert_array_equal(k < SENTINEL_BASE, cand)
        want = _oracle_codes(oracle_path, tmp_path, img, forest_file, thr,
                             f"h{half}")
        np.testing.assert_array_equal(k[cand].astype(np.uint32), want[cand])
        sent = (SENTINEL_BASE + pos[:, half * w:(half + 1) * w]
                + np.zeros((h, 1), np.int64))
        np.testing.assert_array_equal(k[~cand], sent[~cand])


@pytest.mark.parametrize("y0,sh", [(0, 64), (64, 64), (32, 96), (192, 64)])
def test_key_image_slab_matches_full_image(y0, sh):
    """_key_image_jnp_slab on rows [y0, y0+sh) of a 256-row pair (halo from
    the real neighbours, zeros outside) == the same rows of the
    whole-image key image — the per-shard key image of the sharded
    paths."""
    from opengpc_tpu.infer import _key_image_jnp, _key_image_jnp_slab
    from opengpc_tpu.ops.codes import PAD

    rng = np.random.default_rng(y0 + sh)
    h, w = 256, 160
    left = structured_image(rng, h, w)
    right = structured_image(rng, h, w)
    mask = _mask("defaultTauForest.txt")
    settings = InferenceSettings(gradient_threshold=5)
    full = np.asarray(_key_image_jnp(left, right, mask, settings))

    def slab(img):
        return np.pad(img, ((PAD, PAD), (0, 0)))[y0:y0 + sh + 2 * PAD]

    got = np.asarray(_key_image_jnp_slab(slab(left), slab(right), mask,
                                         settings, y0, h))
    np.testing.assert_array_equal(got, full[y0:y0 + sh])


@pytest.mark.parametrize("shape", [(64, 96), (100, 250), (37, 130),
                                   (200, 1100)])
def test_census_matches_oracle(oracle_path, tmp_path, shape):
    from opengpc_tpu.ops.census import census5x5

    rng = np.random.default_rng(sum(shape) + 7)
    img = structured_image(rng, *shape)
    inp, out = str(tmp_path / "in.raw"), str(tmp_path / "out.raw")
    write_raw(inp, img)
    subprocess.run([oracle_path, "census", inp, out], check=True)
    want = read_raw(out)
    got = np.asarray(census5x5(img)).astype(np.uint32)
    assert want.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_tests,w", [(17, 1024), (11, 160),
                                         (None, 1024), (30, 160)])
def test_sort_key_pos_orders_like_numpy(num_tests, w):
    """The matcher row sort, one-operand (pos packed into the key) and
    two-operand: keys come back row-sorted, every (key, pos) pair
    survives, and the one-operand form also orders equal codes by pos."""
    from opengpc_tpu.match import SENTINEL_BASE, _pack_ok, _sort_key_pos

    w2 = 2 * w
    one_op = _pack_ok(num_tests, w2)
    assert one_op == (num_tests is not None and num_tests <= 19)
    rng = np.random.default_rng(w + (num_tests or 0))
    h = 24
    bits = num_tests or 30
    # few distinct codes per row, so equal keys (the matcher's collisions)
    # are common; a third of the pixels carry their position sentinel
    codes = rng.integers(0, min(1 << bits, 64), (h, w2)) * ((1 << bits) // 64
                                                          or 1)
    pos = np.broadcast_to(np.arange(w2, dtype=np.int64), (h, w2))
    valid = rng.random((h, w2)) < 0.66
    key = np.where(valid, codes, SENTINEL_BASE + pos).astype(np.int32)
    key_s, pos_s = (np.asarray(a) for a in _sort_key_pos(
        key, pos.astype(np.int32), w2, num_tests))
    np.testing.assert_array_equal(key_s, np.sort(key, axis=1))
    for y in range(h):
        got = sorted(zip(key_s[y].tolist(), pos_s[y].tolist()))
        want = sorted(zip(key[y].tolist(), pos[y].tolist()))
        assert got == want
        if one_op:
            order = np.lexsort((pos[y], key[y]))
            np.testing.assert_array_equal(pos_s[y], pos[y][order])


def _oracle_supports(oracle_path, tmp_path, forest_file, left, right, s):
    lp, rp, out = (str(tmp_path / n) for n in ("l.raw", "r.raw", "s.txt"))
    write_raw(lp, left)
    write_raw(rp, right)
    subprocess.run([oracle_path, "sparsematch",
                    os.path.join(FORESTS, forest_file), lp, rp, out,
                    str(s.gradient_threshold), str(s.vertical_tolerance),
                    str(s.disp_high), "1", "0"], check=True)
    rows = np.loadtxt(out, dtype=np.int64, ndmin=2).reshape(-1, 3)
    return set(map(tuple, rows.tolist()))


@pytest.mark.parametrize(
    "shape,forest_file,disp_high",
    [
        ((48, 80), "defaultZeroForest.txt", 64),
        ((48, 80), "defaultTauForest.txt", 64),
        ((70, 100), "defaultZeroForest.txt", 64),
        ((70, 100), "defaultTauForest.txt", 64),
        ((40, 6000), "defaultZeroForest.txt", 16),   # very wide rows
        ((1500, 260), "defaultZeroForest.txt", 16),  # very tall frame
    ],
)
def test_masked_pipeline_matches_oracle(oracle_path, tmp_path, shape,
                                        forest_file, disp_high):
    from opengpc_tpu.infer import (build_sparsematch_masked,
                                   masked_supports_to_numpy)

    rng = np.random.default_rng(sum(shape))
    h, w = shape
    left = structured_image(rng, h, w)
    right = np.roll(left, -3, axis=1)
    right[:, -3:] = rng.integers(0, 256, (h, 3)).astype(np.uint8)
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=disp_high, epipolar_mode=True)
    buf, counts = build_sparsematch_masked(_mask(forest_file),
                                           settings)(left, right)
    got = set(map(tuple, masked_supports_to_numpy(
        buf, counts, disp_high).astype(np.int64).tolist()))
    want = _oracle_supports(oracle_path, tmp_path, forest_file, left, right,
                            settings)
    assert len(want) > 0
    assert got == want

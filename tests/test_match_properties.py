"""Matcher property tests vs a brute-force O(n^2) oracle (SURVEY.md §4.3).

Independent of the C++ oracle: the unique-collision rule is restated from
first principles over random codes with heavy duplication.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from opengpc_tpu.match import compact, match_epipolar, match_global


def brute_force_epipolar(codes_l, codes_r, valid_l, valid_r, disp_high):
    """Row-wise: (x, y, d) iff the code occurs exactly once among valid
    pixels of the row in EACH image and |d| <= disp_high."""
    h, w = codes_l.shape
    out = set()
    for y in range(h):
        for x in range(w):
            if not valid_l[y, x]:
                continue
            c = codes_l[y, x]
            if (codes_l[y][valid_l[y]] == c).sum() != 1:
                continue
            tars = np.flatnonzero((codes_r[y] == c) & valid_r[y])
            if len(tars) == 1:
                d = x - int(tars[0])
                if abs(d) <= disp_high:
                    out.add((x, y, d))
    return out


def brute_force_global(codes_l, codes_r, valid_l, valid_r, disp_high, vt):
    h, w = codes_l.shape
    cl = codes_l[valid_l]
    cr = codes_r[valid_r]
    pos_l = np.argwhere(valid_l)  # (n, 2) of (y, x)
    pos_r = np.argwhere(valid_r)
    out = set()
    for (y, x), c in zip(pos_l, codes_l[valid_l]):
        if (cl == c).sum() != 1:
            continue
        hits = np.flatnonzero(cr == c)
        if len(hits) == 1:
            ty, tx = pos_r[hits[0]]
            d = int(x) - int(tx)
            if abs(d) <= disp_high and abs(int(y) - int(ty)) <= vt:
                out.add((int(x), int(y), d))
    return out


def _got(res):
    (xs, ys, ds), count = res
    n = int(count)
    return set(
        zip(np.asarray(xs)[:n].tolist(), np.asarray(ys)[:n].tolist(),
            np.asarray(ds)[:n].tolist())
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("packed", [False, True])
def test_epipolar_matches_brute_force(seed, packed):
    rng = np.random.default_rng(seed)
    h, w = 12, 40
    # tiny code alphabet -> lots of duplicates, triples, singletons
    codes_l = rng.integers(0, 25, (h, w)).astype(np.int32)
    codes_r = rng.integers(0, 25, (h, w)).astype(np.int32)
    valid_l = rng.random((h, w)) < 0.6
    valid_r = rng.random((h, w)) < 0.6

    want = brute_force_epipolar(codes_l, codes_r, valid_l, valid_r, 30)
    got = _got(match_epipolar(
        jnp.asarray(codes_l), jnp.asarray(codes_r),
        jnp.asarray(valid_l), jnp.asarray(valid_r), 30, 4096, packed=packed,
    ))
    assert got == want
    assert len(want) > 0


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("packed", [False, True])
def test_global_matches_brute_force(seed, packed):
    rng = np.random.default_rng(seed)
    h, w = 10, 24
    codes_l = rng.integers(0, 60, (h, w)).astype(np.int32)
    codes_r = rng.integers(0, 60, (h, w)).astype(np.int32)
    valid_l = rng.random((h, w)) < 0.5
    valid_r = rng.random((h, w)) < 0.5

    want = brute_force_global(codes_l, codes_r, valid_l, valid_r, 20, 2)
    got = _got(match_global(
        jnp.asarray(codes_l), jnp.asarray(codes_r),
        jnp.asarray(valid_l), jnp.asarray(valid_r), 20, 2, 4096,
        packed=packed,
    ))
    assert got == want


def test_capacity_overflow_truncates_deterministically():
    """count reports the true total; the buffer holds the first `capacity`
    matches in scan order and never garbage."""
    rng = np.random.default_rng(9)
    h, w = 16, 64
    codes = rng.integers(0, 1 << 20, (h, w)).astype(np.int32)
    valid = np.ones((h, w), bool)
    # identical images -> every pixel with a row-unique code matches d=0
    full = _got(match_epipolar(
        jnp.asarray(codes), jnp.asarray(codes),
        jnp.asarray(valid), jnp.asarray(valid), 8, 4096,
    ))
    cap = 17
    (xs, ys, ds), count = match_epipolar(
        jnp.asarray(codes), jnp.asarray(codes),
        jnp.asarray(valid), jnp.asarray(valid), 8, cap,
    )
    assert int(count) == len(full) > cap
    held = set(
        zip(np.asarray(xs).tolist(), np.asarray(ys).tolist(),
            np.asarray(ds).tolist())
    )
    assert held <= full and len(held) == cap


class TestSingleOperandPackedSort:
    """Small-forest single-operand matcher sort (r4): when
    num_tests + pos_bits(2W) <= 30, pos packs INTO the sort key and the
    payload operand disappears (measured 3.4x on the CPU sort;
    experiments/exp_smallforest.py).  Equality with the 2-operand path is
    the contract here."""

    def test_pack_ok_boundary(self):
        from opengpc_tpu.match import _pack_ok, _pos_bits

        assert _pos_bits(2048) == 11
        assert _pack_ok(19, 2048)       # 19 + 11 = 30: fits
        assert not _pack_ok(20, 2048)   # 31: one bit too many
        assert not _pack_ok(None, 2048)
        assert _pack_ok(17, 8192)       # 17 + 13 = 30 (4K rows)
        assert not _pack_ok(18, 8192)

    def test_pack_unpack_roundtrip(self):
        """_pack_keypos/_unpack_keypos are exact inverses for valid codes
        AND per-position sentinels (the ONE packed-key layout shared by
        _sort_key_pos and the masked-compact path)."""
        import jax.numpy as jnp

        from opengpc_tpu.match import (SENTINEL_BASE, _pack_keypos,
                                       _pos_bits, _unpack_keypos)

        rng = np.random.default_rng(0)
        w2 = 192
        pb = _pos_bits(w2)
        pos = np.arange(w2, dtype=np.int32)[None, :].repeat(4, axis=0)
        code = rng.integers(0, 1 << (30 - pb), (4, w2)).astype(np.int32)
        valid = rng.random((4, w2)) < 0.5
        key = np.where(valid, code, SENTINEL_BASE + pos).astype(np.int32)
        packed = _pack_keypos(jnp.asarray(key), jnp.asarray(pos), pb)
        # sentinels pass through unchanged (they already encode position)
        np.testing.assert_array_equal(
            np.asarray(packed)[~valid], key[~valid])
        k2, p2 = _unpack_keypos(packed, pb)
        np.testing.assert_array_equal(np.asarray(k2), key)
        np.testing.assert_array_equal(np.asarray(p2), pos)

    @pytest.mark.parametrize("n_tests", [1, 11, 17, 19])
    def test_masked_equal_either_sort(self, n_tests):
        """The 1-op path (num_tests given, small) and the 2-op path
        (num_tests=None) must produce IDENTICAL masked buffers — not just
        equal support sets — for the same key image."""
        import os

        from opengpc_tpu.config import InferenceSettings
        from opengpc_tpu.forest import load_forest, make_filter_mask
        from opengpc_tpu.infer import _key_image_jnp
        from opengpc_tpu.match import (_pack_ok, match_epipolar_masked,
                                       match_epipolar_masked_compact)

        forests = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "forests")
        mask = make_filter_mask(
            load_forest(os.path.join(forests, "defaultTauForest.txt")),
            max_tests=n_tests)
        settings = InferenceSettings(gradient_threshold=4,
                                     epipolar_mode=True, disp_high=32,
                                     vertical_tolerance=0, capacity=8192)
        rng = np.random.default_rng(n_tests)
        h, w = 96, 160
        left = rng.integers(0, 256, (h, w)).astype(np.uint8)
        right = np.roll(left, -4, axis=1)
        key = _key_image_jnp(left, right, mask, settings)
        assert _pack_ok(n_tests, 2 * w)

        b1, c1 = match_epipolar_masked(None, None, None, None,
                                       settings.disp_high, key=key,
                                       num_tests=n_tests)
        b2, c2 = match_epipolar_masked(None, None, None, None,
                                       settings.disp_high, key=key)
        np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
        if n_tests >= 11:  # a 1-test forest has 2 codes: nothing unique
            assert int(np.asarray(c1).sum()) > 50

        # compact contract: same buffers, same overflow flag, both sorts
        # single-operand on the packed path
        cb1, cc1, o1 = match_epipolar_masked_compact(
            key, settings.disp_high, 64, 32, num_tests=n_tests)
        cb2, cc2, o2 = match_epipolar_masked_compact(
            key, settings.disp_high, 64, 32)
        assert bool(np.asarray(o1)) == bool(np.asarray(o2))
        if not bool(np.asarray(o1)):
            np.testing.assert_array_equal(np.asarray(cb1), np.asarray(cb2))
            np.testing.assert_array_equal(np.asarray(cc1), np.asarray(cc2))

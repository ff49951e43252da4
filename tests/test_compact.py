"""Unit tests for the sort-based compaction primitives (match.compact,
match.compact_packed, match._row_pack) — the output-materialization core
every matcher now goes through (sort-based instead of cumsum+scatter)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from opengpc_tpu.match import _row_pack, compact, compact_packed


def reference_compact(mask, values, capacity):
    """Oracle semantics: values at true mask positions, flat order,
    truncated to capacity, zero-padded; count = total true."""
    mask = np.asarray(mask).reshape(-1)
    outs = []
    for v in values:
        v = np.asarray(v).reshape(-1)[mask]
        out = np.zeros(capacity, v.dtype)
        out[: min(capacity, len(v))] = v[:capacity]
        outs.append(out)
    return outs, int(mask.sum())


@pytest.mark.parametrize("shape", [(64,), (7, 33), (128, 129)])
@pytest.mark.parametrize("capacity", [8, 64, 100000])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compact_matches_reference(shape, capacity, density):
    rng = np.random.default_rng(hash((shape, capacity, int(density * 10))) % 2**31)
    mask = rng.random(shape) < density
    vals = tuple(rng.integers(-1000, 1000, shape).astype(np.int32)
                 for _ in range(3))
    got, count = jax.jit(
        lambda m, v: compact(m, v, capacity)
    )(jnp.asarray(mask), tuple(jnp.asarray(v) for v in vals))
    want, want_count = reference_compact(mask, vals, capacity)
    assert int(count) == want_count
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("capacity", [4, 50, 4096])
def test_compact_packed_matches_compact_set(capacity):
    """Packed single-operand compaction must emit the same (field tuple)
    multiset as generic compact, zero-padded the same way; order is by
    packed value rather than flat position."""
    rng = np.random.default_rng(3)
    shape = (40, 77)
    mask = rng.random(shape) < 0.4
    a = rng.integers(0, 64, shape).astype(np.int32)    # 6 bits
    b = rng.integers(0, 512, shape).astype(np.int32)   # 9 bits
    (ga, gb), count = jax.jit(
        lambda m, x, y: compact_packed(m, ((x, 6), (y, 9)), capacity)
    )(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b))
    want_count = int(mask.sum())
    assert int(count) == want_count
    n = min(want_count, capacity)
    got_rows = sorted(zip(np.asarray(ga)[:n].tolist(),
                          np.asarray(gb)[:n].tolist()))
    want_all = sorted(zip(np.asarray(a)[mask].tolist(),
                          np.asarray(b)[mask].tolist()))
    # packed output is the SMALLEST n tuples in packed order
    assert got_rows == want_all[:n]
    # padding beyond count is zero
    np.testing.assert_array_equal(np.asarray(ga)[n:], 0)
    np.testing.assert_array_equal(np.asarray(gb)[n:], 0)


def test_compact_empty_and_overflow():
    mask = jnp.zeros((5, 7), bool)
    vals = (jnp.ones((5, 7), jnp.int32),)
    (out,), count = compact(mask, vals, 4)
    assert int(count) == 0 and np.asarray(out).sum() == 0

    mask = jnp.ones((5, 7), bool)
    (out,), count = compact(mask, vals, 4)
    assert int(count) == 35 and np.asarray(out).tolist() == [1, 1, 1, 1]


def test_row_pack_exact():
    """Row-form packing: per-row x-sorted supports, zero-padded, counted."""
    rng = np.random.default_rng(5)
    h, w, disp_high = 9, 32, 16
    wn = 2 * w - 1
    keep = rng.random((h, wn)) < 0.25
    src_x = rng.integers(0, w, (h, wn)).astype(np.int32)
    d = rng.integers(-disp_high, disp_high + 1, (h, wn)).astype(np.int32)
    (xs, ds), counts = jax.jit(
        lambda k, x, dd: _row_pack(k, x, dd, w, disp_high)
    )(jnp.asarray(keep), jnp.asarray(src_x), jnp.asarray(d))
    xs, ds, counts = np.asarray(xs), np.asarray(ds), np.asarray(counts)
    for y in range(h):
        want = sorted(zip(src_x[y][keep[y]].tolist(), d[y][keep[y]].tolist()))
        c = counts[y]
        assert c == len(want)
        assert list(zip(xs[y, :c].tolist(), ds[y, :c].tolist())) == want
        assert (xs[y, c:] == 0).all() and (ds[y, c:] == 0).all()


def test_resolve_masked_compact_chunks_ratio_rule():
    """Single-parameter derivation follows MASKED_COMPACT_CHUNKS' tuned
    K/S ratio (review finding: a hardcoded 1/2 would silently diverge
    from a retuned constant); k > chunk is rejected."""
    import pytest

    from opengpc_tpu.match import (MASKED_COMPACT_CHUNKS,
                                   resolve_masked_compact_chunks)

    s0, k0 = MASKED_COMPACT_CHUNKS
    assert resolve_masked_compact_chunks() == (s0, k0)
    assert resolve_masked_compact_chunks(chunk=2 * s0) == (2 * s0, 2 * k0)
    assert resolve_masked_compact_chunks(k=2 * k0) == (2 * s0, 2 * k0)
    assert resolve_masked_compact_chunks(chunk=64, k=64) == (64, 64)
    with pytest.raises(ValueError):
        resolve_masked_compact_chunks(chunk=64, k=65)

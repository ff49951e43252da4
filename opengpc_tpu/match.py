"""On-device unique-collision matching.

Replaces both reference matchers (hash table hashmatch.hpp:42-273 and
sort+sweep inference.hpp:227-254) with one data-parallel design: sort the
descriptors of both images together by (validity, state) and detect runs
of *exactly two* equal states coming from *different* images — which is
precisely the reference's "state unique in both images and equal" rule
(SURVEY.md §3.4).

Two layouts:

* epipolar mode — the reference packs y into the upper state bits
  (inference.hpp:192-197) so only same-row codes collide.  Here that
  becomes a *per-row* segmented sort over the row-concatenated pair
  (H, 2W): H independent small sorts instead of one big 64-bit sort,
  with no extra key bits.
* global mode — one flat sort over both images; the vertical-tolerance
  filter (inference.hpp:384-391) applies afterwards.

Output is a fixed-capacity support buffer plus a match count (device
pipelines keep static shapes; compaction is a sort by position/packed key,
see compact()).

Deliberate deviation from the reference, pinned by tests: the reference
sweep never emits a match landing on the last target element and skips
the uniqueness check when a duplicate pair occupies the last two target
slots (inference.hpp:243-250).  We implement the clean rule; the C++
oracle implements both for differential testing.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _pair_starts(invalid: jnp.ndarray, code: jnp.ndarray, flag: jnp.ndarray):
    """Given sorted (…, N) keys, return mask over positions i in [0, N-1)
    marking runs of exactly two equal valid codes with differing flags.

    Works on the last axis for any leading batch shape.
    """
    both_valid = (invalid[..., :-1] == 0) & (invalid[..., 1:] == 0)
    eq = (code[..., :-1] == code[..., 1:]) & both_valid  # i ~ i+1
    # eq shifted: prev[i] = eq[i-1], nxt[i] = eq[i+1]
    zeros = jnp.zeros_like(eq[..., :1])
    prev = jnp.concatenate([zeros, eq[..., :-1]], axis=-1)
    nxt = jnp.concatenate([eq[..., 1:], zeros], axis=-1)
    pair = eq & ~prev & ~nxt
    cross = flag[..., :-1] != flag[..., 1:]
    return pair & cross


def compact(mask: jnp.ndarray, values: Tuple[jnp.ndarray, ...], capacity: int):
    """Gather ``values[mask]`` into fixed-size buffers, preserving flat
    mask order.  Returns (compacted values, count).  Entries beyond
    ``capacity`` are dropped; ``count`` is the true number of matches.

    Implemented as ONE unstable flat sort by a position key (matched
    entries keep their flat index, others get the max sentinel) with the
    values as payload operands, instead of the cumsum+scatter
    formulation (which of the two is faster on the GPU is not yet
    measured; ROADMAP Speed 4).  Prefer :func:`compact_packed` in hot
    paths — packing the payload into the key makes the sort
    single-operand.
    """
    mask_f = mask.reshape(-1)
    n = mask_f.shape[0]
    count = jnp.sum(mask_f, dtype=jnp.int32)
    key = jnp.where(mask_f, jnp.arange(n, dtype=jnp.int32),
                    jnp.int32(0x7FFFFFFF))
    ops = jax.lax.sort(
        (key,) + tuple(v.reshape(-1) for v in values),
        dimension=0, num_keys=1, is_stable=False,
    )
    k = min(n, capacity)
    slot_ok = jnp.arange(capacity, dtype=jnp.int32) < count
    outs = []
    for o in ops[1:]:
        buf = o[:k]
        if k < capacity:
            buf = jnp.pad(buf, (0, capacity - k))
        outs.append(jnp.where(slot_ok, buf, 0).astype(o.dtype))
    return tuple(outs), count


def compact_packed(mask: jnp.ndarray, fields, capacity: int):
    """Single-operand sort compaction: every payload field is bit-packed
    into the int32 sort key, so compaction costs one key-only flat sort.

    ``fields``: tuple of ``(array, n_bits)`` with values already offset to
    non-negative ints below ``2**n_bits``; total bits must be <= 30
    (callers check — the sentinel must stay above every packed value).
    Returns (unpacked fields, count).  Output order is by packed tuple
    value — row-major (y, x, ...) for the matchers' (y, x, d) layout —
    not flat mask order like :func:`compact`.
    """
    total = sum(b for _, b in fields)
    assert total <= 30, total
    key = jnp.zeros(mask.shape, jnp.int32)
    for arr, b in fields:
        key = (key << b) | arr.astype(jnp.int32)
    key = jnp.where(mask, key, jnp.int32(0x7FFFFFFF)).reshape(-1)
    n = key.shape[0]
    count = jnp.sum(mask, dtype=jnp.int32)
    key_s = jax.lax.sort((key,), dimension=0, num_keys=1, is_stable=False)[0]
    k = min(n, capacity)
    buf = key_s[:k]
    if k < capacity:
        buf = jnp.pad(buf, (0, capacity - k), constant_values=0x7FFFFFFF)
    slot_ok = jnp.arange(capacity, dtype=jnp.int32) < count
    outs = []
    shift = total
    for _, b in fields:
        shift -= b
        outs.append(jnp.where(slot_ok, (buf >> shift) & ((1 << b) - 1), 0))
    return tuple(outs), count


def _compact_supports(keep, src_x, ycoord, d, capacity, w, h, disp_high):
    """(x, y, d) support compaction: packed single-operand sort when the
    coordinate/disparity ranges fit in 30 bits (any image under ~1 Gpix),
    generic payload sort otherwise."""
    bx = max(1, int(w - 1).bit_length())
    by = max(1, int(h - 1).bit_length())
    bd = max(1, int(2 * disp_high).bit_length())
    if by + bx + bd <= 30:
        (ys, xs, dp), count = compact_packed(
            keep, ((ycoord, by), (src_x, bx), (d + disp_high, bd)), capacity
        )
        slot_ok = jnp.arange(capacity, dtype=jnp.int32) < count
        return (xs, ys, jnp.where(slot_ok, dp - disp_high, 0)), count
    return compact(keep, (src_x, ycoord, d), capacity)


SENTINEL_BASE = 0x40000000  # above any <=30-bit leaf code


def _pos_bits(w2: int) -> int:
    return int(w2 - 1).bit_length()


def _pack_ok(num_tests, w2) -> bool:
    """True when code and position can share ONE int32 sort key: valid
    packed keys (code << pos_bits | pos) stay below SENTINEL_BASE, and the
    per-position sentinels pass through UNCHANGED (they already encode
    their position), so the matcher sort drops its payload operand
    entirely (3.4x faster on the CPU sort).  Small forests only: 17
    tests at Sintel width (pos_bits 11), 19 at W<=256."""
    return num_tests is not None and num_tests + _pos_bits(w2) <= 30


def _pack_keypos(key, pos, pb):
    """Pack pos into the low ``pb`` bits of a valid code key; per-position
    sentinels pass through UNCHANGED (they already encode their position).
    The ONE definition of the single-operand key layout — _unpack_keypos
    is its inverse and every packed-sort path shares the pair."""
    return jnp.where(key < SENTINEL_BASE, (key << pb) | pos, key)


def _unpack_keypos(packed, pb):
    """Inverse of _pack_keypos: recover (key, pos) from packed keys."""
    sent = packed >= SENTINEL_BASE
    key = jnp.where(sent, packed, packed >> pb)
    pos = jnp.where(sent, packed - SENTINEL_BASE,
                    packed & ((1 << pb) - 1))
    return key, pos


def _sort_key_pos(key, pos, w2, num_tests):
    """The matcher's row sort: single-operand pos-packed when the code
    width allows (``_pack_ok``), the (key, pos) 2-operand UNSTABLE sort
    otherwise.  Returns (key_s, pos_s) either way — sentinels come back
    exactly as they went in."""
    if _pack_ok(num_tests, w2):
        pb = _pos_bits(w2)
        packed = _pack_keypos(key, pos, pb)
        packed_s = jax.lax.sort((packed,), dimension=1, num_keys=1,
                                is_stable=False)[0]
        return _unpack_keypos(packed_s, pb)
    # UNSTABLE sort: pair detection is order-insensitive (key equality +
    # lo/hi position normalization), and the emitted support set is
    # identical either way — two matched pairs always have different
    # codes, hence distinct sorted positions.  XLA implements a stable
    # sort by adding an iota tiebreaker to the comparator; dropping it
    # removes real comparator work
    return jax.lax.sort((key, pos), dimension=1, num_keys=1,
                        is_stable=False)


def match_epipolar(
    code_src: jnp.ndarray,
    code_tar: jnp.ndarray,
    valid_src: jnp.ndarray,
    valid_tar: jnp.ndarray,
    disp_high: int,
    capacity: int,
    packed: bool = False,
    num_tests=None,
):
    """Per-row unique-collision matching of two (H, W) code images.

    Returns ((x, y, d), count): support coordinates in the source image
    and disparity d = x_src - x_tar (may be negative; the reference's
    filter is |d| <= disp_high on both signs, inference.hpp:388).

    ``packed=True`` (valid only when codes fit in 30 bits, i.e. forests
    with <= 30 tests — callers check) replaces invalid pixels' codes with
    per-position sentinel values >= SENTINEL_BASE that are unique within a
    row and can never pair, collapsing the sort to ONE key and ONE payload
    operand — ~2x less sort traffic than the 4-operand layout.
    """
    if packed:
        return _match_epipolar_packed(
            code_src, code_tar, valid_src, valid_tar, disp_high, capacity,
            num_tests=num_tests,
        )
    h, w = code_src.shape
    code = jnp.concatenate([code_src, code_tar], axis=1)
    invalid = jnp.concatenate([~valid_src, ~valid_tar], axis=1).astype(jnp.int32)
    flag = jnp.concatenate(
        [jnp.zeros((h, w), jnp.int32), jnp.ones((h, w), jnp.int32)], axis=1
    )
    xcoord = jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32)[None, :], (h, w))
    xcoord = jnp.concatenate([xcoord, xcoord], axis=1)

    # UNSTABLE sort (stable adds an iota tiebreaker operand); a cross
    # pair's (src, tar) order is recovered from the flag, not from sort
    # stability
    invalid_s, code_s, flag_s, x_s = jax.lax.sort(
        (invalid, code, flag, xcoord), dimension=1, num_keys=2,
        is_stable=False,
    )
    is_match = _pair_starts(invalid_s, code_s, flag_s)  # (H, 2W-1)
    left_flag = flag_s[:, :-1]
    left_x, right_x = x_s[:, :-1], x_s[:, 1:]
    src_x = jnp.where(left_flag == 0, left_x, right_x)
    tar_x = jnp.where(left_flag == 0, right_x, left_x)
    d = src_x - tar_x
    keep = is_match & (jnp.abs(d) <= disp_high)
    ycoord = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[:, None], keep.shape)
    return _compact_supports(keep, src_x, ycoord, d, capacity, w, h, disp_high)


def _match_epipolar_packed(code_src, code_tar, valid_src, valid_tar,
                           disp_high, capacity, key=None, num_tests=None):
    if key is not None:
        # prebuilt (H, 2W) sentinel-packed key image (infer._key_image_jnp)
        h, w2 = key.shape
        w = w2 // 2
        pos = jnp.broadcast_to(
            jnp.arange(2 * w, dtype=jnp.int32)[None, :], (h, 2 * w)
        )
    else:
        h, w = code_src.shape
        code = jnp.concatenate([code_src, code_tar], axis=1)   # (H, 2W)
        valid = jnp.concatenate([valid_src, valid_tar], axis=1)
        pos = jnp.broadcast_to(
            jnp.arange(2 * w, dtype=jnp.int32)[None, :], (h, 2 * w)
        )
        # invalid pixels get unique-per-row sentinel keys: they can never
        # form a run of two equal keys, so no validity operand is needed in
        # the sort
        key = jnp.where(valid, code, SENTINEL_BASE + pos)

    # single-operand when the code width allows, (key, pos) UNSTABLE
    # sort otherwise — see _sort_key_pos
    key_s, pos_s = _sort_key_pos(key, pos, 2 * w, num_tests)
    keep, src_x, d = _detect_pairs_packed(key_s, pos_s, w, disp_high)
    if capacity is None:  # row-form output (match_epipolar_rows)
        return _row_pack(keep, src_x, d, w, disp_high)
    ycoord = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[:, None], keep.shape)
    return _compact_supports(keep, src_x, ycoord, d, capacity, w, h, disp_high)


def _detect_pairs_packed(key_s, pos_s, w, disp_high):
    """Pair detection over a row-sorted sentinel-packed key image: returns
    (keep, src_x, d) windows of shape (H, 2W-1)."""
    eq = key_s[:, :-1] == key_s[:, 1:]
    zeros = jnp.zeros_like(eq[:, :1])
    prev = jnp.concatenate([zeros, eq[:, :-1]], axis=1)
    nxt = jnp.concatenate([eq[:, 1:], zeros], axis=1)
    pair = eq & ~prev & ~nxt
    left_pos, right_pos = pos_s[:, :-1], pos_s[:, 1:]
    # the comparator is keys-only, so an equal (src, tar) pair may come out
    # in either order — normalize by position
    lo = jnp.minimum(left_pos, right_pos)
    hi = jnp.maximum(left_pos, right_pos)
    cross = (lo < w) & (hi >= w) & (hi < 2 * w)
    src_x = lo
    tar_x = hi - w
    d = src_x - tar_x
    keep = pair & cross & (jnp.abs(d) <= disp_high)
    return keep, src_x, d


MASKED_SENTINEL = 0x7FFFFFFF


def _masked_emit(keep, src_x, d, w, disp_high):
    """Shared masked-contract emit: pack detected supports as
    ``(src_x << bd) | (d + disp_high)`` in place, MASKED_SENTINEL
    elsewhere, one sentinel pad column, per-row counts.  The ONE place
    the masked pack layout lives (full-width + chunk-compacted matchers)."""
    bd = max(1, int(2 * disp_high).bit_length())
    bx = max(1, int(w - 1).bit_length())
    if bx + bd > 30:
        raise ValueError(
            f"masked pack needs x+d bits <= 30, got {bx}+{bd}; "
            "use match_epipolar"
        )
    out = jnp.where(keep, (src_x << bd) | (d + disp_high),
                    jnp.int32(MASKED_SENTINEL))
    out = jnp.pad(out, ((0, 0), (0, 1)), constant_values=MASKED_SENTINEL)
    counts = jnp.sum(keep, axis=1, dtype=jnp.int32)
    return out, counts


def match_epipolar_masked(code_src, code_tar, valid_src, valid_tar,
                          disp_high, key=None, num_tests=None):
    """MASKED sorted-order epipolar matcher — the minimum-device-work
    output contract: one row sort, pair detection, and a masked emit; NO
    packing sort at all (the row-form contract's work minus its pack).

    Returns (buf (H, 2W) int32, row_counts (H,)): window position i of row
    y holds ``(src_x << bd) | (d + disp_high)`` where a support was
    detected and MASKED_SENTINEL elsewhere (bd = bit_length(2*disp_high)).
    Supports appear in code-sorted order within each row — the same SET as
    every other contract (decode with infer.masked_supports_to_numpy).

    The extraction work the pack sort used to do moves to the consumer:
    host-side it is one vectorized np.nonzero; device-resident consumers
    can reduce over the masked buffer directly.  Same eligibility as
    match_epipolar_rows (packable codes, x+d bits <= 30).
    """
    if key is None:
        h, w = code_src.shape
        code = jnp.concatenate([code_src, code_tar], axis=1)
        valid = jnp.concatenate([valid_src, valid_tar], axis=1)
        pos = jnp.broadcast_to(
            jnp.arange(2 * w, dtype=jnp.int32)[None, :], (h, 2 * w)
        )
        key = jnp.where(valid, code, SENTINEL_BASE + pos)
    else:
        h, w2 = key.shape
        w = w2 // 2
        pos = jnp.broadcast_to(
            jnp.arange(2 * w, dtype=jnp.int32)[None, :], (h, 2 * w)
        )
    key_s, pos_s = _sort_key_pos(key, pos, 2 * w, num_tests)
    keep, src_x, d = _detect_pairs_packed(key_s, pos_s, w, disp_high)
    return _masked_emit(keep, src_x, d, w, disp_high)


# default (chunk, k) for the chunk-compacted masked contract: S=128/K=64,
# the best of an earlier low-density sweep (not yet re-swept on the GPU);
# the K/S=1/2 ratio makes the guard an effective per-row capacity of W
MASKED_COMPACT_CHUNKS = (128, 64)


def resolve_masked_compact_chunks(chunk=None, k=None):
    """The ONE derivation rule for masked-compact (chunk, k): both None ->
    MASKED_COMPACT_CHUNKS; one None -> derived keeping the tuned
    MASKED_COMPACT_CHUNKS K/S ratio; k > chunk rejected.  Every public builder routes through this
    so retuning MASKED_COMPACT_CHUNKS retunes the whole surface (CLI auto
    threshold, AOT, batched/sharded builders, pyramid) consistently."""
    s0, k0 = MASKED_COMPACT_CHUNKS
    if chunk is None and k is None:
        chunk, k = s0, k0
    elif chunk is None:
        chunk = k * (s0 // k0)  # keep the tuned K/S ratio, not a fixed 1/2
    elif k is None:
        k = max(1, chunk * k0 // s0)
    if k > chunk:
        raise ValueError(
            f"masked-compact chunk capacity k={k} exceeds chunk size "
            f"S={chunk}; pass k <= chunk")
    return chunk, k


def match_epipolar_masked_compact(key, disp_high, chunk: int = None,
                                  k: int = None, num_tests=None,
                                  row_overflow: bool = False):
    """Low-density fast path of the masked contract: STRIDED chunked
    pre-compaction shrinks the matcher sort at realistic (~15%) candidate
    density, with the exact support set.

    Each (2W) key row is split into nc = 2W/chunk STRIDED chunks (chunk c
    holds positions p with p % nc == c, so texture-patch candidate
    clusters spread uniformly; contiguous chunking overflows on real
    sparsity — measured).  Each chunk is sorted (valid codes <
    SENTINEL_BASE sort left), its first ``k`` columns survive, and one
    narrower (nc*k) row sort finishes the row.  Exactness guard: if any
    chunk holds more than ``k`` candidates the returned ``overflow`` flag
    is True and the caller MUST re-run the full-width matcher
    (match_epipolar_masked) — with k = chunk/2 the guard is an effective
    per-row candidate capacity of W, so it trips on ~>=50%-dense rows
    (the 79%-density bench scene trips it; the 15% scene never does).

    Returns (buf (H, nc*k) int32, row_counts (H,), overflow bool[]).
    ``buf`` decodes with infer.masked_supports_to_numpy exactly like the
    full-width masked buffer (same packing, narrower rows).  With
    ``row_overflow=True`` the flag is per ROW ((H,) bool — did any of
    this row's chunks overflow) so folded callers (the batched pyramid's
    (B*hs, 2W) stacking) can attribute overflow back to the pair it came
    from; the scalar flag is its ``any()``.
    """
    h, w2 = key.shape
    w = w2 // 2
    chunk, k = resolve_masked_compact_chunks(chunk, k)
    pos = jnp.broadcast_to(jnp.arange(w2, dtype=jnp.int32)[None, :], (h, w2))
    if w2 % chunk:
        # pad to a chunk multiple with unique non-pairing sentinels
        # (positions >= 2W can never pass the cross check)
        padn = chunk - w2 % chunk
        pad_pos = jnp.broadcast_to(
            jnp.arange(w2, w2 + padn, dtype=jnp.int32)[None, :], (h, padn))
        key = jnp.concatenate([key, SENTINEL_BASE + pad_pos], axis=1)
        pos = jnp.concatenate([pos, pad_pos], axis=1)
    w2p = key.shape[1]
    nc = w2p // chunk
    if _pack_ok(num_tests, w2p):
        # single-operand variant: pos rides inside the key through BOTH
        # sorts (chunk stage and final), halving the sort traffic of each
        pb = _pos_bits(w2p)
        packed = _pack_keypos(key, pos, pb)
        kc = packed.reshape(h, chunk, nc).transpose(0, 2, 1).reshape(
            h * nc, chunk)
        vc = jnp.sum(kc < SENTINEL_BASE, axis=1, dtype=jnp.int32)
        overflow = ((vc > k).reshape(h, nc).any(axis=1) if row_overflow
                    else jnp.any(vc > k))
        ks = jax.lax.sort((kc,), dimension=1, num_keys=1,
                          is_stable=False)[0]
        ks = ks[:, :k].reshape(h, nc * k)
        packed_s = jax.lax.sort((ks,), dimension=1, num_keys=1,
                                is_stable=False)[0]
        key_s, pos_s = _unpack_keypos(packed_s, pb)
    else:
        kc = key.reshape(h, chunk, nc).transpose(0, 2, 1).reshape(
            h * nc, chunk)
        pc = pos.reshape(h, chunk, nc).transpose(0, 2, 1).reshape(
            h * nc, chunk)
        vc = jnp.sum(kc < SENTINEL_BASE, axis=1, dtype=jnp.int32)
        overflow = ((vc > k).reshape(h, nc).any(axis=1) if row_overflow
                    else jnp.any(vc > k))
        ks, ps = jax.lax.sort((kc, pc), dimension=1, num_keys=1,
                              is_stable=False)
        ks = ks[:, :k].reshape(h, nc * k)
        ps = ps[:, :k].reshape(h, nc * k)
        key_s, pos_s = jax.lax.sort((ks, ps), dimension=1, num_keys=1,
                                    is_stable=False)
    keep, src_x, d = _detect_pairs_packed(key_s, pos_s, w, disp_high)
    out, counts = _masked_emit(keep, src_x, d, w, disp_high)
    return out, counts, overflow


def _row_pack(keep, src_x, d, w, disp_high):
    """Row-form support output: per-row left-packed (xs, ds) buffers plus
    per-row counts — no flat assembly at all.  Packing is one single-
    operand ROW sort ((x, d) in the key) instead of the flat
    compaction sort; the flat (n, 3) array is assembled host-side by
    infer.row_supports_to_numpy.  At most W supports per row (each uses
    two sorted slots), so the (H, W) slice is lossless."""
    h, wn = keep.shape
    bd = max(1, int(2 * disp_high).bit_length())
    bx = max(1, int(w - 1).bit_length())
    if bx + bd > 30:
        # callers gate on infer._rows_ok, which includes this bound; raise
        # a real error (not an assert) for direct match_epipolar_rows users
        raise ValueError(
            f"row-form pack key needs x+d bits <= 30, got {bx}+{bd}; "
            "use the flat matcher (match_epipolar) for this width/disp_high"
        )
    key = jnp.where(keep, (src_x << bd) | (d + disp_high),
                    jnp.int32(0x7FFFFFFF))
    key_s = jax.lax.sort((key,), dimension=1, num_keys=1,
                         is_stable=False)[0][:, :w]
    counts = jnp.sum(keep, axis=1, dtype=jnp.int32)
    slot_ok = jnp.arange(w, dtype=jnp.int32)[None, :] < counts[:, None]
    xs = jnp.where(slot_ok, key_s >> bd, 0)
    ds = jnp.where(slot_ok, (key_s & ((1 << bd) - 1)) - disp_high, 0)
    return (xs, ds), counts


def match_epipolar_rows(code_src, code_tar, valid_src, valid_tar, disp_high,
                        key=None, num_tests=None):
    """Row-form epipolar matcher: ((xs (H, W), ds (H, W)), row_counts (H,)).

    Same unique-collision semantics as match_epipolar(packed=True) but the
    supports stay in per-row left-packed buffers — skipping the flat
    compaction sort entirely (the costliest stage of the flat
    pipeline).  Row y's supports are
    (xs[y, :c], y, ds[y, :c]) with c = row_counts[y], ordered by x.
    """
    return _match_epipolar_packed(code_src, code_tar, valid_src, valid_tar,
                                  disp_high, capacity=None, key=key,
                                  num_tests=num_tests)


def _global_pairs(code_src, code_tar, valid_src, valid_tar, packed=False):
    """Sorted-pair scaffolding shared by the global matchers: returns
    (is_match, src_x, src_y, tar_x, tar_y) windows over the sorted
    concatenation of both images' descriptors.

    ``packed=True`` (codes < 2^30 and 2*H*W < 2^30) sorts one sentinel-
    masked key plus one position payload instead of 5 operands."""
    h, w = code_src.shape
    n = h * w
    code = jnp.concatenate([code_src.reshape(-1), code_tar.reshape(-1)])

    if packed:
        valid = jnp.concatenate([valid_src.reshape(-1), valid_tar.reshape(-1)])
        pos = jnp.arange(2 * n, dtype=jnp.int32)
        key = jnp.where(valid, code, SENTINEL_BASE + pos)
        key_s, pos_s = jax.lax.sort((key, pos), dimension=0, num_keys=1,
                                    is_stable=False)
        eq = key_s[:-1] == key_s[1:]
        zeros = jnp.zeros_like(eq[:1])
        prev = jnp.concatenate([zeros, eq[:-1]])
        nxt = jnp.concatenate([eq[1:], zeros])
        # unstable sort: normalize the (src, tar) pair order by position
        # (src positions are < n); see _match_epipolar_packed
        lo = jnp.minimum(pos_s[:-1], pos_s[1:])
        hi = jnp.maximum(pos_s[:-1], pos_s[1:])
        is_match = eq & ~prev & ~nxt & (lo < n) & (hi >= n)
        src_idx = lo
        tar_idx = hi - n
        return (
            is_match,
            src_idx % w, src_idx // w,
            tar_idx % w, tar_idx // w,
        )

    invalid = jnp.concatenate(
        [~valid_src.reshape(-1), ~valid_tar.reshape(-1)]
    ).astype(jnp.int32)
    flag = jnp.concatenate([jnp.zeros(n, jnp.int32), jnp.ones(n, jnp.int32)])
    xc = jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32)[None, :], (h, w)).reshape(-1)
    yc = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[:, None], (h, w)).reshape(-1)
    xcoord = jnp.concatenate([xc, xc])
    ycoord = jnp.concatenate([yc, yc])

    invalid_s, code_s, flag_s, x_s, y_s = jax.lax.sort(
        (invalid, code, flag, xcoord, ycoord), dimension=0, num_keys=2,
        is_stable=False,
    )
    is_match = _pair_starts(invalid_s, code_s, flag_s)
    # unstable sort: recover each pair's (src, tar) order from the flag
    src_is_left = flag_s[:-1] == 0
    src_x = jnp.where(src_is_left, x_s[:-1], x_s[1:])
    src_y = jnp.where(src_is_left, y_s[:-1], y_s[1:])
    tar_x = jnp.where(src_is_left, x_s[1:], x_s[:-1])
    tar_y = jnp.where(src_is_left, y_s[1:], y_s[:-1])
    return is_match, src_x, src_y, tar_x, tar_y


def match_global(
    code_src: jnp.ndarray,
    code_tar: jnp.ndarray,
    valid_src: jnp.ndarray,
    valid_tar: jnp.ndarray,
    disp_high: int,
    vertical_tolerance: int,
    capacity: int,
    packed: bool = False,
):
    """Global (non-epipolar) unique-collision matching of two (H, W) code
    images, with the rectified-match epipolar/disparity filter applied
    (inference.hpp:384-391)."""
    is_match, src_x, src_y, tar_x, tar_y = _global_pairs(
        code_src, code_tar, valid_src, valid_tar, packed
    )
    d = src_x - tar_x
    keep = (
        is_match
        & (jnp.abs(d) <= disp_high)
        & (jnp.abs(src_y - tar_y) <= vertical_tolerance)
    )
    h, w = code_src.shape
    return _compact_supports(keep, src_x, src_y, d, capacity, w, h, disp_high)


def match_global_rows(
    key_img: jnp.ndarray,
    w: int,
    disp_high: int,
    vertical_tolerance: int,
    num_rows: int = 0,
    y_offset: int = 0,
):
    """Global (non-epipolar) unique-collision matching with SEGMENTED
    row-form output — the global analog of match_epipolar_rows.

    ``key_img``: (H, 2W) sentinel-packed key image (source columns [0, W),
    target [W, 2W); invalid pixels carry unique sentinels >= SENTINEL_BASE,
    exactly what infer._key_image_jnp emits).

    One flat 2-operand sort finds the globally-unique collisions (the
    uniqueness domain spans the whole image pair, inference.hpp:227-254);
    the supports are then packed with ONE cheap segmented row sort over the
    (R, C) reshape of the sorted order, instead of the flat-contract
    compaction sort over all 2HW elements (the flat contract's costliest
    stage).  Rows are arbitrary C-length segments
    of the code-sorted order — row r's supports are (xs[r, :c], ys[r, :c],
    ds[r, :c]) with c = counts[r]; assemble with
    infer.global_row_supports_to_numpy.

    Packing needs y, x and d bits to fit 30 (callers gate; ~any frame
    under 0.5 Gpix with sane disp_high).

    ``y_offset``: row index of key_img's first row in the full image —
    callers that slice the all-sentinel candidate-margin rows off the key
    image before the flat sort (infer._interior_rows) pass the margin here
    so emitted y coordinates stay in full-image space.
    """
    h, w2 = key_img.shape
    assert w2 == 2 * w
    return _global_rows_core(key_img.reshape(-1),
                             jnp.arange(h * w2, dtype=jnp.int32), w, w2, h,
                             disp_high, vertical_tolerance, num_rows,
                             y_offset)


def _global_rows_core(key, pos, w, w2, h, disp_high, vertical_tolerance,
                      num_rows, y_offset):
    """Shared core of the segmented global contracts: ONE flat 2-operand
    sort of (key, pos) finds the globally-unique collisions, then a cheap
    segmented row sort packs the (R, C) output.  ``pos`` values decode as
    (row, col) of the original (h, w2) key image via divmod(w2); entries
    whose keys are globally unique (pads, sentinels) are never emitted, so
    their pos may be arbitrary."""
    n = key.shape[0]
    key_s, pos_s = jax.lax.sort((key, pos), dimension=0, num_keys=1,
                                is_stable=False)
    eq = key_s[:-1] == key_s[1:]
    zeros = jnp.zeros_like(eq[:1])
    prev = jnp.concatenate([zeros, eq[:-1]])
    nxt = jnp.concatenate([eq[1:], zeros])
    pair = eq & ~prev & ~nxt
    # decode the (H, 2W) layout: col < W -> source pixel.  Equal sentinels
    # can only collide within one image (disjoint src/tar sentinel ranges),
    # so the cross check below rejects them like any same-image run.
    col_l, row_l = pos_s[:-1] % w2, pos_s[:-1] // w2
    col_r, row_r = pos_s[1:] % w2, pos_s[1:] // w2
    l_is_src = col_l < w
    src_x = jnp.where(l_is_src, col_l, col_r)
    src_y = jnp.where(l_is_src, row_l, row_r)
    tar_c = jnp.where(l_is_src, col_r, col_l)
    tar_y = jnp.where(l_is_src, row_r, row_l)
    cross = (src_x < w) & (tar_c >= w)
    d = src_x - (tar_c - w)
    keep = (
        pair & cross
        & (jnp.abs(d) <= disp_high)
        & (jnp.abs(src_y - tar_y) <= vertical_tolerance)
    )
    if y_offset:
        # back to full-image row coordinates (the offset cancels in the
        # |src_y - tar_y| tolerance check above, so only the emitted y
        # needs it)
        src_y = src_y + jnp.int32(y_offset)
    # pad the (n-1,) windows to n and reshape into segments
    r = num_rows if num_rows > 0 else h
    c = -(-n // r)
    padn = r * c - (n - 1)
    keep = jnp.pad(keep, (0, padn))
    src_x = jnp.pad(src_x, (0, padn))
    src_y = jnp.pad(src_y, (0, padn))
    d = jnp.pad(d, (0, padn))
    bx = max(1, int(w - 1).bit_length())
    by = max(1, int(h - 1 + y_offset).bit_length())
    bd = max(1, int(2 * disp_high).bit_length())
    if by + bx + bd > 30:
        raise ValueError(
            f"global row-form pack needs y+x+d bits <= 30, got "
            f"{by}+{bx}+{bd}; use match_global"
        )
    pk = jnp.where(
        keep,
        (((src_y << bx) | src_x) << bd) | (d + disp_high),
        jnp.int32(0x7FFFFFFF),
    ).reshape(r, c)
    pk_s = jax.lax.sort((pk,), dimension=1, num_keys=1, is_stable=False)[0]
    counts = jnp.sum(keep.reshape(r, c), axis=1, dtype=jnp.int32)
    slot_ok = jnp.arange(c, dtype=jnp.int32)[None, :] < counts[:, None]
    ds = jnp.where(slot_ok, (pk_s & ((1 << bd) - 1)) - disp_high, 0)
    xs = jnp.where(slot_ok, (pk_s >> bd) & ((1 << bx) - 1), 0)
    ys = jnp.where(slot_ok, pk_s >> (bd + bx), 0)
    return (xs, ys, ds), counts


def global_compact_chunks(w2: int):
    """Default (chunk, k) for the chunk-compacted global contract.  Wide
    rows (w2 >= 2048) take the deep K/S=1/4 ratio (S=512/K=128, the best
    of an earlier Sintel-sized sweep, not yet re-swept on the GPU);
    narrower rows keep K/S=1/2 (the masked-compact rule, effective
    per-row capacity W) because the strided chunk count collapses at
    small widths and a 1/4 capacity then overflows on ordinary
    patch-textured rows."""
    return (512, 128) if w2 >= 2048 else (128, 64)


def resolve_global_compact_chunks(w2: int, chunk=None, k=None):
    """Resolve the global-compact (chunk, k) pair from the width rule
    (:func:`global_compact_chunks`), deriving a missing parameter with the
    rule's K/S ratio so a single-parameter tuning call can't mix
    incompatible defaults — the global twin of
    resolve_masked_compact_chunks, shared by match_global_rows_compact and
    the sharded-frame global builder."""
    dchunk, dk = global_compact_chunks(w2)
    if chunk is None and k is None:
        chunk, k = dchunk, dk
    elif chunk is None:
        chunk = k * (dchunk // dk)
    elif k is None:
        k = max(1, chunk // (dchunk // dk))
    if k > chunk:
        raise ValueError(
            f"global-compact chunk capacity k={k} exceeds chunk size "
            f"S={chunk}; pass k <= chunk (width defaults: "
            "match.global_compact_chunks)")
    return chunk, k


def match_global_rows_compact(key_img: jnp.ndarray, w: int, disp_high: int,
                              vertical_tolerance: int, chunk: int = None,
                              k: int = None, num_rows: int = 0,
                              y_offset: int = 0):
    """Low-density fast path of the global contract: STRIDED chunked
    pre-compaction shrinks the flat global sort — match_global_rows' cost
    is ONE density-independent sort over all 2HW elements, and at
    realistic candidate density most of that input is never-colliding
    sentinels (larger chunks, S=512/K=128, tolerate more local clustering
    than the masked contract's S=128).

    Each (2W) key row splits into nc strided chunks (chunk c holds
    positions {p : p % nc == c}); each chunk is sorted (valid codes <
    SENTINEL_BASE sort left) and its first ``k`` columns survive, so the
    flat uniqueness sort runs on H*nc*k = 2HW*(K/S) elements.  Exactness
    (overflow False):

    - every VALID candidate survives (the guard asserts no chunk holds
      more than ``k``), so the multiset of valid codes — the global
      uniqueness domain (inference.hpp:227-254) — is unchanged;
    - dropped elements are all sentinels.  Dropping sentinels can change
      equal-sentinel run LENGTHS (a column with three invalid pixels can
      drop to two, forming a new "pair"), but equal sentinels are always
      same-image same-column (src sentinels are SENTINEL_BASE + [0, W),
      tar + [W, 2W)), so the cross check rejects every such pair — the
      same argument match_global_rows already relies on.

    If ``overflow`` is True the caller MUST re-run match_global_rows.
    Returns ``((xs, ys, ds), counts, overflow)``; segment geometry is
    (R, C') with C' = ceil(H*nc*k / R) — decode with
    infer.global_row_supports_to_numpy exactly like the full contract.
    """
    h, w2 = key_img.shape
    assert w2 == 2 * w
    chunk, k = resolve_global_compact_chunks(w2, chunk, k)
    pos = (jnp.arange(h, dtype=jnp.int32)[:, None] * w2
           + jnp.arange(w2, dtype=jnp.int32)[None, :])
    ks, ps, overflow = _strided_chunk_compact(key_img, pos, chunk, k,
                                              pos_never=h * w2)
    out = _global_rows_core(ks, ps, w, w2, h, disp_high,
                            vertical_tolerance, num_rows, y_offset)
    return out + (overflow,)


def _strided_chunk_compact(key_img, pos_img, chunk: int, k: int,
                           pos_never: int):
    """Strided chunked pre-compaction shared by the single-device
    (match_global_rows_compact) and sharded-frame
    (parallel.build_sharded_frame_sparsematch contract="global-compact")
    global fast paths: each key row splits into nc strided chunks (chunk c
    holds columns {j : j % nc == c}), each chunk sorts (valid codes <
    SENTINEL_BASE sort left) and its first ``k`` columns survive.

    ``pos_img`` carries the caller's position payload (GLOBAL flat
    positions in the sharded case); ``pos_never`` is the payload given to
    the chunk-multiple column pads (never emitted — pad keys are unique,
    so they cannot form equal runs).  Returns
    ``(keys (h*nc*k,), pos (h*nc*k,), overflow)`` with ``overflow`` True
    iff some chunk held more than ``k`` valid candidates (the exactness
    guard: the caller must then re-run a full-width contract)."""
    h, w2 = key_img.shape
    if w2 % chunk:
        # pad to a chunk multiple with keys unique within this image and
        # above every real sentinel (real sentinels are
        # SENTINEL_BASE + [0, 2W)), so pads can never form an equal run
        padn = chunk - w2 % chunk
        pad_k = (SENTINEL_BASE + w2
                 + jnp.arange(h, dtype=jnp.int32)[:, None] * padn
                 + jnp.arange(padn, dtype=jnp.int32)[None, :])
        key_img = jnp.concatenate([key_img, pad_k], axis=1)
        pos_img = jnp.concatenate(
            [pos_img, jnp.full((h, padn), pos_never, dtype=jnp.int32)],
            axis=1)
    w2p = key_img.shape[1]
    nc = w2p // chunk
    kc = key_img.reshape(h, chunk, nc).transpose(0, 2, 1).reshape(
        h * nc, chunk)
    pc = pos_img.reshape(h, chunk, nc).transpose(0, 2, 1).reshape(
        h * nc, chunk)
    vc = jnp.sum(kc < SENTINEL_BASE, axis=1, dtype=jnp.int32)
    overflow = jnp.any(vc > k)
    ks, ps = jax.lax.sort((kc, pc), dimension=1, num_keys=1, is_stable=False)
    return ks[:, :k].reshape(-1), ps[:, :k].reshape(-1), overflow


def match_reference_quirk(
    desc_src, desc_tar, epipolar: bool = False
):
    """Host-side, bug-compatible reimplementation of the reference's exact
    sweep (findCorrespondences, inference.hpp:227-254), including its edge
    quirks: a match landing on the last target element is never emitted,
    and a duplicate pair occupying the last two target slots skips its
    uniqueness check.

    For users who need byte-identical behavior to the reference binary;
    the on-device matchers implement the clean unique-collision rule.

    ``desc_*``: (n, 3) int arrays of (x, y, state) rows (e.g. from
    infer.extract_descriptors).  Returns (m, 4) int array of
    (sx, sy, tx, ty).
    """
    import numpy as np

    def keyed(d):
        d = np.asarray(d, np.int64)
        state = d[:, 2].astype(np.uint64)
        if epipolar:
            state = state | (d[:, 1].astype(np.uint64) << np.uint64(32))
        order = np.argsort(state, kind="stable")
        return state[order], d[order, 0], d[order, 1]

    s_state, s_x, s_y = keyed(desc_src)
    t_state, t_x, t_y = keyed(desc_tar)
    out = []
    n = len(t_state)
    if n == 0:
        return np.zeros((0, 4), np.int32)
    j = 0
    i = 0
    while i < len(s_state):
        unique = True
        while i + 1 < len(s_state) and s_state[i] == s_state[i + 1]:
            i += 1
            unique = False
        if unique:
            while j < n - 1 and t_state[j] < s_state[i]:
                j += 1
            if (
                j != n - 1
                and t_state[j] == s_state[i]
                and (j + 1 == n - 1 or t_state[j] != t_state[j + 1])
            ):
                out.append((s_x[i], s_y[i], t_x[j], t_y[j]))
        i += 1
    return np.asarray(out, np.int32).reshape(-1, 4)


def match_hashmatch(
    desc_src, desc_tar, epipolar: bool = False,
    index_size: int = 214673, bucket_cap: int = 10,
):
    """Host-side, bug-compatible emulation of the reference's hash-table
    matcher (``useHashtable=true``; hashmatch.hpp:42-273, instantiated with
    214,673 buckets at inference.hpp:210-211) — the one matching behavior
    class the on-device sort matcher deliberately does NOT implement.

    Semantics: descriptors are inserted src-list first then tar-list into
    ``state % index_size`` buckets; each bucket is kept sorted by state
    (stable after equals) and CAPPED at ``bucket_cap`` elements — later
    arrivals are silently dropped (hashmatch.hpp:93-98).  A per-bucket
    adjacent sweep then emits states present exactly twice and from
    different images (hashmatch.hpp:162-197), with two pinned edge
    behaviors: an early bucket return when an equal third element is the
    bucket's last, and a skip-ahead after a same-image pair followed by a
    cross-image element.

    This diverges from the clean unique-collision rule: the bucket cap can
    both create matches (dropping the duplicates that would make a state
    non-unique — e.g. a state occurring 9x in src and 30x in tar keeps
    9 src + 1 tar and emits a bogus pair) and destroy them (dropping one
    element of a genuine pair in an overflowing bucket).  Differentially
    tested against the oracle's ``hashmatch`` command and, transitively,
    the real reference binary (tests/test_reference_binary.py).

    ``desc_*``: (n, 3) int arrays of (x, y, state) rows in candidate scan
    order (e.g. from infer.extract_descriptors).  Returns (m, 4) int array
    of (sx, sy, tx, ty) unfiltered pairs, like match_reference_quirk.
    """
    import numpy as np

    def states(d):
        d = np.asarray(d, np.int64)
        s = d[:, 2].astype(np.uint64)
        if epipolar:
            s = s | (d[:, 1].astype(np.uint64) << np.uint64(32))
        return s, d[:, 0], d[:, 1]

    buckets = {}

    def insert(state, x, y, is_src):
        b = buckets.setdefault(int(state % np.uint64(index_size)), [])
        if len(b) >= bucket_cap:
            return
        pos = 0
        while pos < len(b) and b[pos][0] <= state:
            pos += 1
        b.insert(pos, (int(state), int(x), int(y), is_src))

    for sd, is_src in ((desc_src, True), (desc_tar, False)):
        s, x, y = states(sd)
        for k in range(len(s)):
            insert(s[k], x[k], y[k], is_src)

    out = []
    for key in sorted(buckets):
        b = buckets[key]
        n = len(b)
        idx = 0
        while idx < n:
            prev = idx
            idx += 1
            if idx < n and b[prev][0] == b[idx][0]:
                if b[prev][3] != b[idx][3]:
                    if idx + 1 < n:
                        if b[idx + 1][0] != b[idx][0]:
                            out.append((b[prev][1], b[prev][2],
                                        b[idx][1], b[idx][2]))
                        if idx + 2 >= n:
                            break  # "checked the last triplet, leave"
                    else:
                        out.append((b[prev][1], b[prev][2],
                                    b[idx][1], b[idx][2]))
                elif idx + 1 < n and b[idx][3] != b[idx + 1][3]:
                    idx += 1  # skip the false same-image pair
    return np.asarray(out, np.int32).reshape(-1, 4)


def match_correspondences(
    code_src: jnp.ndarray,
    code_tar: jnp.ndarray,
    valid_src: jnp.ndarray,
    valid_tar: jnp.ndarray,
    capacity: int,
    packed: bool = False,
):
    """Unfiltered global unique-collision correspondences — the equivalent
    of the reference's stereoMatch/depthPriorFast output before the
    rectified filter (inference.hpp:184-361): ((sx, sy, tx, ty), count)."""
    is_match, src_x, src_y, tar_x, tar_y = _global_pairs(
        code_src, code_tar, valid_src, valid_tar, packed
    )
    return compact(is_match, (src_x, src_y, tar_x, tar_y), capacity)

"""Vectorized greedy fern-forest training.

Data-parallel recast of the reference trainer
(/root/reference/lib/gpc/Fern.hpp:209-393, training.hpp:87-160): instead of
re-walking all N triplets once per candidate test (O(N * depth) scalar loop
per candidate, Fern.hpp:341-350), one device pass scores a whole level's
candidate set at once:

* the triplet tensor is (N, 3, 729) uint8 (ref/pos/neg patches);
* per-triplet *code-prefix equality* flags (eq_pos, eq_neg) are carried
  across levels — code equality over levels [0, L] is just
  ``prefix_eq & (bit_ref == bit_other)``, so no codes are materialized;
* a level evaluates all (resample, tau) candidates in one
  ``lax.scan``-over-resamples x vectorized-over-tau pass, emitting integer
  TP/FP/FN counts;
* score selection happens on host in float64 with the reference's exact
  "strictly greater, first wins" rule (Fern.hpp:345-348), iterated
  resample-major then tau — bit-identical selection to the C++ oracle.

Decision convention (training side): bit = (patch[i] - patch[j] < tau)
(Feature.hpp:102-110).  NOTE the reference's inference kernel uses the
*different* test ``img[i] > img[j] - tau`` (filter.hpp:271-279); both
conventions are preserved exactly on their own side, as in the reference.

Deliberate deviations (documented, tested against the oracle where exact):
* RNG: explicit seeds via numpy Generator (the reference uses unseeded
  std::random_device, Feature.hpp:113-120); candidate *distributions* match
  sampleHyperplane (Feature.hpp:133-177).
* Bootstrap: samples with replacement from the WHOLE training set; the
  reference draws only from its first ``sampleFraction*N`` elements
  (training.hpp:117-128: the uniform distribution is capped at
  sampleFraction*N-1) — an off-by-design quirk we do not copy.
* The per-level stats table prints the stats of the chosen best candidate;
  the reference prints whatever candidate happened to be evaluated last
  (Fern.hpp:358-364 reads ``stats`` after the loops).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from opengpc_tpu.config import ForestSettings, OptimizerSettings
from opengpc_tpu.forest import (
    Fern,
    Forest,
    SCALE_HALF,
    Test,
    PATCH,
    PATCH_HALF,
)

# batched-fern training materializes the whole (F, sub_n, 3, 729) bootstrap
# stack on device at once; above this many bytes train_forest's default
# falls back to the fern-at-a-time loop rather than risk an OOM (explicit
# batch_ferns=True overrides)
BATCH_FERNS_BYTES_CAP = 1 << 30


@dataclasses.dataclass
class LevelStats:
    """Stats of the chosen split at one level (Fern.hpp:53-69).

    ``tp/fp/fn/tot`` are the exclusion-masked counts the greedy selection
    actually scored (evalSplit with the split markers in force,
    Fern.hpp:236,333-334); with ``only_score_non_split_samples=False`` they
    equal the unmasked counts.  ``tp_all/fp_all/fn_all`` classify ALL
    samples by the ≤level code prefix regardless of markers — the
    diagnostic the oracle's trainfern line also carries."""

    level: int
    i: int
    j: int
    tau: int
    tp: int
    fp: int
    fn: int
    tot: int
    prec: float
    rec: float
    hmean: float
    tp_all: int = 0
    fp_all: int = 0
    fn_all: int = 0


def sample_candidates(
    rng: np.random.Generator, scale: int, num: int
) -> np.ndarray:
    """Draw ``num`` distinct (i, j) patch-linear-index pairs inside the
    scale's centered sub-window (sampleHyperplane, Feature.hpp:133-177).

    Returns (num, 2) int32.  All scales map to the same linear layout
    ``(x+13) + 27*(y+13)`` (the reference's 280+/140+ arithmetic reduces
    to exactly this).
    """
    half = SCALE_HALF[scale]
    side = 2 * half + 1
    out = np.empty((num, 2), np.int32)
    for k in range(num):
        i = j = 0
        while True:
            i, j = rng.integers(0, side * side, size=2)
            if i != j:
                break
        ix, iy = i % side - half, i // side - half
        jx, jy = j % side - half, j // side - half
        out[k, 0] = (ix + PATCH_HALF) + PATCH * (iy + PATCH_HALF)
        out[k, 1] = (jx + PATCH_HALF) + PATCH * (jy + PATCH_HALF)
    return out


@functools.partial(jax.jit, static_argnames=("num_taus",))
def _score_level(
    patches: jnp.ndarray,      # (N, 3, 729) uint8
    cand: jnp.ndarray,         # (R, 2) int32 patch linear indices
    tau_lo: jnp.ndarray,       # () int32
    num_taus: int,             # static: tau count
    eq_pos: jnp.ndarray,       # (N,) bool — prefix code equality ref==pos
    eq_neg: jnp.ndarray,       # (N,) bool
    include: jnp.ndarray,      # (N,) bool — not yet excluded (split) samples
):
    """TP/FP/FN counts for every (resample, tau) candidate of one level.

    Returns (R, num_taus, 3) int32 counts.  One scan step gathers the two
    candidate pixels across all triplets ((N, 3) int16 diff), broadcasts
    over the tau axis, and reduces — the whole level is a few fused VPU
    passes over N instead of R*T scalar sweeps.
    """
    taus = tau_lo + jnp.arange(num_taus, dtype=jnp.int16)  # (T,)

    def one_resample(carry, ij):
        # gather the two candidate pixels from the uint8 tensor FIRST and
        # widen the tiny (N, 3) results — never materialize an int16 copy
        # of the whole dataset (2x memory at production N)
        vi = jnp.take(patches, ij[0], axis=2).astype(jnp.int16)  # (N, 3)
        vj = jnp.take(patches, ij[1], axis=2).astype(jnp.int16)
        diff = vi - vj                      # (N, 3)
        bits = diff[:, :, None] < taus[None, None, :]     # (N, 3, T)
        beq_pos = bits[:, 0, :] == bits[:, 1, :]          # (N, T)
        beq_neg = bits[:, 0, :] == bits[:, 2, :]
        ep = eq_pos[:, None] & beq_pos
        en = eq_neg[:, None] & beq_neg
        inc = include[:, None]
        tp = jnp.sum(ep & ~en & inc, axis=0, dtype=jnp.int32)      # (T,)
        fp = jnp.sum(~ep & en & inc, axis=0, dtype=jnp.int32)
        fn = jnp.sum((ep == en) & inc, axis=0, dtype=jnp.int32)
        return carry, jnp.stack([tp, fp, fn], axis=-1)             # (T, 3)

    _, counts = jax.lax.scan(one_resample, 0, cand)
    return counts  # (R, T, 3)


@jax.jit
def _apply_level(
    patches: jnp.ndarray,
    i: jnp.ndarray,
    j: jnp.ndarray,
    tau: jnp.ndarray,
    eq_pos: jnp.ndarray,
    eq_neg: jnp.ndarray,
):
    """Fold the chosen (i, j, tau) into the prefix equality flags."""
    vi = jnp.take(patches, i, axis=2).astype(jnp.int16)
    vj = jnp.take(patches, j, axis=2).astype(jnp.int16)
    bits = (vi - vj) < tau.astype(jnp.int16)  # (N, 3)
    return (
        eq_pos & (bits[:, 0] == bits[:, 1]),
        eq_neg & (bits[:, 0] == bits[:, 2]),
    )


@functools.partial(jax.jit, static_argnames=("num_taus",))
def _score_level_ferns(patches, cand, tau_lo, num_taus, eq_pos, eq_neg,
                       include):
    """One dispatch scoring the SAME level of F independent ferns:
    vmap over the fern axis of (F, N, 3, 729) bootstrap stacks and
    (F, R, 2) candidate sets.  Ferns are independent by construction
    (own bootstrap subsample, own greedy prefix — trainAndExport's loop,
    training.hpp:103-158), so batching them is exact; it just turns
    F*max_depth scorer dispatches into max_depth."""
    return jax.vmap(
        lambda p, c, ep, en, inc: _score_level(p, c, tau_lo, num_taus,
                                               ep, en, inc)
    )(patches, cand, eq_pos, eq_neg, include)


@jax.jit
def _apply_level_ferns(patches, i, j, tau, eq_pos, eq_neg):
    """Per-fern chosen-split fold over the stacked fern axis."""
    return jax.vmap(_apply_level)(patches, i, j, tau, eq_pos, eq_neg)


@jax.jit
def _include_and_tot_ferns(split_pos, split_neg):
    inc = ~(split_pos & split_neg)
    return inc, jnp.sum(inc, axis=1, dtype=jnp.int32)


@jax.jit
def _diag_counts_ferns(eq_pos, eq_neg, valid):
    tp = jnp.sum(eq_pos & ~eq_neg & valid, axis=1, dtype=jnp.int32)
    fp = jnp.sum(~eq_pos & eq_neg & valid, axis=1, dtype=jnp.int32)
    return tp, fp


@jax.jit
def _include_and_tot(split_pos, split_neg):
    """include mask (= not excluded by markSplitSamples) + its count, on
    device — a scalar fetch instead of an (N,) one, and safe on
    multi-process meshes where the flag arrays are not fully addressable
    host-side."""
    inc = ~(split_pos & split_neg)
    return inc, jnp.sum(inc, dtype=jnp.int32)


@jax.jit
def _mark_splits(split_pos, split_neg, eq_pos, eq_neg):
    """markSplitSamples (Fern.hpp:271-291) fold, on device: marks use the
    eq flags of the prefix EXCLUDING the just-chosen test."""
    return split_pos | eq_pos, split_neg | ~eq_neg


@jax.jit
def _diag_counts(eq_pos, eq_neg, valid):
    """Unmasked diagnostic TP/FP over the real (non-pad) triplets:
    TP = eqPos & !eqNeg, FP = !eqPos & eqNeg (Fern.hpp:236-252)."""
    tp = jnp.sum(eq_pos & ~eq_neg & valid, dtype=jnp.int32)
    fp = jnp.sum(~eq_pos & eq_neg & valid, dtype=jnp.int32)
    return tp, fp


def _hmean(tp: int, fp: int, fn: int, w1: float) -> Tuple[float, float, float]:
    """precision, recall, weighted harmonic mean (Fern.hpp:256-261)."""
    w2 = 1.0 - w1
    prec = 0.0 if tp + fp == 0 else tp / (tp + fp)
    rec = 0.0 if tp + fn == 0 else tp / (tp + fn)
    hmean = 0.0 if prec + rec == 0.0 else prec * rec / ((1.0 - w2) * prec + w2 * rec)
    return prec, rec, hmean


def _lin_to_xy(lin: int) -> Tuple[int, int]:
    return lin % PATCH - PATCH_HALF, lin // PATCH - PATCH_HALF


def _select_best(counts, cand, tau_lo: int, num_taus: int, w1: float):
    """Host-side greedy split selection over one level's (R, T, 3) counts:
    float64, strictly-greater-first-wins; if nothing scores > 0 the
    degenerate (0, 0, 0) split is kept (the reference would silently reuse
    the previous level's params via an uninitialized local,
    Fern.hpp:316-351 — not copied)."""
    best_score, best = 0.0, (0, 0, 0)
    best_counts = (0, 0, 0)
    for r in range(counts.shape[0]):
        for t in range(num_taus):
            tp, fp, fn = (int(v) for v in counts[r, t])
            _, _, hm = _hmean(tp, fp, fn, w1)
            if hm > best_score:
                best_score = hm
                best = (int(cand[r, 0]), int(cand[r, 1]), tau_lo + t)
                best_counts = (tp, fp, fn)
    return best, best_counts


def train_fern(
    triplets: np.ndarray,
    scale: int,
    optimizer: OptimizerSettings,
    max_depth: int,
    rng: Optional[np.random.Generator] = None,
    candidates: Optional[Sequence[np.ndarray]] = None,
    verbose: bool = True,
    mesh=None,
) -> Tuple[Fern, List[LevelStats]]:
    """Greedily train one fern (Fern::train, Fern.hpp:312-372).

    ``triplets``: (N, 3, 729) uint8.  Either ``rng`` (candidates drawn per
    level like sampleHyperplane) or ``candidates`` (a list of (R, 2) arrays
    of patch linear indices per level — the injection hook used for
    differential testing against the C++ oracle) must be given.

    ``mesh``: optional ``jax.sharding.Mesh`` with a "data" axis — the
    triplet axis is sharded over it and XLA turns the per-level count
    reductions into psums (data parallelism over triplets, the
    training analog of the reference's row-partitioned threads).
    """
    if candidates is None:
        if rng is None:
            raise ValueError("pass rng or explicit candidates")
        candidates = [
            sample_candidates(rng, scale, optimizer.num_resamples)
            for _ in range(max_depth)
        ]

    n = triplets.shape[0]
    n_pad = 0
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        # NamedSharding needs the triplet axis divisible by the mesh size:
        # pad with EXCLUDED triplets — their split flags start True (below),
        # so `include` masks them out of every level's counts and the
        # selected splits are identical to the unpadded run by construction
        n_dev = int(mesh.devices.size)
        n_pad = (-n) % n_dev
        if n_pad:
            triplets = np.concatenate(
                [np.asarray(triplets),
                 np.zeros((n_pad,) + triplets.shape[1:], triplets.dtype)])
        # exclusion markers (markSplitSamples) and the real-vs-pad mask
        # live ON DEVICE with the same sharding as the triplets: a
        # multi-process mesh cannot fetch them whole host-side, and the
        # per-level consumers only ever need scalar reductions anyway.
        # Pads start fully marked so they never enter a level's `include`.
        sp0 = np.zeros((n + n_pad,), bool)
        sp0[n:] = True
        valid0 = np.arange(n + n_pad) < n
        shard_n = NamedSharding(mesh, P("data"))
        patches = jax.device_put(jnp.asarray(triplets), shard_n)
        eq_pos = jax.device_put(np.ones((n + n_pad,), bool), shard_n)
        eq_neg = jax.device_put(np.ones((n + n_pad,), bool), shard_n)
        split_pos = jax.device_put(sp0, shard_n)
        split_neg = jax.device_put(sp0, shard_n)
        valid = jax.device_put(valid0, shard_n)
    else:
        patches = jnp.asarray(triplets)
        eq_pos = jnp.ones((n,), bool)
        eq_neg = jnp.ones((n,), bool)
        split_pos = jnp.zeros((n,), bool)
        split_neg = jnp.zeros((n,), bool)
        valid = jnp.ones((n,), bool)

    tau_lo, tau_hi = optimizer.tau_lo, optimizer.tau_hi
    num_taus = tau_hi - tau_lo
    chosen: List[Test] = []
    stats_out: List[LevelStats] = []

    if verbose:
        print(
            f"{'Level':>7}{'Prec':>10}{'Rec':>10}{'Har':>10}{'Tot':>8}"
            f"{'TP':>8}{'FP':>8}{'FN':>8}{'scale':>6}{'tau':>5}{'i':>5}{'j':>5}"
        )

    for level in range(max_depth):
        cand = np.asarray(candidates[level], np.int32)
        include, tot_dev = _include_and_tot(split_pos, split_neg)
        counts = np.asarray(
            _score_level(
                patches, jnp.asarray(cand), jnp.int32(tau_lo), num_taus,
                eq_pos, eq_neg, include,
            )
        )  # (R, T, 3)

        best, best_counts = _select_best(counts, cand, tau_lo, num_taus,
                                         optimizer.w1)
        bi, bj, btau = best
        if optimizer.only_score_non_split_samples:
            # markSplitSamples is called with numParams=level
            # (Fern.hpp:357,275): marks use the prefix EXCLUDING the
            # just-chosen test — i.e. the eq flags before this level's
            # fold.  (The level-0 call marks pos.split on the empty
            # prefix, which is vacuously true for every sample.)
            split_pos, split_neg = _mark_splits(split_pos, split_neg,
                                                eq_pos, eq_neg)
        eq_pos, eq_neg = _apply_level(
            patches, jnp.int32(bi), jnp.int32(bj), jnp.int32(btau), eq_pos, eq_neg
        )

        tp, fp, fn = best_counts
        tot = int(tot_dev)
        prec, rec, hm = _hmean(tp, fp, fn, optimizer.w1)
        # unmasked diagnostic counts, free from the post-fold eq flags
        # (the ≤level code-equality prefix), computed on device so a
        # multi-process mesh never needs the (N,) flags host-side;
        # sharding pads are masked out so diagnostics match unsharded runs
        tp_all_d, fp_all_d = _diag_counts(eq_pos, eq_neg, valid)
        tp_all, fp_all = int(tp_all_d), int(fp_all_d)
        fn_all = int(n - tp_all - fp_all)
        ix, iy = _lin_to_xy(bi)
        jx, jy = _lin_to_xy(bj)
        chosen.append(Test(ix, iy, jx, jy, btau))
        stats_out.append(
            LevelStats(level, bi, bj, btau, tp, fp, fn, tot, prec, rec, hm,
                       tp_all, fp_all, fn_all)
        )
        if verbose:
            print(
                f"{level:>7}{prec:>10.4f}{rec:>10.4f}{hm:>10.4f}{tot:>8}"
                f"{tp:>8}{fp:>8}{fn:>8}{scale:>6}{btau:>5}{bi:>5}{bj:>5}"
            )

    return Fern(scale, tuple(chosen)), stats_out


def _train_forest_batched(
    triplets: np.ndarray,
    settings: ForestSettings,
    optimizer: OptimizerSettings,
    rng: np.random.Generator,
    sub_n: int,
    verbose: bool,
    mesh,
) -> Forest:
    """Train ALL ferns level-synchronously: one scorer dispatch per level
    covers every fern's candidate set (vmap over the stacked fern axis).

    Ferns are independent by construction — each has its own bootstrap
    subsample and its own greedy prefix (trainAndExport's sequential loop,
    training.hpp:103-158, shares nothing between ferns but the RNG stream)
    — so batching them is exact.  RNG draws happen host-side in the
    sequential path's exact order (bootstrap_k, then candidates_k per
    level), so the exported forest is BYTE-IDENTICAL to ``train_forest``'s
    fern-at-a-time loop (pinned in tests/test_train.py); the win is
    F*max_depth scorer dispatches collapsing to max_depth — material
    through a high-latency device link.

    ``mesh``: optional data-parallel mesh; the triplet axis (axis 1 of the
    (F, N, 3, 729) stack) shards over it with the same pad-with-excluded
    construction as the sequential path.
    """
    n = triplets.shape[0]
    f = len(settings.ferns)
    max_depth = settings.max_depth
    tau_lo, tau_hi = optimizer.tau_lo, optimizer.tau_hi
    num_taus = tau_hi - tau_lo

    # pre-draw every RNG value in the sequential path's order
    idxs = np.empty((f, sub_n), np.int64)
    cands: List[List[np.ndarray]] = []
    for k, scale in enumerate(settings.ferns):
        idxs[k] = rng.integers(0, n, size=sub_n)
        cands.append([
            sample_candidates(rng, scale, optimizer.num_resamples)
            for _ in range(max_depth)
        ])

    n_pad = 0
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = int(mesh.devices.size)
        n_pad = (-sub_n) % n_dev
        host = np.asarray(triplets)[idxs]  # (F, sub_n, 3, 729)
        if n_pad:
            host = np.concatenate(
                [host, np.zeros((f, n_pad) + host.shape[2:], host.dtype)],
                axis=1)
        np_tot = sub_n + n_pad
        # pads start fully marked (excluded from every level's counts) and
        # invalid (masked out of diagnostics) — identical to unpadded runs
        # by construction, as in train_fern's mesh path
        sp0 = np.zeros((f, np_tot), bool)
        sp0[:, sub_n:] = True
        valid0 = np.ascontiguousarray(
            np.broadcast_to(np.arange(np_tot) < sub_n, (f, np_tot)))
        shard = NamedSharding(mesh, P(None, "data"))
        patches = jax.device_put(host, shard)
        eq_pos = jax.device_put(np.ones((f, np_tot), bool), shard)
        eq_neg = jax.device_put(np.ones((f, np_tot), bool), shard)
        split_pos = jax.device_put(sp0, shard)
        split_neg = jax.device_put(sp0.copy(), shard)
        valid = jax.device_put(valid0, shard)
    else:
        patches = jnp.take(jnp.asarray(triplets), jnp.asarray(idxs), axis=0)
        eq_pos = jnp.ones((f, sub_n), bool)
        eq_neg = jnp.ones((f, sub_n), bool)
        split_pos = jnp.zeros((f, sub_n), bool)
        split_neg = jnp.zeros((f, sub_n), bool)
        valid = jnp.ones((f, sub_n), bool)

    chosen: List[List[Test]] = [[] for _ in range(f)]
    stats_out: List[List[LevelStats]] = [[] for _ in range(f)]
    t0 = time.perf_counter()
    for level in range(max_depth):
        cand_l = np.stack([cands[k][level] for k in range(f)]).astype(
            np.int32)  # (F, R, 2)
        include, tot_dev = _include_and_tot_ferns(split_pos, split_neg)
        counts = np.asarray(
            _score_level_ferns(
                patches, jnp.asarray(cand_l), jnp.int32(tau_lo), num_taus,
                eq_pos, eq_neg, include,
            )
        )  # (F, R, T, 3)
        tots = np.asarray(tot_dev)
        bi = np.empty((f,), np.int32)
        bj = np.empty((f,), np.int32)
        bt = np.empty((f,), np.int32)
        best_counts_all = []
        for k in range(f):
            (bi[k], bj[k], bt[k]), bc = _select_best(
                counts[k], cand_l[k], tau_lo, num_taus, optimizer.w1)
            best_counts_all.append(bc)
        if optimizer.only_score_non_split_samples:
            # elementwise fold — shape-agnostic, same rule as train_fern
            split_pos, split_neg = _mark_splits(split_pos, split_neg,
                                                eq_pos, eq_neg)
        eq_pos, eq_neg = _apply_level_ferns(
            patches, jnp.asarray(bi), jnp.asarray(bj), jnp.asarray(bt),
            eq_pos, eq_neg)
        tp_all_d, fp_all_d = _diag_counts_ferns(eq_pos, eq_neg, valid)
        tp_alls, fp_alls = np.asarray(tp_all_d), np.asarray(fp_all_d)
        for k in range(f):
            tp, fp, fn = best_counts_all[k]
            prec, rec, hm = _hmean(tp, fp, fn, optimizer.w1)
            ix, iy = _lin_to_xy(int(bi[k]))
            jx, jy = _lin_to_xy(int(bj[k]))
            chosen[k].append(Test(ix, iy, jx, jy, int(bt[k])))
            tp_all, fp_all = int(tp_alls[k]), int(fp_alls[k])
            stats_out[k].append(
                LevelStats(level, int(bi[k]), int(bj[k]), int(bt[k]),
                           tp, fp, fn, int(tots[k]), prec, rec, hm,
                           tp_all, fp_all, sub_n - tp_all - fp_all)
            )
        if verbose:
            # liveness line per level: the fern-major tables only print at
            # the end, and a large level can take seconds
            print(f"level {level + 1}/{max_depth}: all {f} ferns scored "
                  f"(t=+{time.perf_counter() - t0:.2f} s)", flush=True)
    elapsed = time.perf_counter() - t0

    if verbose:
        for k, scale in enumerate(settings.ferns):
            print(f"Fern({k + 1}/{f}) num samples: {sub_n}")
            print("*" * 90)
            print(
                f"{'Level':>7}{'Prec':>10}{'Rec':>10}{'Har':>10}{'Tot':>8}"
                f"{'TP':>8}{'FP':>8}{'FN':>8}{'scale':>6}{'tau':>5}"
                f"{'i':>5}{'j':>5}"
            )
            for s in stats_out[k]:
                print(
                    f"{s.level:>7}{s.prec:>10.4f}{s.rec:>10.4f}"
                    f"{s.hmean:>10.4f}{s.tot:>8}{s.tp:>8}{s.fp:>8}{s.fn:>8}"
                    f"{scale:>6}{s.tau:>5}{s.i:>5}{s.j:>5}"
                )
            print()
        print(f"batched {f} ferns x {max_depth} levels in {elapsed:.2f} s\n")

    return Forest(tuple(
        Fern(scale, tuple(chosen[k]))
        for k, scale in enumerate(settings.ferns)
    ))


def train_forest(
    triplets: np.ndarray,
    settings: ForestSettings,
    optimizer: OptimizerSettings,
    seed: int = 0,
    verbose: bool = True,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    batch_ferns: Optional[bool] = None,
) -> Forest:
    """Train a forest: per fern, bootstrap-subsample (with replacement, from
    the whole set — see module docstring) and train
    (trainAndExport, training.hpp:103-158).

    ``checkpoint_path``: incremental export — after each fern finishes the
    partial forest is written there (valid reference text format), so an
    interrupted run keeps its completed ferns (the per-fern analog of the
    reference's artifact-level checkpointing, SURVEY.md §5).

    ``batch_ferns``: train all ferns level-synchronously in ONE scorer
    dispatch per level (see ``_train_forest_batched`` — byte-identical
    forest, F× fewer dispatches).  Default (None): batched whenever there
    is more than one fern, no incremental checkpointing is requested
    (per-fern checkpoints only make sense when ferns finish one at a
    time), AND the stacked (F, sub_n, 3, 729) bootstrap fits the
    ``BATCH_FERNS_BYTES_CAP`` budget — the batched path holds every
    fern's subsample on device at once (~F*sample_fraction× the
    sequential peak), so large datasets keep the fern-at-a-time default
    instead of discovering an OOM.  Explicit ``batch_ferns=True``
    bypasses the cap.
    """
    from opengpc_tpu.forest import save_forest

    rng = np.random.default_rng(seed)
    n = triplets.shape[0]
    if n == 0:
        raise ValueError("training set is empty")
    sub_n = int(settings.sample_fraction * n)
    if batch_ferns is None:
        stack_bytes = (len(settings.ferns) * sub_n * 3 * 729
                       * triplets.dtype.itemsize)
        # with a data-parallel mesh the stack shards its triplet axis over
        # the devices (P(None, "data")), so the budget is per device
        n_dev = int(mesh.devices.size) if mesh is not None else 1
        batch_ferns = (checkpoint_path is None and len(settings.ferns) > 1
                       and stack_bytes // n_dev <= BATCH_FERNS_BYTES_CAP)
    if batch_ferns:
        if checkpoint_path is not None:
            raise ValueError(
                "batch_ferns trains all ferns concurrently; per-fern "
                "incremental checkpointing needs batch_ferns=False")
        return _train_forest_batched(triplets, settings, optimizer, rng,
                                     sub_n, verbose, mesh)
    # upload the dataset once; per-fern bootstrap gathers happen on device
    # (the dataset is the big transfer — hundreds of MB for real runs)
    triplets_dev = jnp.asarray(triplets)
    ferns = []
    for k, scale in enumerate(settings.ferns):
        idx = rng.integers(0, n, size=sub_n)
        sub = jnp.take(triplets_dev, jnp.asarray(idx), axis=0)
        if verbose:
            print(f"Fern({k + 1}/{len(settings.ferns)}) num samples: {sub_n}")
            print("*" * 90)
        t0 = time.perf_counter()
        fern, _ = train_fern(
            sub, scale, optimizer, settings.max_depth, rng=rng,
            verbose=verbose, mesh=mesh,
        )
        if verbose:
            print(f"done in {time.perf_counter() - t0:.2f} s\n")
        ferns.append(fern)
        if checkpoint_path is not None:
            save_forest(Forest(tuple(ferns)), checkpoint_path)
    return Forest(tuple(ferns))

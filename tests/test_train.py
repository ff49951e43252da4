"""Training parity and behavior tests.

Differential: train_fern with injected candidate lists must select the
exact same (i, j, tau) per level — and produce the same TP/FP/FN — as the
C++ oracle's trainFern (cpp/oracle.cc), which implements the reference
semantics (Fern.hpp:209-372).
"""

import os
import subprocess

import numpy as np
import pytest

from opengpc_tpu.config import (
    ForestSettings,
    OptimizerSettings,
    fern_factory,
    tau_optimizer,
    zero_optimizer,
)
from opengpc_tpu.forest import (
    SCALE_L,
    SCALE_M,
    SCALE_S,
    SCALE_HALF,
    PATCH,
    PATCH_HALF,
    make_filter_mask,
    parse_forest,
    serialize_forest,
)
from opengpc_tpu.io.triplets import load_triplets, save_triplets
from opengpc_tpu.train import sample_candidates, train_fern, train_forest


def make_triplets(rng, n):
    """Triplets where pos is a noisy copy of ref and neg is unrelated."""
    ref = rng.integers(0, 256, (n, 729)).astype(np.int16)
    pos = np.clip(ref + rng.integers(-8, 9, (n, 729)), 0, 255)
    neg = rng.integers(0, 256, (n, 729))
    return np.stack([ref, pos, neg], axis=1).astype(np.uint8)


def _oracle_train(oracle_path, tmp_path, trips, cands, depth, tau_lo, tau_hi,
                  w1, only_non_split):
    tp = str(tmp_path / "trips.bin")
    cp = str(tmp_path / "cands.txt")
    op = str(tmp_path / "out.txt")
    save_triplets(trips, tp)
    with open(cp, "w") as f:
        for level, arr in enumerate(cands):
            for i, j in arr:
                f.write(f"{level} {i} {j}\n")
    subprocess.run(
        [oracle_path, "trainfern", tp, cp, str(depth), str(tau_lo), str(tau_hi),
         str(w1), "1" if only_non_split else "0", op],
        check=True,
    )
    rows = []
    with open(op) as f:
        for line in f:
            parts = line.split()
            rows.append(
                dict(
                    level=int(parts[0]), i=int(parts[1]), j=int(parts[2]),
                    tau=int(parts[3]), tp=int(parts[4]), fp=int(parts[5]),
                    fn=int(parts[6]), score=float(parts[7]),
                    # exclusion-masked stats the selection actually used
                    tpx=int(parts[8]), fpx=int(parts[9]), fnx=int(parts[10]),
                    totx=int(parts[11]),
                )
            )
    return rows


@pytest.mark.parametrize("only_non_split", [False, True])
@pytest.mark.parametrize("tau_lo,tau_hi", [(0, 1), (-10, 10)])
def test_train_fern_oracle_parity(oracle_path, tmp_path, tau_lo, tau_hi,
                                  only_non_split):
    rng = np.random.default_rng(5 + tau_hi)
    n, depth, resamples = 300, 4, 6
    trips = make_triplets(rng, n)
    cands = [sample_candidates(rng, SCALE_L, resamples) for _ in range(depth)]

    want = _oracle_train(
        oracle_path, tmp_path, trips, cands, depth, tau_lo, tau_hi, 0.5,
        only_non_split,
    )

    opt = OptimizerSettings(tau_lo, tau_hi, resamples, only_non_split, 0.5)
    fern, stats = train_fern(
        trips, SCALE_L, opt, depth, candidates=cands, verbose=False
    )

    for lvl, w in enumerate(want):
        s = stats[lvl]
        assert (s.i, s.j, s.tau) == (w["i"], w["j"], w["tau"]), f"level {lvl}"
        # oracle prints %g (6 significant digits)
        assert s.hmean == pytest.approx(w["score"], rel=1e-5)
        # full-stats parity in BOTH modes: the exclusion-masked counts the
        # selection scored, the sample count it saw, and the unmasked
        # diagnostic counts (equal to the masked ones when exclusion is off)
        assert (s.tp, s.fp, s.fn, s.tot) == (
            w["tpx"], w["fpx"], w["fnx"], w["totx"]), f"level {lvl} masked"
        assert (s.tp_all, s.fp_all, s.fn_all) == (
            w["tp"], w["fp"], w["fn"]), f"level {lvl} unmasked"


def test_sample_candidates_in_window():
    rng = np.random.default_rng(0)
    for scale in (SCALE_S, SCALE_M, SCALE_L):
        half = SCALE_HALF[scale]
        c = sample_candidates(rng, scale, 500)
        assert (c[:, 0] != c[:, 1]).all()
        for lin in c.reshape(-1):
            x, y = lin % PATCH - PATCH_HALF, lin // PATCH - PATCH_HALF
            assert -half <= x <= half and -half <= y <= half


def test_train_forest_roundtrip(tmp_path):
    """Full train -> export -> parse -> inference-mask pipeline."""
    rng = np.random.default_rng(1)
    trips = make_triplets(rng, 400)
    settings = fern_factory(1, 1, 1, 3)
    forest = train_forest(trips, settings, zero_optimizer(num_resamples=4),
                          seed=7, verbose=False)
    assert len(forest.ferns) == 3
    assert forest.is_zero
    text = serialize_forest(forest)
    assert parse_forest(text) == forest
    mask = make_filter_mask(forest)
    assert mask.num_tests == 9
    assert (np.abs(mask.i_off) <= 13).all()

    # a tau forest trains taus in range and flags type 1
    tf = train_forest(trips, settings, tau_optimizer(num_resamples=4),
                      seed=7, verbose=False)
    taus = [t.tau for f in tf.ferns for t in f.tests]
    assert all(-10 <= t < 10 for t in taus)


def test_training_separates_pos_from_neg():
    """On separable data the learned fern must actually collide ref with pos
    and not with neg (training-side decision convention)."""
    rng = np.random.default_rng(2)
    trips = make_triplets(rng, 600)
    opt = zero_optimizer(num_resamples=8)
    fern, stats = train_fern(trips, SCALE_L, opt, 5, rng=rng, verbose=False)
    final = stats[-1]
    assert final.prec > 0.8
    assert final.rec > 0.15


def test_train_forest_incremental_checkpoint(tmp_path):
    from opengpc_tpu.forest import load_forest

    rng = np.random.default_rng(9)
    trips = make_triplets(rng, 150)
    ckpt = str(tmp_path / "ckpt.txt")
    forest = train_forest(trips, fern_factory(1, 0, 1, 2),
                          zero_optimizer(num_resamples=3), seed=1,
                          verbose=False, checkpoint_path=ckpt)
    # final checkpoint equals the returned forest and parses cleanly
    assert load_forest(ckpt) == forest
    assert len(forest.ferns) == 2


def test_train_forest_batched_matches_sequential():
    """Level-synchronous batched-fern training (one scorer dispatch per
    level covering all ferns) must export a BYTE-IDENTICAL forest to the
    fern-at-a-time loop — RNG draws are pre-drawn in the sequential
    order and integer counts are exact under vmap."""
    rng = np.random.default_rng(11)
    trips = make_triplets(rng, 350)
    settings = fern_factory(1, 1, 1, 3)
    for opt in (
        zero_optimizer(num_resamples=4),
        tau_optimizer(num_resamples=4, only_score_non_split_samples=True),
    ):
        seq = train_forest(trips, settings, opt, seed=3, verbose=False,
                           batch_ferns=False)
        bat = train_forest(trips, settings, opt, seed=3, verbose=False,
                           batch_ferns=True)
        assert serialize_forest(seq) == serialize_forest(bat)


def test_train_forest_batched_mesh_matches_sequential():
    """Batched-fern training with the triplet axis sharded over a mesh
    (non-divisible bootstrap size exercises the pad-with-excluded path)
    equals the unsharded sequential run byte-for-byte."""
    import jax

    from opengpc_tpu.parallel import make_mesh

    mesh = make_mesh(jax.devices()[:4])
    rng = np.random.default_rng(12)
    trips = make_triplets(rng, 215)  # sub_n = 150, 150 % 4 = 2 -> padded
    settings = fern_factory(1, 1, 0, 2)
    opt = tau_optimizer(num_resamples=3)
    seq = train_forest(trips, settings, opt, seed=5, verbose=False,
                       batch_ferns=False)
    bat = train_forest(trips, settings, opt, seed=5, verbose=False,
                       batch_ferns=True, mesh=mesh)
    assert serialize_forest(seq) == serialize_forest(bat)


def test_train_forest_batched_fuzz_identity():
    """Randomized settings sweep: batched == sequential byte-for-byte
    across fern mixes, depths, optimizer modes and dataset sizes."""
    meta = np.random.default_rng(2024)
    for trial in range(4):
        n = int(meta.integers(60, 400))
        trips = make_triplets(np.random.default_rng(100 + trial), n)
        settings = fern_factory(int(meta.integers(0, 3)),
                                int(meta.integers(0, 3)),
                                int(meta.integers(1, 3)),
                                int(meta.integers(1, 4)))
        make_opt = (zero_optimizer, tau_optimizer)[trial % 2]
        opt = make_opt(num_resamples=int(meta.integers(2, 6)),
                       only_score_non_split_samples=bool(trial % 2),
                       w1=float(meta.uniform(0.3, 0.7)))
        seed = int(meta.integers(0, 1000))
        seq = train_forest(trips, settings, opt, seed=seed, verbose=False,
                           batch_ferns=False)
        bat = train_forest(trips, settings, opt, seed=seed, verbose=False,
                           batch_ferns=True)
        assert serialize_forest(seq) == serialize_forest(bat), (
            f"trial {trial}: n={n} ferns={settings.ferns} "
            f"depth={settings.max_depth}")


def test_train_forest_batched_rejects_checkpoint(tmp_path):
    rng = np.random.default_rng(13)
    trips = make_triplets(rng, 120)
    with pytest.raises(ValueError, match="checkpoint"):
        train_forest(trips, fern_factory(1, 0, 0, 2),
                     zero_optimizer(num_resamples=3), seed=1, verbose=False,
                     checkpoint_path=str(tmp_path / "c.txt"),
                     batch_ferns=True)


def test_trained_forest_quality_vs_pretrained():
    """Selection QUALITY gate (not just selection parity): a forest
    trained end-to-end on mined synthetic triplets must match a HELD-OUT
    multi-plane scene about as well as the pretrained defaultZeroForest —
    a regression in split quality (e.g. a broken scorer that still
    selects deterministically) fails here even when parity tests pass.
    Reference analog: the per-level P/R self-check table, Fern.hpp:358-370."""
    from opengpc_tpu import (InferenceSettings, build_sparsematch,
                             fern_factory, load_forest, supports_to_numpy,
                             zero_optimizer)
    from opengpc_tpu.metrics import support_precision
    from opengpc_tpu.mine import extract_triplets, mine_stereo_pair
    from opengpc_tpu.train import train_forest
    from opengpc_tpu.utils.scenes import make_scene

    rng = np.random.default_rng(5)
    h, w = 240, 480
    left, right, gt, occ = make_scene(rng, h, w)
    kl, kr, kn = mine_stereo_pair(gt, occ, np.zeros((h, w), np.uint8),
                                  2500, 10, 25, rng)
    trips = extract_triplets(left, right, kl, kr, kn)
    assert len(trips) >= 2000
    fresh = train_forest(trips, fern_factory(2, 2, 2, 5), zero_optimizer(),
                         seed=1, verbose=False)

    l2, r2, gt2, occ2 = make_scene(np.random.default_rng(77), h, w)
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1 << 17)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pre = load_forest(os.path.join(repo, "forests", "defaultZeroForest.txt"))
    results = {}
    for name, forest in (("fresh", fresh), ("pretrained", pre)):
        supp = supports_to_numpy(
            *build_sparsematch(forest, settings)(l2, r2))
        prec, n = support_precision(supp, gt2, valid=(occ2 == 0), tol=0)
        results[name] = (len(supp), prec)
    n_fresh, p_fresh = results["fresh"]
    n_pre, p_pre = results["pretrained"]
    assert n_pre > 10000
    # within a few percent of the pretrained forest on coverage, and no
    # worse than 1% on exact-disparity precision
    assert n_fresh >= 0.9 * n_pre, (n_fresh, n_pre)
    assert p_fresh >= p_pre - 0.01, (p_fresh, p_pre)


def test_tau_trained_forest_quality_vs_pretrained():
    """Selection QUALITY gate for TAU training (VERDICT r3 item 4): a
    tau_optimizer()-trained forest (the τ line search of Fern.hpp:337-350,
    built by samples/train.cpp:24-37) must match a held-out multi-plane
    scene about as well as the pretrained defaultTauForest.  Tau selection
    had exact parity tests but no end-to-end quality assertion — a
    tau-specific scoring regression that still picks *some* valid test
    ships through parity and fails here."""
    from opengpc_tpu import (InferenceSettings, build_sparsematch,
                             fern_factory, load_forest, supports_to_numpy,
                             tau_optimizer)
    from opengpc_tpu.metrics import support_precision
    from opengpc_tpu.mine import extract_triplets, mine_stereo_pair
    from opengpc_tpu.train import train_forest
    from opengpc_tpu.utils.scenes import make_scene

    rng = np.random.default_rng(15)
    h, w = 240, 480
    left, right, gt, occ = make_scene(rng, h, w)
    kl, kr, kn = mine_stereo_pair(gt, occ, np.zeros((h, w), np.uint8),
                                  2500, 10, 25, rng)
    trips = extract_triplets(left, right, kl, kr, kn)
    assert len(trips) >= 2000
    fresh = train_forest(trips, fern_factory(2, 2, 2, 5), tau_optimizer(),
                         seed=2, verbose=False)
    # the trained ferns must actually USE the tau freedom (a zero-stuck
    # tau search is exactly the regression class this test exists for)
    taus = [t.tau for fern in fresh.ferns for t in fern.tests]
    assert any(t != 0 for t in taus), taus

    l2, r2, gt2, occ2 = make_scene(np.random.default_rng(78), h, w)
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1 << 17)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pre = load_forest(os.path.join(repo, "forests", "defaultTauForest.txt"))
    results = {}
    for name, forest in (("fresh", fresh), ("pretrained", pre)):
        supp = supports_to_numpy(
            *build_sparsematch(forest, settings)(l2, r2))
        prec, n = support_precision(supp, gt2, valid=(occ2 == 0), tol=0)
        results[name] = (len(supp), prec)
    n_fresh, p_fresh = results["fresh"]
    n_pre, p_pre = results["pretrained"]
    assert n_pre > 10000
    assert n_fresh >= 0.9 * n_pre, (n_fresh, n_pre)
    assert p_fresh >= p_pre - 0.01, (p_fresh, p_pre)


def test_batch_ferns_default_respects_bytes_cap(monkeypatch):
    """The batched-fern DEFAULT must fall back to the fern-at-a-time loop
    when the stacked (F, sub_n, 3, 729) bootstrap would exceed
    BATCH_FERNS_BYTES_CAP (r4 review finding: the batched stack multiplies
    peak device memory ~F*sample_fraction x, so big datasets used to OOM
    silently under the new default).  Explicit batch_ferns=True bypasses
    the cap."""
    import opengpc_tpu.train as T

    rng = np.random.default_rng(77)
    trips = make_triplets(rng, 80)
    settings = fern_factory(1, 1, 0, 2)
    opt = zero_optimizer(num_resamples=2)

    calls = []
    real = T._train_forest_batched

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(T, "_train_forest_batched", spy)

    # tiny cap: default (None) must take the sequential path
    monkeypatch.setattr(T, "BATCH_FERNS_BYTES_CAP", 1)
    f_seq = train_forest(trips, settings, opt, seed=9, verbose=False)
    assert calls == []
    # explicit True overrides the cap
    f_bat = train_forest(trips, settings, opt, seed=9, verbose=False,
                         batch_ferns=True)
    assert calls == [1]
    assert serialize_forest(f_seq) == serialize_forest(f_bat)
    # generous cap: default goes batched again
    monkeypatch.setattr(T, "BATCH_FERNS_BYTES_CAP", 1 << 40)
    train_forest(trips, settings, opt, seed=9, verbose=False)
    assert calls == [1, 1]
    # the budget is PER DEVICE: with a data-parallel mesh the stack shards
    # its triplet axis, so a cap that rejects the total must still accept
    # total/n_dev (r4 review finding — the mesh-blind cap lost the batched
    # win on exactly the multi-chip runs it was built for)
    import jax

    from opengpc_tpu.parallel import make_mesh

    sub_n = int(settings.sample_fraction * len(trips))
    stack_bytes = 2 * sub_n * 3 * 729 * trips.dtype.itemsize
    monkeypatch.setattr(T, "BATCH_FERNS_BYTES_CAP", stack_bytes // 4)
    mesh = make_mesh(jax.devices()[:4])
    train_forest(trips, settings, opt, seed=9, verbose=False, mesh=mesh)
    assert calls == [1, 1, 1]  # batched: per-device share fits
    train_forest(trips, settings, opt, seed=9, verbose=False)
    assert calls == [1, 1, 1]  # unsharded: total exceeds, sequential


def test_batched_training_verbose_streams_levels(capsys):
    """Batched verbose training must emit a liveness line as each level
    completes (buffering everything until the end made an hours-long
    run indistinguishable from a hang)."""
    rng = np.random.default_rng(31)
    trips = make_triplets(rng, 90)
    train_forest(trips, fern_factory(1, 1, 0, 3),
                 zero_optimizer(num_resamples=2), seed=2, verbose=True,
                 batch_ferns=True)
    out = capsys.readouterr().out
    assert "level 1/3: all 2 ferns scored" in out
    assert "level 3/3: all 2 ferns scored" in out
    # the per-fern tables still print in full
    assert "Fern(1/2)" in out and "Fern(2/2)" in out

"""Headline benchmark: sparsematch throughput on Sintel-sized stereo pairs.

Covers every BASELINE.json config with a device-timed metric and a
correctness gate:

  1. config 1 — defaultZeroForest, single pair (the headline number,
     gated on exact true disparity AND oracle support-set identity)
  2. config 2 — defaultTauForest (tau-threshold splits), device-timed,
     oracle-gated
  3. config 3 — multi-scale pyramid matching and batched pairs (vmap B=4)
     aggregate Mpix/s on one device
  plus a multi-plane variable-disparity scene gate (a matcher that only
  works for constant disparity fails it).

Reference benchmark config (/root/reference/samples/sparsematch.cpp:29-34):
gradient threshold 5, vertical tolerance 0, dispHigh 128, epipolar mode.
Image size matches Sintel (1024x436, SintelOpticalFlow.hpp:492-493); real
Sintel frames are not downloadable in this environment, so pairs are
reproducible synthetic textured scenes with known ground-truth disparity.

Timing methodology: N chained pipeline iterations run inside one jitted
``lax.fori_loop`` (each iteration's input depends on the previous match
count, so nothing can be elided or overlapped); one scalar is fetched and
two loop lengths are differenced (utils.device_time_per_iter).

Device: the bench measures the GPU and refuses to run without one, unless
``JAX_PLATFORMS=cpu`` is set explicitly (the CPU smoke test); the device
line it prints names what it ran on.

Output contract: the headline config-1 metric (the masked sorted-order
contract) is ONE JSON line on stdout, printed last; auxiliary config
metrics (flat, row-form, global, tau, batched, pyramid, mining, training)
are printed as JSON lines on stderr.
"""

import json
import os
import sys

import numpy as np

from opengpc_tpu.utils.scenes import make_pair, make_scene  # noqa: E402

BASELINE_MPIX_S = 50.0  # BASELINE.json's throughput target
H, W = 436, 1024        # Sintel frame size
TRUE_DISP = 16
# The per-iter estimate differences two wall-clocks; their noise divides
# by the iteration spread, so wide chains (203 for ~0.5-1 ms steps, 103
# for the 2-4 ms batched/pyramid steps) cut the per-metric error for
# negligible extra device time.
# OGPC_BENCH_FAST=1 restores the short chains (CPU dry-runs).
def _env_flag(name):
    # tolerant parse (ADVICE r4): "", "0", "false", "no" are off; anything
    # else (1/true/yes/...) is on — a typo must not crash the bench before
    # any output.
    return os.environ.get(name, "0").strip().lower() not in (
        "", "0", "false", "no")


_SMOKE = _env_flag("OGPC_BENCH_SMOKE")   # CI smoke: tiny chains, 1 repeat
_FAST = _env_flag("OGPC_BENCH_FAST") or _SMOKE
N_SHORT, N_LONG = 3, (5 if _SMOKE else (43 if _FAST else 203))
N_LONG_HEAVY = 4 if _SMOKE else (23 if _FAST else 103)
N_LONG_TRAIN = 13 if _SMOKE else 2003
BATCH = 4


def _rep(n):
    """Timing repeats: 1 in smoke mode (the smoke test checks the output
    contract, not the numbers)."""
    return 1 if _SMOKE else n


def _nonzero(seconds):
    """device_time_per_iter clamps a timing-noise inversion to 0.0; never
    divide by it (one host stall would otherwise kill the whole bench)."""
    return max(seconds, 1e-9)


def _aux(metric, value, unit, note=""):
    rec = {"metric": metric, "value": round(value, 1), "unit": unit,
           "note": note}
    if unit == "Mpix/s":  # the 50 Mpix/s north-star only prices pixels
        rec["vs_baseline"] = round(value / BASELINE_MPIX_S, 2)
    print(json.dumps(rec), file=sys.stderr, flush=True)


def _check_against_oracle(left, right, supp, settings, forest_file,
                          label="", epipolar=True):
    """P/R gate vs the native CPU oracle (BASELINE: within 1%; we require
    exact).  Skipped silently if the oracle can't be built on this host."""
    import os
    import subprocess
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    oracle = os.path.join(repo, "cpp", "build", "oracle")
    if not os.path.exists(oracle):
        r = subprocess.run(["make", "-C", os.path.join(repo, "cpp")],
                           capture_output=True)
        if r.returncode != 0 or not os.path.exists(oracle):
            return
    from opengpc_tpu.io.raw import write_raw

    with tempfile.TemporaryDirectory() as td:
        lp, rp, op = (os.path.join(td, n) for n in ("l.raw", "r.raw", "o.txt"))
        write_raw(lp, left)
        write_raw(rp, right)
        subprocess.run(
            [oracle, "sparsematch", os.path.join(repo, "forests", forest_file),
             lp, rp, op, str(settings.gradient_threshold),
             str(settings.vertical_tolerance), str(settings.disp_high),
             str(int(epipolar)), "0"],
            check=True,
        )
        with open(op) as f:
            want = set(tuple(int(v) for v in line.split()) for line in f
                       if line.strip())
    got = set(map(tuple, supp.tolist()))
    # supp may be capacity-trimmed; every returned support must be in the
    # oracle set and coverage must be essentially total
    assert got <= want, f"{label}: {len(got - want)} supports not in oracle set"
    assert len(got) >= min(len(want), settings.capacity) * 0.999, (
        f"{label}: only {len(got)} of {len(want)} oracle supports reproduced"
    )
    print(f"oracle check [{label}]: {len(got)}/{len(want)} supports, "
          f"exact subset", file=sys.stderr)


def main():
    import jax
    import jax.numpy as jnp

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import load_forest, make_filter_mask
    from opengpc_tpu.infer import (_sparsematch_impl, build_sparsematch,
                                   supports_to_numpy)
    from opengpc_tpu.metrics import support_precision
    from opengpc_tpu.utils import device_time_per_iter
    from opengpc_tpu.utils.device import start

    start()
    if (jax.devices()[0].platform != "gpu"
            and os.environ.get("JAX_PLATFORMS") != "cpu"):
        sys.exit("bench.py measures the GPU and found none "
                 f"({jax.devices()[0].platform}); set JAX_PLATFORMS=cpu "
                 "explicitly for a CPU smoke run")
    settings = InferenceSettings(
        gradient_threshold=5,
        vertical_tolerance=0,
        disp_high=128,
        epipolar_mode=True,
        capacity=1 << 19,
    )
    left, right = make_pair(H, W, TRUE_DISP)

    def timed_mpix(mask, l, r, n_long=N_LONG):
        """Device-time the jitted pipeline on (possibly batched) pairs.

        The step consumes EVERY output buffer, not just the count —
        otherwise XLA dead-code-eliminates the support compaction and the
        "throughput" measures a program no user can run.
        """
        def one(x, y):
            xs, ys, ds, count = _sparsematch_impl(
                x, y, mask=mask, settings=settings)
            return (xs.sum(dtype=jnp.int32) + ys.sum(dtype=jnp.int32)
                    + ds.sum(dtype=jnp.int32) + count)

        def stepb(a, b):
            if a.ndim == 3:
                # lax.map like build_sparsematch
                return jnp.sum(jax.lax.map(lambda ab: one(*ab), (a, b)))
            return jnp.sum(one(a, b))

        def make_dep(count, args):
            a, b = args
            upd = (count & 1).astype(jnp.uint8).reshape((1,) * a.ndim)
            a = jax.lax.dynamic_update_slice(a, upd, (0,) * a.ndim)
            return (a, b)

        best = device_time_per_iter(stepb, (l, r), make_dep, N_SHORT, n_long,
                                    repeats=_rep(5))
        npix = 2 * l.size  # both images
        return (npix / 1e6) / _nonzero(best)

    # ------------------------------------------------------------------
    # config 1: defaultZeroForest single pair (headline) + gates
    # ------------------------------------------------------------------
    forest = load_forest("forests/defaultZeroForest.txt")
    mask = make_filter_mask(forest)
    match = build_sparsematch(forest, settings)
    supp = supports_to_numpy(*match(left, right))
    assert len(supp) > 1000, f"too few supports: {len(supp)}"
    correct = float((supp[:, 2] == TRUE_DISP).mean())
    assert correct > 0.99, f"support accuracy {correct:.3f} < 0.99"
    _check_against_oracle(left, right, supp, settings,
                          "defaultZeroForest.txt", "config1 zero")

    # multi-plane variable-disparity gate: the same
    # pipeline must be correct where disparity varies across the image
    mp_left, mp_right, mp_disp, mp_occ = make_scene(
        np.random.default_rng(0), H, W)
    mp_supp = supports_to_numpy(*match(mp_left, mp_right))
    assert len(mp_supp) > 1000, f"multi-plane: too few supports {len(mp_supp)}"
    prec, n_valid = support_precision(mp_supp, mp_disp, mp_occ == 0, tol=0.0)
    assert prec > 0.97, f"multi-plane precision {prec:.3f} <= 0.97"
    print(f"multi-plane gate: {n_valid} non-occluded supports, "
          f"exact-disparity precision {prec:.4f}", file=sys.stderr)
    _check_against_oracle(mp_left, mp_right, mp_supp, settings,
                          "defaultZeroForest.txt", "config1 multi-plane")

    mpix_s = timed_mpix(mask, left, right)

    # ------------------------------------------------------------------
    # row-form output contract (maximum-throughput path): same support
    # set, per-row packed buffers, no flat assembly
    # ------------------------------------------------------------------
    from opengpc_tpu.infer import (_sparsematch_rows_impl,
                                   row_supports_to_numpy)

    rows_fn = jax.jit(lambda l, r: _sparsematch_rows_impl(
        l, r, mask=mask, settings=settings))
    (rxs, rds), rcounts = rows_fn(left, right)
    row_supp = row_supports_to_numpy(rxs, rds, rcounts)
    assert set(map(tuple, row_supp.tolist())) == set(map(tuple, supp.tolist())), \
        "row-form support set != flat support set"

    def rstep(a, b):
        (xs, ds), counts = _sparsematch_rows_impl(
            a, b, mask=mask, settings=settings)
        return (xs.sum(dtype=jnp.int32) + ds.sum(dtype=jnp.int32)
                + counts.sum(dtype=jnp.int32))

    def rdep(count, args):
        a, b = args
        a = jax.lax.dynamic_update_slice(
            a, (count & 1).astype(jnp.uint8).reshape(1, 1), (0, 0))
        return (a, b)

    rbest = device_time_per_iter(rstep, (left, right), rdep, N_SHORT, N_LONG,
                                 repeats=_rep(5))
    rowform_mpix = 2 * H * W / 1e6 / _nonzero(rbest)
    _aux("flat_buffer_throughput", mpix_s, "Mpix/s",
         "config 1 with the flat fixed-capacity buffer contract "
         "(build_sparsematch)")
    _aux("rowform_throughput", rowform_mpix, "Mpix/s",
         "config 1 with the row-form contract (build_sparsematch_rows; "
         "the r2 headline)")

    # ------------------------------------------------------------------
    # masked sorted-order contract (build_sparsematch_masked) — the
    # minimum-device-work contract and the r3 HEADLINE: one row sort +
    # detection + masked emit, no packing sort; supports decode host-side
    # with one vectorized nonzero (or reduce on-device).  Gated: decoded
    # set must equal the flat contract's (itself oracle-gated above).
    # ------------------------------------------------------------------
    from opengpc_tpu.infer import (_sparsematch_masked_impl,
                                   masked_supports_to_numpy)

    masked_fn = jax.jit(lambda l, r: _sparsematch_masked_impl(
        l, r, mask=mask, settings=settings))
    mbuf, mcounts = masked_fn(left, right)
    msupp = masked_supports_to_numpy(mbuf, mcounts, settings.disp_high)
    assert set(map(tuple, msupp.tolist())) == set(map(tuple, supp.tolist())), \
        "masked support set != flat support set"

    def mstep(a, b):
        buf, counts = _sparsematch_masked_impl(
            a, b, mask=mask, settings=settings)
        return buf.sum(dtype=jnp.int32) + counts.sum(dtype=jnp.int32)

    # the HEADLINE metric: a couple more repeats than the aux configs to
    # damp run-to-run variance (best-of semantics)
    mbest = device_time_per_iter(mstep, (left, right), rdep, N_SHORT, N_LONG,
                                 repeats=_rep(9))
    masked_mpix = 2 * H * W / 1e6 / _nonzero(mbest)
    # the headline: the masked sorted-order contract — full sparse match,
    # every output buffer consumed, decoded support set asserted identical
    # to the flat contract (itself oracle-gated above)
    headline_rec = {
        "metric": "sintel_sparsematch_throughput",
        "value": round(masked_mpix, 1),
        "unit": "Mpix/s",
        "vs_baseline": round(masked_mpix / BASELINE_MPIX_S, 2),
    }

    def _aux_tail():

        # ------------------------------------------------------------------
        # realistic-density scene: ~15% of pixels pass gradientThreshold 5
        # (vs make_pair's 79%) — the masked contract's device time is
        # density-independent by construction (static shapes), and this
        # metric checks it on a measured low-density frame instead of
        # asserting it
        # ------------------------------------------------------------------
        from opengpc_tpu.ops.preprocess import candidate_mask, sobel3
        from opengpc_tpu.utils.scenes import make_sparse_pair

        sl, sr = make_sparse_pair(H, W, TRUE_DISP, density=0.15)
        # jitted: one program instead of one dispatch per eager jnp op
        sdens = float(np.asarray(jax.jit(
            lambda x: candidate_mask(sobel3(x, 5)).mean())(sl)))
        s_supp = supports_to_numpy(*match(sl, sr))
        s_acc = float((s_supp[:, 2] == TRUE_DISP).mean())
        assert len(s_supp) > 1000, f"low-density: too few supports {len(s_supp)}"
        assert s_acc > 0.99, f"low-density support accuracy {s_acc:.3f}"
        _check_against_oracle(sl, sr, s_supp, settings, "defaultZeroForest.txt",
                              "config1 low-density")
        sbuf2, scounts2 = masked_fn(sl, sr)
        sdec = masked_supports_to_numpy(sbuf2, scounts2, settings.disp_high)
        assert set(map(tuple, sdec.tolist())) == set(map(tuple, s_supp.tolist())), \
            "low-density masked set != flat set"
        sbest = device_time_per_iter(mstep, (sl, sr), rdep, N_SHORT, N_LONG,
                                     repeats=_rep(5))
        _aux("lowdensity_sparsematch_throughput",
             2 * H * W / 1e6 / _nonzero(sbest), "Mpix/s",
             f"masked contract on a {sdens:.2f}-candidate-density scene "
             f"({len(s_supp)} supports; headline scene is 0.79-dense) — "
             "oracle-gated")

        # chunk-compacted masked contract (the low-density fast path): gate
        # on no-overflow + set equality
        from opengpc_tpu.infer import _sparsematch_masked_compact_impl

        cfn = jax.jit(lambda l, r: _sparsematch_masked_compact_impl(
            l, r, mask=mask, settings=settings, chunk=128, k=64))
        cbuf, ccounts, covf = cfn(sl, sr)
        assert not bool(np.asarray(covf)), "low-density scene tripped overflow"
        cdec = masked_supports_to_numpy(cbuf, ccounts, settings.disp_high)
        assert set(map(tuple, cdec.tolist())) == set(map(tuple,
                                                         s_supp.tolist())), \
            "compact masked set != flat set"

        def cstep(a, b):
            buf, counts, ovf = _sparsematch_masked_compact_impl(
                a, b, mask=mask, settings=settings,
                chunk=128, k=64)
            return (buf.sum(dtype=jnp.int32) + counts.sum(dtype=jnp.int32)
                    + ovf.astype(jnp.int32))

        cbest = device_time_per_iter(cstep, (sl, sr), rdep, N_SHORT, N_LONG,
                                     repeats=_rep(5))
        _aux("lowdensity_compact_throughput",
             2 * H * W / 1e6 / _nonzero(cbest), "Mpix/s",
             "chunk-compacted masked contract (strided S=128 K=64) on the "
             "low-density scene — overflow-guarded, set-equality gated")

        # ------------------------------------------------------------------
        # MID-density scene (~0.35 candidates): the
        # policy boundary region — above the 0.30 auto-compact cutoff, so
        # auto rides the full masked contract here.  Three numbers price
        # the compact contracts' worst case on chip: (a) the masked
        # contract at mid density (its density-independence claim, proved
        # at a third point), (b) whether the S=128/K=64 compact contract
        # overflows here, and (c) the MISPREDICTION cost — the wasted
        # compact dispatch that precedes the full-width re-run when the
        # auto policy guesses wrong (compact time / masked time).
        # ------------------------------------------------------------------
        ml_, mr_ = make_sparse_pair(H, W, TRUE_DISP, density=0.35)
        mdens = float(np.asarray(jax.jit(
            lambda x: candidate_mask(sobel3(x, 5)).mean())(ml_)))
        m_supp = supports_to_numpy(*match(ml_, mr_))
        assert len(m_supp) > 1000
        assert float((m_supp[:, 2] == TRUE_DISP).mean()) > 0.99
        _check_against_oracle(ml_, mr_, m_supp, settings,
                              "defaultZeroForest.txt", "config1 mid-density")
        mbuf3, mcounts3 = masked_fn(ml_, mr_)
        mdec3 = masked_supports_to_numpy(mbuf3, mcounts3, settings.disp_high)
        assert set(map(tuple, mdec3.tolist())) == set(map(
            tuple, m_supp.tolist())), "mid-density masked set != flat set"
        midbest = device_time_per_iter(mstep, (ml_, mr_), rdep, N_SHORT,
                                       N_LONG, repeats=_rep(5))
        _aux("middensity_sparsematch_throughput",
             2 * H * W / 1e6 / _nonzero(midbest), "Mpix/s",
             f"masked contract on a {mdens:.2f}-candidate-density scene "
             "(the auto-policy boundary region) — oracle-gated")
        _, _, movf = cfn(ml_, mr_)
        mid_ovf = bool(np.asarray(movf))
        midcbest = device_time_per_iter(cstep, (ml_, mr_), rdep, N_SHORT,
                                        N_LONG, repeats=_rep(5))
        _aux("middensity_compact_throughput",
             2 * H * W / 1e6 / _nonzero(midcbest), "Mpix/s",
             f"S=128/K=64 compact contract on the {mdens:.2f}-density "
             f"scene (overflow={mid_ovf}); when it overflows this is the "
             "pure misprediction waste a tripped auto policy pays before "
             "the full-width re-run "
             f"(+{100 * midcbest / _nonzero(midbest):.0f}% of a masked "
             "dispatch)")

        # ------------------------------------------------------------------
        # global (non-epipolar) mode — the reference's DEFAULT settings path
        # (inference.hpp:75) — on the segmented global row-form contract
        # ------------------------------------------------------------------
        import dataclasses

        from opengpc_tpu.infer import (_sparsematch_global_rows_impl,
                                       global_row_supports_to_numpy)

        gsettings = dataclasses.replace(settings, epipolar_mode=False)
        grows_fn = jax.jit(lambda l, r: _sparsematch_global_rows_impl(
            l, r, mask=mask, settings=gsettings))
        (gxs, gys, gds), gcounts = grows_fn(left, right)
        gsupp = global_row_supports_to_numpy(gxs, gys, gds, gcounts)
        gacc = float((gsupp[:, 2] == TRUE_DISP).mean())
        assert gacc > 0.99, f"global support accuracy {gacc:.3f}"
        _check_against_oracle(left, right, gsupp, gsettings,
                              "defaultZeroForest.txt", "global zero",
                              epipolar=False)

        def gstep(a, b):
            (xs, ys, ds), counts = _sparsematch_global_rows_impl(
                a, b, mask=mask, settings=gsettings)
            return (xs.sum(dtype=jnp.int32) + ys.sum(dtype=jnp.int32)
                    + ds.sum(dtype=jnp.int32) + counts.sum(dtype=jnp.int32))

        gbest = device_time_per_iter(gstep, (left, right), rdep, N_SHORT, N_LONG,
                                     repeats=_rep(5))
        _aux("global_sparsematch_throughput", 2 * H * W / 1e6 / _nonzero(gbest),
             "Mpix/s", "global (non-epipolar) mode, segmented row-form "
             "contract, oracle-gated")

        # chunk-compacted GLOBAL contract on the low-density scene (the
        # flat uniqueness sort runs on 2HW*(K/S) elements): gate on
        # no-overflow + set equality
        # with the full global contract
        from opengpc_tpu.infer import (_sparsematch_global_compact_impl,
                                       global_row_supports_to_numpy)

        gcfn = jax.jit(lambda l, r: _sparsematch_global_compact_impl(
            l, r, mask=mask, settings=gsettings,
            chunk=512, k=128))
        (gcx, gcy, gcd), gcc, gcovf = gcfn(sl, sr)
        assert not bool(np.asarray(gcovf)), \
            "low-density scene tripped the global-compact overflow"
        (gsx, gsy, gsd), gsc = grows_fn(sl, sr)
        gsup_sparse = global_row_supports_to_numpy(gsx, gsy, gsd, gsc)
        gcdec = global_row_supports_to_numpy(gcx, gcy, gcd, gcc)
        assert set(map(tuple, gcdec.tolist())) == set(map(
            tuple, gsup_sparse.tolist())), "global-compact set != global set"

        def gcstep(a, b):
            (xs, ys, ds), counts, ovf = _sparsematch_global_compact_impl(
                a, b, mask=mask, settings=gsettings,
                chunk=512, k=128)
            return (xs.sum(dtype=jnp.int32) + ys.sum(dtype=jnp.int32)
                    + ds.sum(dtype=jnp.int32) + counts.sum(dtype=jnp.int32)
                    + ovf.astype(jnp.int32))

        gcbest = device_time_per_iter(gcstep, (sl, sr), rdep, N_SHORT, N_LONG,
                                      repeats=_rep(5))
        _aux("lowdensity_global_compact_throughput",
             2 * H * W / 1e6 / _nonzero(gcbest), "Mpix/s",
             "chunk-compacted global contract (strided S=512 K=128) on the "
             "low-density scene — overflow-guarded, set-equality gated")

        # ------------------------------------------------------------------
        # config 2: defaultTauForest (sequence stands on per-pair throughput;
        # frames stream through the same compiled program)
        # ------------------------------------------------------------------
        tau_forest = load_forest("forests/defaultTauForest.txt")
        tau_mask = make_filter_mask(tau_forest)
        tau_match = build_sparsematch(tau_forest, settings)
        tau_supp = supports_to_numpy(*tau_match(left, right))
        tau_acc = float((tau_supp[:, 2] == TRUE_DISP).mean())
        assert tau_acc > 0.99, f"tau support accuracy {tau_acc:.3f}"
        _check_against_oracle(left, right, tau_supp, settings,
                              "defaultTauForest.txt", "config2 tau")
        # tau is just as eligible for the masked headline contract as the zero
        # forest (30 tests; the fused kernel carries per-test taus) — time it
        # there, gated on decode equality vs the oracle-gated flat tau set
        tau_masked_fn = jax.jit(lambda l, r: _sparsematch_masked_impl(
            l, r, mask=tau_mask, settings=settings))
        tbuf, tcounts = tau_masked_fn(left, right)
        tdec = masked_supports_to_numpy(tbuf, tcounts, settings.disp_high)
        assert set(map(tuple, tdec.tolist())) == set(map(tuple,
                                                         tau_supp.tolist())), \
            "tau masked support set != tau flat support set"

        def tstep(a, b):
            buf, counts = _sparsematch_masked_impl(
                a, b, mask=tau_mask, settings=settings)
            return buf.sum(dtype=jnp.int32) + counts.sum(dtype=jnp.int32)

        tbest = device_time_per_iter(tstep, (left, right), rdep, N_SHORT, N_LONG,
                                     repeats=_rep(5))
        tau_mpix = 2 * H * W / 1e6 / _nonzero(tbest)
        _aux("tau_sparsematch_throughput", tau_mpix, "Mpix/s",
             "config 2: defaultTauForest on the masked contract, device-timed "
             "(decode gated against the oracle-gated flat tau set)")

        # ------------------------------------------------------------------
        # small-forest single-operand sort:
        # a <=17-test mask at this width packs the sort payload INTO the key,
        # dropping one operand from the matcher sort.  Gate: masked decode set
        # equal to the flat pipeline's on the SAME truncated mask (truncation
        # semantics themselves are pinned to the real readForest by the
        # random-forest differential tests).
        # ------------------------------------------------------------------
        mask17 = make_filter_mask(forest, max_tests=17)
        assert mask17.num_tests == 17
        sf_flat = build_sparsematch(mask17, settings)
        sf_supp = supports_to_numpy(*sf_flat(left, right))
        sf_acc = float((sf_supp[:, 2] == TRUE_DISP).mean())
        assert sf_acc > 0.99, f"small-forest support accuracy {sf_acc:.3f}"
        sf_fn = jax.jit(lambda l, r: _sparsematch_masked_impl(
            l, r, mask=mask17, settings=settings))
        sfbuf, sfcounts = sf_fn(left, right)
        sfdec = masked_supports_to_numpy(sfbuf, sfcounts, settings.disp_high)
        assert set(map(tuple, sfdec.tolist())) == set(map(tuple,
                                                          sf_supp.tolist())), \
            "small-forest masked set != flat set"

        def sfstep(a, b):
            buf, counts = _sparsematch_masked_impl(
                a, b, mask=mask17, settings=settings)
            return buf.sum(dtype=jnp.int32) + counts.sum(dtype=jnp.int32)

        sfbest = device_time_per_iter(sfstep, (left, right), rdep, N_SHORT,
                                      N_LONG, repeats=_rep(5))
        _aux("smallforest_sparsematch_throughput",
             2 * H * W / 1e6 / _nonzero(sfbest), "Mpix/s",
             "17-test truncated zero forest on the masked contract — the "
             "single-operand packed sort path, set-equality gated")

        # ------------------------------------------------------------------
        # config 4: extract — GT mining throughput (host-side numpy pipeline;
        # wall clock is the honest metric, no device in the loop), gated on
        # keypoint correctness against the scene's exact warp
        # ------------------------------------------------------------------
        import time as _time

        from opengpc_tpu.mine import extract_triplets, mine_stereo_pair

        rng = np.random.default_rng(1)
        m_left, m_right, m_disp, m_occ = make_scene(rng, H, W)
        oof = np.zeros((H, W), np.uint8)
        n_trip = 2000
        t0 = _time.perf_counter()
        kl, kr, kn = mine_stereo_pair(m_disp.astype(np.float64), m_occ, oof,
                                      n_trip, 10, 20, rng)
        trips = extract_triplets(m_left, m_right, kl, kr, kn)
        mine_dt = _time.perf_counter() - t0
        ok = (m_right[kr[:, 1], kr[:, 0]] == m_left[kl[:, 1], kl[:, 0]]).mean()
        assert ok > 0.999, f"mining keypoint correctness {ok:.4f}"
        assert len(trips) >= 0.9 * n_trip
        _aux("mining_triplets_per_s", len(trips) / _nonzero(mine_dt), "triplets/s",
             "config 4: extract (mine_stereo_pair + 27x27 patch crops, host)")

        # ------------------------------------------------------------------
        # config 5: train — split-scorer throughput (the training hot loop),
        # gated by the existing oracle trainfern parity (tests/test_train.py);
        # here we re-gate cheaply: scored counts must sum to N per candidate
        # ------------------------------------------------------------------
        from opengpc_tpu.train import _score_level, sample_candidates

        n_tr = 32768  # 72 MB of patches (ROADMAP Reach f resizes this cell)
        rng2 = np.random.default_rng(2)
        ref = rng2.integers(0, 256, (n_tr, 729))
        pos = np.clip(ref + rng2.integers(-8, 9, (n_tr, 729)), 0, 255)
        neg = rng2.integers(0, 256, (n_tr, 729))
        patches = jnp.asarray(
            np.stack([ref, pos, neg], axis=1).astype(np.uint8))
        cand = jnp.asarray(sample_candidates(rng2, 0, 10).astype(np.int32))
        num_taus = 20
        ones = jnp.ones((n_tr,), bool)

        def trn_step(p):
            counts = _score_level(p, cand, jnp.int32(-10), num_taus,
                                  ones, ones, ones)
            return counts.sum(dtype=jnp.int32) & 0xFF

        def trn_dep(s, args):
            (p,) = args
            p = jax.lax.dynamic_update_slice(
                p, (s & 1).astype(jnp.uint8).reshape(1, 1, 1), (0, 0, 0))
            return (p,)

        counts0 = np.asarray(jax.jit(lambda p: _score_level(
            p, cand, jnp.int32(-10), num_taus, ones, ones, ones))(patches))
        assert (counts0.sum(axis=-1) == n_tr).all(), "scored counts != N"
        # one scorer pass is short; chain thousands of iterations so the
        # loop-length difference dwarfs host jitter
        trn_best = device_time_per_iter(trn_step, (patches,), trn_dep, 3, N_LONG_TRAIN,
                                        repeats=_rep(3))
        evals = n_tr * 10 * num_taus  # triplet-test evaluations per pass
        _aux("train_split_evals_per_s", evals / _nonzero(trn_best) / 1e9,
             "G evals/s",
             "config 5: vectorized greedy split scorer (_score_level), "
             "32k triplets x 10 resamples x 20 taus")

        # ------------------------------------------------------------------
        # config 3a: batched pairs aggregate throughput per device — the
        # batch is FOLDED into one (B*H, 2W) segmented row sort
        # (infer._sparsematch_rows_batched_impl)
        # ------------------------------------------------------------------
        from opengpc_tpu.infer import _sparsematch_rows_batched_impl

        lefts, rights = [], []
        for b in range(BATCH):
            l2, r2 = make_pair(H, W, TRUE_DISP, seed=100 + b)
            lefts.append(l2)
            rights.append(r2)
        lb = np.stack(lefts)
        rb = np.stack(rights)
        brows_fn = jax.jit(lambda l, r: _sparsematch_rows_batched_impl(
            l, r, mask=mask, settings=settings))
        (bxs, bds), bcounts = brows_fn(lb, rb)
        # gate: stacked batch element 0 == the single-pair flat pipeline
        s0 = row_supports_to_numpy(np.asarray(bxs)[0], np.asarray(bds)[0],
                                   np.asarray(bcounts)[0])
        flat0 = supports_to_numpy(*match(lb[0], rb[0]))
        assert set(map(tuple, s0.tolist())) == set(map(tuple, flat0.tolist())), \
            "stacked batch supports != single-pair supports"
        acc0 = float((s0[:, 2] == TRUE_DISP).mean())
        assert acc0 > 0.99, f"batched pair-0 accuracy {acc0:.3f}"

        def bstep(a, b):
            (xs, ds), counts = _sparsematch_rows_batched_impl(
                a, b, mask=mask, settings=settings)
            return (xs.sum(dtype=jnp.int32) + ds.sum(dtype=jnp.int32)
                    + counts.sum(dtype=jnp.int32))

        def bdep(count, args):
            a, b = args
            a = jax.lax.dynamic_update_slice(
                a, (count & 1).astype(jnp.uint8).reshape(1, 1, 1), (0, 0, 0))
            return (a, b)

        bbest = device_time_per_iter(bstep, (lb, rb), bdep, N_SHORT, N_LONG_HEAVY,
                                     repeats=_rep(5))
        batch_mpix = 2 * BATCH * H * W / 1e6 / _nonzero(bbest)
        _aux("batched_rows_throughput", batch_mpix, "Mpix/s",
             f"config 3: B={BATCH} stacked into one (B*H, 2W) row sort, "
             "aggregate per chip")

        # batched MASKED contract: the same stacked fold without the row-pack
        # sort — the peak aggregate number (gate: batch element 0 decodes to
        # the single-pair flat set)
        bmasked_fn = jax.jit(lambda l, r: _sparsematch_masked_impl(
            l, r, mask=mask, settings=settings))
        bmbuf, bmcounts = bmasked_fn(lb, rb)
        bm0 = masked_supports_to_numpy(np.asarray(bmbuf)[0],
                                       np.asarray(bmcounts)[0],
                                       settings.disp_high)
        assert set(map(tuple, bm0.tolist())) == set(map(tuple, flat0.tolist())), \
            "batched masked pair-0 supports != single-pair supports"

        def bmstep(a, b):
            buf, counts = _sparsematch_masked_impl(
                a, b, mask=mask, settings=settings)
            return buf.sum(dtype=jnp.int32) + counts.sum(dtype=jnp.int32)

        bmbest = device_time_per_iter(bmstep, (lb, rb), bdep, N_SHORT, N_LONG_HEAVY,
                                      repeats=_rep(5))
        bmasked_mpix = 2 * BATCH * H * W / 1e6 / _nonzero(bmbest)
        _aux("batched_masked_throughput", bmasked_mpix, "Mpix/s",
             f"config 3: B={BATCH} stacked into one (B*H, 2W) masked emit "
             "(no pack sort), aggregate per chip")

        # ------------------------------------------------------------------
        # config 3b: 3-level pyramid multi-scale matching
        # ------------------------------------------------------------------
        from opengpc_tpu.pyramid import (build_pyramid_sparsematch,
                                         pyramid_supports_to_numpy)

        pmatch = build_pyramid_sparsematch(forest, settings, num_levels=3)
        rows = pyramid_supports_to_numpy(*pmatch(left, right))
        lv0 = rows[rows[:, 3] == 0]
        pacc = float((lv0[:, 2] == TRUE_DISP).mean())
        assert pacc > 0.99, f"pyramid level-0 accuracy {pacc:.3f}"

        def pstep(a, b):
            xs, ys, ds, lv, counts = pmatch(a, b)
            return (xs.sum(dtype=jnp.int32) + ys.sum(dtype=jnp.int32)
                    + ds.sum(dtype=jnp.int32) + lv.sum(dtype=jnp.int32)
                    + jnp.sum(counts))

        def pdep(count, args):
            a, b = args
            a = jax.lax.dynamic_update_slice(
                a, (count & 1).astype(jnp.uint8).reshape(1, 1), (0, 0))
            return (a, b)

        pbest = device_time_per_iter(pstep, (left, right), pdep, N_SHORT, N_LONG_HEAVY,
                                     repeats=_rep(5))
        # pyramid processes 2*(1 + 1/4 + 1/16) H*W pixels
        ppix = 2 * H * W * (1 + 0.25 + 0.0625)
        _aux("pyramid_throughput", ppix / 1e6 / _nonzero(pbest), "Mpix/s",
             "config 3: 3-level pyramid, all-level pixels counted")

        # low-density pyramid: chunk-compacted per-level matchers —
        # overflow-guarded, set-equality gated vs the rows
        # pyramid on the same scene (same (H, W) shape reuses its compile)
        from opengpc_tpu.pyramid import build_pyramid_sparsematch_compact

        cpmatch = build_pyramid_sparsematch_compact(
            forest, settings, num_levels=3)
        cp_out = cpmatch(sl, sr)
        assert not bool(np.asarray(cp_out[-1])), \
            "low-density scene tripped pyramid compact overflow"
        cp_set = set(map(tuple,
                         pyramid_supports_to_numpy(*cp_out[:-1]).tolist()))
        rp_set = set(map(tuple,
                         pyramid_supports_to_numpy(*pmatch(sl, sr)).tolist()))
        assert cp_set == rp_set, "compact pyramid set != rows pyramid set"

        def cpstep(a, b):
            xs, ys, ds, lv, counts, ovf = cpmatch(a, b)
            return (xs.sum(dtype=jnp.int32) + ys.sum(dtype=jnp.int32)
                    + ds.sum(dtype=jnp.int32) + lv.sum(dtype=jnp.int32)
                    + jnp.sum(counts) + ovf.astype(jnp.int32))

        prbest = device_time_per_iter(pstep, (sl, sr), pdep, N_SHORT, N_LONG_HEAVY,
                                      repeats=_rep(5))
        cpbest = device_time_per_iter(cpstep, (sl, sr), pdep, N_SHORT, N_LONG_HEAVY,
                                      repeats=_rep(5))
        _aux("lowdensity_pyramid_rows_throughput",
             ppix / 1e6 / _nonzero(prbest), "Mpix/s",
             "3-level rows pyramid on the 0.15-density scene (compact A/B "
             "baseline)")
        _aux("lowdensity_pyramid_compact_throughput",
             ppix / 1e6 / _nonzero(cpbest), "Mpix/s",
             "3-level chunk-compacted pyramid on the 0.15-density scene — "
             "overflow-guarded, set-equality gated vs the rows pyramid")

        # device densify: multigrid coarse-to-fine from the masked buffer
        # — gate: everything fills on the dense scene and the filled
        # region pins every seed; metric: ms/frame
        from opengpc_tpu.densify import _densify_from_masked

        dbuf, _dcounts = masked_fn(left, right)
        dbuf = jnp.asarray(dbuf)
        dv, df = _densify_from_masked(dbuf, settings.disp_high, 10, width=W)
        assert bool(np.asarray(df).all()), "densify left unfilled pixels"
        dacc = float(np.asarray(jnp.abs(dv - TRUE_DISP).max()))
        assert dacc < 0.5, f"densify max err {dacc} on the constant scene"

        def dstep(b):
            val, filled = _densify_from_masked(b, settings.disp_high, 10,
                                               width=W)
            return (val.sum(dtype=jnp.float32).astype(jnp.int32)
                    + filled.sum(dtype=jnp.int32))

        def ddep(s, args):
            (b,) = args
            b = jax.lax.dynamic_update_slice(
                b, (s & 1).reshape(1, 1), (0, 0))
            return (b,)

        dbest = device_time_per_iter(dstep, (dbuf,), ddep, N_SHORT,
                                     N_LONG_HEAVY, repeats=_rep(5))
        _aux("densify_ms_per_frame", dbest * 1e3, "ms",
             "device-resident multigrid densify from the masked buffer "
             "(10 sweeps/level; exact-fill gated on the constant-disparity "
             "scene)")

        # batched pyramid HYBRID fold: build_pyramid_sparsematch on a
        # (B, H, W) stack folds every level's matcher into one
        # (B*hs, 2W_l) row sort while the finest-wins dedup runs per pair
        # under lax.map.
        # Gate: stacked element 0 decodes to the single-pair pyramid set.
        from opengpc_tpu.pyramid import pyramid_supports_to_numpy

        bp_out = pmatch(lb, rb)
        bp0 = set(map(tuple, pyramid_supports_to_numpy(
            *(np.asarray(o)[0] for o in bp_out)).tolist()))
        sp0 = set(map(tuple,
                      pyramid_supports_to_numpy(*pmatch(lb[0],
                                                        rb[0])).tolist()))
        assert bp0 == sp0, "batched pyramid pair-0 != single-pair pyramid"

        def bpstep(a, b):
            xs, ys, ds, lv, counts = pmatch(a, b)
            return (xs.sum(dtype=jnp.int32) + ys.sum(dtype=jnp.int32)
                    + ds.sum(dtype=jnp.int32) + lv.sum(dtype=jnp.int32)
                    + jnp.sum(counts))

        bpbest = device_time_per_iter(bpstep, (lb, rb), bdep, N_SHORT,
                                      N_LONG_HEAVY, repeats=_rep(5))
        _aux("batched_pyramid_throughput",
             ppix * BATCH / 1e6 / _nonzero(bpbest), "Mpix/s",
             f"config 3: B={BATCH} pyramids, hybrid fold (per-level "
             "(B*hs, 2W) row sorts + per-pair lax.map dedup), aggregate "
             "per chip")

        print(
            "methodology note: all steps consume every output buffer (a "
            "count-only program lets XLA dead-code-eliminate the support "
            "compaction).  The headline contract is build_sparsematch_masked: "
            "detection results are emitted as a masked (H, 2W) buffer; the "
            "per-row left-packing the row-form contract did on device moves "
            "to the consumer (one vectorized nonzero host-side, included in "
            "CLI wall-clock numbers).",
            file=sys.stderr,
        )

    # Output contract: a reader that merges stdout+stderr and parses the
    # LAST JSON line gets the headline, even when the aux tail crashes.
    try:
        _aux_tail()
    finally:
        print(json.dumps(headline_rec), flush=True)



if __name__ == "__main__":
    main()

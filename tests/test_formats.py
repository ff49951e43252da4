"""Golden-file and round-trip tests for the persistent artifact contracts
(SURVEY.md §4 item 1)."""

import os

import numpy as np
import pytest

from opengpc_tpu import forest as forest_mod
from opengpc_tpu.forest import (
    Forest,
    Fern,
    Test,
    load_forest,
    parse_forest,
    serialize_forest,
    make_filter_mask,
)
from opengpc_tpu.io import (
    read_flo,
    write_flo,
    read_raw,
    write_raw,
    load_triplets,
    save_triplets,
    read_gray,
    read_rgb,
    write_png,
    read_png,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZERO_FOREST = os.path.join(REPO, "forests", "defaultZeroForest.txt")
TAU_FOREST = os.path.join(REPO, "forests", "defaultTauForest.txt")


class TestForestFormat:
    def test_parse_default_zero(self):
        f = load_forest(ZERO_FOREST)
        assert len(f.ferns) == 6
        assert [fern.scale for fern in f.ferns] == [2, 2, 1, 1, 0, 0]
        assert all(len(fern.tests) == 5 for fern in f.ferns)
        assert f.is_zero
        # first test of first fern: "0 -3 -3 2 3 0"
        assert f.ferns[0].tests[0] == Test(-3, -3, 2, 3, 0)

    def test_parse_default_tau(self):
        f = load_forest(TAU_FOREST)
        assert not f.is_zero
        assert f.ferns[0].tests[0] == Test(0, 3, -3, -2, 1)
        taus = [t.tau for fern in f.ferns for t in fern.tests]
        assert min(taus) >= -15 and max(taus) <= 15

    def test_roundtrip_identity(self):
        for path in (ZERO_FOREST, TAU_FOREST):
            f = load_forest(path)
            assert parse_forest(serialize_forest(f)) == f

    def test_serialized_tokens_match_reference_file(self):
        # Same token stream as the committed reference artifacts (the
        # reference writer separates with single spaces/newlines,
        # training.hpp:150-154; whitespace may differ).
        for path in (ZERO_FOREST, TAU_FOREST):
            f = load_forest(path)
            with open(path) as fh:
                assert serialize_forest(f).split() == fh.read().split()

    def test_filter_mask_cap32(self):
        # 7 ferns x 5 tests = 35 -> capped to 32 like inference.hpp:426-432
        fern = Fern(0, tuple(Test(i % 13, -(i % 13), 1, 2, 0) for i in range(5)))
        f = Forest(tuple([fern] * 7))
        fm = make_filter_mask(f)
        assert fm.num_tests == 32
        assert fm.type == 0

    def test_filter_mask_type_counts_discarded_taus(self):
        # tau != 0 only beyond the 32-test cap still flips the forest type
        # (inference.hpp:433 counts every parsed test)
        zero_fern = Fern(0, tuple(Test(1, 2, 3, 4, 0) for _ in range(5)))
        tau_fern = Fern(0, tuple(Test(1, 2, 3, 4, 7) for _ in range(5)))
        f = Forest(tuple([zero_fern] * 7 + [tau_fern]))
        fm = make_filter_mask(f)
        assert fm.num_tests == 32
        assert np.all(fm.tau == 0)
        assert fm.type == 1

    def test_patch_linear_index(self):
        assert forest_mod.patch_linear_index(0, 0) == 13 + 27 * 13
        assert forest_mod.patch_linear_index(-13, -13) == 0
        assert forest_mod.patch_linear_index(13, 13) == 728
        # scale-s example from Feature.hpp:144: i = 280 + (ix+3) + 27*(iy+3)
        assert forest_mod.patch_linear_index(-3, -3) == 280


class TestTriplets:
    def test_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        trips = rng.integers(0, 256, size=(17, 3, 729), dtype=np.uint8)
        p = str(tmp_path / "t.bin")
        save_triplets(trips, p)
        assert os.path.getsize(p) == 17 * 2187
        out = load_triplets(p)
        np.testing.assert_array_equal(out, trips)

    def test_bad_size_rejected(self, tmp_path):
        p = str(tmp_path / "bad.bin")
        with open(p, "wb") as f:
            f.write(b"\x00" * 1000)
        with pytest.raises(IOError):
            load_triplets(p)


class TestFlo:
    def test_roundtrip(self, tmp_path):
        rng = np.random.default_rng(1)
        u = rng.normal(size=(7, 9)).astype(np.float32)
        v = rng.normal(size=(7, 9)).astype(np.float32)
        p = str(tmp_path / "f.flo")
        write_flo(p, u, v)
        u2, v2 = read_flo(p)
        np.testing.assert_array_equal(u, u2)
        np.testing.assert_array_equal(v, v2)

    def test_bad_tag(self, tmp_path):
        p = str(tmp_path / "bad.flo")
        with open(p, "wb") as f:
            f.write(b"\x00" * 64)
        with pytest.raises(IOError):
            read_flo(p)


class TestRaw:
    def test_roundtrip_dtypes(self, tmp_path):
        rng = np.random.default_rng(2)
        for dt in (np.uint8, np.uint32, np.int32, np.float32):
            arr = rng.integers(0, 100, size=(5, 8)).astype(dt)
            p = str(tmp_path / f"{np.dtype(dt).name}.raw")
            write_raw(p, arr)
            np.testing.assert_array_equal(read_raw(p), arr)


class TestPng:
    def test_gray_roundtrip(self, tmp_path):
        rng = np.random.default_rng(3)
        img = rng.integers(0, 256, size=(20, 32), dtype=np.uint8)
        p = str(tmp_path / "g.png")
        write_png(p, img)
        np.testing.assert_array_equal(read_gray(p), img)

    def test_rgb_roundtrip_and_gray_conversion(self, tmp_path):
        rng = np.random.default_rng(4)
        img = rng.integers(0, 256, size=(10, 16, 3), dtype=np.uint8)
        p = str(tmp_path / "c.png")
        write_png(p, img)
        np.testing.assert_array_equal(read_rgb(p), img)
        # reference gray conversion: integer mean (buffer.hpp:298-301)
        expect = (
            img[:, :, 0].astype(np.uint32)
            + img[:, :, 1].astype(np.uint32)
            + img[:, :, 2].astype(np.uint32)
        ) // 3
        np.testing.assert_array_equal(read_gray(p), expect.astype(np.uint8))

    def test_python_and_native_agree(self, tmp_path):
        from opengpc_tpu.io import png as png_mod

        if png_mod._native_lib() is None:
            pytest.skip("native io library not built")
        rng = np.random.default_rng(5)
        img = rng.integers(0, 256, size=(13, 24, 3), dtype=np.uint8)
        p = str(tmp_path / "n.png")
        png_mod._write_python(p, img, 3)
        native, d1 = png_mod._read_native(p)
        pure, d2 = png_mod._read_python(p)
        assert d1 == d2 == 8
        np.testing.assert_array_equal(native, pure)


class TestPNGVariants:
    """Hand-constructed PNGs exercise the pure-python reader's 16-bit,
    palette, and sub-byte paths (reference semantics: buffer.hpp:280-301)."""

    @staticmethod
    def _mk_png(width, height, bit_depth, color_type, raw_scanlines,
                palette=None, interlace=0):
        import struct
        import zlib

        def chunk(typ, body):
            c = struct.pack(">I", len(body)) + typ + body
            return c + struct.pack(">I", zlib.crc32(typ + body) & 0xFFFFFFFF)

        ihdr = struct.pack(">IIBBBBB", width, height, bit_depth, color_type,
                           0, 0, interlace)
        out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
        if palette is not None:
            out += chunk(b"PLTE", palette)
        out += chunk(b"IDAT", zlib.compress(raw_scanlines))
        out += chunk(b"IEND", b"")
        return out

    def test_16bit_gray_truncates_low_byte(self, tmp_path):
        from opengpc_tpu.io.png import read_gray, read_png

        # 2x2 16-bit gray, big-endian samples
        vals = [0x0102, 0xFFEE, 0x0080, 0xABCD]
        rows = b""
        for r in range(2):
            rows += b"\x00"  # filter 0
            for v in vals[2 * r: 2 * r + 2]:
                rows += bytes([(v >> 8) & 0xFF, v & 0xFF])
        p = str(tmp_path / "g16.png")
        with open(p, "wb") as f:
            f.write(self._mk_png(2, 2, 16, 0, rows))
        arr, depth = read_png(p)
        assert depth == 16 and arr.dtype == np.uint16
        np.testing.assert_array_equal(arr.reshape(-1), vals)
        # read_gray truncates to the low byte like the reference's
        # ``*ptr = val`` with T = uint8_t (buffer.hpp:284-286)
        g = read_gray(p)
        np.testing.assert_array_equal(
            g.reshape(-1), [v & 0xFF for v in vals]
        )

    def test_palette_png(self, tmp_path):
        from opengpc_tpu.io.png import read_gray

        palette = bytes([10, 20, 30, 200, 100, 0])  # 2 entries
        rows = b"\x00\x00\x01" + b"\x00\x01\x00"    # 2x2, 8-bit indices
        p = str(tmp_path / "pal.png")
        with open(p, "wb") as f:
            f.write(self._mk_png(2, 2, 8, 3, rows, palette))
        g = read_gray(p)
        c0 = (10 + 20 + 30) // 3
        c1 = (200 + 100 + 0) // 3
        np.testing.assert_array_equal(g, [[c0, c1], [c1, c0]])

    def test_1bit_gray(self, tmp_path):
        from opengpc_tpu.io.png import read_gray

        # 4x1, bits 1010 -> 255, 0, 255, 0
        rows = b"\x00\xa0"
        p = str(tmp_path / "b1.png")
        with open(p, "wb") as f:
            f.write(self._mk_png(4, 1, 1, 0, rows))
        g = read_gray(p)
        np.testing.assert_array_equal(g, [[255, 0, 255, 0]])


class TestInterlacedPngs:
    """Adam7-interlaced PNGs (a real-file encoder variant the synthetic
    fixtures flagged as residual risk): the pure-python fallback must
    deinterlace exactly like libpng (png_set_interlace_handling,
    cpp/io.cc:65), pinned here against hand-built pass data AND the
    native reader when available."""

    _PASSES = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

    @classmethod
    def _scanlines(cls, arr, bit_depth):
        out = b""
        for x0, y0, dx, dy in cls._PASSES:
            sub = arr[y0::dy, x0::dx]
            if sub.shape[0] == 0 or sub.shape[1] == 0:
                continue
            for row in sub:
                if bit_depth == 16:
                    out += b"\x00" + row.astype(">u2").tobytes()
                elif bit_depth == 8:
                    out += b"\x00" + row.astype(np.uint8).tobytes()
                elif bit_depth == 1:
                    out += b"\x00" + np.packbits(
                        row.astype(np.uint8).reshape(-1)).tobytes()
                else:
                    raise AssertionError(bit_depth)
        return out

    def _check(self, tmp_path, arr, bit_depth, color_type, name):
        from opengpc_tpu.io.png import _read_python, read_png

        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(TestPNGVariants._mk_png(
                arr.shape[1], arr.shape[0], bit_depth, color_type,
                self._scanlines(arr, bit_depth), interlace=1))
        got, depth = _read_python(p)
        return p, got, depth

    @pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (8, 8), (13, 21)])
    def test_gray8(self, tmp_path, h, w):
        from opengpc_tpu.io.png import read_png

        rng = np.random.default_rng(h * 100 + w)
        arr = rng.integers(0, 256, (h, w)).astype(np.uint8)
        p, got, depth = self._check(tmp_path, arr, 8, 0, "i8.png")
        assert depth == 8
        np.testing.assert_array_equal(got, arr)
        native, ndepth = read_png(p)  # libpng path when built
        np.testing.assert_array_equal(np.asarray(native), arr)

    def test_gray16(self, tmp_path):
        rng = np.random.default_rng(7)
        arr = rng.integers(0, 1 << 16, (6, 11)).astype(np.uint16)
        _, got, depth = self._check(tmp_path, arr, 16, 0, "i16.png")
        assert depth == 16 and got.dtype == np.uint16
        np.testing.assert_array_equal(got, arr)

    def test_rgb8(self, tmp_path):
        from opengpc_tpu.io.png import read_png

        rng = np.random.default_rng(8)
        arr = rng.integers(0, 256, (9, 14, 3)).astype(np.uint8)
        p, got, depth = self._check(tmp_path, arr, 8, 2, "irgb.png")
        np.testing.assert_array_equal(got, arr)
        native, _ = read_png(p)
        np.testing.assert_array_equal(np.asarray(native), arr)

    def test_gray1(self, tmp_path):
        arr = (np.arange(5 * 9).reshape(5, 9) % 2).astype(np.uint8)
        _, got, depth = self._check(tmp_path, arr, 1, 0, "i1.png")
        assert depth == 8
        np.testing.assert_array_equal(got, arr * 255)


def test_read_gray_batch(tmp_path):
    from opengpc_tpu.io.png import read_gray, read_gray_batch, write_png

    rng = np.random.default_rng(0)
    paths = []
    imgs = []
    for i in range(6):
        img = rng.integers(0, 256, (20 + i, 30)).astype(np.uint8)
        p = str(tmp_path / f"im{i}.png")
        write_png(p, img)
        paths.append(p)
        imgs.append(img)
    out = read_gray_batch(paths, max_workers=4)
    for got, want in zip(out, imgs):
        np.testing.assert_array_equal(got, want)


def test_truncate_forest_matches_cap_rule():
    """truncate_forest(f, n) must materialize exactly the reference's
    file-order cap rule: its tests are f.flat_tests(n), its filter mask
    equals make_filter_mask(f, max_tests=n) (offsets + taus), and it
    round-trips through the text format like any forest."""
    import numpy as np

    from opengpc_tpu.forest import (load_forest, make_filter_mask,
                                    parse_forest, serialize_forest,
                                    truncate_forest)
    from opengpc_tpu.utils.fuzz import random_forest

    forests = [load_forest(f"forests/default{k}Forest.txt")
               for k in ("Zero", "Tau")]
    rng = np.random.default_rng(11)
    forests += [random_forest(rng) for _ in range(3)]
    for f in forests:
        for n in (1, 2, 5, 15, 17, f.num_tests, f.num_tests + 7):
            tf = truncate_forest(f, n)
            assert tf.flat_tests(64) == f.flat_tests(n)
            m_t = make_filter_mask(tf, max_tests=n)
            m_f = make_filter_mask(f, max_tests=n)
            assert (m_t.i_off == m_f.i_off).all()
            assert (m_t.j_off == m_f.j_off).all()
            assert (m_t.tau == m_f.tau).all()
            assert parse_forest(serialize_forest(tf)) == tf
    import pytest

    with pytest.raises(ValueError):
        truncate_forest(forests[0], 0)


def test_truncate_forest_tau_prefix_type_corner():
    """Documented corner: a TAU forest whose kept prefix is all-zero
    derives type 0 (the reference's type rule counts every parsed test).
    The pipelines must still emit the identical support set — a tau test
    with tau == 0 is the zero test."""
    import numpy as np

    from opengpc_tpu.config import InferenceSettings
    from opengpc_tpu.forest import (Fern, Forest, Test, make_filter_mask,
                                    truncate_forest)
    from opengpc_tpu.infer import build_sparsematch, supports_to_numpy
    from opengpc_tpu.utils.scenes import make_pair

    rng = np.random.default_rng(3)
    zero_tests = tuple(
        Test(*map(int, rng.integers(-3, 4, 4)), tau=0) for _ in range(8))
    tau_tests = tuple(
        Test(*map(int, rng.integers(-3, 4, 4)), tau=int(t)) for t in (3, -2))
    f = Forest(ferns=(Fern(scale=2, tests=zero_tests),
                      Fern(scale=2, tests=tau_tests)))
    assert not f.is_zero
    tf = truncate_forest(f, 8)
    assert tf.is_zero  # type flips — results must not
    m_full_rule = make_filter_mask(f, max_tests=8)   # type 1, taus all 0
    m_trunc = make_filter_mask(tf)                   # type 0
    assert m_full_rule.type == 1 and m_trunc.type == 0
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True,
                                 vertical_tolerance=0, disp_high=16,
                                 capacity=4096)
    left, right = make_pair(64, 96, 3, seed=5)
    a = supports_to_numpy(*build_sparsematch(m_full_rule, settings)(left, right))
    b = supports_to_numpy(*build_sparsematch(m_trunc, settings)(left, right))
    assert set(map(tuple, a.tolist())) == set(map(tuple, b.tolist()))
    assert len(a) > 0


def test_write_supports_byte_identical_to_savetxt(tmp_path):
    """io.supports.write_supports (native itoa writer, cpp/decode.cc) must
    be byte-identical to np.savetxt(fmt='%d') — the supports-file format is
    an interchange surface with the oracle and the e2e tests."""
    import numpy as np

    import opengpc_tpu.io.png as iopng
    from opengpc_tpu.io.supports import read_supports, write_supports

    lib = iopng._native_lib()
    if lib is None:
        import pytest
        pytest.skip("native library not built")
    # a loaded lib without the symbol means a stale build — fail, don't
    # silently compare savetxt against itself
    assert hasattr(lib, "ogpc_write_supports"), \
        "stale cpp/build/libopengpc_io.so: rebuild with `make -C cpp`"
    rng = np.random.default_rng(3)
    a = np.stack([rng.integers(0, 2048, 5000),
                  rng.integers(0, 512, 5000),
                  rng.integers(-128, 129, 5000)], axis=1).astype(np.int32)
    p1, p2 = tmp_path / "a.txt", tmp_path / "b.txt"
    write_supports(str(p1), a)
    np.savetxt(str(p2), a, fmt="%d")
    assert p1.read_bytes() == p2.read_bytes()
    assert (read_supports(str(p1)) == a).all()
    write_supports(str(tmp_path / "e.txt"), a[:0])
    assert (tmp_path / "e.txt").read_bytes() == b""


def test_write_supports_parallel_byte_identical(tmp_path):
    """The threaded writer (ogpc_write_supports_par: per-thread slice
    formatting, ordered buffer writes) must stay byte-identical to savetxt
    above its 50k-row engagement threshold."""
    import ctypes

    import numpy as np

    import opengpc_tpu.io.png as iopng
    from opengpc_tpu.io.supports import write_supports

    lib = iopng._native_lib()
    if lib is None:
        import pytest
        pytest.skip("native library not built")
    assert hasattr(lib, "ogpc_write_supports_par"), \
        "stale cpp/build/libopengpc_io.so: rebuild with `make -C cpp`"
    rng = np.random.default_rng(4)
    n = 60_000  # above the write_supports par threshold
    a = np.stack([rng.integers(0, 4096, n),
                  rng.integers(0, 2048, n),
                  rng.integers(-(2**31), 2**31, n)], axis=1).astype(np.int32)
    a[0] = (-(2**31), 0, 2**31 - 1)  # INT32_MIN through the itoa
    p1, p2, p3 = (tmp_path / f for f in ("p.txt", "s.txt", "t.txt"))
    write_supports(str(p1), a)
    np.savetxt(str(p2), a, fmt="%d")
    assert p1.read_bytes() == p2.read_bytes()
    # direct-lib thread sweep incl. more threads than a tiny n
    for t, nn in ((7, n), (5, 3), (3, 0)):
        rc = lib.ogpc_write_supports_par(
            str(p3).encode(),
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), nn, t)
        assert rc == 0
        want = p2.read_bytes() if nn == n else b"".join(
            b"%d %d %d\n" % tuple(r) for r in a[:nn].tolist())
        assert p3.read_bytes() == want, (t, nn)

    # multi-block streaming: n > 64Ki crosses the t=1 block boundary
    # (the writer streams fixed-size blocks instead of materializing the
    # whole file — 40 bytes/line for 10M+ triples would be 400 MB+), and
    # t=2 exercises a block whose last slice is partial
    big = np.tile(a, (3, 1))[: (1 << 16) + 12345]
    pb = tmp_path / "b.txt"
    for t in (1, 2):
        rc = lib.ogpc_write_supports_par(
            str(pb).encode(),
            big.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            big.shape[0], t)
        assert rc == 0
        np.savetxt(str(p2), big, fmt="%d")
        assert pb.read_bytes() == p2.read_bytes(), t


class TestCorruptInputs:
    """Error-path contracts: malformed forests and PNGs raise clear
    ValueError/IOError instead of returning garbage or leaking internals
    (the reference reads both formats unchecked — inference.hpp:404-446
    forest parse, buffer.hpp:197-474 PNG — and would walk into UB)."""

    @pytest.mark.parametrize("text,msg", [
        ("", "truncated"),
        ("2\n0 s 5\n0 1 1 2 2 0\n", "truncated"),     # fewer tests than declared
        ("1\n0 X 1\n0 0 0 0 0 0\n", "scale char"),    # bad scale letter
    ])
    def test_malformed_forest_raises(self, text, msg):
        with pytest.raises(ValueError, match=msg):
            parse_forest(text)

    def test_non_integer_token_raises(self):
        with pytest.raises(ValueError):
            parse_forest("1\n0 s foo\n")

    def test_empty_forest_rejected_by_mask(self):
        assert parse_forest("0\n").num_tests == 0
        with pytest.raises(ValueError, match="no tests"):
            make_filter_mask(parse_forest("0\n"))

    def test_out_of_window_offsets_rejected(self):
        # the fused kernel DMAs a fixed PATCH_HALF halo per tile; a forest
        # with wider offsets would silently read the wrong rows — the mask
        # builder must refuse it loudly
        bad = Forest((Fern(0, (Test(14, 0, 0, 0, 0),)),))
        with pytest.raises(ValueError, match="patch window"):
            make_filter_mask(bad)
        ok = Forest((Fern(0, (Test(13, -13, 13, -13, 0),)),))
        assert make_filter_mask(ok).num_tests == 1

    def _corrupt_pngs(self, tmp_path):
        arr = (np.arange(64 * 48, dtype=np.uint8).reshape(48, 64) % 251)
        good = tmp_path / "good.png"
        write_png(str(good), arr)
        data = good.read_bytes()
        not_png = tmp_path / "notpng.png"
        not_png.write_bytes(b"hello world, definitely not a png")
        trunc = tmp_path / "trunc.png"
        trunc.write_bytes(data[: len(data) // 2])
        flipped = tmp_path / "flip.png"
        bad = bytearray(data)
        bad[50] ^= 0xFF  # inside the IDAT stream
        flipped.write_bytes(bytes(bad))
        return [not_png, trunc, flipped]

    def test_corrupt_png_raises_ioerror_native_or_python(self, tmp_path):
        # public read_png (native libpng fast path when built)
        for p in self._corrupt_pngs(tmp_path):
            with pytest.raises(IOError):
                read_png(str(p))

    def test_corrupt_png_raises_ioerror_pure_python(self, tmp_path):
        # the pure-python fallback must match the error surface — a bare
        # zlib.error used to leak from truncated/bit-flipped IDAT streams
        from opengpc_tpu.io.png import _read_python

        for p in self._corrupt_pngs(tmp_path):
            with pytest.raises(IOError):
                _read_python(str(p))

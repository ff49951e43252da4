"""GPC forest model and its persistent text format.

This is the central artifact contract of the framework: a *forest* is an
ordered list of *ferns* (oblivious decision trees); each fern has a patch
scale (s=7x7, m=17x17, l=27x27 sub-window of a 27x27 patch) and an ordered
list of binary tests.  A test compares two pixels of a (box-blurred) image
patch: ``sign(img[p + (ix, iy)] - img[p + (jx, jy)] - tau)``.

The text serialization is bit-compatible with the reference implementation
(writer: /root/reference/lib/gpc/training.hpp:142-158, reader:
/root/reference/lib/gpc/inference.hpp:404-446)::

    numFerns
    fernId scaleChar numTests
    level ix iy jx jy tau     # numTests lines per fern
    ...

For inference the forest is *flattened* to at most 32 tests in file order
(the reference caps the filter mask at 32 tests and discards the rest,
inference.hpp:426-432).  A forest whose parsed tests all have tau == 0 is a
"zero forest" (type 0); otherwise it is a "tau forest" (type 1)
(inference.hpp:436-445 counts *every* parsed test, including discarded
ones, when deciding the type).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

# scale codes: match the reference's FernSettings.scale
# (Fern.hpp:405-413: s -> 2, m -> 1, l -> 0)
SCALE_S, SCALE_M, SCALE_L = 2, 1, 0

_SCALE_TO_CHAR = {SCALE_S: "s", SCALE_M: "m", SCALE_L: "l"}
_CHAR_TO_SCALE = {v: k for k, v in _SCALE_TO_CHAR.items()}

# Sub-window half-sizes per scale (Feature.hpp:133-177).
SCALE_HALF = {SCALE_S: 3, SCALE_M: 8, SCALE_L: 13}

MAX_TESTS = 32  # inference filter-mask cap (inference.hpp:426)
PATCH = 27      # patch side length
PATCH_HALF = 13


@dataclasses.dataclass(frozen=True)
class Test:
    """One binary test: img[p + (ix, iy)] > img[p + (jx, jy)] - tau.

    Offsets are in *image* coordinates as used by the inference filter mask
    (inference.hpp:427-428: linear offset = ix + iy * width, i.e. ix is the
    x/column offset and iy the y/row offset).
    """

    __test__ = False  # keep pytest from collecting this dataclass

    ix: int
    iy: int
    jx: int
    jy: int
    tau: int = 0


@dataclasses.dataclass(frozen=True)
class Fern:
    scale: int  # SCALE_S / SCALE_M / SCALE_L
    tests: Tuple[Test, ...]

    def __post_init__(self):
        if self.scale not in _SCALE_TO_CHAR:
            raise ValueError(f"bad fern scale {self.scale}")


@dataclasses.dataclass(frozen=True)
class Forest:
    ferns: Tuple[Fern, ...]

    @property
    def num_tests(self) -> int:
        return sum(len(f.tests) for f in self.ferns)

    @property
    def is_zero(self) -> bool:
        """True iff every test (in every fern) has tau == 0."""
        return all(t.tau == 0 for f in self.ferns for t in f.tests)

    def flat_tests(self, max_tests: int = MAX_TESTS) -> Tuple[Test, ...]:
        """Tests in file order, capped like the reference filter mask."""
        out: List[Test] = []
        for f in self.ferns:
            for t in f.tests:
                if len(out) < max_tests:
                    out.append(t)
        return tuple(out)


def parse_forest(text: str) -> Forest:
    """Parse the reference text forest format (inference.hpp:404-446)."""
    toks = text.split()
    pos = 0

    def nxt() -> str:
        nonlocal pos
        if pos >= len(toks):
            raise ValueError("truncated forest file")
        tok = toks[pos]
        pos += 1
        return tok

    num_ferns = int(nxt())
    ferns: List[Fern] = []
    for _ in range(num_ferns):
        _fern_id = int(nxt())
        scale_char = nxt()
        if scale_char not in _CHAR_TO_SCALE:
            raise ValueError(f"bad fern scale char {scale_char!r}")
        scale = _CHAR_TO_SCALE[scale_char]
        num_tests = int(nxt())
        tests = []
        for _ in range(num_tests):
            _level = int(nxt())
            ix, iy, jx, jy, tau = (int(nxt()) for _ in range(5))
            tests.append(Test(ix, iy, jx, jy, tau))
        ferns.append(Fern(scale, tuple(tests)))
    return Forest(tuple(ferns))


def load_forest(path: str) -> Forest:
    with open(path, "r") as f:
        return parse_forest(f.read())


def serialize_forest(forest: Forest) -> str:
    """Serialize to the reference writer's exact byte layout
    (training.hpp:142-158: values separated by single spaces, one record
    per line, trailing newline)."""
    lines = [f"{len(forest.ferns)}"]
    for f_id, fern in enumerate(forest.ferns):
        lines.append(f"{f_id} {_SCALE_TO_CHAR[fern.scale]} {len(fern.tests)}")
        for lvl, t in enumerate(fern.tests):
            lines.append(f"{lvl} {t.ix} {t.iy} {t.jx} {t.jy} {t.tau}")
    return "\n".join(lines) + "\n"


def save_forest(forest: Forest, path: str) -> None:
    with open(path, "w") as f:
        f.write(serialize_forest(forest))


@dataclasses.dataclass(frozen=True)
class FilterMask:
    """Flattened forest ready for the code kernel.

    Equivalent of the reference FilterMask (inference.hpp:137-156) but
    width-independent: offsets stay 2-D ``(dy, dx)`` and are turned into
    static slices at trace time instead of being baked into linear offsets
    for one image width (inference.hpp:427-428).

    ``type`` follows the reference: 0 = zero forest (all tau 0), 1 = tau
    forest.  ``i_off``/``j_off`` have shape (T, 2) with rows (dy, dx);
    ``tau`` has shape (T,).
    """

    i_off: np.ndarray
    j_off: np.ndarray
    tau: np.ndarray
    type: int

    @property
    def num_tests(self) -> int:
        return int(self.i_off.shape[0])


def make_filter_mask(forest: Forest, max_tests: int = MAX_TESTS) -> FilterMask:
    tests = forest.flat_tests(max_tests)
    if not tests:
        raise ValueError("forest has no tests")
    i_off = np.array([(t.iy, t.ix) for t in tests], dtype=np.int32)
    j_off = np.array([(t.jy, t.jx) for t in tests], dtype=np.int32)
    # every downstream consumer assumes offsets live inside the 27x27
    # patch window (jnp path pads by PATCH_HALF; the fused Pallas kernel
    # DMAs a fixed PATCH_HALF halo per tile and would silently read the
    # wrong rows) — reject corrupt forests loudly instead.  The reference
    # bakes offsets into unchecked linear indices (inference.hpp:427-428),
    # so no valid reference forest can exceed this.
    if max(int(np.abs(i_off).max()), int(np.abs(j_off).max())) > PATCH_HALF:
        raise ValueError(
            f"forest test offsets exceed the {2*PATCH_HALF+1}x"
            f"{2*PATCH_HALF+1} patch window (|offset| > {PATCH_HALF}); "
            "corrupt or incompatible forest file")
    tau = np.array([t.tau for t in tests], dtype=np.int32)
    ftype = 0 if forest.is_zero else 1
    return FilterMask(i_off=i_off, j_off=j_off, tau=tau, type=ftype)


def truncate_forest(forest: Forest, max_tests: int) -> Forest:
    """A forest containing exactly ``forest.flat_tests(max_tests)`` — whole
    ferns in file order, the boundary fern cut level-wise, empty trailing
    ferns dropped.  This is the reference's own file-order cap rule
    (inference.hpp:426-432) materialized as a forest artifact, so the
    result serializes/round-trips like any other forest.

    Why: the matcher sort drops its payload operand when
    ``num_tests + bit_length(2W-1) <= 30`` (match._pack_ok — ≤17 tests at
    Sintel width): one sort operand less, for fewer supports.
    ``truncate_forest(f, n)`` gives the same filter mask
    as ``make_filter_mask(f, max_tests=n)`` except for one corner: a TAU
    forest whose kept prefix is all-zero derives type 0 instead of the
    reference's all-parsed-tests type rule — the match results are
    identical either way (a tau test with tau == 0 is the zero test), only
    the kernel variant differs.
    """
    if max_tests < 1:
        raise ValueError(f"max_tests must be >= 1, got {max_tests}")
    ferns: List[Fern] = []
    left = max_tests
    for f in forest.ferns:
        if left <= 0:
            break
        take = f.tests[:left]
        if take:
            ferns.append(Fern(scale=f.scale, tests=tuple(take)))
            left -= len(take)
    return Forest(ferns=tuple(ferns))


def patch_linear_index(ix: int, iy: int) -> int:
    """Linear index of offset (ix, iy) inside a serialized 27x27 patch.

    The reference stores training patches *transposed* relative to image
    axes (buffer.hpp:534-544: patch(row=a, col=b) = image(x+a-13, y+b-13))
    and training reads element ``(ix+13) + 27*(iy+13)`` for a test offset
    (ix, iy) (Feature.hpp:144,157,171).  We preserve both conventions so
    the binary triplet format and trained forests stay interchangeable
    with the reference.
    """
    return (ix + PATCH_HALF) + PATCH * (iy + PATCH_HALF)

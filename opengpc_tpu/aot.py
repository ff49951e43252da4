"""AOT export / serving: freeze a matcher pipeline into a serialized
StableHLO artifact.

``jax.export`` traces and lowers the COMPLETE device pipeline once
(preprocess + codes + matcher + output contract) and serializes the
resulting StableHLO module; a serving process deserializes and calls it
with zero Python re-tracing — only jax and the artifact are needed, not
this package or the forest file.  This is the analog of shipping the
reference's compiled sparsematch binary
(/root/reference/samples/sparsematch.cpp, built once per deployment):
the forest, settings, frame shape, and output contract are burned in at
export time, and the PJRT runtime executes the module on any matching
backend.

Artifacts are self-describing: a small JSON header records the output
contract and the decode parameters, so a generic server can route the
device outputs to the right host-side decoder
(``masked_supports_to_numpy`` & co — which remain ordinary host code).

The exported module itself is written by ``_serialize`` in a container that
needs nothing beyond jax: ``jax.export``'s own ``serialize()`` needs the
``flatbuffers`` package, which a serving host may lack.  Blobs in the
``jax.export`` format still load where ``flatbuffers`` is installed.

One artifact can target several platforms (``platforms=("cpu",
"cuda")``; JAX names the NVIDIA GPU export target ``cuda``).
"""

from __future__ import annotations

import functools
import json
import struct
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from opengpc_tpu.config import InferenceSettings
from opengpc_tpu.forest import Forest, make_filter_mask

CONTRACTS = ("flat", "rows", "masked", "masked-compact", "global-rows",
             "global-compact", "pyramid", "pyramid-compact")

_MAGIC = b"OGPCAOT1"
_BLOB_MAGIC = b"OGPCXLA1"


def _skeleton(treedef):
    """JSON form of a pytree structure (tuples, lists, dicts, None; 0 for
    each leaf)."""
    import jax

    def enc(x):
        if isinstance(x, tuple):
            return {"t": [enc(v) for v in x]}
        if isinstance(x, list):
            return {"l": [enc(v) for v in x]}
        if isinstance(x, dict):
            return {"d": [[k, enc(v)] for k, v in x.items()]}
        if x is None:
            return {"n": 0}
        return 0

    return enc(jax.tree_util.tree_unflatten(treedef,
                                            [0] * treedef.num_leaves))


def _from_skeleton(obj):
    import jax

    def dec(x):
        if not isinstance(x, dict):
            return 0
        (kind, v), = x.items()
        if kind == "t":
            return tuple(dec(e) for e in v)
        if kind == "l":
            return [dec(e) for e in v]
        if kind == "d":
            return {k: dec(e) for k, e in v}
        return None

    return jax.tree_util.tree_structure(dec(obj))


def _serialize(exp) -> bytes:
    """``jax.export.Exported`` -> bytes without ``flatbuffers``: a JSON
    header with the fields this repo's exports use, then the StableHLO
    module.  Argument shardings, effects and disabled safety checks are
    never used here and are refused rather than dropped."""
    if (any(s is not None for s in exp.in_shardings_hlo
            + exp.out_shardings_hlo)
            or exp.ordered_effects or exp.unordered_effects
            or exp.disabled_safety_checks):
        raise ValueError("module uses argument shardings, effects or "
                         "disabled safety checks; not supported by the "
                         "artifact container")
    head = json.dumps({
        "fun_name": exp.fun_name,
        "in_tree": _skeleton(exp.in_tree),
        "out_tree": _skeleton(exp.out_tree),
        "in_avals": [[list(a.shape), str(a.dtype)] for a in exp.in_avals],
        "out_avals": [[list(a.shape), str(a.dtype)] for a in exp.out_avals],
        "nr_devices": exp.nr_devices,
        "platforms": list(exp.platforms),
        "calling_convention_version": exp.calling_convention_version,
        "module_kept_var_idx": list(exp.module_kept_var_idx),
        "uses_global_constants": exp.uses_global_constants,
    }).encode()
    return (_BLOB_MAGIC + struct.pack("<I", len(head)) + head
            + exp.mlir_module_serialized)


def _deserialize(data: bytes):
    """Inverse of :func:`_serialize`; blobs in ``jax.export``'s own format
    go to ``jax.export.deserialize``."""
    import jax
    from jax import export as jexport

    data = bytes(data)
    if not data.startswith(_BLOB_MAGIC):
        return jexport.deserialize(bytearray(data))
    (hlen,) = struct.unpack_from("<I", data, len(_BLOB_MAGIC))
    start = len(_BLOB_MAGIC) + 4
    h = json.loads(data[start:start + hlen].decode())

    def avals(rows):
        return tuple(jax.core.ShapedArray(tuple(shape), np.dtype(dt))
                     for shape, dt in rows)

    n_in, n_out = len(h["in_avals"]), len(h["out_avals"])
    return jexport.Exported(
        fun_name=h["fun_name"],
        in_tree=_from_skeleton(h["in_tree"]),
        in_avals=avals(h["in_avals"]),
        out_tree=_from_skeleton(h["out_tree"]),
        out_avals=avals(h["out_avals"]),
        _has_named_shardings=True,
        _in_named_shardings=(None,) * n_in,
        _out_named_shardings=(None,) * n_out,
        in_shardings_hlo=(None,) * n_in,
        out_shardings_hlo=(None,) * n_out,
        nr_devices=h["nr_devices"],
        platforms=tuple(h["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=(),
        mlir_module_serialized=data[start + hlen:],
        calling_convention_version=h["calling_convention_version"],
        module_kept_var_idx=tuple(h["module_kept_var_idx"]),
        uses_global_constants=h["uses_global_constants"],
        _get_vjp=None,
    )


def _impl_for(contract: str, mask, settings: InferenceSettings,
              shape, num_levels: int = 3) -> Callable:
    """Resolve the jit-able impl for ``contract``, validating eligibility
    for ``shape`` the same way the build_* constructors do.
    ``num_levels`` applies to the pyramid contracts only."""
    from opengpc_tpu.infer import (_global_rows_ok, _rows_ok,
                                   _sparsematch_global_compact_impl,
                                   _sparsematch_global_rows_impl,
                                   _sparsematch_impl,
                                   _sparsematch_masked_compact_impl,
                                   _sparsematch_masked_impl,
                                   _sparsematch_rows_impl)

    if contract not in CONTRACTS:
        raise ValueError(f"contract must be one of {CONTRACTS}, "
                         f"got {contract!r}")
    if contract in ("pyramid", "pyramid-compact"):
        from opengpc_tpu.pyramid import (_pyramid_compact_impl,
                                         _pyramid_impl, _rows_eligible)

        if contract == "pyramid":
            # _pyramid_impl routes to the rows pyramid when eligible and
            # falls back to the flat per-level path otherwise — both
            # freeze fine (same output contract)
            return functools.partial(
                _pyramid_impl, mask=mask, settings=settings,
                num_levels=num_levels, dedup=True)
        el = _rows_eligible(mask, settings, shape[0], shape[1], num_levels)
        if el is None or settings.disp_high < 1:
            raise ValueError(
                "contract 'pyramid-compact' needs epipolar mode, a "
                "<=30-test packable forest, disp_high >= 1 and 31-bit "
                f"packable dedup keys for shape {shape} x {num_levels} "
                "levels; export 'pyramid' instead")
        mult, nbd = el
        return functools.partial(
            _pyramid_compact_impl, mask=mask, settings=settings,
            num_levels=num_levels, mult=mult, nbd=nbd, chunk=None, k=None)
    if contract == "flat":
        return functools.partial(_sparsematch_impl, mask=mask,
                                 settings=settings)
    if contract in ("global-rows", "global-compact"):
        if settings.epipolar_mode:
            raise ValueError(f"contract {contract!r} needs "
                             "epipolar_mode=False")
        if not _global_rows_ok(mask, shape, settings):
            raise ValueError(f"contract {contract!r} has no packable key "
                             f"for shape {shape}")
        if contract == "global-compact":
            return functools.partial(_sparsematch_global_compact_impl,
                                     mask=mask, settings=settings,
                                     chunk=None, k=None)
        return functools.partial(_sparsematch_global_rows_impl, mask=mask,
                                 settings=settings)
    if not _rows_ok(mask, shape, settings):
        raise ValueError(f"contract {contract!r} needs epipolar mode, a "
                         f"<=30-test forest and packable (x, d) keys for "
                         f"shape {shape}")
    if contract == "masked-compact":
        return functools.partial(_sparsematch_masked_compact_impl,
                                 mask=mask, settings=settings,
                                 chunk=None, k=None)
    impl = {"rows": _sparsematch_rows_impl,
            "masked": _sparsematch_masked_impl}[contract]
    return functools.partial(impl, mask=mask, settings=settings)


def export_sparsematch(forest_or_mask, settings: InferenceSettings,
                       shape: Tuple[int, int], contract: str = "masked",
                       platforms: Optional[Sequence[str]] = None,
                       num_levels: int = 3) -> bytes:
    """Serialize the full matcher pipeline for one (H, W) frame shape.

    Returns the serialized module (``_serialize``; no artifact header —
    see ``save_artifact`` for the self-describing file format).  ``platforms``
    defaults to the current backend; pass ``("cpu", "cuda")`` for one
    multi-platform artifact.  ``num_levels`` applies to the pyramid
    contracts (burned into the module like everything else).
    """
    import jax
    from jax import export as jexport

    mask = (make_filter_mask(forest_or_mask)
            if isinstance(forest_or_mask, Forest) else forest_or_mask)
    plats = tuple(platforms) if platforms else None
    fn = jax.jit(_impl_for(contract, mask, settings, shape,
                           num_levels=num_levels))
    spec = jax.ShapeDtypeStruct(tuple(shape), np.uint8)
    return _serialize(jexport.export(fn, platforms=plats)(spec, spec))


def load_sparsematch(data: bytes) -> Callable:
    """Deserialize an ``export_sparsematch`` blob into a jitted callable
    ``(left, right) -> device outputs`` (layout per the exported
    contract).  Needs only jax — no forest file, no re-trace."""
    import jax

    return jax.jit(_deserialize(data).call)


def export_sharded_frame(forest_or_mask, settings: InferenceSettings,
                         shape: Tuple[int, int], mesh,
                         contract: str = "masked",
                         num_levels: int = 3) -> bytes:
    """Serialize the SINGLE-FRAME multi-chip matcher
    (parallel.build_sharded_frame_sparsematch: one pair's rows over the
    mesh with a 14-row ppermute halo) — multi-device serving from one
    artifact.  ``contract="pyramid"`` freezes the sharded multi-scale
    matcher instead (parallel.build_sharded_frame_pyramid, ``num_levels``
    levels; H must divide by mesh_size * 2^(levels-1)).  The module pins
    the device count: the serving side loads it over a same-size mesh
    (``load_sharded_frame``)."""
    import jax
    from jax import export as jexport

    from opengpc_tpu.parallel import (build_sharded_frame_pyramid,
                                      build_sharded_frame_sparsematch)

    if contract == "pyramid":
        fn = build_sharded_frame_pyramid(forest_or_mask, settings, mesh,
                                         num_levels=num_levels)
    else:
        fn = build_sharded_frame_sparsematch(forest_or_mask, settings, mesh,
                                             contract=contract)
    spec = jax.ShapeDtypeStruct(tuple(shape), np.uint8)
    return _serialize(jexport.export(fn)(spec, spec))


def load_sharded_frame(data: bytes, mesh=None) -> Callable:
    """Deserialize an ``export_sharded_frame`` blob over a serving mesh.
    With ``mesh=None`` the mesh is built over the FIRST ``nr_devices``
    visible devices (the module records its exported device count), so a
    4-chip artifact serves on an 8-chip host; an explicit mesh must match
    the exported device count exactly.  Inputs are row-sharded over the
    mesh by the returned jitted callable."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from opengpc_tpu.parallel import DATA_AXIS, make_mesh

    exp = _deserialize(data)
    want = getattr(exp, "nr_devices", None)
    if mesh is None:
        devs = jax.devices()
        if want is not None and want <= len(devs):
            devs = devs[:want]
        mesh = make_mesh(devs)
    n = mesh.devices.size
    if want is not None and want != n:
        raise ValueError(
            f"artifact was exported for {exp.nr_devices} devices; the "
            f"serving mesh has {n}")
    sh = NamedSharding(mesh, P(DATA_AXIS))
    return jax.jit(exp.call, in_shardings=(sh, sh))


def export_batched_sharded_frame(forest_or_mask,
                                 settings: InferenceSettings,
                                 batch: int, shape: Tuple[int, int], mesh,
                                 contract: str = "masked",
                                 num_levels: int = 3) -> bytes:
    """Serialize the COMPOSED 2-D matcher
    (parallel.build_batched_sharded_frame_sparsematch: a (batch, H, W)
    stack over a ("data", "rows") mesh — frames over "data", each frame's
    rows over "rows" with the halo exchange).  ``contract="pyramid"``
    freezes the 2-D multi-scale matcher instead
    (parallel.build_batched_sharded_frame_pyramid, ``num_levels``
    levels).  The module pins the mesh SHAPE; serve it over a same-shape
    mesh (``load_batched_sharded_frame`` or ``load_artifact`` with
    ``extra={"mesh_shape": [D, R], "batch": B}`` metadata).  Outputs keep
    the stacked (batch, ...) layout — decode per frame with the
    contract's ``*_supports_to_numpy``."""
    import jax
    from jax import export as jexport

    from opengpc_tpu.parallel import (build_batched_sharded_frame_pyramid,
                                      build_batched_sharded_frame_sparsematch)

    if contract == "pyramid":
        fn = build_batched_sharded_frame_pyramid(
            forest_or_mask, settings, mesh, num_levels=num_levels)
    else:
        fn = build_batched_sharded_frame_sparsematch(
            forest_or_mask, settings, mesh, contract=contract)
    spec = jax.ShapeDtypeStruct((batch,) + tuple(shape), np.uint8)
    return _serialize(jexport.export(fn)(spec, spec))


def load_batched_sharded_frame(data: bytes, mesh_shape: Tuple[int, int],
                               mesh=None) -> Callable:
    """Deserialize an ``export_batched_sharded_frame`` blob over a serving
    mesh of the exported ("data", "rows") shape (default: ``make_mesh_2d``
    over the first D*R visible devices)."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from opengpc_tpu.parallel import DATA_AXIS, ROWS_AXIS, make_mesh_2d

    exp = _deserialize(data)
    d, r = mesh_shape
    if mesh is None:
        mesh = make_mesh_2d(d, r)
    n = mesh.devices.size
    if getattr(exp, "nr_devices", n) != n:
        raise ValueError(
            f"artifact was exported for {exp.nr_devices} devices; the "
            f"serving mesh has {n}")
    if (mesh.shape.get(DATA_AXIS), mesh.shape.get(ROWS_AXIS)) != (d, r):
        raise ValueError(
            f"artifact was exported for a {d}x{r} ({DATA_AXIS}, "
            f"{ROWS_AXIS}) mesh; the serving mesh is "
            f"{dict(mesh.shape)}")
    sh = NamedSharding(mesh, P(DATA_AXIS, ROWS_AXIS, None))
    return jax.jit(exp.call, in_shardings=(sh, sh))


def save_artifact(path: str, blob: bytes, *, contract: str,
                  settings: InferenceSettings, shape: Tuple[int, int],
                  platforms: Optional[Sequence[str]] = None,
                  extra: Optional[dict] = None) -> None:
    """Write a self-describing artifact file: magic, JSON metadata (the
    decode parameters a generic server needs), then the export blob.
    ``extra`` merges additional keys (e.g. ``{"n_devices": 8}`` for
    sharded-frame artifacts)."""
    meta = {
        "contract": contract,
        "shape": list(shape),
        "disp_high": settings.disp_high,
        "capacity": settings.capacity,
        "epipolar_mode": settings.epipolar_mode,
        "gradient_threshold": settings.gradient_threshold,
        "vertical_tolerance": settings.vertical_tolerance,
        "platforms": list(platforms) if platforms else None,
    }
    if extra:
        meta.update(extra)
    head = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        f.write(blob)


def _read_artifact(path: str, want_blob: bool) -> Tuple[dict, bytes]:
    """One open/parse of a ``save_artifact`` file: (metadata, blob).
    ``want_blob=False`` stops after the JSON header (the peek path)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an opengpc AOT artifact "
                             f"(bad magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(hlen).decode())
        return meta, (f.read() if want_blob else b"")


def peek_artifact_meta(path: str) -> dict:
    """Read ONLY the JSON metadata header of a ``save_artifact`` file —
    no deserialize, no mesh construction.  Lets callers route or reject
    an artifact (e.g. a stacked ``mesh_shape`` one on a single-device
    serving box) before paying for the load."""
    return _read_artifact(path, want_blob=False)[0]


def load_artifact(path: str, mesh=None) -> Tuple[Callable, dict]:
    """Load a ``save_artifact`` file: (jitted callable, metadata dict).

    A sharded-frame artifact (``extra={"n_devices": N}`` at save time)
    routes through ``load_sharded_frame``; with ``mesh=None`` the serving
    mesh is built over the FIRST N visible devices (not all of them), so
    an artifact exported for 4 chips serves on an 8-chip host.  Stacked
    artifacts (``mesh_shape`` metadata) route through
    ``load_batched_sharded_frame`` the same way.  Everything else loads
    single-device via ``load_sparsematch``; ``mesh`` is ignored for
    unsharded blobs."""
    meta, blob = _read_artifact(path, want_blob=True)
    if meta.get("mesh_shape"):
        return load_batched_sharded_frame(blob, tuple(meta["mesh_shape"]),
                                          mesh), meta
    if meta.get("n_devices", 1) > 1:
        # load_sharded_frame's mesh=None default serves over the first
        # nr_devices visible devices (recorded in the module itself)
        return load_sharded_frame(blob, mesh), meta
    return load_sparsematch(blob), meta


def decode_outputs(meta: dict, out) -> np.ndarray:
    """Route an artifact's device outputs to the matching host decoder,
    returning (n, 3) [x, y, d] supports — except the pyramid contracts,
    which return (n, 4) [x, y, d, level] (d/x/y in level-0 units; slice
    ``[:, :3]`` for the plain support list).  The compact contracts'
    overflow flag raises here — an AOT artifact has a single frozen
    program, so the caller must re-export (or ship alongside) a
    full-width artifact for dense frames."""
    from opengpc_tpu.infer import (global_row_supports_to_numpy,
                                   masked_supports_to_numpy,
                                   row_supports_to_numpy, supports_to_numpy)

    contract = meta["contract"]
    if contract in ("pyramid", "pyramid-compact"):
        from opengpc_tpu.pyramid import pyramid_supports_to_numpy

        if contract == "pyramid-compact":
            *out, ovf = out
            if bool(np.asarray(ovf)):
                raise OverflowError(
                    "pyramid-compact chunk overflow: frame too dense for "
                    "this artifact — serve a full 'pyramid' artifact for "
                    "it")
        return pyramid_supports_to_numpy(*out)
    if contract == "flat":
        return supports_to_numpy(*out)
    if contract == "rows":
        (xs, ds), counts = out
        return row_supports_to_numpy(xs, ds, counts)
    if contract == "masked":
        buf, counts = out
        return masked_supports_to_numpy(buf, counts, meta["disp_high"])
    if contract == "masked-compact":
        buf, counts, ovf = out
        if bool(np.asarray(ovf)):
            raise OverflowError(
                "masked-compact chunk overflow: frame too dense for this "
                "artifact — serve a full-width 'masked' artifact for it")
        return masked_supports_to_numpy(buf, counts, meta["disp_high"])
    if contract == "global-rows":
        (xs, ys, ds), counts = out
        return global_row_supports_to_numpy(xs, ys, ds, counts)
    if contract == "global-compact":
        (xs, ys, ds), counts, ovf = out
        if bool(np.asarray(ovf)):
            raise OverflowError(
                "global-compact chunk overflow: frame too dense for this "
                "artifact — serve a full-width 'global-rows' artifact for "
                "it")
        return global_row_supports_to_numpy(xs, ys, ds, counts)
    raise ValueError(f"unknown contract {contract!r} in artifact metadata")

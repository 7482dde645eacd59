"""Sharded decode: shard_map over restart segments + DP over images.

The reference is strictly single-threaded (SURVEY.md §2, "Parallelism");
here segments and images are first-class parallel axes:

* Entropy decode runs under ``shard_map`` over the ``seg`` mesh axis: each
  device decodes its local shard of restart segments with the block-
  lockstep decoder (ops/entropy_flat) — zero cross-device traffic during
  the sequential hot loop, because RSTn segments share no state (DC
  predictors reset, jpeg.cpp:419-425).  DRI=0 blobs decode via the
  batched speculative path (ops/entropy_spec) in decode_batch_sharded.
* Plane assembly (scan-order -> per-component planes) and the pixel pipeline
  run under ``jit`` with NamedSharding annotations; XLA inserts the
  all-to-all/all-gather collectives, which ride ICI on a real slice.
* Image batches shard over the ``data`` axis (pure DP).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..layout import scan_layout
from ..ops import entropy_flat, pixel as pixel_ops
from ..ops import scan_prep
from ..types import FrameHeader, JPEGError, ScanHeader


def _pad_to(x: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "max_mcus", "mesh_holder"))
def _decode_segments_shmap(words, seg_nmcus, dc_luts, *,
                           block_comp, n_comps, max_mcus, mesh_holder):
    """shard_map-wrapped segment decode: rows of ``words`` are sharded over
    the 'seg' mesh axis; each device runs the block-lockstep decoder on its
    local segments only.  ``dc_luts``: merged (2*n_comps, 65536) uint16."""
    mesh = mesh_holder.mesh
    bpm = len(block_comp)

    def local(words_l, nmcus_l, luts_l):
        # Block-lockstep decoder over the local segment lanes (see
        # ops/entropy_flat).
        s_local, w = words_l.shape
        pool = words_l.reshape(-1)
        base = jnp.arange(s_local, dtype=jnp.int32) * (w * 32)
        nblocks = nmcus_l.astype(jnp.int32) * bpm
        out, err, _, _, _, _, _ = entropy_flat.decode_lockstep(
            pool, base, nblocks,
            jnp.full((s_local,), 2**30, jnp.int32), luts_l,
            block_comp=block_comp, n_comps=n_comps,
            max_blocks=max_mcus * bpm)
        # Global failure count over ICI: every shard learns whether ANY
        # segment anywhere failed (cheap scalar psum on the 'seg' axis) so
        # callers can gate collective post-processing without a host round
        # trip.
        global_errs = jax.lax.psum(jnp.sum(err.astype(jnp.int32)), "seg")
        return out, err, global_errs

    out, err, global_errs = shard_map(
        local, mesh=mesh,
        in_specs=(P("seg", None), P("seg"), P(None, None)),
        out_specs=(P("seg", None, None), P("seg"), P()),
        check_vma=False,
    )(words, seg_nmcus, dc_luts)
    return out, err, global_errs


_DEVICE_LUT_CACHE: dict = {}


def _device_luts(luts: np.ndarray, mesh: Mesh):
    """Replicated device copy of a merged LUT table, cached by content.

    The merged (2*n_comps, 65536) uint16 table is ~0.8 MB — comparable to
    a whole group's entropy wire.  Serving corpora reuse a handful of
    table sets (most encoders emit the Annex K tables), so repeat
    dispatches hit HBM-resident LUTs instead of re-shipping them."""
    # Key by a strong digest of the table contents: Python's 64-bit hash()
    # could collide, and a collision here would silently decode with the
    # wrong Huffman tables (ADVICE r3).  sha1 of ~0.8 MB is ~1 ms, amortized
    # by the cache itself.
    import hashlib

    key = (hashlib.sha1(luts.tobytes()).hexdigest(), luts.shape,
           tuple(d.id for d in mesh.devices.flat),
           tuple(mesh.shape.items()))
    arr = _DEVICE_LUT_CACHE.get(key)
    if arr is None:
        arr = jax.device_put(jnp.asarray(luts),
                             NamedSharding(mesh, P(*[None] * luts.ndim)))
        if len(_DEVICE_LUT_CACHE) > 64:
            _DEVICE_LUT_CACHE.clear()
        _DEVICE_LUT_CACHE[key] = arr
    return arr


class _MeshHolder:
    """Hashable wrapper so a Mesh can ride through jit static args."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __hash__(self):
        return hash((tuple(self.mesh.shape.items()),
                     tuple(d.id for d in self.mesh.devices.flat)))

    def __eq__(self, other):
        return (isinstance(other, _MeshHolder)
                and self.mesh.shape == other.mesh.shape
                and [d.id for d in self.mesh.devices.flat]
                == [d.id for d in other.mesh.devices.flat])


def decode_scan_sharded(hdr: FrameHeader, scan: ScanHeader,
                        mesh: Mesh) -> np.ndarray:
    """Baseline scan decode with segments sharded over mesh axis 'seg'.

    Output identical to every other entropy backend (tests/test_sharding.py
    asserts equality with python_ref).
    """
    words, nm, block_comp, max_mcus, lay = scan_prep.prepare_scan(hdr, scan)
    luts = entropy_flat.merged_luts(hdr, scan).reshape(
        2 * len(hdr.components), 65536)

    n_seg_dev = mesh.shape["seg"]
    n_segments = words.shape[0]
    padded = -(-n_segments // n_seg_dev) * n_seg_dev
    words_p = _pad_to(words, padded)
    nm_p = _pad_to(nm, padded)  # padded rows: n_mcus=0 -> decode nothing

    seg_sharding = NamedSharding(mesh, P("seg", None))
    words_j = jax.device_put(jnp.asarray(words_p), seg_sharding)
    nm_j = jax.device_put(jnp.asarray(nm_p), NamedSharding(mesh, P("seg")))
    luts_j = _device_luts(luts, mesh)

    out, err, global_errs = _decode_segments_shmap(
        words_j, nm_j, luts_j,
        block_comp=block_comp, n_comps=len(hdr.components),
        max_mcus=max_mcus, mesh_holder=_MeshHolder(mesh))
    # One scalar crosses back for the happy path; the per-segment error
    # array is fetched only for diagnostics.
    if int(np.asarray(global_errs)) != 0:
        err = np.asarray(err)[:n_segments]
        raise JPEGError(
            f"sharded entropy decode failed in segments "
            f"{np.flatnonzero(err)[:8]}")
    bpm = len(block_comp)
    # Strip per-segment padding ON DEVICE with one gather (each segment
    # contributed max_mcus*bpm rows; only the first nm[s]*bpm are valid),
    # so the single D2H fetch carries no padding.
    take = nm.astype(np.int64) * bpm
    total = int(take.sum())
    seg_of = np.repeat(np.arange(n_segments, dtype=np.int64), take)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(take) - take, take)
    idx = seg_of * (max_mcus * bpm) + within
    valid = jnp.take(out.reshape(-1, 64), jnp.asarray(idx), axis=0)
    return np.asarray(valid)[: lay.n_mcus * bpm]


def decode_planes_sharded(hdr: FrameHeader, mesh: Mesh):
    """Full-frame entropy decode (sharded) -> per-component planes."""
    scan_coefs = decode_scan_sharded(hdr, hdr.scans[0], mesh)
    lay = scan_layout(hdr)
    planes = []
    for ci in range(len(hdr.components)):
        rows, cols = lay.comp_shapes[ci]
        planes.append(scan_coefs[lay.comp_src[ci]].reshape(rows, cols, 64))
    return planes


# ---------------------------------------------------------------------------
# Batched (DP) pixel pipeline
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("height", "width", "samplings", "idct", "upsample",
                     "color", "precision"))
def _batched_pixel(planes, qtables, *, height, width, samplings, idct,
                   upsample, color="auto", precision=8):
    fn = functools.partial(
        pixel_ops.pixel_pipeline_impl,
        height=height, width=width, samplings=samplings,
        idct=idct, upsample=upsample, color=color, precision=precision)
    return jax.vmap(lambda ps: fn(ps, qtables))(planes)


def batch_pixel_pipeline(planes_batch, qtables, hdr: FrameHeader,
                         mesh: Mesh | None = None, *, idct="fast",
                         upsample="fancy"):
    """Run the pixel pipeline on a batch of same-geometry images.

    ``planes_batch``: tuple of per-component arrays (B, rows, cols, 64).
    With a mesh, the batch axis is sharded over 'data' x 'seg' (flattened) —
    pure image-level DP.
    """
    samplings = tuple(
        (hdr.v_max // c.v, hdr.h_max // c.h) for c in hdr.components)
    planes_batch = tuple(jnp.asarray(p) for p in planes_batch)
    qtables = tuple(jnp.asarray(q) for q in qtables)
    if mesh is not None:
        flat_axes = tuple(mesh.axis_names)
        sh = NamedSharding(mesh, P(flat_axes, None, None, None))
        planes_batch = tuple(jax.device_put(p, sh) for p in planes_batch)
    return _batched_pixel(
        planes_batch, qtables, height=hdr.height, width=hdr.width,
        samplings=samplings, idct=idct, upsample=upsample,
        color=hdr.colorspace, precision=hdr.precision)


# ---------------------------------------------------------------------------
# Single-jit full decode step (entropy + assembly + pixel) over a 2-D mesh
# ---------------------------------------------------------------------------

def _group_pixels(blocks, qtables, comp_srcs, *, comp_shapes, keep_planes,
                  **pixel_kw):
    """(B, rows, 64) scan-order blocks -> ((B, H, W, 3) RGB, planes).

    Plane assembly gathers each component's cells (``comp_srcs``) into
    (B, rows, cols, 64) planes; ``planes`` is that tuple when
    ``keep_planes`` (the coefficients as the route decoded them, for
    conformance checks), else None."""
    b = blocks.shape[0]
    planes = tuple(
        jnp.take(blocks, src, axis=1).reshape(b, rows, cols, 64)
        for src, (rows, cols) in zip(comp_srcs, comp_shapes))
    rgb = jax.vmap(lambda ps: pixel_ops.pixel_pipeline_impl(
        ps, qtables, **pixel_kw))(planes)
    return rgb, (planes if keep_planes else None)


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "max_mcus", "comp_shapes",
                     "samplings", "height", "width", "idct", "upsample",
                     "color", "precision", "mesh_holder", "keep_planes"))
def _full_step(words, nm, luts, qtables, comp_srcs, *,
               block_comp, n_comps, max_mcus, comp_shapes, samplings,
               height, width, idct, upsample, color, precision,
               mesh_holder, keep_planes=False):
    """One compiled program: shard_map'ed entropy decode over ('seg'),
    image batch over ('data'), plane assembly + pixel pipeline with XLA-
    inserted collectives.

    words: (B, S, W) uint32 — B images x S segments, sharded P('data','seg').
    comp_srcs: tuple of (rows*cols,) int32 gather maps (replicated).
    Returns (B, height, width, 3) uint8 sharded over 'data', the (B, S)
    segment error flags, their per-image OR, and the planes
    (:func:`_group_pixels`).
    """
    mesh = mesh_holder.mesh
    bpm = len(block_comp)

    def local(words_l, nm_l, luts_l):
        # All local (image, segment) pairs are lanes of ONE lockstep
        # decode — images and segments flatten into the lane axis.
        b_l, s_l, w = words_l.shape
        pool = words_l.reshape(-1)
        base = jnp.arange(b_l * s_l, dtype=jnp.int32) * (w * 32)
        nblocks = nm_l.reshape(-1).astype(jnp.int32) * bpm
        out, errf, _, _, _, _, _ = entropy_flat.decode_lockstep(
            pool, base, nblocks,
            jnp.full((b_l * s_l,), 2**30, jnp.int32), luts_l,
            block_comp=block_comp, n_comps=n_comps,
            max_blocks=max_mcus * bpm)
        return (out.reshape(b_l, s_l, max_mcus * bpm, 64),
                errf.reshape(b_l, s_l))

    blocks, err = shard_map(
        local, mesh=mesh,
        in_specs=(P("data", "seg", None), P("data", "seg"),
                  P(None, None)),
        out_specs=(P("data", "seg", None, None), P("data", "seg")),
        check_vma=False,
    )(words, nm, luts)

    b = words.shape[0]
    blocks = blocks.reshape(b, -1, 64)  # (B, S*max_mcus*bpm, 64) scan order

    rgb, planes = _group_pixels(
        blocks, qtables, comp_srcs, comp_shapes=comp_shapes,
        keep_planes=keep_planes, height=height, width=width,
        samplings=samplings, idct=idct, upsample=upsample, color=color,
        precision=precision)
    # Per-image error flag (segment detail stays on device): one bool per
    # image crosses the host link instead of (B, S).
    return rgb, err, err.any(axis=1), planes


def full_decode_step(hdr: FrameHeader, words_b: np.ndarray,
                     nm_b: np.ndarray, mesh: Mesh, *, idct="fast",
                     upsample="fancy", keep_planes=False):
    """Decode a batch of same-geometry images in ONE jitted step.

    ``words_b``/``nm_b``: (B, S, W) uint32 / (B, S) int32 per-segment packed
    streams (B images, S segments each, padded).  This is the multi-chip
    "training step" equivalent: segments shard over ICI ('seg'), images over
    DCN ('data'); plane-assembly gathers are XLA-inserted collectives.
    Returns (rgb, segment errors, per-image error), plus the per-component
    coefficient planes (B, rows, cols, 64) when ``keep_planes``.
    """
    scan = hdr.scans[0]
    lay = scan_layout(hdr)
    ri = scan.restart_interval
    max_mcus = ri if ri else lay.n_mcus
    block_comp = tuple(
        ci for ci, c in enumerate(hdr.components) for _ in range(c.v * c.h))
    luts = entropy_flat.merged_luts(hdr, scan).reshape(
        2 * len(hdr.components), 65536)
    qtables = tuple(jnp.asarray(hdr.quant_tables[c.tq].values)
                    for c in hdr.components)
    samplings = tuple(
        (hdr.v_max // c.v, hdr.h_max // c.h) for c in hdr.components)

    # Gather maps from padded scan-order rows (incl. per-segment padding) to
    # plane cells: row of (seg s, local mcu m, block k) =
    # (s*max_mcus + m)*bpm + k.
    bpm = len(block_comp)
    n_seg = words_b.shape[1]
    valid_rows = np.arange(lay.n_mcus)  # global mcu index
    seg_of = valid_rows // max_mcus if ri else np.zeros_like(valid_rows)
    loc_of = valid_rows - seg_of * max_mcus
    row_of_mcu = (seg_of * max_mcus + loc_of) * bpm  # base row per mcu
    scan_row = np.repeat(row_of_mcu, bpm) + np.tile(np.arange(bpm),
                                                    lay.n_mcus)
    comp_srcs = tuple(
        jnp.asarray(scan_row[lay.comp_src[ci]].astype(np.int32))
        for ci in range(len(hdr.components)))
    comp_shapes = tuple(lay.comp_shapes)

    # Pad batch and segment axes to mesh-divisible sizes (padded rows decode
    # nothing: nm=0).
    b0 = words_b.shape[0]
    bp = -(-b0 // mesh.shape["data"]) * mesh.shape["data"]
    sp = -(-n_seg // mesh.shape["seg"]) * mesh.shape["seg"]
    words_b = _pad_to(_pad_to(words_b, bp, 0), sp, 1)
    nm_b = _pad_to(_pad_to(nm_b, bp, 0), sp, 1)

    data_sh = NamedSharding(mesh, P("data", "seg", None))
    words_j = jax.device_put(jnp.asarray(words_b), data_sh)
    nm_j = jax.device_put(jnp.asarray(nm_b),
                          NamedSharding(mesh, P("data", "seg")))
    luts_j = _device_luts(luts, mesh)

    rgb, err, err_img, planes = _full_step(
        words_j, nm_j, luts_j, qtables, comp_srcs,
        block_comp=block_comp, n_comps=len(hdr.components),
        max_mcus=max_mcus, comp_shapes=comp_shapes, samplings=samplings,
        height=hdr.height, width=hdr.width, idct=idct, upsample=upsample,
        color=hdr.colorspace, precision=hdr.precision,
        mesh_holder=_MeshHolder(mesh), keep_planes=keep_planes)
    out = rgb[:b0], err[:b0, :n_seg], err_img[:b0]
    return out + (tuple(p[:b0] for p in planes),) if keep_planes else out


# ---------------------------------------------------------------------------
# Sharded speculative decode for DRI=0 groups: chunk lanes over ('data','seg')
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "cap", "n_mcus", "C",
                     "precision", "comp_shapes", "samplings", "height",
                     "width", "idct", "upsample", "color", "mesh_holder",
                     "keep_planes"))
def _spec_full_step(pools, base_rel, limits_rel, active, luts, qtables,
                    comp_srcs, *, block_comp, n_comps, cap, n_mcus, C,
                    precision, comp_shapes, samplings, height, width,
                    idct, upsample, color, mesh_holder,
                    keep_planes=False):
    """DRI=0 group decode as ONE sharded program (VERDICT r2 item 2).

    Speculative chunk lanes shard over the same ('data', 'seg') mesh as
    restart segments: phase 1 (lockstep decode, the hot loop) runs under
    shard_map with each device decoding its local (image, chunk) lanes —
    zero cross-device traffic, exactly like the RSTn path.  The per-image
    splice (a lax.scan over ALL the image's lanes), record gather, DC
    prefix sum and pixel pipeline run under jit; XLA inserts the seg-axis
    collectives (the splice metadata is ~KBs, the records all-gather rides
    ICI on a real slice).  One dispatch, one (B,) ok fetch.

    Positions returned by the local decode are rebased image-relative so
    lanes of the same image on different 'seg' shards stay comparable.
    """
    from ..ops.entropy_spec import _dc_prefix_sum, _device_splice

    mesh = mesh_holder.mesh
    B, W = pools.shape
    bpm = len(block_comp)

    def local(pools_l, base_l, lim_l, act_l, luts_l):
        b_l, c_l = base_l.shape
        w = pools_l.shape[1]
        img_base = (jnp.arange(b_l, dtype=jnp.int32) * (w * 32))[:, None]
        base_abs = (img_base + base_l).reshape(-1)
        lim_abs = (img_base + lim_l).reshape(-1)
        nblocks = jnp.where(act_l.reshape(-1), cap * bpm, 0)
        (out, _err, _nd, starts, n_rec, end_pos,
         valid) = entropy_flat.decode_lockstep(
            pools_l.reshape(-1), base_abs, nblocks, lim_abs, luts_l,
            block_comp=block_comp, n_comps=n_comps, max_blocks=cap * bpm,
            dc_diff=True, record_mcus=1, max_mcus=cap, precision=precision)
        ib = img_base[:, :, None]
        return (out.reshape(b_l, c_l, cap, bpm * 64),
                starts.reshape(b_l, c_l, cap) - ib,
                n_rec.reshape(b_l, c_l),
                end_pos.reshape(b_l, c_l) - img_base,
                valid.reshape(b_l, c_l, cap))

    out, starts, n_rec, end_pos, valid = shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data", "seg"), P("data", "seg"),
                  P("data", "seg"), P(None, None)),
        out_specs=(P("data", "seg", None, None), P("data", "seg", None),
                   P("data", "seg"), P("data", "seg"),
                   P("data", "seg", None)),
        check_vma=False,
    )(pools, base_rel, limits_rel, active, luts)

    src, ok = jax.vmap(
        functools.partial(_device_splice, n_mcus=n_mcus, cap=cap))(
        starts, n_rec, end_pos, base_rel, valid)

    records = out.reshape(B, C * cap, bpm * 64)
    blocks = jax.vmap(lambda r, s: jnp.take(r, s, axis=0))(records, src)
    blocks = jax.vmap(
        functools.partial(_dc_prefix_sum, block_comp=block_comp,
                          n_comps=n_comps))(
        blocks.reshape(B, n_mcus, bpm, 64)).reshape(B, n_mcus * bpm, 64)

    rgb, planes = _group_pixels(
        blocks, qtables, comp_srcs, comp_shapes=comp_shapes,
        keep_planes=keep_planes, height=height, width=width,
        samplings=samplings, idct=idct, upsample=upsample, color=color,
        precision=precision)
    return rgb, ok, planes


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "stride", "n_mcus", "C",
                     "precision", "comp_shapes", "samplings", "height",
                     "width", "idct", "upsample", "color", "mesh_holder",
                     "keep_planes"))
def _hybrid_full_step(pools, starts_rel, nm_lane, skel_bad, luts, qtables,
                      comp_srcs, *, block_comp, n_comps, stride, n_mcus, C,
                      precision, comp_shapes, samplings, height, width,
                      idct, upsample, color, mesh_holder,
                      keep_planes=False):
    """Hybrid DRI=0 group decode as ONE sharded program: device lanes
    decode from TRUE MCU starts (host skeleton scan, jd_skeleton_scan), so
    there is no overflow window, no chunk-skew idling and no splice — the
    DRI=0 path runs at the restart-segment rate.  Lanes shard over
    ('data', 'seg') exactly like restart segments; the DC prefix sum and
    pixel pipeline run under jit with XLA-inserted collectives.  One
    dispatch, one (B,) ok fetch."""
    from ..ops.entropy_spec import _dc_prefix_sum

    mesh = mesh_holder.mesh
    B, W = pools.shape
    bpm = len(block_comp)

    def local(pools_l, starts_l, nm_l, luts_l):
        b_l, c_l = starts_l.shape
        w = pools_l.shape[1]
        img_base = (jnp.arange(b_l, dtype=jnp.int32) * (w * 32))[:, None]
        base_abs = (img_base + starts_l).reshape(-1)
        nblocks = (nm_l * bpm).reshape(-1)
        out, err, n_done, *_ = entropy_flat.decode_lockstep(
            pools_l.reshape(-1), base_abs, nblocks,
            jnp.full((b_l * c_l,), 2**30, jnp.int32), luts_l,
            block_comp=block_comp, n_comps=n_comps,
            max_blocks=stride * bpm, dc_diff=True, precision=precision)
        bad = (err | (n_done < nblocks)).reshape(b_l, c_l)
        return out.reshape(b_l, c_l, stride * bpm, 64), bad

    out, bad = shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data", "seg"), P("data", "seg"),
                  P(None, None)),
        out_specs=(P("data", "seg", None, None), P("data", "seg")),
        check_vma=False,
    )(pools, starts_rel, nm_lane, luts)

    # Lanes 0..C-2 hold exactly `stride` MCUs and the last active lane the
    # remainder (padded lanes decode nothing), so flattening lane slots
    # restores scan order with no gather.
    blocks = out.reshape(B, C * stride * bpm, 64)[:, : n_mcus * bpm]
    blocks = jax.vmap(
        functools.partial(_dc_prefix_sum, block_comp=block_comp,
                          n_comps=n_comps))(
        blocks.reshape(B, n_mcus, bpm, 64)).reshape(B, n_mcus * bpm, 64)

    rgb, planes = _group_pixels(
        blocks, qtables, comp_srcs, comp_shapes=comp_shapes,
        keep_planes=keep_planes, height=height, width=width,
        samplings=samplings, idct=idct, upsample=upsample, color=color,
        precision=precision)
    # Device-visible failure flag is SELF-SUFFICIENT (ADVICE r3): a row
    # whose host skeleton scan failed ships skel_bad=True, so callers
    # need no side-channel AND.
    return rgb, ~bad.any(axis=1) & ~skel_bad, planes


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "max_nm", "n_mcus", "C",
                     "precision", "comp_shapes", "samplings", "height",
                     "width", "idct", "upsample", "color", "mesh_holder",
                     "keep_planes"))
def _hybrid_full_step_flat(pools, starts_rel, nm_lane, skel_bad, src_idx,
                           luts, qtables, comp_srcs, *, block_comp, n_comps,
                           max_nm, n_mcus, C, precision, comp_shapes,
                           samplings, height, width, idct, upsample,
                           color, mesh_holder,
                           keep_planes=False):
    """Byte-balanced hybrid group decode as ONE sharded program: flat
    symbol loop (scalar commit) over lanes with ~equal BYTES — trip count
    ~1.1-1.4x the balanced ideal vs the lockstep form's ~3.5x (see
    ops.entropy_spec.prepare_hybrid_batch_balanced).  Lanes shard over
    ('data', 'seg'); gather reassembly + DC prefix sum + pixel under jit."""
    from ..ops.entropy_spec import _dc_prefix_sum

    mesh = mesh_holder.mesh
    B, W = pools.shape
    bpm = len(block_comp)

    def local(pools_l, starts_l, nm_l, luts_l):
        b_l, c_l = starts_l.shape
        w = pools_l.shape[1]
        img_base = (jnp.arange(b_l, dtype=jnp.int32) * (w * 32))[:, None]
        base_abs = (img_base + starts_l).reshape(-1)
        nblocks = (nm_l * bpm).reshape(-1)
        out, err, n_done, *_ = entropy_flat.decode_flat(
            pools_l.reshape(-1), base_abs, nblocks,
            jnp.full((b_l * c_l,), 2**30, jnp.int32), luts_l,
            block_comp=block_comp, n_comps=n_comps,
            max_blocks=max_nm * bpm, dc_diff=True, precision=precision,
            commit="scalar")
        bad = (err | (n_done < nblocks)).reshape(b_l, c_l)
        return out.reshape(b_l, c_l, max_nm * bpm, 64), bad

    out, bad = shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data", "seg"), P("data", "seg"),
                  P(None,)),
        out_specs=(P("data", "seg", None, None), P("data", "seg")),
        check_vma=False,
    )(pools, starts_rel, nm_lane, luts)

    rows = out.reshape(B, C * max_nm * bpm, 64)
    blocks = jax.vmap(lambda r, s: jnp.take(r, s, axis=0))(rows, src_idx)
    blocks = jax.vmap(
        functools.partial(_dc_prefix_sum, block_comp=block_comp,
                          n_comps=n_comps))(
        blocks.reshape(B, n_mcus, bpm, 64)).reshape(B, n_mcus * bpm, 64)

    rgb, planes = _group_pixels(
        blocks, qtables, comp_srcs, comp_shapes=comp_shapes,
        keep_planes=keep_planes, height=height, width=width,
        samplings=samplings, idct=idct, upsample=upsample, color=color,
        precision=precision)
    # Device-visible failure flag is SELF-SUFFICIENT (ADVICE r3): a row
    # whose host skeleton scan failed ships skel_bad=True, so callers
    # need no side-channel AND.
    return rgb, ~bad.any(axis=1) & ~skel_bad, planes


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "T", "n_mcus", "C",
                     "precision", "comp_shapes", "samplings", "height",
                     "width", "idct", "upsample", "color", "pair",
                     "mesh_holder",
                     "keep_planes"))
def _hybrid_full_step_emit(pools, starts_rel, nm_lane, skel_bad, lane_off,
                           seg_first, luts, qtables, comp_srcs, *,
                           block_comp, n_comps, T, n_mcus, C, precision,
                           comp_shapes, samplings, height, width, idct,
                           upsample, color, pair, mesh_holder,
                           keep_planes=False):
    """Symbol-balanced hybrid group decode as ONE sharded program: the
    emission kernel (no in-loop stores; trip count = max lane symbol
    total ~ balanced ideal) under shard_map over ('data', 'seg'), one
    post-loop scatter straight into scan order, DC prefix sum + pixel
    under jit."""
    from ..ops.entropy_spec import _dc_prefix_sum_seg
    from ..types import ZIGZAG_INV

    mesh = mesh_holder.mesh
    B, W = pools.shape
    bpm = len(block_comp)

    def local(pools_l, starts_l, nm_l, off_l, luts_l):
        b_l, c_l = starts_l.shape
        w = pools_l.shape[1]
        img_base = (jnp.arange(b_l, dtype=jnp.int32) * (w * 32))[:, None]
        base_abs = (img_base + starts_l).reshape(-1)
        nblocks = (nm_l * bpm).reshape(-1)
        kern = (entropy_flat.decode_emit2 if pair
                else entropy_flat.decode_emit)
        pos, val, err, n_done = kern(
            pools_l.reshape(-1), base_abs, nblocks, luts_l,
            block_comp=block_comp, n_comps=n_comps, T=T,
            precision=precision)
        pos = pos.reshape(-1, base_abs.shape[0])
        val = val.reshape(-1, base_abs.shape[0])
        bad = (err | (n_done < nblocks)).reshape(b_l, c_l)
        # Scatter the local lanes' emissions into LOCAL per-image dense
        # planes; the 'seg' axis then reduces partial planes with one
        # XLA collective (psum) — each lane writes disjoint slots, so
        # the sum is exact.
        img_out = (jnp.arange(b_l, dtype=jnp.int32)
                   * (n_mcus * bpm * 64))[:, None]
        out_off = (img_out + off_l).reshape(-1)
        n_total = b_l * n_mcus * bpm * 64
        flat_pos = jnp.where(pos >= 0, pos + out_off[None, :], n_total)
        out = jnp.zeros((n_total,), jnp.int32).at[
            flat_pos.reshape(-1)].add(val.reshape(-1), mode="drop")
        out = jax.lax.psum(out.reshape(b_l, n_mcus * bpm, 64), "seg")
        return out, bad

    blocks, bad = shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data", "seg"), P("data", "seg"),
                  P("data", "seg"), P(None,)),
        out_specs=(P("data", None, None), P("data", "seg")),
        check_vma=False,
    )(pools, starts_rel, nm_lane, lane_off, luts)

    blocks = jnp.take(blocks, jnp.asarray(ZIGZAG_INV), axis=2)
    blocks = jax.vmap(
        functools.partial(_dc_prefix_sum_seg, block_comp=block_comp,
                          n_comps=n_comps),
        in_axes=(0, None))(
        blocks.reshape(B, n_mcus, bpm, 64),
        seg_first).reshape(B, n_mcus * bpm, 64)

    rgb, planes = _group_pixels(
        blocks, qtables, comp_srcs, comp_shapes=comp_shapes,
        keep_planes=keep_planes, height=height, width=width,
        samplings=samplings, idct=idct, upsample=upsample, color=color,
        precision=precision)
    # Device-visible failure flag is SELF-SUFFICIENT (ADVICE r3): a row
    # whose host skeleton scan failed ships skel_bad=True, so callers
    # need no side-channel AND.
    return rgb, ~bad.any(axis=1) & ~skel_bad, planes


def _hybrid_group_dispatch(hdr, scans, mesh: Mesh, *, idct, upsample,
                           keep_planes=False):
    """Dispatch (without blocking) one DRI=0 group through the hybrid
    pipeline (host skeleton scan -> device true-start lanes).  Returns
    (rgb (B, H, W, 3) device, ok (B,) device flags), plus the coefficient
    planes (B, rows, cols, 64) per component when ``keep_planes``.  The
    ok flag is SELF-SUFFICIENT: rows whose host skeleton scan failed
    ship a skel_bad input folded into it on device (ADVICE r3), so
    callers need no side-channel AND; they route not-ok rows to the
    per-image fallback.

    JD_HYBRID_KERNEL selects the device kernel (tools/hybrid_kernel_ab.py
    measures all three in one process):
      "emit" (default) — symbol-balanced lanes + emission kernel (no
        in-loop stores; trip count = max lane symbol total ~ ideal);
      "lockstep" — equal-MCU lanes, block-lockstep kernel (~3.5x ideal
        trip count: each block slot pays the max-over-lanes density);
      "flat" — byte-balanced lanes, per-iteration scalar scatter
        (kept for ablation).
    """
    from ..models import decoder as decoder_mod
    from ..ops import entropy_spec

    lay = scan_layout(hdr)
    block_comp = tuple(
        ci for ci, c in enumerate(hdr.components) for _ in range(c.v * c.h))
    kernel = os.environ.get("JD_HYBRID_KERNEL", "emit")
    luts = entropy_flat.merged_luts(hdr, scans[0])
    qtables = tuple(jnp.asarray(hdr.quant_tables[c.tq].values)
                    for c in hdr.components)
    comp_srcs = decoder_mod._comp_srcs_jax(lay)
    samplings = tuple(
        (hdr.v_max // c.v, hdr.h_max // c.h) for c in hdr.components)

    if kernel == "emit":
        (pools, starts, nm_lane, lane_off, T, T2, C, seg_first,
         skel_ok) = entropy_spec.prepare_hybrid_batch_emit(hdr, scans)
        pair = entropy_spec.use_pair_kernel()
        if pair:
            T = T2
    elif kernel == "flat":
        (pools, starts, nm_lane, max_nm, C, src_idx,
         skel_ok) = entropy_spec.prepare_hybrid_batch_balanced(hdr, scans)
    else:
        pools, starts, nm_lane, stride, C, skel_ok = \
            entropy_spec.prepare_hybrid_batch(hdr, scans)
        luts = luts.reshape(2 * len(hdr.components), 65536)

    b0 = len(scans)
    bp = -(-b0 // mesh.shape["data"]) * mesh.shape["data"]
    cp = -(-C // mesh.shape["seg"]) * mesh.shape["seg"]
    pools = _pad_to(pools, bp, 0)
    starts = _pad_to(_pad_to(starts, bp, 0), cp, 1)
    nm_lane = _pad_to(_pad_to(nm_lane, bp, 0), cp, 1)
    skel_bad = np.zeros(bp, bool)
    skel_bad[:b0] = ~np.asarray(skel_ok, bool)

    pools_j = jax.device_put(jnp.asarray(pools),
                             NamedSharding(mesh, P("data", None)))
    lane_sh = NamedSharding(mesh, P("data", "seg"))
    starts_j = jax.device_put(jnp.asarray(starts), lane_sh)
    nm_j = jax.device_put(jnp.asarray(nm_lane), lane_sh)
    sb_j = jax.device_put(jnp.asarray(skel_bad),
                          NamedSharding(mesh, P("data")))
    luts_j = _device_luts(luts, mesh)

    common = dict(
        block_comp=block_comp, n_comps=len(hdr.components),
        n_mcus=lay.n_mcus, C=cp, precision=hdr.precision,
        comp_shapes=tuple(lay.comp_shapes), samplings=samplings,
        height=hdr.height, width=hdr.width, idct=idct, upsample=upsample,
        color=hdr.colorspace, mesh_holder=_MeshHolder(mesh),
        keep_planes=keep_planes)
    if kernel == "emit":
        off_j = jax.device_put(
            jnp.asarray(_pad_to(_pad_to(lane_off, bp, 0), cp, 1)),
            lane_sh)
        seg_j = jax.device_put(jnp.asarray(seg_first),
                               NamedSharding(mesh, P(None,)))
        rgb, ok, planes = _hybrid_full_step_emit(
            pools_j, starts_j, nm_j, sb_j, off_j, seg_j, luts_j, qtables,
            comp_srcs, T=T, pair=pair, **common)
    elif kernel == "flat":
        src_j = jax.device_put(jnp.asarray(_pad_to(src_idx, bp, 0)),
                               NamedSharding(mesh, P("data", None)))
        rgb, ok, planes = _hybrid_full_step_flat(
            pools_j, starts_j, nm_j, sb_j, src_j, luts_j, qtables,
            comp_srcs, max_nm=max_nm, **common)
    else:
        rgb, ok, planes = _hybrid_full_step(
            pools_j, starts_j, nm_j, sb_j, luts_j, qtables, comp_srcs,
            stride=stride, **common)
    if keep_planes:
        return rgb[:b0], ok[:b0], tuple(p[:b0] for p in planes)
    return rgb[:b0], ok[:b0]


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "T", "n_mcus_b", "C",
                     "precision", "comp_shapes_b", "comp_hv", "samplings",
                     "height_b", "width_b", "idct", "upsample", "color",
                     "pair", "mesh_holder", "keep_planes"))
def _hybrid_full_step_emit_dyn(pools, starts_rel, nm_lane, skel_bad,
                               lane_off, lut_base, luts, qtables_b, geom,
                               *, block_comp, n_comps, T, n_mcus_b, C,
                               precision, comp_shapes_b, comp_hv,
                               samplings, height_b, width_b, idct,
                               upsample, color, pair, mesh_holder,
                               keep_planes=False):
    """GEOMETRY-BUCKETED emission group decode as ONE sharded program
    (VERDICT r3 item 4): a serving corpus of arbitrary image sizes
    compiles O(log sizes) sharded programs, not one per distinct size.

    Per-image TRUE geometry rides as a dynamic ``geom`` row
    (mcus_x, mcus_y, height, width, restart_interval): the emission
    scatter lands in true scan order inside the bucket block range, the
    DC prefix sum derives segment starts from DRI in closed form, and
    plane assembly + the fancy upsampler's edge replication use the
    true dims (models.batch._rgb_one_dyn — the same machinery the
    BatchDecoder buckets with).  ``lut_base`` points each image's lanes
    at its Huffman table stack row, so tables need not be in the group
    key.  Pixels inside (height, width) are bit-exact with the
    unbucketed path; BatchItem.rgb crops the bucket padding.  With
    ``keep_planes`` it also returns the bucket-size coefficient planes
    (true planes a top-left crop), else None.
    """
    from ..models.batch import _planes_from_blocks_dyn, _rgb_one_dyn
    from ..ops.entropy_spec import _dc_prefix_sum_seg
    from ..types import ZIGZAG_INV

    mesh = mesh_holder.mesh
    B = pools.shape[0]
    bpm = len(block_comp)

    def local(pools_l, starts_l, nm_l, off_l, lutb_l, luts_l):
        b_l, c_l = starts_l.shape
        w = pools_l.shape[1]
        img_base = (jnp.arange(b_l, dtype=jnp.int32) * (w * 32))[:, None]
        base_abs = (img_base + starts_l).reshape(-1)
        nblocks = (nm_l * bpm).reshape(-1)
        lutb = jnp.broadcast_to(lutb_l[:, None], (b_l, c_l)).reshape(-1)
        kern = (entropy_flat.decode_emit2 if pair
                else entropy_flat.decode_emit)
        pos, val, err, n_done = kern(
            pools_l.reshape(-1), base_abs, nblocks, luts_l, lutb,
            block_comp=block_comp, n_comps=n_comps, T=T,
            precision=precision)
        pos = pos.reshape(-1, base_abs.shape[0])
        val = val.reshape(-1, base_abs.shape[0])
        bad = (err | (n_done < nblocks)).reshape(b_l, c_l)
        img_out = (jnp.arange(b_l, dtype=jnp.int32)
                   * (n_mcus_b * bpm * 64))[:, None]
        out_off = (img_out + off_l).reshape(-1)
        n_total = b_l * n_mcus_b * bpm * 64
        flat_pos = jnp.where(pos >= 0, pos + out_off[None, :], n_total)
        out = jnp.zeros((n_total,), jnp.int32).at[
            flat_pos.reshape(-1)].add(val.reshape(-1), mode="drop")
        out = jax.lax.psum(out.reshape(b_l, n_mcus_b * bpm, 64), "seg")
        return out, bad

    blocks, bad = shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data", "seg"), P("data", "seg"),
                  P("data", "seg"), P("data"), P(None,)),
        out_specs=(P("data", None, None), P("data", "seg")),
        check_vma=False,
    )(pools, starts_rel, nm_lane, lane_off, lut_base, luts)

    blocks = jnp.take(blocks, jnp.asarray(ZIGZAG_INV), axis=2)

    def prefix_one(blocks_i, ri):
        # Segment starts in closed form from the image's DRI: the first
        # MCU of MCU m's segment is (m // ri) * ri (0 for DRI=0).
        m = jnp.arange(n_mcus_b, dtype=jnp.int32)
        ris = jnp.maximum(ri, 1)
        seg_first = jnp.where(ri > 0, (m // ris) * ris, 0)
        return _dc_prefix_sum_seg(
            blocks_i.reshape(n_mcus_b, bpm, 64), seg_first,
            block_comp=block_comp, n_comps=n_comps)

    blocks = jax.vmap(prefix_one)(
        blocks, geom[:, 4]).reshape(B, n_mcus_b * bpm, 64)

    rgb = jax.vmap(
        functools.partial(
            _rgb_one_dyn, comp_shapes=comp_shapes_b, comp_hv=comp_hv,
            height=height_b, width=width_b, samplings=samplings,
            idct=idct, upsample=upsample, color=color,
            precision=precision))(blocks, qtables_b, geom[:, :4])
    planes = None
    if keep_planes:
        planes = jax.vmap(functools.partial(
            _planes_from_blocks_dyn, comp_shapes=comp_shapes_b,
            comp_hv=comp_hv, bpm=bpm))(blocks, geom[:, :4])
    return rgb, ~bad.any(axis=1) & ~skel_bad, planes


def _hybrid_group_dispatch_dyn(items, mesh: Mesh, *, idct, upsample,
                               keep_planes=False):
    """Dispatch one GEOMETRY-BUCKETED group (images of assorted sizes,
    same sampling/colorspace, any DRI) through the emission pipeline.

    ``items``: list of (index, hdr, scan).  Returns (rgb (B, Hb, Wb, 3)
    device, ok (B,) self-sufficient device flags), plus the bucket-size
    coefficient planes when ``keep_planes``.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ..models.batch import _bucket_pow2
    from ..ops import entropy_spec

    B = len(items)
    hdr0 = items[0][1]
    comp_hv = tuple((c.h, c.v) for c in hdr0.components)
    h_max = max(h for h, _ in comp_hv)
    v_max = max(v for _, v in comp_hv)
    bpm = sum(h * v for h, v in comp_hv)
    block_comp = tuple(ci for ci, (h, v) in enumerate(comp_hv)
                       for _ in range(h * v))
    # Grouping is pow-2 (bounded group count) but PADDING inside the
    # group is eighth-granularity of the group max: per-step and pixel
    # cost scale with the padded dims, and pow-2 padding wastes up to 2x
    # per axis.  JD_DYN_PAD=max|pow2 for A/B.
    pad_mode = os.environ.get("JD_DYN_PAD", "fine")
    mx_t = max(hdr.mcus_x for _, hdr, _s in items)
    my_t = max(hdr.mcus_y for _, hdr, _s in items)
    if pad_mode == "max":
        mxb, myb = mx_t, my_t
    elif pad_mode == "pow2":
        mxb, myb = _bucket_pow2(mx_t), _bucket_pow2(my_t)
    else:
        def _eighth(n):
            step = 1 << max(n.bit_length() - 3, 0)
            return -(-n // step) * step

        mxb, myb = _eighth(mx_t), _eighth(my_t)
    n_mcus_b = mxb * myb
    comp_shapes_b = tuple((myb * v, mxb * h) for h, v in comp_hv)
    samplings = tuple((v_max // v, h_max // h) for h, v in comp_hv)
    height_b, width_b = myb * 8 * v_max, mxb * 8 * h_max

    # Per-image emit prep (skeleton scans thread across images).
    preps: list = [None] * B

    def prep_one(k):
        # An unexpected prep failure must not sink the whole pow-2
        # bucket group (ADVICE r4): the image routes to the per-image
        # fallback via skel_bad instead.
        _i, hdr, scan = items[k]
        try:
            preps[k] = entropy_spec.prepare_hybrid_batch_emit(
                hdr, [scan], threads=1)
        except Exception:  # noqa: BLE001 — per-image isolation
            preps[k] = None

    if B > 1:
        with ThreadPoolExecutor(min(4, B)) as ex:
            list(ex.map(prep_one, range(B)))
    else:
        prep_one(0)

    from ..ops.entropy_spec import _bucket_T

    # Pool width is an array SHAPE (a trace key): bucket it like T so
    # batches of assorted byte sizes share one compiled program.
    live = [p for p in preps if p is not None]
    W = _bucket_T(max((p[0].shape[1] for p in live), default=64))
    C = max((p[6] for p in live), default=1)
    pair = entropy_spec.use_pair_kernel()
    T = max((p[5] if pair else p[4] for p in live), default=64)
    pools = np.zeros((B, W), np.uint32)
    starts = np.zeros((B, C), np.int32)
    nm_lane = np.zeros((B, C), np.int32)
    lane_off = np.zeros((B, C), np.int32)
    skel_bad = np.zeros(B, bool)
    geom = np.zeros((B, 5), np.int32)
    # One LUT stack per DISTINCT table set; images point lanes at theirs.
    lut_sets: dict[bytes, int] = {}
    lut_stacks: list[np.ndarray] = []
    lut_base = np.zeros(B, np.int32)
    for k, (_i, hdr, scan) in enumerate(items):
        p = preps[k]
        if p is None:
            skel_bad[k] = True
        else:
            pools[k, : p[0].shape[1]] = p[0][0]
            c_k = p[1].shape[1]
            starts[k, :c_k] = p[1][0]
            nm_lane[k, :c_k] = p[2][0]
            lane_off[k, :c_k] = p[3][0]
            skel_bad[k] = not bool(p[8][0])
        geom[k] = (hdr.mcus_x, hdr.mcus_y, hdr.height, hdr.width,
                   scan.restart_interval)
        luts_k = entropy_flat.merged_luts(hdr, scan)
        digest = luts_k.tobytes()
        idx = lut_sets.get(digest)
        if idx is None:
            idx = lut_sets.setdefault(digest, len(lut_stacks))
            lut_stacks.append(luts_k)
        lut_base[k] = idx * 2 * len(comp_hv)
    luts = np.concatenate(lut_stacks)
    qtables_b = np.stack([
        np.stack([hdr.quant_tables[c.tq].values for c in hdr.components])
        for _i, hdr, _s in items]).astype(np.int32)

    bp = -(-B // mesh.shape["data"]) * mesh.shape["data"]
    # Lane-count bucketing must stay FINE: per-step cost is ~linear in
    # total lanes (idle pad lanes still execute the masked gathers), so
    # coarse C rounding costs steps.  Eighth-granularity caps pad waste
    # at ~12% while keeping compiled-program counts O(log) (C is a static
    # arg of the step).
    c_step = 1 << max(C.bit_length() - 3, 0)
    cp = -(-(-(-C // c_step) * c_step) // mesh.shape["seg"]) \
        * mesh.shape["seg"]
    pools = _pad_to(pools, bp, 0)
    starts = _pad_to(_pad_to(starts, bp, 0), cp, 1)
    nm_lane = _pad_to(_pad_to(nm_lane, bp, 0), cp, 1)
    lane_off = _pad_to(_pad_to(lane_off, bp, 0), cp, 1)
    lut_base = _pad_to(lut_base, bp)
    skel_bad = _pad_to(skel_bad, bp)
    geom = _pad_to(geom, bp, 0)
    geom[B:, :2] = 1  # padded rows: 1x1 MCU, nothing decodes
    qtables_b = _pad_to(qtables_b, bp, 0)

    lane_sh = NamedSharding(mesh, P("data", "seg"))
    data_sh = NamedSharding(mesh, P("data"))
    pools_j = jax.device_put(jnp.asarray(pools),
                             NamedSharding(mesh, P("data", None)))
    args = (jax.device_put(jnp.asarray(starts), lane_sh),
            jax.device_put(jnp.asarray(nm_lane), lane_sh),
            jax.device_put(jnp.asarray(skel_bad), data_sh),
            jax.device_put(jnp.asarray(lane_off), lane_sh),
            jax.device_put(jnp.asarray(lut_base), data_sh))
    luts_j = _device_luts(luts, mesh)
    qt_j = jax.device_put(jnp.asarray(qtables_b), data_sh)
    geom_j = jax.device_put(jnp.asarray(geom), data_sh)

    rgb, ok, planes = _hybrid_full_step_emit_dyn(
        pools_j, *args, luts_j, qt_j, geom_j,
        block_comp=block_comp, n_comps=len(comp_hv), T=T,
        n_mcus_b=n_mcus_b, C=cp, precision=hdr0.precision,
        comp_shapes_b=comp_shapes_b, comp_hv=comp_hv,
        samplings=samplings, height_b=height_b, width_b=width_b,
        idct=idct, upsample=upsample, color=hdr0.colorspace,
        pair=pair, mesh_holder=_MeshHolder(mesh), keep_planes=keep_planes)
    if keep_planes:
        return rgb[:B], ok[:B], tuple(p[:B] for p in planes)
    return rgb[:B], ok[:B]


def _spec_group_dispatch(hdr, scans, mesh: Mesh, *, idct, upsample,
                         keep_planes=False):
    """Dispatch (without blocking) one DRI=0 group through the sharded
    speculative pipeline.  Returns (rgb (B, H, W, 3) device, ok (B,)
    device) — callers fetch ``ok`` after ALL groups are enqueued so group
    dispatches overlap — plus the coefficient planes when
    ``keep_planes``."""
    from ..models import decoder as decoder_mod
    from ..ops import entropy_spec

    lay = scan_layout(hdr)
    block_comp = tuple(
        ci for ci, c in enumerate(hdr.components) for _ in range(c.v * c.h))
    pools, base, lim, act, cap, C = entropy_spec.prepare_spec_batch(
        hdr, scans)
    luts = entropy_flat.merged_luts(hdr, scans[0]).reshape(
        2 * len(hdr.components), 65536)
    qtables = tuple(jnp.asarray(hdr.quant_tables[c.tq].values)
                    for c in hdr.components)
    comp_srcs = decoder_mod._comp_srcs_jax(lay)
    samplings = tuple(
        (hdr.v_max // c.v, hdr.h_max // c.h) for c in hdr.components)

    # Pad the image axis to the mesh 'data' dim; the chunk axis C to the
    # 'seg' dim.  Padded rows/lanes are inactive (decode nothing; their
    # splice ok is ignored by the caller).
    b0 = len(scans)
    bp = -(-b0 // mesh.shape["data"]) * mesh.shape["data"]
    cp = -(-C // mesh.shape["seg"]) * mesh.shape["seg"]
    pools = _pad_to(pools, bp, 0)
    base = _pad_to(_pad_to(base, bp, 0), cp, 1)
    lim = _pad_to(_pad_to(lim, bp, 0), cp, 1)
    act = _pad_to(_pad_to(act, bp, 0), cp, 1)

    pools_j = jax.device_put(jnp.asarray(pools),
                             NamedSharding(mesh, P("data", None)))
    lane_sh = NamedSharding(mesh, P("data", "seg"))
    base_j = jax.device_put(jnp.asarray(base), lane_sh)
    lim_j = jax.device_put(jnp.asarray(lim), lane_sh)
    act_j = jax.device_put(jnp.asarray(act), lane_sh)
    luts_j = _device_luts(luts, mesh)

    rgb, ok, planes = _spec_full_step(
        pools_j, base_j, lim_j, act_j, luts_j, qtables, comp_srcs,
        block_comp=block_comp, n_comps=len(hdr.components), cap=cap,
        n_mcus=lay.n_mcus, C=cp, precision=hdr.precision,
        comp_shapes=tuple(lay.comp_shapes), samplings=samplings,
        height=hdr.height, width=hdr.width, idct=idct, upsample=upsample,
        color=hdr.colorspace, mesh_holder=_MeshHolder(mesh),
        keep_planes=keep_planes)
    if keep_planes:
        return rgb[:b0], ok[:b0], tuple(p[:b0] for p in planes)
    return rgb[:b0], ok[:b0]


def _spec_group_rgb(hdr, scans, mesh: Mesh | None = None, *, idct,
                    upsample):
    """RGB for a group of same-geometry DRI=0 blobs via the sharded
    speculative pipeline (chunk lanes over ('data', 'seg')).  Images whose
    device splice fails (extreme MCU-size skew) fall back per image
    through the single-image speculative path."""
    if mesh is None:
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "seg"))
    rgb, ok = _spec_group_dispatch(hdr, scans, mesh, idct=idct,
                                   upsample=upsample)
    rgb, errs = _spec_group_finalize(hdr, scans, rgb, np.asarray(ok),
                                     idct=idct, upsample=upsample)
    bad = [e for e in errs if e is not None]
    if bad:
        raise bad[0]
    return rgb


def _spec_group_finalize(hdr, scans, rgb, ok_np, *, idct, upsample):
    """Patch rows whose device splice / skeleton scan failed (rare:
    extreme MCU-size skew, corrupt streams) via the single-image
    speculative path.  Failures stay PER-IMAGE: returns
    (rgb, [error-or-None per image]) so one corrupt stream cannot sink
    its whole geometry group."""
    from ..models import decoder as decoder_mod
    from ..models.batch import _batched_from_scan
    from ..ops import entropy_spec

    errs: list = [None] * len(scans)
    if ok_np.all():
        return rgb, errs
    lay = scan_layout(hdr)
    bpm = lay.blocks_per_mcu
    comp_srcs = decoder_mod._comp_srcs_jax(lay)
    samplings = tuple(
        (hdr.v_max // c.v, hdr.h_max // c.h) for c in hdr.components)
    qt = np.stack([hdr.quant_tables[c.tq].values for c in hdr.components])
    qt_j = jnp.asarray(qt)[None]
    for k in np.flatnonzero(~ok_np):
        try:
            if len(scans[int(k)].seg_offsets) == 2:
                one = entropy_spec.decode_scan_speculative(
                    hdr, scans[int(k)], as_device=True)
            else:
                # Restart streams off the emission path: host resilient
                # chain (native when built, oracle-grade Python last).
                one = jnp.asarray(decoder_mod._decode_scan_robust(
                    hdr, scans[int(k)], "auto"))
        except Exception as e:  # noqa: BLE001 — per-image isolation
            errs[int(k)] = e
            continue
        blocks1 = one[: lay.n_mcus * bpm].astype(jnp.int32)[None]
        rgb1 = _batched_from_scan(
            blocks1, qt_j, comp_srcs,
            comp_shapes=tuple(lay.comp_shapes), height=hdr.height,
            width=hdr.width, samplings=samplings, idct=idct,
            upsample=upsample, color=hdr.colorspace,
            precision=hdr.precision)
        rgb = rgb.at[int(k)].set(rgb1[0])
    return rgb, errs


# ---------------------------------------------------------------------------
# Fully device-resident batch decode from raw JPEG blobs
# ---------------------------------------------------------------------------

def _host_rgb_one(hdr, scan, *, idct, upsample):
    """Single-image host-entropy RGB at the image's TRUE geometry — the
    per-image fallback for bucketed-group rows whose device decode or
    skeleton scan failed."""
    from ..models import decoder as decoder_mod
    from ..models.batch import _batched_from_scan
    from ..ops import entropy_spec

    lay = scan_layout(hdr)
    bpm = lay.blocks_per_mcu
    if len(scan.seg_offsets) == 2 and not scan.restart_interval:
        one = entropy_spec.decode_scan_speculative(hdr, scan,
                                                   as_device=True)
    else:
        one = jnp.asarray(decoder_mod._decode_scan_robust(
            hdr, scan, "auto"))
    blocks1 = one[: lay.n_mcus * bpm].astype(jnp.int32)[None]
    qt = np.stack([hdr.quant_tables[c.tq].values
                   for c in hdr.components])
    samplings = tuple(
        (hdr.v_max // c.v, hdr.h_max // c.h) for c in hdr.components)
    rgb1 = _batched_from_scan(
        blocks1, jnp.asarray(qt)[None],
        decoder_mod._comp_srcs_jax(lay),
        comp_shapes=tuple(lay.comp_shapes), height=hdr.height,
        width=hdr.width, samplings=samplings, idct=idct,
        upsample=upsample, color=hdr.colorspace,
        precision=hdr.precision)
    return rgb1[0]


def decode_batch_sharded(blobs, mesh: Mesh, *, idct="kron",
                         upsample="fancy", keep_planes=False):
    """Decode a list of JPEG blobs with the ENTIRE compute path on device.

    The host does parse + unstuff only; the raw entropy words (the
    smallest possible wire: ~0.2 B/px on typical corpora vs 0.35 B/px for
    the nibble coefficient wire) ship to HBM, and entropy decode, plane
    assembly and the pixel pipeline run as ONE jitted program per geometry
    group — images shard over 'data'; restart segments (DRI>0, via
    :func:`full_decode_step`) or speculative chunk lanes (DRI=0, via
    :func:`_spec_full_step`) shard over 'seg'.  This is the serving shape
    for hosts whose CPUs cannot feed the chips (vs the BatchDecoder's
    host-entropy path) and the pod-scale aggregate-throughput path
    (docs/ARCHITECTURE.md).

    All groups are DISPATCHED before any result is fetched, so H2D and
    compute for different geometry groups overlap; the only host round
    trip per group is one (B,)-bool flag fetch.

    Device lanes carry single-scan 8-bit baseline Huffman frames;
    progressive / arithmetic / 12-bit / multi-scan / RST-mismatch frames
    fall back PER IMAGE to the BatchDecoder host-entropy path (decoded as
    one extra batch whose host stage overlaps the device waves), so a
    mixed corpus returns errors only for genuinely undecodable blobs
    (VERDICT r3 item 3).  Returns a list of models.batch.BatchItem;
    per-image failures are isolated.  With ``keep_planes`` every image a
    device route decoded also carries its quantized coefficient planes
    (``BatchItem.planes``) from the same programs that made its RGB.

    Default ``idct="kron"``: the fused dequant+IDCT Kronecker product
    (one contraction, no intermediate dequantized plane); like ``fast``
    it is within +-1 count of the float64 IDCT (tests pin |kron - fast|
    <= 1), inside libjpeg conformance tolerance.
    """
    from ..io import parser
    from ..models import decoder as decoder_mod
    from ..models.batch import BatchItem


    results: list = [None] * len(blobs)
    groups: dict[tuple, list] = {}
    host_fallback: list[int] = []
    prog_frames: list = []
    try:
        from ..entropy import native as _native_mod

        native_ok = _native_mod.available()
    except Exception:  # noqa: BLE001
        native_ok = False
    emit_max_lanes = int(os.environ.get("JD_RESTART_EMIT_MAX_LANES",
                                        "512"))
    # Geometry-BUCKETED grouping (VERDICT r3 item 4): when the emission
    # route is available, images group by pow-2 MCU-grid bucket +
    # sampling + colorspace — a serving corpus of arbitrary sizes
    # compiles O(log sizes) sharded programs, not one per distinct
    # (size, DRI, table-set).  Tables/DRI ride as dynamic inputs.
    use_dyn = (native_ok
               and os.environ.get("JD_SHARDED_BUCKET", "pow2") == "pow2"
               and os.environ.get("JD_DEVICE_ENTROPY", "hybrid") != "spec"
               and os.environ.get("JD_HYBRID_KERNEL", "emit") == "emit")
    if use_dyn:
        from ..models.batch import _bucket_pow2
    for i, blob in enumerate(blobs):
        try:
            hdr = parser.parse(blob)
            if (hdr.progressive and not hdr.arithmetic
                    and hdr.precision == 8):
                # Huffman progressive: device lane kernels
                # (ops/entropy_prog) — scan kinds decode as lockstep
                # lanes, planes stay in HBM (VERDICT r3 item 2).
                prog_frames.append((i, hdr))
                continue
            scan = hdr.scans[0]
            # 12-bit baseline Huffman rides the device lanes too (the
            # kernels take precision-dependent size caps, VERDICT r4
            # item 5; reference rejects precision != 8 at jpeg.cpp:77).
            if (hdr.progressive or hdr.arithmetic
                    or hdr.precision not in (8, 12)
                    or decoder_mod.needs_scan_loop(hdr)
                    or decoder_mod.segment_mismatch(hdr, scan)):
                # Valid frame the device lanes don't cover: host path,
                # decoded below as one BatchDecoder batch.
                host_fallback.append(i)
                continue
            exact_key = (
                hdr.width, hdr.height, hdr.precision,
                tuple((c.h, c.v) for c in hdr.components),
                # colorspace is a pixel-stage static: two same-geometry
                # same-table streams can differ only in APP14/JFIF
                # markers (stored-RGB vs YCbCr) and must not share a
                # compiled group (review r4 finding).
                hdr.colorspace,
                scan.restart_interval,
                tuple(sorted((tid, spec.counts.tobytes(),
                              spec.symbols.tobytes())
                             for tid, spec in scan.dc_specs.items())),
                tuple(sorted((tid, spec.counts.tobytes(),
                              spec.symbols.tobytes())
                             for tid, spec in scan.ac_specs.items())),
                tuple(sorted((tid, t.values.tobytes())
                             for tid, t in hdr.quant_tables.items())))
            n_seg = len(scan.seg_offsets) - 1
            if use_dyn and n_seg < emit_max_lanes:
                key = ("dyn", _bucket_pow2(hdr.mcus_x),
                       _bucket_pow2(hdr.mcus_y),
                       tuple((c.h, c.v) for c in hdr.components),
                       hdr.colorspace, hdr.precision)
            else:
                key = exact_key
            groups.setdefault(key, []).append((i, hdr, scan, exact_key))
        except Exception as e:  # noqa: BLE001 — per-image isolation
            results[i] = BatchItem(index=i, header=None, rgb_batch=None,
                                   batch_index=-1, error=e)

    # Phase 1: dispatch every group (async); nothing blocks on the
    # device.  Groups run on a 2-thread pool (jax dispatch is
    # thread-safe, the skeleton scans release the GIL), so group k+1's
    # HOST prep overlaps group k's H2D + device wave — the bench's
    # device-path breakdown showed host prep ~20% of the wall clock
    # when run serially (VERDICT r3 item 5, experiment 3).
    dispatched_by_slot: list = [None] * len(groups)

    def _dispatch_group(slot, key, items):
        hdr0 = items[0][1]
        B = len(items)
        try:
            from ..entropy import native as native_mod

            if key[0] == "dyn":
                # Geometry-bucketed emission route.  One special case
                # preserved from the exact router: a UNIFORM group of
                # restart streams whose segment lanes already exceed the
                # emission threshold (JD_RESTART_EMIT_MAX_LANES, default
                # 512; not yet tuned for the GPU) takes the lockstep
                # kernel.
                n_seg0 = len(hdr0.scans[0].seg_offsets) - 1
                uniform = len({it[3] for it in items}) == 1
                if uniform and not (
                        hdr0.scans[0].restart_interval
                        and B * n_seg0 >= emit_max_lanes):
                    # A UNIFORM group pays none of the dyn route's
                    # dynamic-geometry overhead (per-image prep, device-
                    # built gather maps), and the exact emission dispatch
                    # compiles the same O(1) programs for it.
                    scans = [it[2] for it in items]
                    out = _hybrid_group_dispatch(
                        hdr0, scans, mesh, idct=idct, upsample=upsample,
                        keep_planes=keep_planes)
                    dispatched_by_slot[slot] = (items, *out[:2], scans,
                                                "hybrid", out[2:])
                    return
                if (uniform and hdr0.scans[0].restart_interval
                        and B * n_seg0 >= emit_max_lanes):
                    prepped = [scan_prep.prepare_scan(hdr, scan)[:2]
                               for _, hdr, scan, _k in items]
                    s_max = max(len(nm) for _, nm in prepped)
                    w_max = max(w.shape[1] for w, _ in prepped)
                    words_b = np.zeros((B, s_max, w_max), np.uint32)
                    nm_b = np.zeros((B, s_max), np.int64)
                    for k, (w, nm) in enumerate(prepped):
                        words_b[k, : w.shape[0], : w.shape[1]] = w
                        nm_b[k, : len(nm)] = nm
                    out = full_decode_step(
                        hdr0, words_b, nm_b, mesh, idct=idct,
                        upsample=upsample, keep_planes=keep_planes)
                    dispatched_by_slot[slot] = (items, out[0], out[2], None,
                                                "lockstep", out[3:])
                else:
                    out = _hybrid_group_dispatch_dyn(
                        [(i, hdr, scan) for i, hdr, scan, _k in items],
                        mesh, idct=idct, upsample=upsample,
                        keep_planes=keep_planes)
                    dispatched_by_slot[slot] = (items, *out[:2], "dyn",
                                                "hybrid-dyn", out[2:])
                return

            # Exact-geometry routes (no native lib / emit disabled /
            # >= emit_max_lanes restart segments per image).
            n_seg0 = len(hdr0.scans[0].seg_offsets) - 1
            use_emit_restart = (
                hdr0.scans[0].restart_interval
                and native_mod.available()
                and B * n_seg0 < emit_max_lanes
                and os.environ.get("JD_DEVICE_ENTROPY", "hybrid")
                != "spec"
                and os.environ.get("JD_HYBRID_KERNEL", "emit") == "emit")
            if hdr0.scans[0].restart_interval and not use_emit_restart:
                # Restart streams without the native lib (or with the
                # emit kernel disabled): segments are the lanes.
                prepped = [scan_prep.prepare_scan(hdr, scan)[:2]
                           for _, hdr, scan, _k in items]
                s_max = max(len(nm) for _, nm in prepped)
                w_max = max(w.shape[1] for w, _ in prepped)
                words_b = np.zeros((B, s_max, w_max), np.uint32)
                nm_b = np.zeros((B, s_max), np.int64)
                for k, (w, nm) in enumerate(prepped):
                    words_b[k, : w.shape[0], : w.shape[1]] = w
                    nm_b[k, : len(nm)] = nm
                out = full_decode_step(
                    hdr0, words_b, nm_b, mesh, idct=idct, upsample=upsample,
                    keep_planes=keep_planes)
                dispatched_by_slot[slot] = (items, out[0], out[2], None,
                                            "lockstep", out[3:])
            elif use_emit_restart:
                # Restart streams on the emission path: per-segment
                # skeleton scans give MCU-granular symbol-balanced
                # lanes (segment starts forced as lane boundaries), so
                # an image with few segments still fills hundreds of
                # lanes.  Images whose skeleton fails fall back to the
                # resilient host chain per image via the finalize path.
                scans = [it[2] for it in items]
                out = _hybrid_group_dispatch(
                    hdr0, scans, mesh, idct=idct, upsample=upsample,
                    keep_planes=keep_planes)
                dispatched_by_slot[slot] = (items, *out[:2], scans,
                                            "hybrid", out[2:])
            else:
                # DRI=0 streams: hybrid decode (host skeleton scan ->
                # device lanes from TRUE MCU starts) when the native lib
                # is present; speculative chunk lanes otherwise, or when
                # JD_DEVICE_ENTROPY=spec forces the zero-host-cycles path.
                scans = [it[2] for it in items]
                use_hybrid = (native_mod.available()
                              and os.environ.get("JD_DEVICE_ENTROPY",
                                                 "hybrid") != "spec")
                dispatch, route = ((_hybrid_group_dispatch, "hybrid")
                                   if use_hybrid else
                                   (_spec_group_dispatch, "spec"))
                out = dispatch(hdr0, scans, mesh, idct=idct,
                               upsample=upsample, keep_planes=keep_planes)
                dispatched_by_slot[slot] = (items, *out[:2], scans, route,
                                            out[2:])
        except Exception as e:  # noqa: BLE001
            for it in items:
                results[it[0]] = BatchItem(
                    index=it[0], header=it[1], rgb_batch=None,
                    batch_index=-1, error=e)

    group_list = list(groups.items())
    # Threaded dispatch is for ONE-DEVICE meshes only: every device must
    # enqueue collective programs in the same order, and a thread pool
    # could interleave two groups' psum-bearing programs differently on
    # different devices (a collective deadlock) — across the processes of
    # jax.distributed or across the GPUs of one process alike.
    serial = mesh.size > 1
    if len(group_list) > 1 and not serial:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as ex:
            list(ex.map(lambda sk: _dispatch_group(sk[0], *sk[1]),
                        enumerate(group_list)))
    else:
        for slot, (key, items) in enumerate(group_list):
            _dispatch_group(slot, key, items)
    dispatched = [d for d in dispatched_by_slot if d is not None]

    # Progressive frames: per-image device-lane decode (host does only
    # the position-only skeleton walks), overlapping the in-flight
    # baseline groups; frames run on a 2-thread pool (the skeleton
    # walks release the GIL, jax dispatch is thread-safe) so one
    # image's host walks overlap another's device programs.  A frame
    # whose device decode fails falls back to the host path.
    def _prog_one(arg):
        i, hdr = arg
        try:
            from ..ops import entropy_prog

            planes = entropy_prog.decode_progressive_lanes(
                hdr, as_device=True, mesh=mesh)
            qtables = tuple(jnp.asarray(hdr.quant_tables[c.tq].values)
                            for c in hdr.components)
            samplings = tuple(
                (hdr.v_max // c.v, hdr.h_max // c.h)
                for c in hdr.components)
            rgb = pixel_ops.pixel_pipeline(
                tuple(planes), qtables, height=hdr.height,
                width=hdr.width, samplings=samplings, idct=idct,
                upsample=upsample, color=hdr.colorspace,
                precision=hdr.precision)
            results[i] = BatchItem(
                index=i, header=hdr, rgb_batch=rgb[None], batch_index=0,
                route="progressive",
                planes=tuple(planes) if keep_planes else None)
        except Exception:  # noqa: BLE001 — per-image isolation
            host_fallback.append(i)

    if len(prog_frames) > 1 and not serial:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as ex:
            list(ex.map(_prog_one, prog_frames))
    else:
        for pf in prog_frames:
            _prog_one(pf)

    # Host-path frames decode while the device groups are in flight: the
    # BatchDecoder's host entropy stage runs now, its own device pixel
    # dispatches interleave with the sharded waves, and per-image
    # isolation comes with it.
    if host_fallback:
        from ..models.batch import BatchDecoder

        bd = BatchDecoder(idct=idct, upsample=upsample)
        host_items = bd.decode([blobs[i] for i in host_fallback])
        for i, it in zip(host_fallback, host_items):
            results[i] = BatchItem(
                index=i, header=it.header, rgb_batch=it.rgb_batch,
                batch_index=it.batch_index, error=it.error, route="host")

    # Phase 2: fetch ALL groups' flags with ONE device concatenation +
    # D2H transfer — one host round trip in total, not one per group.
    flags_np: list = []
    if dispatched:
        cat_dev = jnp.concatenate([jnp.ravel(d[2]) for d in dispatched])
        if jax.process_count() > 1:
            # Multihost: the flags are sharded over 'data'; gather the
            # full array on every process (np.asarray on a non-fully-
            # addressable global array raises).
            from jax.experimental import multihost_utils

            cat = np.asarray(
                multihost_utils.process_allgather(cat_dev, tiled=True))
        else:
            cat = np.asarray(cat_dev)
        o = 0
        for d in dispatched:
            n = int(np.prod(np.shape(d[2])))
            flags_np.append(cat[o: o + n])
            o += n
    for (items, rgb_b, flags, scans, route, kept), fl in zip(dispatched,
                                                             flags_np):
        hdr0 = items[0][1]
        override: dict[int, object] = {}
        row_fallback = np.zeros(len(items), bool)
        try:
            if scans is None:  # restart path: flags = per-image error
                errs = [JPEGError("device entropy decode failed")
                        if bool(f) else None for f in fl]
            elif scans == "dyn":
                # Bucketed group: a failed row re-decodes per image at
                # its OWN geometry and becomes a STANDALONE batch-of-1
                # result.  (Patching the host array into the
                # 'data'-sharded group batch would mix a process-local
                # array into a multi-process sharded one, and pays a
                # full functional update of the batch — ADVICE r4.)
                ok_np = fl
                errs = [None] * len(items)
                for k in np.flatnonzero(~ok_np):
                    _i, hdr_k, scan_k, _key = items[int(k)]
                    try:
                        rgb1 = _host_rgb_one(hdr_k, scan_k, idct=idct,
                                             upsample=upsample)
                        override[int(k)] = jnp.asarray(rgb1)[None]
                    except Exception as e:  # noqa: BLE001
                        errs[int(k)] = e
            else:
                # hybrid/spec ok flags are self-sufficient device bools.
                ok_np = fl
                row_fallback = ~np.asarray(ok_np, bool)
                rgb_b, errs = _spec_group_finalize(
                    hdr0, scans, rgb_b, ok_np, idct=idct,
                    upsample=upsample)
            for k, it in enumerate(items):
                if k in override:
                    results[it[0]] = BatchItem(
                        index=it[0], header=it[1],
                        rgb_batch=override[k], batch_index=0,
                        error=errs[k], route="host-row")
                else:
                    planes = None
                    if kept and not row_fallback[k]:
                        # Group planes may be bucket-size: the image's own
                        # planes are their top-left crop.
                        shapes = scan_layout(it[1]).comp_shapes
                        planes = tuple(p[k, :r, :c]
                                       for p, (r, c) in zip(kept[0], shapes))
                    results[it[0]] = BatchItem(
                        index=it[0], header=it[1], rgb_batch=rgb_b,
                        batch_index=k, error=errs[k],
                        route="host-row" if row_fallback[k] else route,
                        planes=planes)
        except Exception as e:  # noqa: BLE001
            for it in items:
                results[it[0]] = BatchItem(
                    index=it[0], header=it[1], rgb_batch=None,
                    batch_index=-1, error=e)
    return results

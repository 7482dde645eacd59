"""Batched decode: the throughput/serving path.

Decodes many JPEGs by (1) running host entropy decode in a thread pool (the
native C++ backend releases the GIL), (2) grouping images by frame geometry,
and (3) dispatching ONE fused device program per group — scan blocks are
shipped verbatim and plane assembly/dequant/IDCT/upsample/color all happen
on device, vmapped over the batch.

Decoded RGB stays device-resident by default: the dominant accelerator use
case is feeding decoded images straight into an ML input pipeline on the
same device; fetch to host only when asked.
"""

from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from .. import layout as layout_mod
from ..io import parser
from ..ops import pixel as pixel_ops
from ..types import FrameHeader
from . import decoder as decoder_mod


@functools.partial(jax.jit, static_argnames=(
    "comp_shapes", "height", "width", "samplings", "idct", "upsample",
    "color", "precision"))
def _batched_from_scan(blocks_b, qtables_b, comp_srcs, *, comp_shapes,
                       height, width, samplings, idct, upsample, color="auto", precision=8):
    """(B, N, 64) scan blocks + (B, ncomp, 64) qtables -> (B, H, W, 3)."""

    def one(blocks, qt):
        blocks = blocks.astype(jnp.int32)  # widen int16 wire format
        planes = tuple(
            jnp.take(blocks, src, axis=0).reshape(rows, cols, 64)
            for src, (rows, cols) in zip(comp_srcs, comp_shapes))
        qts = tuple(qt[i] for i in range(len(comp_shapes)))
        return pixel_ops.pixel_pipeline_impl(
            planes, qts, height=height, width=width,
            samplings=samplings, idct=idct, upsample=upsample,
            color=color, precision=precision)

    return jax.vmap(one)(blocks_b, qtables_b)


def _planes_from_blocks_dyn(blocks, geom, *, comp_shapes, comp_hv, bpm):
    """Per-image plane assembly with the gather map built ON DEVICE from
    the image's dynamic geometry (geometry bucketing: one compiled program
    serves every image size in the bucket).

    ``blocks``: (n_blk_bucket, 64) scan-order blocks, true blocks a prefix.
    ``geom``: (4,) int32 = (mcus_x, mcus_y, height, width), traced.
    ``comp_shapes``: static BUCKET plane dims per component;
    ``comp_hv``: static (h, v) sampling factors per component.
    Cells beyond the image's true plane extent read zero blocks (take
    mode='fill'), reproducing layout.scan_layout's comp_src maps inside
    the true region (pinned by tests/test_batch_bucketing.py)."""
    mcus_x = geom[0]
    mcus_y = geom[1]
    n_blk = blocks.shape[0]
    planes = []
    k0 = 0
    for (R, C_), (h, v) in zip(comp_shapes, comp_hv):
        r = jax.lax.broadcasted_iota(jnp.int32, (R, C_), 0)
        c = jax.lax.broadcasted_iota(jnp.int32, (R, C_), 1)
        src = ((r // v) * mcus_x + (c // h)) * bpm \
            + (k0 + (r % v) * h + (c % h))
        valid = (r < mcus_y * v) & (c < mcus_x * h)
        src = jnp.where(valid, src, n_blk).reshape(-1)
        planes.append(jnp.take(blocks, src, axis=0, mode="fill",
                               fill_value=0).reshape(R, C_, 64))
        k0 += h * v
    return tuple(planes)


def _rgb_one_dyn(blocks, qt, geom, *, comp_shapes, comp_hv, height, width,
                 samplings, idct, upsample, color, precision):
    """blocks (n_blk_bucket, 64) + dynamic geometry -> bucket-size RGB;
    pixels inside (geom height, width) are exact, the rest is padding the
    consumer crops (models.batch.BatchItem.rgb)."""
    bpm = sum(h * v for h, v in comp_hv)
    planes = _planes_from_blocks_dyn(
        blocks, geom, comp_shapes=comp_shapes, comp_hv=comp_hv, bpm=bpm)
    qts = tuple(qt[i] for i in range(len(comp_shapes)))
    return pixel_ops.pixel_pipeline_impl(
        planes, qts, height=height, width=width, samplings=samplings,
        idct=idct, upsample=upsample, color=color, precision=precision,
        true_dims=(geom[2], geom[3]))


def pack_blocks(blocks: np.ndarray):
    """Compact lossless wire format for quantized coefficients.

    JPEG AC coefficients rarely exceed |127|; DC values routinely do.
    Split: DC plane as int16, AC as int8 with a sparse escape list for the
    outliers.  ~1.9x fewer bytes over PCIe than int16 blocks.

    Returns (dc16 (N,), ac8 (N, 64) with [:,0]=0, esc_idx (E,), esc_val (E,)).
    """
    dc16 = blocks[:, 0].astype(np.int16)
    ac = blocks.copy()
    ac[:, 0] = 0
    flat = ac.reshape(-1)
    esc_idx = np.flatnonzero((flat < -128) | (flat > 127)).astype(np.int32)
    esc_val = flat[esc_idx].astype(np.int16)
    ac8 = np.clip(ac, -128, 127).astype(np.int8)
    return dc16, ac8, esc_idx, esc_val


def sparsify_ac(ac8: np.ndarray):
    """Sparse AC wire encoding: (gap uint8, value int8) pairs.

    JPEG AC planes are overwhelmingly zero (the format's run-length coding
    exists because of it) — a dense int8 plane ships ~64 B/block while the
    corpus averages ~9 nonzeros/block.  Encode the flat (N*64) AC stream
    (DC slots zeroed) as successive-nonzero gaps: entry i means "advance
    gap_i positions, write val_i".  Gaps > 255 emit extender entries
    (gap=255, val=0) — val 0 writes are no-ops on the zero-initialized
    device plane, so reconstruction is a plain cumsum + scatter-add.

    ~3.4x fewer wire bytes than the dense packed format on the reference
    corpus (0.52 vs 1.78 B/px) — the H2D transfer is the serving
    bottleneck, not compute (docs/ARCHITECTURE.md).
    """
    flat = ac8.reshape(-1)
    nz = np.flatnonzero(flat)
    gaps = np.diff(nz, prepend=-1)
    n_ext = (gaps - 1) // 255
    total = nz.size + int(n_ext.sum())
    g = np.full(total, 255, np.uint8)
    v = np.zeros(total, np.int8)
    last = np.cumsum(n_ext + 1) - 1
    g[last] = (gaps - 255 * n_ext).astype(np.uint8)
    v[last] = flat[nz]
    return g, v


def nibbleize_ac(ac8: np.ndarray):
    """Nibble wire encoding ("v2"): one byte per entry, (gap<<4)|val-code.

    Val codes: 0x1-0x7 = +1..+7, 0x9-0xF = -7..-1 (two's-complement low
    nibble), 0x8 = value overflows 4 bits and comes from the next slot of
    the side `ov` int8 stream, 0x0 = extender (no value written).  Gap
    semantics: a real entry advances by its gap nibble (0-15); an extender
    entry advances by gap*16 (so one extender + one entry cover gaps up to
    255, like the v1 uint8 gap; chains of (15,0) extenders cover more).

    ~1.5x fewer wire bytes than the (gap u8, val i8) pair format on the
    reference corpus (0.35 vs 0.52 B/px) — values cluster in [-7, 7].

    Returns (entries (K,) uint8, ov (O,) int8).  |val| > 127 still goes
    through the separate escape list (the int8 ov slot holds the clipped
    value, exactly like the v1 val stream).
    """
    flat = ac8.reshape(-1)
    nz = np.flatnonzero(flat)
    vals = flat[nz].astype(np.int32)
    gaps = np.diff(nz, prepend=-1)
    n240 = np.maximum(0, -(-(gaps - 255) // 240))
    rem = gaps - 240 * n240          # in [1, 255] (>= 16 when n240 > 0)
    n16 = rem > 15
    reps = n240 + n16 + 1
    total = int(reps.sum())
    e = np.full(total, 0xF0, np.uint8)     # default: chain extender (+240)
    last = np.cumsum(reps) - 1
    lo = np.where(n16, rem & 15, rem)
    vc = np.where(np.abs(vals) <= 7, vals & 15, 8).astype(np.uint8)
    e[last] = (lo.astype(np.uint8) << 4) | vc
    scaled = last[n16] - 1
    e[scaled] = (rem[n16] >> 4).astype(np.uint8) << 4
    ov = np.clip(vals[np.abs(vals) > 7], -128, 127).astype(np.int8)
    return e, ov


def slotify_ac(ac8: np.ndarray, cap: int):
    """Per-block slot wire encoding: (N, C) position/value slot arrays.

    The first ``cap`` nonzeros of each block fill its slots (position =
    natural-order index 1..63; 0 marks an empty slot — the DC slot is
    never an AC position); the tail spills to an overflow list of (flat
    index, value) pairs.  Reconstruction needs NO large scatter: a
    per-block one-hot compare-and-sum rebuilds dense blocks on the VPU,
    ~10-15x faster than the scatter-add the gap-coded wires require —
    the trade is more wire bytes (2*C per block), so this format wins
    when H2D bandwidth is plentiful and the device is the bottleneck.

    Returns (pos (N, C) uint8, val (N, C) int8, ov_idx (O,) int32,
    ov_val (O,) int16).
    """
    n = ac8.shape[0]
    rows, cols0 = np.nonzero(ac8[:, 1:])
    cols = cols0 + 1
    counts = np.bincount(rows, minlength=n)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(rows)) - first[rows]
    in_slot = rank < cap
    pos = np.zeros((n, cap), np.uint8)
    val = np.zeros((n, cap), np.int8)
    pos[rows[in_slot], rank[in_slot]] = cols[in_slot]
    val[rows[in_slot], rank[in_slot]] = ac8[rows[in_slot], cols[in_slot]]
    ov_rows, ov_cols = rows[~in_slot], cols[~in_slot]
    ov_idx = (ov_rows.astype(np.int64) * 64 + ov_cols).astype(np.int32)
    ov_val = ac8[ov_rows, ov_cols].astype(np.int16)
    return pos, val, ov_idx, ov_val


#: Fixed slot capacity: covers ~p90 of corpus blocks; the tail goes to
#: the overflow scatter (30x fewer updates than a full scatter wire).
_SLOT_CAP = 16


@functools.partial(jax.jit, static_argnames=(
    "comp_shapes", "comp_hv", "height", "width", "samplings", "idct",
    "upsample", "color", "precision"))
def _batched_from_slots(dc16_b, pos_b, val_b, ov_idx_b, ov_val_b,
                        esc_idx_b, esc_val_b, qtables_b, geom_b, *,
                        comp_shapes, comp_hv, height, width, samplings,
                        idct, upsample, color="auto", precision=8):
    """Slot-wire batch: one-hot compare-and-sum per block, no big scatter.

    Padding: empty slots are (0, 0) — position 0 never matches an AC
    lane; overflow/escape pads use out-of-range indices (dropped)."""

    lane = jnp.arange(1, 64, dtype=jnp.int32)  # AC lanes only

    def one(dc16, pos, val, ov_idx, ov_val, esc_idx, esc_val, qt, geom):
        n = dc16.shape[0]
        p = pos.astype(jnp.int32)
        v = val.astype(jnp.int32)
        ac = (v[:, :, None]
              * (p[:, :, None] == lane[None, None, :])).sum(axis=1)
        blocks = jnp.concatenate(
            [dc16.astype(jnp.int32)[:, None], ac], axis=1)
        flat = blocks.reshape(-1)
        flat = flat.at[ov_idx].set(ov_val.astype(jnp.int32), mode="drop")
        flat = flat.at[esc_idx].set(esc_val.astype(jnp.int32), mode="drop")
        blocks = flat.reshape(n, 64)
        return _rgb_one_dyn(
            blocks, qt, geom, comp_shapes=comp_shapes, comp_hv=comp_hv,
            height=height, width=width, samplings=samplings, idct=idct,
            upsample=upsample, color=color, precision=precision)

    return jax.vmap(one)(dc16_b, pos_b, val_b, ov_idx_b, ov_val_b,
                         esc_idx_b, esc_val_b, qtables_b, geom_b)


@functools.partial(jax.jit, static_argnames=(
    "comp_shapes", "comp_hv", "height", "width", "samplings", "idct",
    "upsample", "color", "precision"))
def _batched_from_nibble(dc16_b, e_b, ov_b, esc_idx_b, esc_val_b,
                         qtables_b, geom_b, *, comp_shapes, comp_hv,
                         height, width, samplings, idct, upsample,
                         color="auto", precision=8):
    """Nibble-wire batch: decode entry bytes, cumsum advances, scatter-add.

    Padding: 0x00 filler entries advance 0 and write 0; all-filler rows
    cumsum to -1 (dropped); ov pads are never ranked; escape pads are out
    of range (dropped)."""

    def one(dc16, e, ov, esc_idx, esc_val, qt, geom):
        n = dc16.shape[0]
        ei = e.astype(jnp.int32)
        g, vcode = ei >> 4, ei & 15
        adv = jnp.where(vcode == 0, g * 16, g)
        idx = jnp.cumsum(adv) - 1
        v4 = ((vcode + 8) & 15) - 8          # 0x8 -> -8, replaced below
        is_ov = vcode == 8
        rank = jnp.cumsum(is_ov.astype(jnp.int32)) - 1
        vals = jnp.where(is_ov, ov[rank].astype(jnp.int32), v4)
        flat = jnp.zeros((n * 64,), jnp.int32)
        flat = flat.at[idx].add(vals, mode="drop")
        flat = flat.at[esc_idx].set(esc_val.astype(jnp.int32), mode="drop")
        blocks = flat.reshape(n, 64).at[:, 0].set(dc16.astype(jnp.int32))
        return _rgb_one_dyn(
            blocks, qt, geom, comp_shapes=comp_shapes, comp_hv=comp_hv,
            height=height, width=width, samplings=samplings, idct=idct,
            upsample=upsample, color=color, precision=precision)

    return jax.vmap(one)(dc16_b, e_b, ov_b, esc_idx_b, esc_val_b,
                         qtables_b, geom_b)


@functools.partial(jax.jit, static_argnames=(
    "comp_shapes", "comp_hv", "height", "width", "samplings", "idct",
    "upsample", "color", "precision"))
def _batched_from_sparse(dc16_b, gaps_b, vals_b, esc_idx_b, esc_val_b,
                         qtables_b, geom_b, *, comp_shapes, comp_hv,
                         height, width, samplings, idct, upsample,
                         color="auto", precision=8):
    """Sparse-wire batch: cumsum the gaps, scatter-add the values.

    Padding conventions (all dropped/no-op on device): gap=0,val=0 fillers
    re-add 0 at the last real position (indices of real entries are
    strictly increasing, so scatter-add == scatter-set for them); an
    all-filler row cumsums to index -1, dropped by mode='drop'; escape
    pads use index n*64 (out of range, dropped)."""

    def one(dc16, gaps, vals, esc_idx, esc_val, qt, geom):
        n = dc16.shape[0]
        idx = jnp.cumsum(gaps.astype(jnp.int32)) - 1
        flat = jnp.zeros((n * 64,), jnp.int32)
        flat = flat.at[idx].add(vals.astype(jnp.int32), mode="drop")
        flat = flat.at[esc_idx].set(esc_val.astype(jnp.int32), mode="drop")
        blocks = flat.reshape(n, 64).at[:, 0].set(dc16.astype(jnp.int32))
        return _rgb_one_dyn(
            blocks, qt, geom, comp_shapes=comp_shapes, comp_hv=comp_hv,
            height=height, width=width, samplings=samplings, idct=idct,
            upsample=upsample, color=color, precision=precision)

    return jax.vmap(one)(dc16_b, gaps_b, vals_b, esc_idx_b, esc_val_b,
                         qtables_b, geom_b)


@functools.partial(jax.jit, static_argnames=(
    "comp_shapes", "comp_hv", "height", "width", "samplings", "idct",
    "upsample", "color", "precision"))
def _batched_from_packed(dc16_b, ac8_b, esc_idx_b, esc_val_b, qtables_b,
                         geom_b, *, comp_shapes, comp_hv, height, width,
                         samplings, idct, upsample, color="auto",
                         precision=8):
    """Packed-wire-format batch: unpack on device, then the usual pipeline.

    esc_idx_b is padded with out-of-range indices (dropped by the scatter).
    """

    def one(dc16, ac8, esc_idx, esc_val, qt, geom):
        n = ac8.shape[0]
        flat = ac8.astype(jnp.int32).reshape(-1)
        flat = flat.at[esc_idx].set(esc_val.astype(jnp.int32), mode="drop")
        blocks = flat.reshape(n, 64)
        blocks = blocks.at[:, 0].set(dc16.astype(jnp.int32))
        return _rgb_one_dyn(
            blocks, qt, geom, comp_shapes=comp_shapes, comp_hv=comp_hv,
            height=height, width=width, samplings=samplings, idct=idct,
            upsample=upsample, color=color, precision=precision)

    return jax.vmap(one)(dc16_b, ac8_b, esc_idx_b, esc_val_b, qtables_b,
                         geom_b)


def _bucket(n: int, min_size: int = 256) -> int:
    """Round up keeping 4 significant bits (max 6.25% padding waste).

    Pure pow-2 bucketing wastes up to 2x wire bytes on the padded sparse
    streams — material when H2D transfer is the bottleneck.  Finer buckets
    trade a few more compiled programs for tight transfers (the
    persistent compilation cache absorbs the compile cost)."""
    n = max(n, min_size)
    step = 1 << max((n - 1).bit_length() - 4, 0)
    return -(-n // step) * step


def _bucket_pow2(n: int) -> int:
    """Next power of two (geometry buckets: MCU grid dims round up so a
    serving corpus of arbitrary image sizes compiles O(log sizes) pixel
    programs, not one per distinct size — VERDICT r2 item 7).  The pixel
    pipeline is ~50x faster than host entropy, so padded pixel compute is
    nearly free; wire bytes stay proportional to TRUE content (the sparse
    formats ship only real nonzeros)."""
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass
class BatchItem:
    index: int              # position in the input list
    header: FrameHeader | None
    rgb_batch: jax.Array | None  # (B, H, W, 3) uint8 group output (device)
    batch_index: int        # this image's row in rgb_batch
    error: Exception | None = None  # per-image failure isolation
    # decode_batch_sharded: the device route that decoded this image
    # ("hybrid", "hybrid-dyn", "lockstep", "spec", "progressive"), or
    # "host" / "host-row" when it fell back to host entropy decode.
    route: str | None = None
    # decode_batch_sharded(keep_planes=True): the quantized coefficient
    # planes (rows, cols, 64) per component, as the device route decoded
    # them; None on host routes.
    planes: tuple | None = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def rgb(self) -> jax.Array:
        """This image's (H, W, 3) RGB.  Materialized lazily: slicing a
        device array dispatches one small program per item — batch
        consumers should use ``rgb_batch`` directly (its rows may carry
        geometry-bucket padding beyond (header.height, header.width); this
        crop removes it)."""
        row = self.rgb_batch[self.batch_index]
        if (self.header is not None
                and row.shape[:2] != (self.header.height,
                                      self.header.width)):
            row = row[: self.header.height, : self.header.width]
        return row


class BatchDecoder:
    """Reusable batched decoder with per-geometry program caching."""

    def __init__(self, *, entropy: str = "auto", idct: str = "fast",
                 upsample: str = "fancy", device=None,
                 host_threads: int | None = None, wire: str = "nibble",
                 bucket: str | None = "pow2"):
        if wire not in ("nibble", "sparse", "packed", "slots"):
            raise ValueError(f"unknown wire format {wire!r}")
        if bucket not in (None, "pow2"):
            raise ValueError(f"unknown bucket mode {bucket!r}")
        self.entropy = entropy
        self.idct = idct
        self.upsample = upsample
        self.wire = wire
        self.bucket = bucket
        self.device = device
        self._pool = ThreadPoolExecutor(host_threads or 2)
        self._device_pool = ThreadPoolExecutor(2)
        self._decode_scan = decoder_mod._entropy_backend(entropy)
        # Fast path: native decoder emits the wire format directly.
        self._packed_fn = None
        self._sparse_fn = None
        self._nibble_fn = None
        self._slots_fn = None
        if entropy in ("auto", "native"):
            try:
                from ..entropy import native

                if native.available():
                    self._packed_fn = native.decode_scan_packed
                    self._sparse_fn = native.decode_scan_sparse
                    self._nibble_fn = getattr(
                        native, "decode_scan_nibble", None)
                    self._slots_fn = getattr(
                        native, "decode_scan_slots", None)
            except Exception:
                pass

    def _host_one(self, blob):
        """Host stage with per-image failure isolation: one malformed image
        must not fail the batch (unlike the reference's exit(1) policy,
        SURVEY.md §5)."""
        try:
            return self._host_one_inner(blob)
        except Exception as e:  # noqa: BLE001
            return e, None

    def _host_one_inner(self, blob):
        hdr = parser.parse(blob)
        if (hdr.progressive or hdr.arithmetic or hdr.precision != 8
                or decoder_mod.needs_scan_loop(hdr)
                or decoder_mod.segment_mismatch(hdr, hdr.scans[0])):
            planes = decoder_mod.decode_to_planes(hdr, entropy=self.entropy)
            # Flatten planes back to scan order so batching is uniform.
            lay = layout_mod.scan_layout(hdr)
            blocks = np.zeros((lay.total_blocks, 64), np.int32)
            for ci, p in enumerate(planes):
                blocks[lay.comp_src[ci]] = p.reshape(-1, 64)
            pack = pack_blocks(blocks)
        elif self.wire == "slots" and self._slots_fn is not None:
            return hdr, self._slots_fn(hdr, hdr.scans[0], _SLOT_CAP)
        elif self.wire == "nibble" and self._nibble_fn is not None:
            return hdr, self._nibble_fn(hdr, hdr.scans[0])
        elif self.wire == "sparse" and self._sparse_fn is not None:
            # Native emitter: straight from the run-length decode loop to
            # the sparse wire, no dense AC plane at all.
            return hdr, self._sparse_fn(hdr, hdr.scans[0])
        elif self._packed_fn is not None:
            pack = self._packed_fn(hdr, hdr.scans[0])
        else:
            pack = pack_blocks(
                np.asarray(self._decode_scan(hdr, hdr.scans[0])))
        if self.wire == "slots":
            dc16, ac8, esc_idx, esc_val = pack
            pos, val, ov_idx, ov_val = slotify_ac(ac8, _SLOT_CAP)
            return hdr, (dc16, pos, val, ov_idx, ov_val, esc_idx, esc_val)
        if self.wire == "nibble":
            dc16, ac8, esc_idx, esc_val = pack
            e, ov = nibbleize_ac(ac8)
            return hdr, (dc16, e, ov, esc_idx, esc_val)
        if self.wire == "sparse":
            dc16, ac8, esc_idx, esc_val = pack
            g, v = sparsify_ac(ac8)
            return hdr, (dc16, g, v, esc_idx, esc_val)
        return hdr, pack

    def decode(self, blobs: list[bytes],
               wave: int | None = None) -> list[BatchItem]:
        """Decode a list of JPEG byte strings; returns device-resident RGB
        in input order.

        Large inputs are processed in *waves*: host entropy for wave k+1
        overlaps device transfer/compute for wave k (2-stage pipeline).
        """
        if wave is None:
            wave = 96
        if len(blobs) > wave:
            results: list[BatchItem | None] = [None] * len(blobs)
            device_fut = None
            for start in range(0, len(blobs), wave):
                chunk = blobs[start:start + wave]
                host_out = list(self._pool.map(self._host_one, chunk))
                if device_fut is not None:
                    device_fut.result()
                device_fut = self._device_pool.submit(
                    self._decode_wave, host_out, results, start)
            if device_fut is not None:
                device_fut.result()
            return results  # type: ignore[return-value]
        results = [None] * len(blobs)
        self._decode_wave(list(self._pool.map(self._host_one, blobs)),
                          results, 0)
        return results  # type: ignore[return-value]

    def _decode_wave(self, host_out, results, base):
        import os
        import time

        debug = os.environ.get("JD_BATCH_DEBUG")
        t0 = time.perf_counter()

        # Group by geometry BUCKET (pow-2 MCU-grid dims by default) and
        # table-independent pipeline signature: a serving corpus of
        # arbitrary image sizes compiles O(buckets) device programs, not
        # one per distinct size (VERDICT r2 item 7).  Per-image true
        # geometry rides along as a dynamic (mcus_x, mcus_y, H, W) row.
        groups: dict[tuple, list[int]] = {}
        for i, (hdr, _) in enumerate(host_out):
            if isinstance(hdr, Exception):
                results[base + i] = BatchItem(
                    index=base + i, header=None, rgb_batch=None,
                    batch_index=-1, error=hdr)
                continue
            if self.bucket == "pow2":
                mxb, myb = _bucket_pow2(hdr.mcus_x), _bucket_pow2(hdr.mcus_y)
            else:
                mxb, myb = hdr.mcus_x, hdr.mcus_y
            key = (mxb, myb,
                   tuple((c.h, c.v) for c in hdr.components),
                   hdr.colorspace, hdr.precision)
            groups.setdefault(key, []).append(i)

        def run_group(key_idxs):
            key, idxs = key_idxs
            mxb, myb, comp_hv, color, precision = key
            hdr0 = host_out[idxs[0]][0]
            h_max = max(h for h, _ in comp_hv)
            v_max = max(v for _, v in comp_hv)
            bpm = sum(h * v for h, v in comp_hv)
            height_b, width_b = myb * 8 * v_max, mxb * 8 * h_max
            comp_shapes = tuple((myb * v, mxb * h) for h, v in comp_hv)
            samplings = tuple((v_max // v, h_max // h) for h, v in comp_hv)
            n_blk = mxb * myb * bpm            # bucket block capacity
            packs = [host_out[i][1] for i in idxs]
            wire = self.wire
            b = len(packs)
            n_coef = n_blk * 64
            geom_b = np.stack([
                np.array([host_out[i][0].mcus_x, host_out[i][0].mcus_y,
                          host_out[i][0].height, host_out[i][0].width],
                         np.int32) for i in idxs])
            # True blocks are a prefix of the bucket block range, so every
            # wire stream's flat indices stay valid after row padding.
            dc_b = np.zeros((b, n_blk), np.int16)
            for k, p in enumerate(packs):
                dc_b[k, : len(p[0])] = p[0]
            if wire == "slots":
                # Slot arrays are (N, C) with per-image C: pad slots to
                # the group max capacity with (0, 0) empties; overflow
                # lists pad with out-of-range indices (dropped).
                cmax = max(p[1].shape[1] for p in packs)
                pos_b = np.zeros((b, n_blk, cmax), np.uint8)
                valp_b = np.zeros((b, n_blk, cmax), np.int8)
                omax = _bucket(max(len(p[3]) for p in packs), min_size=64)
                ovi_b = np.full((b, omax), n_coef, np.int32)
                ovv_b = np.zeros((b, omax), np.int16)
                for k, p in enumerate(packs):
                    pos_b[k, :p[1].shape[0], :p[1].shape[1]] = p[1]
                    valp_b[k, :p[2].shape[0], :p[2].shape[1]] = p[2]
                    ovi_b[k, :len(p[3])] = p[3]
                    ovv_b[k, :len(p[4])] = p[4]
                ac_parts, ei_at, ev_at = (pos_b, valp_b, ovi_b, ovv_b), 5, 6
            elif wire == "nibble":
                # Entry and overflow streams are ragged with independent
                # lengths: pad each to its own bucketed group max
                # (0x00 entries / 0 values are no-ops).
                kmax = _bucket(max(len(p[1]) for p in packs))
                omax = _bucket(max(len(p[2]) for p in packs), min_size=64)
                e_b = np.zeros((b, kmax), np.uint8)
                o_b = np.zeros((b, omax), np.int8)
                for k, p in enumerate(packs):
                    e_b[k, :len(p[1])] = p[1]
                    o_b[k, :len(p[2])] = p[2]
                ac_parts, ei_at, ev_at = (e_b, o_b), 3, 4
            elif wire == "sparse":
                # Sparse (gap, val) streams are ragged: pad to the group
                # max (bucketed) with (0, 0) no-op fillers.
                kmax = _bucket(max(len(p[1]) for p in packs))
                g_b = np.zeros((b, kmax), np.uint8)
                v_b = np.zeros((b, kmax), np.int8)
                for k, p in enumerate(packs):
                    g_b[k, :len(p[1])] = p[1]
                    v_b[k, :len(p[2])] = p[2]
                ac_parts, ei_at, ev_at = (g_b, v_b), 3, 4
            else:
                ac_b = np.zeros((b, n_blk, 64), np.int8)
                for k, p in enumerate(packs):
                    ac_b[k, : p[1].shape[0]] = p[1]
                ac_parts, ei_at, ev_at = (ac_b,), 2, 3
            # Escape lists are ragged: pad each to the group max (bucketed)
            # with out-of-range indices, dropped by the device-side scatter.
            emax = _bucket(max(len(p[ei_at]) for p in packs), min_size=64)
            ei_b = np.full((b, emax), n_coef, np.int32)
            ev_b = np.zeros((b, emax), np.int16)
            for k, p in enumerate(packs):
                ei_b[k, :len(p[ei_at])] = p[ei_at]
                ev_b[k, :len(p[ev_at])] = p[ev_at]
            qtables_b = np.stack([
                np.stack([host_out[i][0].quant_tables[c.tq].values
                          for c in host_out[i][0].components])
                for i in idxs])
            # Pad the batch to the next power of two so each geometry
            # compiles O(log B) programs, not one per batch size.
            b0 = len(idxs)
            bp = 1 << (b0 - 1).bit_length()
            if bp != b0:
                def padb(x, fill=0):
                    w = [(0, bp - b0)] + [(0, 0)] * (x.ndim - 1)
                    return np.pad(x, w, constant_values=fill)
                dc_b, ev_b = padb(dc_b), padb(ev_b)
                ac_parts = tuple(padb(x) for x in ac_parts)
                ei_b = padb(ei_b, fill=n_coef)
                qtables_b = np.pad(
                    qtables_b, [(0, bp - b0), (0, 0), (0, 0)], mode="edge")
                geom_b = np.pad(geom_b, [(0, bp - b0), (0, 0)], mode="edge")
            arrs = [jnp.asarray(x) for x in (dc_b, *ac_parts, ei_b, ev_b,
                                             qtables_b, geom_b)]
            if self.device is not None:
                arrs = [jax.device_put(x, self.device) for x in arrs]
            fn = {"slots": _batched_from_slots,
                  "nibble": _batched_from_nibble,
                  "sparse": _batched_from_sparse,
                  "packed": _batched_from_packed}[wire]
            rgb_b = fn(
                *arrs,
                comp_shapes=comp_shapes, comp_hv=comp_hv,
                height=height_b, width=width_b,
                samplings=samplings, idct=self.idct, upsample=self.upsample,
                color=color, precision=precision)
            for k, i in enumerate(idxs):
                results[base + i] = BatchItem(
                    index=base + i, header=host_out[i][0],
                    rgb_batch=rgb_b, batch_index=k)
            if debug:
                print(f"[batch] group {key}: B={len(idxs)} "
                      f"{time.perf_counter()-t0:.3f}s", flush=True)

        # Groups run on a small thread pool: H2D transfers for one group
        # overlap the previous group's dispatch (jax dispatch is
        # thread-safe; per-group results land in disjoint slots).
        if len(groups) > 1:
            list(self._device_pool.map(run_group, groups.items()))
        else:
            for kv in groups.items():
                run_group(kv)


def decode_batch(blobs: list[bytes], **kw) -> list[BatchItem]:
    return BatchDecoder(**kw).decode(blobs)

"""Device-side chunk-parallel entropy decode for DRI=0 streams.

Two strategies share this module:

* **Hybrid** (`decode_scan_hybrid` / `prepare_hybrid_batch`): a native
  host *skeleton scan* (jd_skeleton_scan — full Huffman symbol-length
  decode, no coefficient stores, 250-430 MP/s/thread) records the TRUE
  start bit of every stride-th MCU; device lanes then decode exactly
  `stride` MCUs each from true starts.  Perfect lane balance, no
  redundant decode, no splice — the DRI=0 device path runs at the
  restart-segment rate.  Needs the native lib and host cycles.
* **Speculative** (`decode_scan_speculative` / `prepare_spec_batch`,
  below): zero host cycles beyond parse+unstuff — lanes start at
  arbitrary byte boundaries and self-synchronize.  Pays an
  overflow-window redundancy (~1.2-1.3x) and equal-byte chunk skew
  (1.4-4x measured) the hybrid path does not.

Speculative design notes: device lane lift of the host C++ scheme
(jd_decode_scan_speculative,
entropy/native_src/jpeg_entropy.cpp:260-500; SURVEY §7 hard-part 1's
stretch goal): a JPEG stream without restart markers has a single
entropy-coded segment the RSTn path cannot shard, but Huffman streams
self-synchronize — a decoder started at an arbitrary byte boundary
(assuming MCU phase) converges to the true symbol stream within a few
MCUs with overwhelming probability.

Pipeline:

  phase 1 (device, one lockstep launch): the stream is split into
    byte-aligned chunks; each lane decodes speculatively from its chunk
    start with DC as raw diffs, recording every speculative MCU's start
    bit and coefficients, continuing ``ovf_bytes`` past its chunk end
    (the overflow region where synchronization with the next lane's
    trace happens).  A lane whose junk speculation hits an invalid code
    does not park: it byte-aligns and RETRIES at the next MCU slot
    (error-restart), leaving an invalid tombstone record — without this,
    one early-erroring misaligned lane leaves nothing to synchronize
    against and whole images fall back to the host (measured on most of
    the corpus).  Restart safety: a decode from a true position never
    errors on a valid stream, so tombstones exist only in the pre-sync
    garbage prefix and the splice never consumes them.
  phase 2 (device): splice — a lax.scan over lanes with carry (true bit
    position, MCUs emitted); lane 0's records are exact, and each lane's
    true entry bit must be one of its VALID recorded starts (self-sync).
    Phases 1+2+3 fuse into ONE program (single dispatch + one scalar
    fetch).  If any sync fails (ok=False: extreme MCU-size skew beyond
    the record caps, corrupt streams), the host splice with sequential
    gap fill takes over, so correctness never depends on speculation.
  phase 3 (device): gather the true records into scan order and
    prefix-sum the DC diffs per component (jpeg.cpp:344-345 semantics)
    — the cross-chunk DC fix-up as one associative scan.

tests/test_entropy_spec.py pins that the device splice SUCCEEDS (no
host fallback) on every corpus image at several chunk sizes, plus exact
output everywhere; prepare_spec_batch/_spec_pipeline_batch decode a
whole batch of same-geometry images as one program
(parallel/sharded.decode_batch_sharded).

Output is bit-identical to entropy.python_ref (tests/test_entropy_spec.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..huffman import build_lut
from ..layout import scan_layout
from ..types import FrameHeader, JPEGError, ScanHeader
from . import entropy_flat


def _host_decode_mcus(data: bytes, bit: int, n: int, dc_luts, ac_luts,
                      block_comp, precision: int = 8
                      ) -> tuple[np.ndarray, int]:
    """Sequential host decode of ``n`` MCUs from absolute ``bit`` with DC
    as raw diffs (splice gap fill).  Returns ((n, bpm, 64) int32, end bit)."""
    from ..entropy import python_ref

    reader = python_ref.BitReader(data)
    reader.pos = bit
    bpm = len(block_comp)
    max_dc, max_ac = (15, 14) if precision > 8 else (11, 10)
    out = np.zeros((n, bpm, 64), np.int32)
    for m in range(n):
        for k, ci in enumerate(block_comp):
            python_ref.decode_block(reader, dc_luts[ci], ac_luts[ci],
                                    out[m, k], 0, max_dc, max_ac)
    return out, reader.pos


def _dc_prefix_sum(blocks, block_comp, n_comps):
    """DC diff prefix-sum per component over scan order (jpeg.cpp:344-345
    semantics as one associative scan per component)."""
    n_mcus = blocks.shape[0]
    dc = blocks[:, :, 0]
    for ci in range(n_comps):
        cols = tuple(k for k, c in enumerate(block_comp) if c == ci)
        if not cols:
            continue
        sub = dc[:, cols].reshape(-1)           # scan order for this comp
        sub = jnp.cumsum(sub).reshape(n_mcus, len(cols))
        dc = dc.at[:, cols].set(sub)
    return blocks.at[:, :, 0].set(dc)


def _dc_prefix_sum_seg(blocks, seg_first_mcu, block_comp, n_comps):
    """Segmented DC prefix sum: predictors reset at every restart segment
    (jpeg.cpp:419-425).  ``seg_first_mcu[m]`` is the first MCU index of
    the segment containing MCU m (all zeros for DRI=0 -> plain cumsum).
    One global cumsum per component minus the value just before each
    segment's first row — an associative scan plus one gather."""
    n_mcus = blocks.shape[0]
    dc = blocks[:, :, 0]
    for ci in range(n_comps):
        cols = tuple(k for k, c in enumerate(block_comp) if c == ci)
        if not cols:
            continue
        nc = len(cols)
        sub = dc[:, cols].reshape(-1)
        cs = jnp.cumsum(sub)
        pad = jnp.concatenate([jnp.zeros((1,), cs.dtype), cs])
        first_row = jnp.repeat(seg_first_mcu * nc, nc)
        fixed = cs - jnp.take(pad, first_row)
        dc = dc.at[:, cols].set(fixed.reshape(n_mcus, nc))
    return blocks.at[:, :, 0].set(dc)


@functools.partial(jax.jit, static_argnames=("block_comp", "n_comps"))
def _assemble(records, src, dc_luts_unused, *, block_comp, n_comps):
    """Gather true MCU records into scan order + DC diff prefix-sum."""
    del dc_luts_unused
    bpm = len(block_comp)
    blocks = jnp.take(records, src, axis=0)     # (n_mcus, bpm*64)
    n_mcus = blocks.shape[0]
    blocks = _dc_prefix_sum(blocks.reshape(n_mcus, bpm, 64),
                            block_comp, n_comps)
    return blocks.reshape(n_mcus * bpm, 64)


@functools.partial(jax.jit, static_argnames=("n_mcus", "cap"))
def _device_splice(starts, n_rec, end_pos, base_bits, valid, *,
                   n_mcus: int, cap: int):
    """The splice as a lax.scan over lanes, entirely on device.

    In the no-gap case consumption is strictly lane-sequential (a lane's
    overflow never reaches past the next chunk's end), so a scan with
    carry (true bit position, MCUs emitted) reproduces the host splice.
    Returns (src (n_mcus,) record ids, ok scalar) — ok False means a
    sync gap and the caller falls back to the host splice."""
    C = starts.shape[0]
    iota_cap = jax.lax.broadcasted_iota(jnp.int32, (cap,), 0)

    def step(carry, xs):
        bit, m = carry
        st_row, cnt, ep, va = xs
        row = jnp.where(iota_cap < cnt, st_row, jnp.int32(2**30))
        j = jnp.searchsorted(row, bit).astype(jnp.int32)
        jc = jnp.minimum(j, cap - 1)
        # A match must land on a VALID record: aborted-speculation slots
        # (error-restart tombstones) carry a start bit but no decode.
        found = (j < cnt) & (row[jc] == bit) & va[jc]
        take = jnp.where(found,
                         jnp.minimum(cnt - j, n_mcus - m), 0)
        bit2 = jnp.where(found & (m + take < n_mcus), ep, bit)
        return (bit2, m + take), (j, take, m)

    (bit_end, m_end), (js, takes, m_starts) = jax.lax.scan(
        step, (base_bits[0], jnp.int32(0)),
        (starts, n_rec.astype(jnp.int32), end_pos, valid))
    ok = m_end >= n_mcus

    # Expand (j, take, m_start) per lane into src[m] = lane*cap + j + (m -
    # m_start): scatter each contributing lane's id at its m_start, forward
    # fill with cummax, then gather the lane's (j, m_start).
    lanes = jnp.arange(C, dtype=jnp.int32)
    tgt = jnp.where(takes > 0, m_starts, n_mcus)
    seg = jnp.zeros((n_mcus,), jnp.int32).at[tgt].max(
        lanes + 1, mode="drop")
    seg = jax.lax.cummax(seg) - 1                       # lane of each MCU
    seg = jnp.maximum(seg, 0)
    m = jnp.arange(n_mcus, dtype=jnp.int32)
    src = seg * cap + jnp.take(js, seg) + (m - jnp.take(m_starts, seg))
    return src, ok


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "max_blocks", "max_mcus",
                     "n_mcus", "precision"))
def _spec_pipeline(pool, base_bits, nblocks, limits, luts2d, *,
                   block_comp, n_comps, max_blocks, max_mcus, n_mcus,
                   precision=8):
    """Phase 1 + device splice + assembly as ONE program: a single device
    dispatch and a single scalar fetch per image on the happy path."""
    bpm = len(block_comp)
    cap = max_mcus
    (out, err, n_done, starts, n_rec, end_pos,
     valid) = entropy_flat.decode_lockstep(
        pool, base_bits, nblocks, limits, luts2d,
        block_comp=block_comp, n_comps=n_comps, max_blocks=max_blocks,
        dc_diff=True, record_mcus=1, max_mcus=cap, precision=precision)
    src, ok = _device_splice(starts, n_rec, end_pos, base_bits, valid,
                             n_mcus=n_mcus, cap=cap)
    records = out.reshape(-1, bpm * 64)
    blocks = jnp.take(records, src, axis=0).reshape(n_mcus, bpm, 64)
    blocks = _dc_prefix_sum(blocks, block_comp, n_comps)
    return (blocks.reshape(n_mcus * bpm, 64), ok,
            out, starts, n_rec, end_pos, valid)


def decode_scan_speculative(hdr: FrameHeader, scan: ScanHeader, *,
                            chunk_bytes: int = 2048,
                            ovf_bytes: int | None = None,
                            max_chunks: int = 256,
                            as_device: bool = False):
    """Chunk-parallel device decode of a single-segment interleaved scan.

    Same contract as every entropy backend: (total_blocks, 64) int32
    scan-order natural-order coefficients.  With ``as_device=True`` the
    blocks stay a device array (the only host round trip is the small
    per-chunk MCU-start trace the splice needs), so the pixel stage
    consumes them in place."""
    if len(scan.seg_offsets) != 2:
        raise JPEGError("speculative decode expects a single segment "
                        "(DRI=0); use the segment path otherwise")
    lay = scan_layout(hdr)
    n_mcus = lay.n_mcus
    bpm = lay.blocks_per_mcu
    block_comp = tuple(
        ci for ci, c in enumerate(hdr.components) for _ in range(c.v * c.h))
    data = np.asarray(scan.data, np.uint8)
    nbytes = int(len(data))
    if ovf_bytes is None:
        ovf_bytes = _adaptive_ovf(nbytes, n_mcus)

    n_chunks = max(1, min(max_chunks, nbytes // chunk_bytes))
    cb = -(-nbytes // n_chunks)
    starts_b = np.arange(n_chunks, dtype=np.int64) * cb
    ends_b = np.minimum(starts_b + cb, nbytes)

    # Shared word pool (one stream, all lanes index into it).
    pad = np.zeros(((nbytes + 3) // 4 + 2) * 4, np.uint8)
    pad[:nbytes] = data
    pool = pad.view(">u4").astype(np.uint32)

    # Record capacity per lane: 8x the average + overflow share + slack.
    # Flat image regions pack MCUs at a fraction of the average size
    # (img.jpg's sky runs ~6 bytes/MCU vs a 35-byte average) and a lane
    # whose records fill before its bit limit breaks the splice chain
    # mid-chunk.  A generous cap costs memory (~10-15x the coefficient
    # plane), NOT iterations — every lane stops at its bit limit.
    exp_mcus = -(-n_mcus // n_chunks)
    cap = int(8 * exp_mcus + (exp_mcus * ovf_bytes) // max(1, cb) + 96)
    base_bits = (starts_b * 8).astype(np.int32)
    limits = (np.minimum(ends_b + ovf_bytes, nbytes) * 8).astype(np.int32)
    # The last lane stops at the stream end (at most one phantom MCU from
    # the padding bits; the splice never reaches phantom records).
    limits[-1] = nbytes * 8
    luts = entropy_flat.merged_luts(hdr, scan)

    blocks, ok, out, starts, n_rec, end_pos, valid = _spec_pipeline(
        jnp.asarray(pool), jnp.asarray(base_bits),
        jnp.full((n_chunks,), cap * bpm, jnp.int32),
        jnp.asarray(limits),
        jnp.asarray(luts.reshape(2 * len(hdr.components), 65536)),
        block_comp=block_comp, n_comps=len(hdr.components),
        max_blocks=cap * bpm, max_mcus=cap, n_mcus=n_mcus,
        precision=hdr.precision)
    if bool(ok):
        # Happy path (real streams): one dispatch, one scalar fetch.
        return blocks if as_device else np.asarray(blocks)

    starts_np = np.asarray(starts)
    n_rec_np = np.asarray(n_rec).astype(np.int64)
    end_np = np.asarray(end_pos).astype(np.int64)
    valid_np = np.asarray(valid)
    # A lane that errored mid-MCU still has valid completed records; a lane
    # that errored BEFORE its first record contributes nothing.

    # ---- phase 2 fallback: host splice with sequential gap fill ----
    dc_luts = {}
    ac_luts = {}
    data_bytes = None
    chunk_start_bits = base_bits.astype(np.int64)
    src = np.empty(n_mcus, np.int64)
    patches = []
    bit = 0
    m = 0
    while m < n_mcus:
        lane = int(np.searchsorted(chunk_start_bits, bit, side="right") - 1)
        found = -1
        for ln in (lane, lane - 1):
            if 0 <= ln < n_chunks and n_rec_np[ln] > 0:
                j = int(np.searchsorted(starts_np[ln, : n_rec_np[ln]], bit))
                if (j < n_rec_np[ln] and starts_np[ln, j] == bit
                        and valid_np[ln, j]):
                    found = ln
                    break
        if found >= 0:
            take = int(min(n_rec_np[found] - j, n_mcus - m))
            src[m: m + take] = found * cap + np.arange(j, j + take)
            m += take
            bit = int(end_np[found])
        else:
            # Gap: decode one MCU sequentially on host (diff-mode DC).
            if data_bytes is None:
                data_bytes = data.tobytes()
                for ci, c in enumerate(hdr.components):
                    dc_luts[ci] = build_lut(scan.dc_specs[c.td]).tolist()
                    ac_luts[ci] = build_lut(scan.ac_specs[c.ta]).tolist()
            mcu, bit = _host_decode_mcus(
                data_bytes, bit, 1, dc_luts, ac_luts, block_comp,
                hdr.precision)
            src[m] = n_chunks * cap + len(patches)
            patches.append(mcu.reshape(bpm * 64))
            m += 1

    # ---- phase 3: device assembly ----
    records = out.reshape(n_chunks * cap, bpm * 64)
    if patches:
        records = jnp.concatenate(
            [records, jnp.asarray(np.stack(patches), jnp.int32)], axis=0)
    blocks = _assemble(records, jnp.asarray(src.astype(np.int32)), None,
                       block_comp=block_comp, n_comps=len(hdr.components))
    return blocks if as_device else np.asarray(blocks)


# ---------------------------------------------------------------------------
# Batched speculative decode: many same-geometry DRI=0 images, one program
# ---------------------------------------------------------------------------

def _adaptive_ovf(n_bytes: int, n_mcus: int) -> int:
    """Overflow-window bytes: the splice needs each lane to decode past
    the NEXT lane's self-sync point, and the sync distance scales with the
    stream's average MCU byte size (junk speculation near a chunk start
    burns ~10 garbage 'MCUs' before locking on).  Thresholds measured on
    real photos with tools/spec_param_sweep*.py: ~7-8x the average breaks
    the splice, ~10-11x holds; 13x is the margin.  Every lane redundantly
    decodes its overflow window, so oversizing it taxes the whole kernel
    (a fixed 1536 B cost ~1.3x on small-MCU streams)."""
    avg = n_bytes / max(1, n_mcus)
    return int(min(1536, max(512, 13 * avg)))


def prepare_spec_batch(hdr: FrameHeader, scans: list, *,
                       chunk_bytes: int = 2048, ovf_bytes: int | None = None,
                       max_chunks: int = 128):
    """Host prep for a batch of same-geometry single-segment scans.

    Every image gets the same lane count C (its stream split into up to C
    chunks; short streams leave trailing lanes inactive) so the batch is a
    dense (B, C) lane grid.  Returns numpy arrays ready for
    :func:`_spec_pipeline_batch`:
      pools (B, W) uint32, base_rel (B, C) int32 bit offsets within the
      image's pool row, limits_rel (B, C) int32, active (B, C) bool,
      cap, C.
    """
    B = len(scans)
    nbytes = [int(len(s.data)) for s in scans]
    lay = scan_layout(hdr)
    if ovf_bytes is None:
        ovf_bytes = _adaptive_ovf(max(nbytes), lay.n_mcus)
    # Lanes-per-image scale INVERSELY with batch: the kernel saturates
    # around ~1-2k total lanes (tools/spec_param_sweep2.py), and beyond
    # that extra chunks only add per-lane overflow redundancy.
    max_chunks = max(16, min(max_chunks, 2048 // max(1, B)))
    C = max(1, min(max_chunks, max(nbytes) // chunk_bytes))
    exp_mcus = -(-lay.n_mcus // C)
    # Record capacity per lane: 8x the average + overflow share + slack.
    # Flat image regions pack MCUs at a fraction of the average size
    # (img.jpg's sky runs ~6 bytes/MCU vs a 35-byte average) and a lane
    # whose records fill before its bit limit breaks the splice chain
    # mid-chunk.  A generous cap costs memory (~10-15x the coefficient
    # plane), NOT iterations — every lane stops at its bit limit.
    cap = int(8 * exp_mcus + (exp_mcus * ovf_bytes) // max(1, chunk_bytes)
              + 96)
    W = (max(nbytes) + 3) // 4 + 2
    pools = np.zeros((B, W), np.uint32)
    base_rel = np.zeros((B, C), np.int32)
    limits_rel = np.zeros((B, C), np.int32)
    active = np.zeros((B, C), bool)
    for b, s in enumerate(scans):
        n = nbytes[b]
        data = np.asarray(s.data, np.uint8)
        pad = np.zeros(W * 4, np.uint8)
        pad[:n] = data
        pools[b] = pad.view(">u4")
        cb = max(1, -(-n // C))
        starts = np.minimum(np.arange(C, dtype=np.int64) * cb, n)
        ends = np.minimum(starts + cb, n)
        act = starts < ends
        base_rel[b] = (starts * 8).astype(np.int32)
        lim = (np.minimum(ends + ovf_bytes, n) * 8).astype(np.int32)
        # The image's last active lane decodes to its stream end.
        if act.any():
            lim[np.flatnonzero(act)[-1]] = n * 8
        limits_rel[b] = lim
        active[b] = act
    return pools, base_rel, limits_rel, active, cap, C


# ---------------------------------------------------------------------------
# Hybrid decode: host skeleton scan -> device lanes from TRUE MCU starts
# ---------------------------------------------------------------------------
#
# The speculative path pays two taxes the lockstep kernel itself does not
# have: every lane redundantly decodes an overflow window (~1.2-1.3x), and
# equal-BYTE chunks give unequal MCU counts, so the lockstep trip count is
# set by the flattest lane (measured 1.4-4x the average on the corpus).
# The hybrid path removes both: a native host *skeleton scan*
# (jd_skeleton_scan — full Huffman symbol-length decode, no coefficient
# stores, 250-430 MP/s/thread vs 150-260 for the full host decode) records
# the TRUE start bit of every stride-th MCU, and each device lane decodes
# exactly `stride` MCUs from a true start (DC as raw diffs + one prefix
# sum, as in the speculative path).  No overflow, no skew, no splice, no
# record mode — the DRI=0 device path runs at the restart-segment rate.


def prepare_hybrid_batch(hdr: FrameHeader, scans: list, *,
                         max_lanes_total: int = 2048,
                         max_chunks: int = 256, threads: int | None = None):
    """Host prep for the hybrid device decode of same-geometry DRI=0 scans.

    Runs the native skeleton scan per image (threaded across images) and
    returns (pools (B, W) uint32, starts_rel (B, C) int32 TRUE start bits,
    nm_lane (B, C) int32 MCUs per lane, stride, C, skel_ok (B,) bool).
    Images whose skeleton scan fails (corrupt streams) get all-inactive
    lanes (nm=0) and skel_ok False — callers patch them via the
    speculative/host fallback chain.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ..entropy import native

    B = len(scans)
    lay = scan_layout(hdr)
    n_mcus = lay.n_mcus
    # Lane count: saturate the kernel (~1-2k total lanes, see
    # tools/spec_param_sweep2.py) without exceeding it per batch.
    C = max(1, min(max_chunks, max_lanes_total // max(1, B), n_mcus))
    stride = -(-n_mcus // C)
    C = -(-n_mcus // stride)

    nbytes = [int(len(s.data)) for s in scans]
    W = (max(nbytes) + 3) // 4 + 2
    pools = np.zeros((B, W), np.uint32)
    starts_rel = np.zeros((B, C), np.int32)
    nm_lane = np.zeros((B, C), np.int32)
    skel_ok = np.zeros(B, bool)

    def prep_one(b):
        s = scans[b]
        n = nbytes[b]
        data = np.asarray(s.data, np.uint8)
        pad = np.zeros(W * 4, np.uint8)
        pad[:n] = data
        pools[b] = pad.view(">u4")
        try:
            bits = native.skeleton_scan(hdr, s, stride)
        except JPEGError:
            return  # skel_ok stays False; lanes stay inactive
        starts_rel[b, : len(bits)] = bits.astype(np.int32)
        nm_lane[b, : len(bits)] = stride
        nm_lane[b, len(bits) - 1] = n_mcus - stride * (len(bits) - 1)
        skel_ok[b] = True

    if B > 1 and (threads is None or threads > 1):
        with ThreadPoolExecutor(threads or min(4, B)) as ex:
            list(ex.map(prep_one, range(B)))
    else:
        for b in range(B):
            prep_one(b)
    return pools, starts_rel, nm_lane, stride, C, skel_ok


def prepare_hybrid_batch_balanced(hdr: FrameHeader, scans: list, *,
                                  max_lanes_total: int = 2048,
                                  max_chunks: int = 256,
                                  threads: int | None = None,
                                  cap_factor: int = 4):
    """Byte-balanced hybrid prep: lanes get ~equal BYTES, not equal MCUs.

    The lockstep kernel's trip count is Σ_slot max_lanes(symbols-in-slot)
    — ~3.5x the balanced ideal on the corpus because a slot pays the
    p99 block density over the lanes; a flat symbol loop's trip count is
    max_lane(total symbols), which equal-BYTE lanes bring within ~1.1-1.4x
    of ideal (bytes ∝ symbols).  The skeleton scan records every MCU
    start, boundaries snap to MCU starts nearest the equal-byte targets
    (lane size capped at ``cap_factor``x the mean to bound the padded
    output buffer), and a host-built gather map restores scan order.

    Returns (pools (B, W) uint32, starts_rel (B, C) int32, nm_lane (B, C)
    int32, max_nm, C, src_idx (B, n_mcus*bpm) int32, skel_ok (B,) bool).
    """
    from concurrent.futures import ThreadPoolExecutor

    from ..entropy import native

    B = len(scans)
    lay = scan_layout(hdr)
    n_mcus = lay.n_mcus
    bpm = lay.blocks_per_mcu
    C = max(1, min(max_chunks, max_lanes_total // max(1, B), n_mcus))
    cap_nm = -(-n_mcus * cap_factor // C)

    nbytes = [int(len(s.data)) for s in scans]
    W = (max(nbytes) + 3) // 4 + 2
    pools = np.zeros((B, W), np.uint32)
    all_bits: list = [None] * B
    skel_ok = np.zeros(B, bool)

    def scan_one(b):
        s = scans[b]
        n = nbytes[b]
        pad = np.zeros(W * 4, np.uint8)
        pad[:n] = np.asarray(s.data, np.uint8)
        pools[b] = pad.view(">u4")
        try:
            all_bits[b] = native.skeleton_scan(hdr, s, 1)
        except JPEGError:
            return
        skel_ok[b] = True

    if B > 1 and (threads is None or threads > 1):
        with ThreadPoolExecutor(threads or min(4, B)) as ex:
            list(ex.map(scan_one, range(B)))
    else:
        for b in range(B):
            scan_one(b)

    starts_rel = np.zeros((B, C), np.int32)
    nm_lane = np.zeros((B, C), np.int32)
    src_idx = np.zeros((B, n_mcus * bpm), np.int32)
    max_nm = 1
    bounds_b = []
    for b in range(B):
        if not skel_ok[b]:
            bounds_b.append(None)
            continue
        bits = all_bits[b]
        targets = np.linspace(0, nbytes[b] * 8, C + 1)[1:-1]
        want = np.searchsorted(bits, targets)
        bounds = np.empty(C + 1, np.int64)
        bounds[0] = 0
        lo = 0
        for i in range(C):
            hi = int(want[i]) if i < C - 1 else n_mcus
            hi = min(max(hi, lo), lo + cap_nm, n_mcus)
            hi = max(hi, n_mcus - (C - 1 - i) * cap_nm)
            bounds[i + 1] = hi
            lo = hi
        m_lo, m_hi = bounds[:-1], bounds[1:]
        nm = (m_hi - m_lo).astype(np.int32)
        starts_rel[b] = bits[np.minimum(m_lo, n_mcus - 1)].astype(np.int32)
        nm_lane[b] = nm
        max_nm = max(max_nm, int(nm.max()))
        bounds_b.append((m_lo, nm))
    for b in range(B):
        if bounds_b[b] is None:
            continue
        m_lo, nm = bounds_b[b]
        lane_of = np.repeat(np.arange(C, dtype=np.int64), nm)
        local = np.arange(n_mcus, dtype=np.int64) - np.repeat(m_lo, nm)
        row = (lane_of * max_nm + local) * bpm
        src_idx[b] = (row[:, None]
                      + np.arange(bpm, dtype=np.int64)[None, :]
                      ).reshape(-1).astype(np.int32)
    return pools, starts_rel, nm_lane, max_nm, C, src_idx, skel_ok


def _bucket_T(t: int) -> int:
    """Round a trip count up to quarter-pow2 granularity so distinct
    corpora compile O(log) emission programs, not one per exact count."""
    t = max(64, int(t))
    step = max(64, 1 << (t.bit_length() - 3))
    return -(-t // step) * step


def use_pair_kernel() -> bool:
    """Paired emission kernel (decode_emit2) selection: on by default;
    JD_EMIT_PAIR=0 reverts (tools/emit_pair_ab.py compares the two)."""
    import os

    return os.environ.get("JD_EMIT_PAIR", "1") != "0"


def prepare_hybrid_batch_emit(hdr: FrameHeader, scans: list, *,
                              max_chunks: int = 512,
                              threads: int | None = None,
                              cap_factor: int = 4,
                              target_steps: int = 1300):
    """Symbol-balanced hybrid prep for the emission kernel.

    The skeleton scan counts Huffman symbols per MCU, so lane boundaries
    split the stream into ~equal SYMBOL counts — the emission kernel's
    trip count is then the max lane total, within a few percent of the
    balanced ideal (lane MCU count still capped at ``cap_factor``x the
    mean).  Lanes cover contiguous MCU ranges, so the post-scatter
    output is ALREADY scan-order dense — no gather map, no padding.

    The lane count adapts to the stream: per-step cost is ~linear in
    total lanes (LUT/stream gathers are latency-bound) with a small
    fixed floor, so throughput peaks near a constant TRIP count.  C is
    chosen so each image's symbol total / C ~ ``target_steps``; the
    default 1300 has not been tuned for the GPU yet
    (tools/emit_lane_sweep.py sweeps it).

    Restart streams work identically — the per-segment skeleton scans
    are independent (DC resets + byte alignment, jpeg.cpp:419-425),
    segment starts are forced lane boundaries (a lane must not decode
    across the byte-alignment gap), and the returned ``seg_first_mcu``
    drives the segmented DC prefix sum.  The device parallelism is then
    MCU-granular, not segment-granular: an image with 50 restart
    segments still fills hundreds of balanced lanes.

    Lane boundaries balance the PAIRED step counts (the skeleton scan
    simulates the two-symbol-per-step emission kernel exactly), which is
    what both kernels' trip counts track to within a few percent.

    Returns (pools (B, W) uint32, starts_rel (B, C) int32 bit offsets,
    nm_lane (B, C) int32 MCUs per lane, lane_off (B, C) int32 — the
    lane's first coefficient slot ``first_mcu * bpm * 64``, T (bucketed
    max lane SYMBOL count — decode_emit's trip count), T2 (bucketed max
    lane PAIRED step count — decode_emit2's trip count), C,
    seg_first_mcu (n_mcus,) int32, skel_ok (B,) bool).
    """
    from concurrent.futures import ThreadPoolExecutor

    from ..entropy import native

    B = len(scans)
    lay = scan_layout(hdr)
    n_mcus = lay.n_mcus
    bpm = lay.blocks_per_mcu
    ri = scans[0].restart_interval
    per_seg = ri if ri else n_mcus
    seg_lo = np.arange(0, n_mcus, per_seg, dtype=np.int64)
    seg_first_mcu = np.repeat(seg_lo, np.minimum(
        per_seg, n_mcus - seg_lo)).astype(np.int32)

    nbytes = [int(len(s.data)) for s in scans]
    W = (max(nbytes) + 3) // 4 + 2
    pools = np.zeros((B, W), np.uint32)
    lanes: list = [None] * B
    skel_ok = np.zeros(B, bool)

    # Per-image one-call C++ prep (jd_emit_prep, ABI 22): per-segment
    # skeleton walks, pair-balanced lane boundaries and exact per-lane
    # trip maxima all happen native-side — the prior shape paid one
    # ctypes call per SEGMENT plus Python bounds loops (VERDICT r4
    # item 4).
    def scan_one(b):
        s = scans[b]
        n = nbytes[b]
        pad = np.zeros(W * 4, np.uint8)
        pad[:n] = np.asarray(s.data, np.uint8)
        pools[b] = pad.view(">u4")
        try:
            lanes[b] = native.emit_prep(
                hdr, s, max_chunks=max_chunks, cap_factor=cap_factor,
                target_steps=target_steps,
                n_threads=1 if threads == 1 else None)
        except JPEGError:
            return
        skel_ok[b] = True

    if B > 1 and (threads is None or threads > 1):
        with ThreadPoolExecutor(threads or min(4, B)) as ex:
            list(ex.map(scan_one, range(B)))
    else:
        for b in range(B):
            scan_one(b)

    C = max((len(ln[0]) for ln in lanes if ln is not None), default=1)
    starts_rel = np.zeros((B, C), np.int32)
    nm_lane = np.zeros((B, C), np.int32)
    lane_off = np.zeros((B, C), np.int32)
    T = 64
    T2 = 64
    for b in range(B):
        if lanes[b] is None:
            continue
        m_lo, nm, starts, t_sym, t_pair = lanes[b]
        k = len(m_lo)
        nm_lane[b, :k] = nm
        starts_rel[b, :k] = starts
        lane_off[b, :k] = (m_lo * bpm * 64).astype(np.int32)
        T = max(T, t_sym)
        T2 = max(T2, t_pair)
    return (pools, starts_rel, nm_lane, lane_off, _bucket_T(T),
            _bucket_T(T2), C, seg_first_mcu, skel_ok)


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "T", "n_mcus", "C",
                     "precision", "pair"))
def _hybrid_pipeline_batch_emit(pools, starts_rel, nm_lane, lane_off,
                                seg_first_mcu, luts_flat, *, block_comp,
                                n_comps, T, n_mcus, C, precision=8,
                                pair=False):
    """Device half of the symbol-balanced hybrid decode: emission kernel
    + one post-loop scatter-add straight into scan order + segmented DC
    prefix sum.  Returns (blocks (B, n_mcus*bpm, 64), err (B,))."""
    from ..types import ZIGZAG_INV

    B = pools.shape[0]
    W = pools.shape[1]
    bpm = len(block_comp)
    img_base = (jnp.arange(B, dtype=jnp.int32) * (W * 32))[:, None]
    base_abs = (img_base + starts_rel).reshape(-1)
    nblocks = (nm_lane * bpm).reshape(-1)
    kern = entropy_flat.decode_emit2 if pair else entropy_flat.decode_emit
    pos, val, err, n_done = kern(
        pools.reshape(-1), base_abs, nblocks, luts_flat,
        block_comp=block_comp, n_comps=n_comps, T=T, precision=precision)
    S_all = base_abs.shape[0]
    pos = pos.reshape(-1, S_all)
    val = val.reshape(-1, S_all)
    bad = (err | (n_done < nblocks)).reshape(B, C).any(axis=1)

    # Lane-local positions -> dense per-image scan-order slots: lanes
    # cover contiguous MCU ranges, so slot = lane's first slot + local.
    img_out = (jnp.arange(B, dtype=jnp.int32)
               * (n_mcus * bpm * 64))[:, None]
    out_off = (img_out + lane_off).reshape(-1)
    n_total = B * n_mcus * bpm * 64
    flat_pos = jnp.where(pos >= 0, pos + out_off[None, :], n_total)
    out = jnp.zeros((n_total,), jnp.int32).at[flat_pos.reshape(-1)].add(
        val.reshape(-1), mode="drop")
    blocks = jnp.take(out.reshape(B, n_mcus * bpm, 64),
                      jnp.asarray(ZIGZAG_INV), axis=2)
    blocks = jax.vmap(
        functools.partial(_dc_prefix_sum_seg, block_comp=block_comp,
                          n_comps=n_comps),
        in_axes=(0, None))(
        blocks.reshape(B, n_mcus, bpm, 64), seg_first_mcu)
    return blocks.reshape(B, n_mcus * bpm, 64), bad


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "max_nm", "n_mcus", "C",
                     "precision"))
def _hybrid_pipeline_batch_flat(pools, starts_rel, nm_lane, src_idx,
                                luts_flat, *, block_comp, n_comps, max_nm,
                                n_mcus, C, precision=8):
    """Device half of the byte-balanced hybrid decode: flat symbol loop
    (scalar commit — one coefficient per lane per iteration) + gather
    reassembly + DC prefix sum.  Returns (blocks (B, n_mcus*bpm, 64),
    err (B,))."""
    B = pools.shape[0]
    W = pools.shape[1]
    bpm = len(block_comp)
    img_base = (jnp.arange(B, dtype=jnp.int32) * (W * 32))[:, None]
    base_abs = (img_base + starts_rel).reshape(-1)
    nblocks = (nm_lane * bpm).reshape(-1)
    out, err, n_done, *_ = entropy_flat.decode_flat(
        pools.reshape(-1), base_abs, nblocks,
        jnp.full((B * C,), 2**30, jnp.int32), luts_flat,
        block_comp=block_comp, n_comps=n_comps,
        max_blocks=max_nm * bpm, dc_diff=True, precision=precision,
        commit="scalar")
    bad = (err | (n_done < nblocks)).reshape(B, C).any(axis=1)
    rows = out.reshape(B, C * max_nm * bpm, 64)
    blocks = jax.vmap(lambda r, s: jnp.take(r, s, axis=0))(rows, src_idx)
    blocks = jax.vmap(
        functools.partial(_dc_prefix_sum, block_comp=block_comp,
                          n_comps=n_comps))(
        blocks.reshape(B, n_mcus, bpm, 64))
    return blocks.reshape(B, n_mcus * bpm, 64), bad


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "stride", "n_mcus", "C",
                     "precision"))
def _hybrid_pipeline_batch(pools, starts_rel, nm_lane, luts2d, *,
                           block_comp, n_comps, stride, n_mcus, C,
                           precision=8):
    """Device half of the hybrid decode for a (B, C) lane grid, one
    program: lockstep decode from TRUE starts + DC prefix sum.  Returns
    (blocks (B, n_mcus*bpm, 64), err (B,))."""
    B = pools.shape[0]
    W = pools.shape[1]
    bpm = len(block_comp)
    img_base = (jnp.arange(B, dtype=jnp.int32) * (W * 32))[:, None]
    base_abs = (img_base + starts_rel).reshape(-1)
    nblocks = (nm_lane * bpm).reshape(-1)
    out, err, n_done, *_ = entropy_flat.decode_lockstep(
        pools.reshape(-1), base_abs, nblocks,
        jnp.full((B * C,), 2**30, jnp.int32), luts2d,
        block_comp=block_comp, n_comps=n_comps,
        max_blocks=stride * bpm, dc_diff=True, precision=precision)
    bad = (err | (n_done < nblocks)).reshape(B, C).any(axis=1)
    # Lanes 0..C-2 decode exactly `stride` MCUs and lane C-1 the remainder,
    # so flattening lane slots restores scan order directly (no gather).
    blocks = out.reshape(B, C * stride * bpm, 64)[:, : n_mcus * bpm]
    blocks = jax.vmap(
        functools.partial(_dc_prefix_sum, block_comp=block_comp,
                          n_comps=n_comps))(
        blocks.reshape(B, n_mcus, bpm, 64))
    return blocks.reshape(B, n_mcus * bpm, 64), bad


def decode_scan_hybrid(hdr: FrameHeader, scan: ScanHeader, *,
                       as_device: bool = False,
                       max_lanes_total: int | None = None,
                       kernel: str = "emit"):
    """Single-image hybrid decode (host skeleton -> device true-start
    lanes).  Same contract as every entropy backend: (total_blocks, 64)
    int32 scan-order natural-order coefficients.

    ``kernel``: "emit" (default — symbol-balanced lanes, emission
    kernel; handles restart streams too, with segment starts as forced
    lane boundaries) or "lockstep" (equal-MCU lanes, DRI=0 only;
    ``max_lanes_total`` caps the lane count for that form)."""
    if len(scan.seg_offsets) != 2 and kernel != "emit":
        raise JPEGError("hybrid lockstep decode expects a single segment "
                        "(DRI=0); use the segment path otherwise")
    lay = scan_layout(hdr)
    block_comp = tuple(
        ci for ci, c in enumerate(hdr.components) for _ in range(c.v * c.h))
    luts = entropy_flat.merged_luts(hdr, scan)
    if kernel == "emit":
        (pools, starts_rel, nm_lane, lane_off, T, T2, C, seg_first,
         skel_ok) = prepare_hybrid_batch_emit(hdr, [scan], threads=1)
        if not skel_ok[0]:
            raise JPEGError("skeleton scan failed (corrupt stream)")
        pair = use_pair_kernel()
        blocks, bad = _hybrid_pipeline_batch_emit(
            jnp.asarray(pools), jnp.asarray(starts_rel),
            jnp.asarray(nm_lane), jnp.asarray(lane_off),
            jnp.asarray(seg_first), jnp.asarray(luts),
            block_comp=block_comp,
            n_comps=len(hdr.components), T=(T2 if pair else T),
            n_mcus=lay.n_mcus, C=C,
            precision=hdr.precision, pair=pair)
    else:
        pools, starts_rel, nm_lane, stride, C, skel_ok = \
            prepare_hybrid_batch(
                hdr, [scan], max_lanes_total=max_lanes_total or 2048,
                threads=1)
        if not skel_ok[0]:
            raise JPEGError("skeleton scan failed (corrupt stream)")
        blocks, bad = _hybrid_pipeline_batch(
            jnp.asarray(pools), jnp.asarray(starts_rel),
            jnp.asarray(nm_lane),
            jnp.asarray(luts.reshape(2 * len(hdr.components), 65536)),
            block_comp=block_comp, n_comps=len(hdr.components),
            stride=stride, n_mcus=lay.n_mcus, C=C,
            precision=hdr.precision)
    if bool(np.asarray(bad)[0]):
        raise JPEGError("hybrid device decode failed")
    blocks = blocks[0]
    return blocks if as_device else np.asarray(blocks)


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "cap", "n_mcus", "C",
                     "precision"))
def _spec_pipeline_batch(pools, base_rel, limits_rel, active, luts2d, *,
                         block_comp, n_comps, cap, n_mcus, C,
                         precision=8):
    """Phase 1 + per-image device splice + assembly for a (B, C) lane
    grid, as ONE program.  Returns (blocks (B, n_mcus*bpm, 64), ok (B,)).
    Images whose splice fails (ok False) fall back per image on the host
    (rare; see decode_scan_speculative)."""
    B = pools.shape[0]
    W = pools.shape[1]
    bpm = len(block_comp)
    img_base = (jnp.arange(B, dtype=jnp.int32) * (W * 32))[:, None]
    base_abs = (img_base + base_rel).reshape(-1)
    limits_abs = (img_base + limits_rel).reshape(-1)
    nblocks = jnp.where(active.reshape(-1), cap * bpm, 0)
    (out, err, n_done, starts, n_rec, end_pos,
     valid) = entropy_flat.decode_lockstep(
        pools.reshape(-1), base_abs, nblocks, limits_abs, luts2d,
        block_comp=block_comp, n_comps=n_comps, max_blocks=cap * bpm,
        dc_diff=True, record_mcus=1, max_mcus=cap, precision=precision)

    src, ok = jax.vmap(
        functools.partial(_device_splice, n_mcus=n_mcus, cap=cap))(
        starts.reshape(B, C, cap), n_rec.reshape(B, C),
        end_pos.reshape(B, C), base_abs.reshape(B, C),
        valid.reshape(B, C, cap))

    records = out.reshape(B, C * cap, bpm * 64)
    blocks = jax.vmap(lambda r, s: jnp.take(r, s, axis=0))(records, src)
    blocks = jax.vmap(
        functools.partial(_dc_prefix_sum, block_comp=block_comp,
                          n_comps=n_comps))(
        blocks.reshape(B, n_mcus, bpm, 64))
    return blocks.reshape(B, n_mcus * bpm, 64), ok

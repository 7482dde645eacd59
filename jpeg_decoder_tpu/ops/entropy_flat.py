"""Flat symbol-loop on-device entropy decode (JAX/XLA, lane-batched).

Second-generation device decoder (VERDICT r1 item 1) replacing the nested
MCU-loop/AC-while structure of the v1 decoder (tools/entropy_jax_v1.py) with ONE batched
while-loop in which every iteration decodes exactly one Huffman symbol on
every lane:

* **No lock-step idling.**  The v1 design vmapped a per-segment decoder
  whose nested loops (fori over MCUs, unrolled blocks, while over AC
  symbols) forced all lanes to run the max-over-lanes iteration count of
  EVERY inner loop.  Here the only loop is "decode one symbol"; a lane's
  trip count is its own total symbol count, and the batched trip count is
  a single max over lanes.
* **Register-resident bit window.**  The next 64 stream bits live in two
  uint32 carries (``cur``/``nxt``) refilled by at most one gather per
  symbol (a symbol consumes <= 27 bits), instead of two dynamic word
  gathers per peek (the C++ host decoder measured +14% from the same
  restructuring; on device it halves the dominant gather count).
* **One merged LUT.**  DC and AC tables for all components are stacked
  into a single ``(2 * n_comps * 65536,)`` table; the per-symbol probe is
  one gather with a computed row offset — no per-table branching.
* **Lanes are unified work.**  A lane is "decode from bit position B
  until block-count / bit-limit", so the same kernel serves restart
  segments (per-RSTn parallelism, jpeg.cpp:419-425 semantics) and the
  speculative chunk decode of DRI=0 streams (see ops.entropy_spec), and
  can batch segments of many images in one launch.

Semantics are bit-identical to entropy.python_ref (decodeMCUComponent /
getNextSymbol parity, jpeg.cpp:300-446), asserted in
tests/test_entropy_flat.py.  Corrupt streams set a per-lane error flag
(no divergence); erroring lanes park until the loop drains.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..huffman import build_lut
from ..layout import scan_layout
from ..types import FrameHeader, JPEGError, ScanHeader, ZIGZAG_INV


def merged_luts(hdr: FrameHeader, scan: ScanHeader) -> np.ndarray:
    """Stack per-component DC/AC LUTs into one flat uint16 table.

    Row layout: ``row = comp * 2 + is_ac`` — entry ``(sym << 5) | len``
    (fits uint16: sym <= 255, len <= 16), 0 marking an invalid prefix.
    """
    rows = []
    for c in hdr.components:
        rows.append(build_lut(scan.dc_specs[c.td]))
        rows.append(build_lut(scan.ac_specs[c.ta]))
    return np.concatenate(rows).astype(np.uint16)


def _extend(value, size):
    """JPEG sign extension (parity: jpeg.cpp:340-343)."""
    value = value.astype(jnp.int32)
    half = jnp.where(size > 0, 1 << jnp.maximum(size - 1, 0), 0)
    return jnp.where((size > 0) & (value < half),
                     value - ((1 << size) - 1), value)


def _window32(cur, nxt, off):
    """The next 32 bits given the two-word register pipeline."""
    return jnp.where(off == 0, cur,
                     (cur << off) | (nxt >> (32 - jnp.maximum(off, 1))))


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "max_blocks", "dc_diff",
                     "record_mcus", "max_mcus", "precision", "commit"))
def decode_flat(words, base_bits, nblocks, bit_limits, luts, *,
                block_comp: tuple[int, ...], n_comps: int, max_blocks: int,
                dc_diff: bool = False, record_mcus: int = 0,
                max_mcus: int = 0, precision: int = 8,
                commit: str = "block"):
    """Batched flat-loop decode of S independent lanes.

    Args:
      words: (N,) uint32 — big-endian packed stream word pool shared by all
        lanes (pad with >= 2 zero words past every lane's data).
      base_bits: (S,) int32 — absolute start bit of each lane (byte- or
        word-aligned not required).
      nblocks: (S,) int32 — decode at most this many 8x8 blocks per lane.
      bit_limits: (S,) int32 — in speculative mode (record_mcus > 0), stop
        at the first MCU whose start bit is >= this limit; ignored when
        record_mcus == 0 (pass e.g. 2**30).
      luts: (2 * n_comps * 65536,) uint16 merged decode LUTs.
      block_comp: static per-within-MCU-block component indices.
      max_blocks: static per-lane output capacity.
      dc_diff: DC coefficients stored as raw diffs (no predictor chain) —
        the speculative-chunk representation (DC prefix-sum happens after
        splicing, mirroring jd_decode_scan_speculative's phase 3).
      record_mcus / max_mcus: when > 0, also record the start bit of every
        decoded MCU (speculative trace) into a (S, max_mcus) buffer.
      commit: "block" accumulates each block in an (S, 64) register tile
        and scatters it on completion; "scalar" writes each decoded
        coefficient straight into the output with a one-element-per-lane
        scatter — no accumulator, no per-block commit (the cheaper mode
        when per-op scatter overhead beats per-element cost; measured by
        tools/entropy_ablation.py).

    Returns:
      out: (S, max_blocks, 64) int32, natural coefficient order.
      err: (S,) bool.
      n_done: (S,) int32 — blocks fully decoded per lane.
      mcu_starts: (S, max_mcus) int32 (zeros-size-1 when record_mcus == 0).
      n_mcus_rec: (S,) int32 — recorded MCU count.
      end_pos: (S,) int32 — bit position after the last completed MCU.
    """
    S = base_bits.shape[0]
    bpm = len(block_comp)
    n_words = words.shape[0]
    bc_arr = jnp.asarray(np.asarray(block_comp, np.int32))
    lanes = jnp.arange(S, dtype=jnp.int32)
    lane64 = jax.lax.broadcasted_iota(jnp.int32, (S, 64), 1)
    comp_iota = jax.lax.broadcasted_iota(jnp.int32, (S, n_comps), 1)
    rec = max(1, max_mcus if record_mcus else 1)

    w0 = (base_bits >> 5).astype(jnp.int32)
    off0 = (base_bits & 31).astype(jnp.uint32)
    cur0 = jnp.take(words, jnp.minimum(w0, n_words - 1))
    nxt0 = jnp.take(words, jnp.minimum(w0 + 1, n_words - 1))

    state = dict(
        cur=cur0, nxt=nxt0, off=off0, w_idx=w0 + 2,
        pos=base_bits.astype(jnp.int32),
        mcu_start=base_bits.astype(jnp.int32),
        end_pos=base_bits.astype(jnp.int32),
        blk=jnp.zeros((S,), jnp.int32),      # completed blocks
        k=jnp.zeros((S,), jnp.int32),        # block index within MCU
        coef=jnp.zeros((S,), jnp.int32),     # next zigzag index (0 = DC)
        preds=jnp.zeros((S, n_comps), jnp.int32),
        acc=jnp.zeros((S, 64), jnp.int32),   # current block, zigzag order
        out=jnp.zeros((S, max_blocks, 64), jnp.int32),
        starts=jnp.zeros((S, rec), jnp.int32),
        n_mcus=jnp.zeros((S,), jnp.int32),
        err=jnp.zeros((S,), jnp.bool_),
        done=nblocks <= 0,
        it=jnp.int32(0),
    )
    # Safety bound: a valid block never needs more than 64 symbols; +2
    # slack for DC and EOB accounting.  Erroring lanes park immediately,
    # so this cap is never the loop exit on well-formed streams.
    max_iters = int(max_blocks) * 66 + 8

    def cond(s):
        return jnp.any(~(s["done"] | s["err"])) & (s["it"] < max_iters)

    def body(s):
        active = ~(s["done"] | s["err"])
        window = _window32(s["cur"], s["nxt"], s["off"])
        w16 = (window >> 16).astype(jnp.int32)

        comp = jnp.take(bc_arr, s["k"])
        is_dc = s["coef"] == 0
        row = comp * 2 + (~is_dc).astype(jnp.int32)
        entry = jnp.take(luts, row * 65536 + w16).astype(jnp.int32)
        length = (entry & 31).astype(jnp.uint32)
        sym = (entry >> 5) & 0xFF
        bad = (entry == 0)

        is_eob = (~is_dc) & (sym == 0)
        run = jnp.where(sym == 0xF0, 16, sym >> 4)
        csize = jnp.where(is_dc, sym, sym & 15).astype(jnp.uint32)
        max_dc, max_ac = (15, 14) if precision > 8 else (11, 10)
        bad = bad | jnp.where(is_dc, sym > max_dc, (sym & 15) > max_ac)
        csize = jnp.minimum(csize, 16)  # keep shifts defined on bad lanes

        raw = jnp.where(
            csize == 0, jnp.uint32(0),
            (window << length) >> (32 - jnp.maximum(csize, 1)))
        val = _extend(raw, csize.astype(jnp.int32))
        adv = (length + csize).astype(jnp.int32)

        # --- DC path: predictor chain (or raw diff in speculative mode)
        if dc_diff:
            dc_val = val
            preds = s["preds"]
        else:
            pred_old = jnp.sum(
                jnp.where(comp_iota == comp[:, None], s["preds"], 0), axis=1)
            dc_val = pred_old + val
            upd = is_dc & active
            preds = jnp.where(
                (comp_iota == comp[:, None]) & upd[:, None],
                dc_val[:, None], s["preds"])

        # --- AC path bookkeeping (parity: python_ref.decode_block)
        wpos = s["coef"] + run                      # i + run
        overflow = (~is_dc) & (~is_eob) & (
            (wpos > 64) | ((csize > 0) & (wpos >= 64)))
        bad = bad | overflow
        write_idx = jnp.where(is_dc, 0, jnp.clip(wpos, 0, 63))
        value = jnp.where(is_dc, dc_val, val)
        do_write = active & ~bad & (is_dc | ((~is_eob) & (csize > 0)))

        coef_next = jnp.where(
            is_dc, 1,
            jnp.where(is_eob, 64, wpos + (csize > 0).astype(jnp.int32)))
        block_done = active & ~bad & (~is_dc) & (coef_next >= 64)

        if commit == "scalar":
            # One coefficient per lane per iteration, straight to the
            # output: no accumulator, no per-block commit scatter.
            o2 = s["out"].reshape(S, max_blocks * 64)
            cidx = jnp.where(do_write, s["blk"] * 64 + write_idx,
                             max_blocks * 64)
            out = o2.at[lanes, cidx].add(value, mode="drop",
                                         unique_indices=True
                                         ).reshape(S, max_blocks, 64)
            acc = s["acc"]
        else:
            acc = s["acc"] + jnp.where(
                do_write[:, None] & (lane64 == write_idx[:, None]),
                value[:, None], 0)
            # --- commit completed blocks (scatter; non-committers drop)
            tgt = jnp.where(block_done, s["blk"], max_blocks)
            out = s["out"].at[lanes, tgt].add(acc, mode="drop")
            acc = jnp.where(block_done[:, None], 0, acc)
        blk = s["blk"] + block_done
        k_next = jnp.where(block_done, s["k"] + 1, s["k"])
        mcu_done = block_done & (k_next >= bpm)
        k_next = jnp.where(mcu_done, 0, k_next)
        coef_next = jnp.where(block_done, 0, coef_next)

        # --- bit cursor advance + at most one refill
        adv = jnp.where(active & ~bad, adv, 0)
        pos = s["pos"] + adv
        offp = s["off"] + adv.astype(jnp.uint32)
        need = offp >= 32
        loaded = jnp.take(words, jnp.minimum(s["w_idx"], n_words - 1))
        cur = jnp.where(need, s["nxt"], s["cur"])
        nxt = jnp.where(need, loaded, s["nxt"])
        w_idx = s["w_idx"] + need
        off = offp - jnp.where(need, 32, 0).astype(jnp.uint32)

        # --- MCU trace (speculative mode) + termination
        end_pos = jnp.where(mcu_done, pos, s["end_pos"])
        if record_mcus:
            rtgt = jnp.where(mcu_done & (s["n_mcus"] < rec),
                             s["n_mcus"], rec)
            starts = s["starts"].at[lanes, rtgt].add(
                s["mcu_start"], mode="drop")
            n_mcus = s["n_mcus"] + (mcu_done & (s["n_mcus"] < rec))
            mcu_start = jnp.where(mcu_done, pos, s["mcu_start"])
            hit_limit = mcu_done & (pos >= bit_limits)
            full = mcu_done & (n_mcus >= rec)
            done = s["done"] | hit_limit | full | (blk >= nblocks)
        else:
            starts = s["starts"]
            n_mcus = s["n_mcus"] + mcu_done
            mcu_start = jnp.where(mcu_done, pos, s["mcu_start"])
            done = s["done"] | (blk >= nblocks)

        err = s["err"] | (bad & active)
        return dict(
            cur=cur, nxt=nxt, off=off, w_idx=w_idx, pos=pos,
            mcu_start=mcu_start, end_pos=end_pos, blk=blk, k=k_next,
            coef=coef_next, preds=preds, acc=acc, out=out, starts=starts,
            n_mcus=n_mcus, err=err, done=done, it=s["it"] + 1)

    s = jax.lax.while_loop(cond, body, state)
    out = jnp.take(s["out"], jnp.asarray(ZIGZAG_INV), axis=2)
    return (out, s["err"], s["blk"], s["starts"], s["n_mcus"], s["end_pos"])


# ---------------------------------------------------------------------------
# Emission variant: no in-loop stores at all
# ---------------------------------------------------------------------------
#
# Both earlier kernels pay for coefficient STORES inside the loop: the
# flat loop's per-lane scatter costs per-op overhead every iteration, and
# the lockstep
# kernel's uniform-index commits force all lanes through block slot b
# together — sum-over-slots of the max-over-lanes block symbol count,
# measured ~3.5x the balanced ideal trip count on the corpus.
#
# The emission kernel stores nothing: a fixed-trip lax.scan decodes one
# symbol per lane per step and EMITS (lane-local zigzag position, value)
# as stacked scan outputs — sequential uniform-index writes XLA handles
# natively.  ONE large scatter-add after the loop materializes all T*S
# coefficients at once, amortizing the scatter op overhead.  With lanes
# balanced by EXACT symbol counts (the native skeleton scan counts
# probes per MCU), the trip count is the max lane total ~= the balanced
# ideal.  Requires dc_diff semantics (raw DC diffs + prefix-sum later),
# i.e. the hybrid true-start path.


@functools.partial(
    jax.jit, static_argnames=("block_comp", "n_comps", "T", "precision"))
def decode_emit(words, base_bits, nblocks, luts, lut_base=None, *,
                block_comp: tuple[int, ...], n_comps: int, T: int,
                precision: int = 8):
    """Emission decode of S lanes: exactly ``T`` symbol steps per lane.

    Args are as :func:`decode_flat` (flat merged ``luts``); ``T`` must be
    >= every lane's total Huffman symbol count (lanes that exhaust their
    ``nblocks`` idle).  DC coefficients are raw diffs (dc_diff).
    ``lut_base``: optional (S,) int32 per-lane offset into ``luts`` (in
    rows of 65536) — geometry-bucketed groups ship one LUT stack per
    distinct table set and point each image's lanes at its rows.

    Returns (pos (T, S) int32 — lane-local ``blk*64 + zigzag_index`` or
    -1 for non-writing steps, val (T, S) int32, err (S,) bool,
    n_done (S,) int32 completed blocks).
    """
    S = base_bits.shape[0]
    bpm = len(block_comp)
    n_words = words.shape[0]
    bc_arr = jnp.asarray(np.asarray(block_comp, np.int32))
    max_dc, max_ac = (15, 14) if precision > 8 else (11, 10)

    w0 = (base_bits >> 5).astype(jnp.int32)
    off0 = (base_bits & 31).astype(jnp.uint32)
    cur0 = jnp.take(words, jnp.minimum(w0, n_words - 1))
    nxt0 = jnp.take(words, jnp.minimum(w0 + 1, n_words - 1))
    carry0 = dict(
        cur=cur0, nxt=nxt0, off=off0, w_idx=w0 + 2,
        blk=jnp.zeros((S,), jnp.int32),
        coef=jnp.zeros((S,), jnp.int32),
        err=jnp.zeros((S,), jnp.bool_))

    def step(s, _):
        active = ~s["err"] & (s["blk"] < nblocks)
        window = _window32(s["cur"], s["nxt"], s["off"])
        w16 = (window >> 16).astype(jnp.int32)
        comp = jnp.take(bc_arr, s["blk"] % bpm)
        is_dc = s["coef"] == 0
        row = comp * 2 + (~is_dc).astype(jnp.int32)
        if lut_base is not None:
            row = row + lut_base
        entry = jnp.take(luts, row * 65536 + w16).astype(jnp.int32)
        length = (entry & 31).astype(jnp.uint32)
        sym = (entry >> 5) & 0xFF
        bad = entry == 0
        is_eob = (~is_dc) & (sym == 0)
        run = jnp.where(sym == 0xF0, 16, sym >> 4)
        csize = jnp.where(is_dc, sym, sym & 15).astype(jnp.uint32)
        bad = bad | jnp.where(is_dc, sym > max_dc, (sym & 15) > max_ac)
        csize = jnp.minimum(csize, 16)
        raw = jnp.where(
            csize == 0, jnp.uint32(0),
            (window << length) >> (32 - jnp.maximum(csize, 1)))
        val = _extend(raw, csize.astype(jnp.int32))

        wpos = s["coef"] + run
        overflow = (~is_dc) & (~is_eob) & (
            (wpos > 64) | ((csize > 0) & (wpos >= 64)))
        bad = bad | overflow
        write_idx = jnp.where(is_dc, 0, jnp.clip(wpos, 0, 63))
        do_write = active & ~bad & (is_dc | ((~is_eob) & (csize > 0)))
        pos = jnp.where(do_write, s["blk"] * 64 + write_idx, -1)

        coef_next = jnp.where(
            is_dc, 1,
            jnp.where(is_eob, 64, wpos + (csize > 0).astype(jnp.int32)))
        ok = active & ~bad
        block_done = ok & (~is_dc) & (coef_next >= 64)
        blk = s["blk"] + block_done
        coef = jnp.where(ok, jnp.where(block_done, 0, coef_next),
                         s["coef"])

        adv = jnp.where(ok, (length + csize).astype(jnp.int32), 0)
        offp = s["off"] + adv.astype(jnp.uint32)
        need = offp >= 32
        loaded = jnp.take(words, jnp.minimum(s["w_idx"], n_words - 1))
        carry = dict(
            cur=jnp.where(need, s["nxt"], s["cur"]),
            nxt=jnp.where(need, loaded, s["nxt"]),
            off=offp - jnp.where(need, 32, 0).astype(jnp.uint32),
            w_idx=s["w_idx"] + need, blk=blk, coef=coef,
            err=s["err"] | (bad & active))
        return carry, (pos, jnp.where(do_write, val, 0))

    end, (pos, val) = jax.lax.scan(step, carry0, None, length=T)
    return pos, val, end["err"], end["blk"]


# ---------------------------------------------------------------------------
# Block-lockstep variant: every store is a uniform-index update
# ---------------------------------------------------------------------------
#
# Scatters with per-lane indices inside the loop body are what the flat
# loop pays for every symbol (tools/entropy_ablation.py measures them).
# In block-lockstep, all lanes work on the same block slot b at once, so
# the block commit, the DC-predictor update and the MCU-trace record all
# happen at indices that are UNIFORM scalars across lanes — each lowers to
# an in-place dynamic_update_slice instead of a scatter.  The price is
# block-granular idling (a lane waits for the slowest lane's symbol count
# within each block).


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "n_comps", "max_blocks", "dc_diff",
                     "record_mcus", "max_mcus", "precision"))
def decode_lockstep(words, base_bits, nblocks, bit_limits, luts2d, *,
                    block_comp: tuple[int, ...], n_comps: int,
                    max_blocks: int, dc_diff: bool = False,
                    record_mcus: int = 0, max_mcus: int = 0,
                    precision: int = 8):
    """Same contract as :func:`decode_flat` (see there for argument docs),
    with ``luts2d`` shaped (2 * n_comps, 65536) uint16."""
    S = base_bits.shape[0]
    bpm = len(block_comp)
    n_words = words.shape[0]
    bc_arr = jnp.asarray(np.asarray(block_comp, np.int32))
    lane64 = jax.lax.broadcasted_iota(jnp.int32, (S, 64), 1)
    rec = max(1, max_mcus if record_mcus else 1)

    w0 = (base_bits >> 5).astype(jnp.int32)
    off0 = (base_bits & 31).astype(jnp.uint32)
    cur0 = jnp.take(words, jnp.minimum(w0, n_words - 1))
    nxt0 = jnp.take(words, jnp.minimum(w0 + 1, n_words - 1))

    def consume(cur, nxt, off, w_idx, adv):
        """Advance the two-word register window by ``adv`` (< 32) bits."""
        offp = off + adv
        need = offp >= 32
        loaded = jnp.take(words, jnp.minimum(w_idx, n_words - 1))
        return (jnp.where(need, nxt, cur), jnp.where(need, loaded, nxt),
                offp - jnp.where(need, 32, 0).astype(jnp.uint32),
                w_idx + need)

    state = dict(
        cur=cur0, nxt=nxt0, off=off0, w_idx=w0 + 2,
        pos=base_bits.astype(jnp.int32),
        end_pos=base_bits.astype(jnp.int32),
        b=jnp.int32(0),
        preds=jnp.zeros((S, n_comps), jnp.int32),
        out=jnp.zeros((max_blocks, S, 64), jnp.int32),
        starts=jnp.zeros((rec, S), jnp.int32),
        valid=jnp.zeros((rec, S), jnp.bool_),
        n_mcus=jnp.zeros((S,), jnp.int32),
        skip=jnp.zeros((S,), jnp.bool_),
        err=jnp.zeros((S,), jnp.bool_),
        done=jnp.zeros((S,), jnp.bool_),
    )

    def outer_cond(s):
        return (s["b"] < max_blocks) & jnp.any(
            ~(s["done"] | s["err"]) & (s["b"] < nblocks))

    def outer_body(s):
        b = s["b"]
        k = b % bpm
        comp = jnp.take(bc_arr, k)          # uniform scalar
        dc_row = jax.lax.dynamic_index_in_dim(luts2d, comp * 2,
                                              keepdims=False)
        ac_row = jax.lax.dynamic_index_in_dim(luts2d, comp * 2 + 1,
                                              keepdims=False)
        active = ~(s["done"] | s["err"]) & (b < nblocks)
        # Speculative error-restart (record mode): a lane whose junk
        # speculation hits an invalid code does NOT park — it byte-aligns
        # and idles to the next MCU slot, then speculates again.  Without
        # this, one early-erroring misaligned lane leaves no trace for
        # its neighbors to synchronize against and the whole image falls
        # back to the host splice (measured on most corpus images).
        # Restart safety: a decode from a TRUE position never errors on a
        # valid stream, so aborted (tombstone) records exist only in the
        # pre-sync garbage prefix and are never consumed by the splice —
        # the `valid` bitmap additionally makes them unmatchable.
        listen = (active & ~s["skip"]) if record_mcus else active
        pos_block_start = s["pos"]

        # ---- DC symbol (uniform: every lane is at coef 0) ----
        window = _window32(s["cur"], s["nxt"], s["off"])
        entry = jnp.take(dc_row, (window >> 16).astype(jnp.int32)
                         ).astype(jnp.int32)
        length = (entry & 31).astype(jnp.uint32)
        size = (entry >> 5).astype(jnp.uint32)
        bad = (entry == 0) | (size > (15 if precision > 8 else 11))
        size = jnp.minimum(size, 16)
        raw = jnp.where(size == 0, jnp.uint32(0),
                        (window << length) >> (32 - jnp.maximum(size, 1)))
        diff = _extend(raw, size.astype(jnp.int32))
        if dc_diff:
            dc_val = diff
            preds = s["preds"]
        else:
            pred_old = jax.lax.dynamic_slice(
                s["preds"], (0, comp), (S, 1))[:, 0]
            dc_val = pred_old + diff
            upd = listen & ~bad
            preds = jax.lax.dynamic_update_slice(
                s["preds"],
                jnp.where(upd, dc_val, pred_old)[:, None], (0, comp))
        ok = listen & ~bad
        acc = jnp.where((lane64 == 0) & ok[:, None], dc_val[:, None], 0)
        adv = jnp.where(ok, length + size, 0)
        if record_mcus:
            abort_dc = listen & bad
            align = (8 - (s["pos"].astype(jnp.uint32) & 7)) & 7
            align = jnp.where(align == 0, 8, align)
            adv = jnp.where(abort_dc, align, adv)
        else:
            abort_dc = jnp.zeros_like(bad)
        pos = s["pos"] + adv.astype(jnp.int32)
        cur, nxt, off, w_idx = consume(
            s["cur"], s["nxt"], s["off"], s["w_idx"], adv.astype(jnp.uint32))

        # ---- AC symbols (while: any lane still inside block b) ----
        def ac_cond(c):
            return jnp.any(c["in"])

        def ac_body(c):
            window = _window32(c["cur"], c["nxt"], c["off"])
            entry = jnp.take(ac_row, (window >> 16).astype(jnp.int32)
                             ).astype(jnp.int32)
            length = (entry & 31).astype(jnp.uint32)
            sym = (entry >> 5) & 0xFF
            bad = (entry == 0) | ((sym & 15) > (14 if precision > 8 else 10))
            is_eob = sym == 0
            run = jnp.where(sym == 0xF0, 16, sym >> 4)
            csize = jnp.minimum((sym & 15).astype(jnp.uint32), 16)
            wpos = c["coef"] + run
            bad = bad | ((~is_eob) & (
                (wpos > 64) | ((csize > 0) & (wpos >= 64))))
            raw = jnp.where(
                csize == 0, jnp.uint32(0),
                (window << length) >> (32 - jnp.maximum(csize, 1)))
            val = _extend(raw, csize.astype(jnp.int32))
            live = c["in"] & ~bad
            do_write = live & (~is_eob) & (csize > 0)
            idx = jnp.clip(wpos, 0, 63)
            acc = c["acc"] + jnp.where(
                do_write[:, None] & (lane64 == idx[:, None]),
                val[:, None], 0)
            coef = jnp.where(live,
                             wpos + (csize > 0).astype(jnp.int32),
                             c["coef"])
            adv = jnp.where(live, length + csize, 0)
            if record_mcus:
                abort_now = bad & c["in"]
                align = (8 - (c["pos"].astype(jnp.uint32) & 7)) & 7
                align = jnp.where(align == 0, 8, align)
                adv = jnp.where(abort_now, align, adv)
                err = c["err"]
                abort = c["abort"] | abort_now
            else:
                err = c["err"] | (bad & c["in"])
                abort = c["abort"]
            pos = c["pos"] + adv.astype(jnp.int32)
            cur, nxt, off, w_idx = consume(
                c["cur"], c["nxt"], c["off"], c["w_idx"],
                adv.astype(jnp.uint32))
            in_next = live & ~is_eob & (coef < 64)
            return dict(cur=cur, nxt=nxt, off=off, w_idx=w_idx, pos=pos,
                        coef=coef, acc=acc, err=err, abort=abort,
                        **{"in": in_next})

        ac0 = dict(cur=cur, nxt=nxt, off=off, w_idx=w_idx, pos=pos,
                   coef=jnp.where(ok, 1, 64), acc=acc,
                   err=(s["err"] if record_mcus
                        else s["err"] | (bad & active)),
                   abort=abort_dc)
        ac0["in"] = ok
        ac = jax.lax.while_loop(ac_cond, ac_body, ac0)

        # ---- commit block b (uniform index: in-place slice update) ----
        out = jax.lax.dynamic_update_slice(s["out"], ac["acc"][None],
                                           (b, 0, 0))
        boundary = k == bpm - 1
        if record_mcus:
            completed = ok & ~ac["abort"]
            mcu_done = completed & boundary & ~s["skip"]
            skip = (s["skip"] | ac["abort"]) & ~boundary
        else:
            completed = ok & ~(ac["err"] & ~s["err"])
            mcu_done = completed & boundary
            skip = s["skip"]
        end_pos = jnp.where(mcu_done, ac["pos"], s["end_pos"])
        if record_mcus:
            m = b // bpm
            # Slot-indexed trace: every active lane's slot m records the
            # MCU's start bit (at k==0) and, at the boundary, whether the
            # whole MCU decoded (valid); aborted slots stay invalid.
            # The writes are lax.cond-gated on the uniform scalars k==0 /
            # boundary: each (rec, S) trace array is touched once per MCU
            # instead of once per block (slot m is written exactly once,
            # so no read-modify is needed either) — the ungated form cost
            # a measurable slice of the record-mode iteration.
            starts = jax.lax.cond(
                k == 0,
                lambda st: jax.lax.dynamic_update_slice(
                    st, jnp.where(listen, pos_block_start, 0)[None],
                    (m, 0)),
                lambda st: st, s["starts"])
            valid = jax.lax.cond(
                boundary,
                lambda vd: jax.lax.dynamic_update_slice(
                    vd, mcu_done[None], (m, 0)),
                lambda vd: vd, s["valid"])
            n_mcus = s["n_mcus"] + (active & boundary)
            done = s["done"] | (active & boundary
                                & (ac["pos"] >= bit_limits))
        else:
            starts = s["starts"]
            valid = s["valid"]
            n_mcus = s["n_mcus"] + mcu_done
            done = s["done"]

        return dict(
            cur=ac["cur"], nxt=ac["nxt"], off=ac["off"], w_idx=ac["w_idx"],
            pos=ac["pos"], end_pos=end_pos, b=b + 1, preds=preds, out=out,
            starts=starts, valid=valid, n_mcus=n_mcus, skip=skip,
            err=ac["err"], done=done)

    s = jax.lax.while_loop(outer_cond, outer_body, state)
    out = jnp.take(s["out"].transpose(1, 0, 2), jnp.asarray(ZIGZAG_INV),
                   axis=2)
    n_done = jnp.minimum(jnp.where(s["err"] | s["done"],
                                   s["n_mcus"] * bpm, nblocks), nblocks)
    return (out, s["err"], n_done, s["starts"].T, s["n_mcus"],
            s["end_pos"], s["valid"].T)


# ---------------------------------------------------------------------------
# Segment-mode wrapper (common backend signature)
# ---------------------------------------------------------------------------

def prepare_scan_flat(hdr: FrameHeader, scan: ScanHeader):
    """Host prep: one flat word pool + per-lane base bits (NumPy, cheap)."""
    lay = scan_layout(hdr)
    ri = scan.restart_interval
    n_mcus = lay.n_mcus
    seg_offsets = np.asarray(scan.seg_offsets, np.int64)
    n_segments = len(seg_offsets) - 1
    expected = -(-n_mcus // ri) if ri else 1
    if n_segments != expected:
        raise JPEGError(
            f"restart-segment count {n_segments} does not match DRI {ri}")
    bpm = lay.blocks_per_mcu
    # Pack each segment at a word-aligned offset of one shared pool.
    seg_lens = np.diff(seg_offsets)
    word_lens = (seg_lens + 3) // 4
    word_base = np.zeros(n_segments + 1, np.int64)
    np.cumsum(word_lens + 2, out=word_base[1:])  # +2 pad words per segment
    pool = np.zeros(int(word_base[-1]) + 2, np.uint32)
    data = np.asarray(scan.data, np.uint8)
    for s in range(n_segments):
        seg = data[seg_offsets[s]: seg_offsets[s + 1]]
        nw = int(word_lens[s])
        padded = np.zeros(nw * 4, np.uint8)
        padded[: len(seg)] = seg
        pool[word_base[s]: word_base[s] + nw] = padded.view(">u4")
    base_bits = (word_base[:-1] * 32).astype(np.int32)
    nm = np.full(n_segments, ri if ri else n_mcus, np.int64)
    if ri:
        nm[-1] = n_mcus - ri * (n_segments - 1)
    nblocks = (nm * bpm).astype(np.int32)
    max_blocks = int(nblocks.max())
    block_comp = tuple(
        ci for ci, c in enumerate(hdr.components) for _ in range(c.v * c.h))
    return pool, base_bits, nblocks, max_blocks, block_comp, lay


def decode_scan_baseline(hdr: FrameHeader, scan: ScanHeader,
                         impl: str = "lockstep",
                         as_device: bool = False):
    """Common-backend-signature wrapper: (total_blocks, 64) int32 scan-order
    natural-layout coefficients (identical to python_ref/native/jax).

    ``impl``: "lockstep" (default — uniform-index stores, no scatters) or
    "flat" (pure symbol loop; kept as a second implementation the tests
    cross-check and the ablation harness measures against).
    ``as_device``: return a device array (no coefficient-plane D2H; only
    the per-segment error flags cross to host).
    """
    pool, base_bits, nblocks, max_blocks, block_comp, lay = \
        prepare_scan_flat(hdr, scan)
    luts = merged_luts(hdr, scan)
    decode = decode_lockstep if impl == "lockstep" else decode_flat
    if impl == "lockstep":
        luts = luts.reshape(2 * len(hdr.components), 65536)
    out, err, n_done, *_ = decode(
        jnp.asarray(pool), jnp.asarray(base_bits), jnp.asarray(nblocks),
        jnp.full(base_bits.shape, 2**30, jnp.int32), jnp.asarray(luts),
        block_comp=block_comp, n_comps=len(hdr.components),
        max_blocks=max_blocks, precision=hdr.precision)
    err = np.asarray(err) | (np.asarray(n_done) < nblocks)
    if err.any():
        bad = np.flatnonzero(err)
        raise JPEGError(f"device entropy decode failed in segments {bad[:8]}")
    bpm = len(block_comp)
    if (nblocks == max_blocks).all():
        out = out.reshape(-1, 64)[: lay.n_mcus * bpm]
    else:
        # Strip per-segment padding with one device gather (host builds
        # only the index metadata).
        S = len(nblocks)
        seg_of = np.repeat(np.arange(S, dtype=np.int64), nblocks)
        within = (np.arange(nblocks.sum(), dtype=np.int64)
                  - np.repeat(np.cumsum(nblocks) - nblocks, nblocks))
        idx = seg_of * max_blocks + within
        out = jnp.take(out.reshape(-1, 64), jnp.asarray(idx), axis=0)
    return out if as_device else np.asarray(out)


@functools.partial(
    jax.jit, static_argnames=("block_comp", "n_comps", "T", "precision"))
def decode_emit2(words, base_bits, nblocks, luts, lut_base=None, *,
                 block_comp: tuple[int, ...], n_comps: int, T: int,
                 precision: int = 8):
    """Paired emission decode: up to TWO Huffman symbols per scan step.

    A 32-bit window holds two typical symbols (~5-10 bits each): symbol A
    is decoded from the window top and, when ``lenA + sizeA <= 16`` (the
    16 probe bits for B are then fully valid) and the pair fits the
    window (``advA + advB <= 32``), symbol B decodes from the SAME
    window shifted — halving the per-step fixed cost (loop machinery +
    lane-wide ALU) that dominates at the measured optimum lane count,
    at the price of one extra dependent LUT gather per step.

    ``T`` must be >= every lane's PAIRED step count (the native skeleton
    scan counts it exactly; a safe bound is the symbol count).  Returns
    (pos (T, 2, S) int32, val (T, 2, S) int32, err (S,) bool,
    n_done (S,) int32) — same (pos, val) semantics as decode_emit with
    two slots per step (slot 1 is -1 when unpaired).
    """
    S = base_bits.shape[0]
    bpm = len(block_comp)
    n_words = words.shape[0]
    bc_arr = jnp.asarray(np.asarray(block_comp, np.int32))
    max_dc, max_ac = (15, 14) if precision > 8 else (11, 10)

    def sym_decode(window, blk, coef, active):
        """One symbol from ``window``'s top bits on active lanes.
        Returns (pos, val, adv uint32, blk', coef', bad)."""
        w16 = (window >> 16).astype(jnp.int32)
        comp = jnp.take(bc_arr, blk % bpm)
        is_dc = coef == 0
        row = comp * 2 + (~is_dc).astype(jnp.int32)
        if lut_base is not None:
            row = row + lut_base
        entry = jnp.take(luts, row * 65536 + w16).astype(jnp.int32)
        length = (entry & 31).astype(jnp.uint32)
        sym = (entry >> 5) & 0xFF
        bad = entry == 0
        is_eob = (~is_dc) & (sym == 0)
        run = jnp.where(sym == 0xF0, 16, sym >> 4)
        csize = jnp.where(is_dc, sym, sym & 15).astype(jnp.uint32)
        bad = bad | jnp.where(is_dc, sym > max_dc, (sym & 15) > max_ac)
        csize = jnp.minimum(csize, 16)
        raw = jnp.where(
            csize == 0, jnp.uint32(0),
            (window << length) >> (32 - jnp.maximum(csize, 1)))
        val = _extend(raw, csize.astype(jnp.int32))
        wpos = coef + run
        overflow = (~is_dc) & (~is_eob) & (
            (wpos > 64) | ((csize > 0) & (wpos >= 64)))
        bad = bad | overflow
        write_idx = jnp.where(is_dc, 0, jnp.clip(wpos, 0, 63))
        do_write = active & ~bad & (is_dc | ((~is_eob) & (csize > 0)))
        pos = jnp.where(do_write, blk * 64 + write_idx, -1)
        coef_next = jnp.where(
            is_dc, 1,
            jnp.where(is_eob, 64, wpos + (csize > 0).astype(jnp.int32)))
        ok = active & ~bad
        block_done = ok & (~is_dc) & (coef_next >= 64)
        blk_n = blk + block_done
        coef_n = jnp.where(ok, jnp.where(block_done, 0, coef_next), coef)
        adv = jnp.where(ok, (length + csize).astype(jnp.uint32), 0)
        return pos, jnp.where(do_write, val, 0), adv, blk_n, coef_n, bad

    w0 = (base_bits >> 5).astype(jnp.int32)
    off0 = (base_bits & 31).astype(jnp.uint32)
    carry0 = dict(
        cur=jnp.take(words, jnp.minimum(w0, n_words - 1)),
        nxt=jnp.take(words, jnp.minimum(w0 + 1, n_words - 1)),
        off=off0, w_idx=w0 + 2,
        blk=jnp.zeros((S,), jnp.int32),
        coef=jnp.zeros((S,), jnp.int32),
        err=jnp.zeros((S,), jnp.bool_))

    def step(s, _):
        active = ~s["err"] & (s["blk"] < nblocks)
        window = _window32(s["cur"], s["nxt"], s["off"])
        posA, valA, advA, blkA, coefA, badA = sym_decode(
            window, s["blk"], s["coef"], active)
        err1 = s["err"] | (badA & active)
        activeB = ~err1 & (blkA < nblocks)
        can_probe = advA <= 16
        wB = window << advA
        posB, valB, advB, blkB, coefB, badB = sym_decode(
            wB, blkA, coefA, activeB & can_probe)
        fit = can_probe & (advA + advB <= 32)
        err2 = err1 | (badB & activeB & can_probe)
        do_B = activeB & fit & ~badB
        blk = jnp.where(do_B, blkB, blkA)
        coef = jnp.where(do_B, coefB, coefA)
        posB = jnp.where(do_B, posB, -1)
        valB = jnp.where(do_B, valB, 0)
        adv = advA + jnp.where(do_B, advB, 0)
        offp = s["off"] + adv
        need = offp >= 32
        loaded = jnp.take(words, jnp.minimum(s["w_idx"], n_words - 1))
        carry = dict(
            cur=jnp.where(need, s["nxt"], s["cur"]),
            nxt=jnp.where(need, loaded, s["nxt"]),
            off=offp - jnp.where(need, 32, 0).astype(jnp.uint32),
            w_idx=s["w_idx"] + need, blk=blk, coef=coef, err=err2)
        return carry, (jnp.stack([posA, posB]), jnp.stack([valA, valB]))

    end, (pos, val) = jax.lax.scan(step, carry0, None, length=T)
    return pos, val, end["err"], end["blk"]

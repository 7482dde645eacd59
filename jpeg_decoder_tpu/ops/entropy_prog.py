"""On-device progressive entropy decode (T.81 Annex G.2) — lane-parallel.

Capability far beyond the reference (which hard-exits on SOF2,
/root/reference/jpeg.cpp:69-73): every progressive scan kind runs as lanes
of a block-lockstep device kernel, the same design as the baseline
lockstep decoder (ops/entropy_flat):

* **DC first** — one DC probe per block slot; no inner loop at all.
  Lane DC predictors seed from the lane table (restart segments seed 0;
  DRI=0 skeleton lanes seed the recorded predictor), so no cross-lane
  pass is needed.
* **DC refinement** — one raw bit per block at a CLOSED-FORM stream
  position (bit i of the lane = block i): no kernel, one vectorized
  gather computes every block's ``+= bit << al`` delta.
* **AC first** — run/size symbols with EOB-run state per lane; lanes in
  an EOB run skip whole block slots without touching the stream.
* **AC refinement** — correction-bit pass: reads the CURRENT device-
  resident coefficient band (one row gather per block slot), walks the
  band positions emitting ``+/- (1 << al)`` deltas.

Every kernel emits DELTAS: progressive plane updates are all
mathematically scatter-ADDS on conformant streams (DC-first writes into
zero DC slots; refinement bits target value bits proven zero by the
successive-approximation invariant — value mod 2^(al+1) == 0 entering
scan ``al``), so one ``plane.at[rows].add(delta)`` applies each scan and
the plane never leaves HBM.

Lanes come from restart segments (DC reset + eobrun reset per segment,
T.81 G.2 — zero host work) or, for DRI=0 scans, from the native
progressive skeleton scan (entropy/native.prog_skeleton) recording
(bit position, eobrun, DC predictors) at every stride-th MCU.

Bit-exactness vs entropy/progressive.py is asserted scan-by-scan in
tests/test_entropy_prog.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..huffman import build_lut
from ..layout import comp_dims_unpadded
from ..types import FrameHeader, JPEGError, ScanHeader, ZIGZAG, ZIGZAG_INV
from .entropy_flat import _extend, _window32


def scan_words(scan: ScanHeader) -> np.ndarray:
    """Whole-scan big-endian uint32 word buffer, zero-padded (lanes index
    it by absolute bit position — no per-segment repacking)."""
    data = np.asarray(scan.data, np.uint8)
    nw = (len(data) + 3) // 4 + 8
    buf = np.zeros(nw * 4, np.uint8)
    buf[: len(data)] = data
    return buf.view(">u4").astype(np.uint32)


def segment_lanes(scan: ScanHeader, n_mcus: int):
    """Restart segments as lanes: (base_bits, n_per_lane, mcu_first),
    all (S,) int32/int64.  DRI=0 scans yield one lane."""
    offs = np.asarray(scan.seg_offsets, np.int64)
    n_seg = len(offs) - 1
    ri = scan.restart_interval
    expected = -(-n_mcus // ri) if ri else 1
    if n_seg != expected:
        raise JPEGError(
            f"progressive scan: segment count {n_seg} != expected "
            f"{expected} (DRI {ri}, {n_mcus} MCUs)")
    base_bits = (offs[:-1] * 8).astype(np.int64)
    per = ri if ri else n_mcus
    n_per = np.full(n_seg, per, np.int32)
    if ri:
        n_per[-1] = n_mcus - ri * (n_seg - 1)
    mcu_first = (np.arange(n_seg, dtype=np.int64) * per)
    return base_bits, n_per, mcu_first


# ---------------------------------------------------------------------------
# DC scans
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("block_comp", "max_blocks", "al"))
def decode_dc_first(words, base_bits, nblocks, pred0, luts2d, *,
                    block_comp: tuple[int, ...], max_blocks: int, al: int):
    """DC-first scan (ss=0, ah=0) over S lanes, block-lockstep.

    luts2d: (n_scan_comps, 65536) uint16 DC LUTs (scan component order).
    pred0: (S, n_scan_comps) int32 predictor seeds.
    Returns (vals (S, max_blocks) int32 = pred << al per block slot,
    err (S,) bool).  Parity: entropy/progressive._decode_dc_first.
    """
    S = base_bits.shape[0]
    bpm = len(block_comp)
    n_words = words.shape[0]
    bc_arr = jnp.asarray(np.asarray(block_comp, np.int32))

    w0 = (base_bits >> 5).astype(jnp.int32)
    off0 = (base_bits & 31).astype(jnp.uint32)
    state = dict(
        cur=jnp.take(words, jnp.minimum(w0, n_words - 1)),
        nxt=jnp.take(words, jnp.minimum(w0 + 1, n_words - 1)),
        off=off0, w_idx=w0 + 2,
        b=jnp.int32(0),
        preds=pred0.astype(jnp.int32),
        out=jnp.zeros((max_blocks, S), jnp.int32),
        err=jnp.zeros((S,), jnp.bool_))

    def cond(s):
        return (s["b"] < max_blocks) & jnp.any(~s["err"] & (s["b"] < nblocks))

    def body(s):
        b = s["b"]
        comp = jnp.take(bc_arr, b % bpm)          # uniform scalar
        lut_row = jax.lax.dynamic_index_in_dim(luts2d, comp, keepdims=False)
        active = ~s["err"] & (b < nblocks)
        window = _window32(s["cur"], s["nxt"], s["off"])
        entry = jnp.take(lut_row, (window >> 16).astype(jnp.int32)
                         ).astype(jnp.int32)
        length = (entry & 31).astype(jnp.uint32)
        size = (entry >> 5).astype(jnp.uint32)
        bad = (entry == 0) | (size > 11)
        size = jnp.minimum(size, 16)
        raw = jnp.where(size == 0, jnp.uint32(0),
                        (window << length) >> (32 - jnp.maximum(size, 1)))
        diff = _extend(raw, size.astype(jnp.int32))
        ok = active & ~bad
        pred_old = jax.lax.dynamic_slice(s["preds"], (0, comp), (S, 1))[:, 0]
        pred = pred_old + diff
        preds = jax.lax.dynamic_update_slice(
            s["preds"], jnp.where(ok, pred, pred_old)[:, None], (0, comp))
        out = jax.lax.dynamic_update_slice(
            s["out"], jnp.where(ok, pred << al, 0)[None], (b, 0))
        adv = jnp.where(ok, length + size, 0)
        offp = s["off"] + adv
        need = offp >= 32
        loaded = jnp.take(words, jnp.minimum(s["w_idx"], n_words - 1))
        return dict(
            cur=jnp.where(need, s["nxt"], s["cur"]),
            nxt=jnp.where(need, loaded, s["nxt"]),
            off=offp - jnp.where(need, 32, 0).astype(jnp.uint32),
            w_idx=s["w_idx"] + need, b=b + 1, preds=preds, out=out,
            err=s["err"] | (bad & active))

    s = jax.lax.while_loop(cond, body, state)
    return s["out"].T, s["err"]


def dc_refine_bits(words, base_bits, nblocks, max_blocks: int, al: int):
    """DC refinement (ss=0, ah>0): block i of a lane reads exactly bit
    ``base + i`` — closed form, no kernel.

    Each lane's bits are CONTIGUOUS, so the single-lane case (the DRI=0
    hybrid path) unpacks one dynamic word slice instead of paying a
    per-element gather (566k positions on the 12 MP sample); multi-lane
    tables keep the vectorized gather.

    Returns (S, max_blocks) int32 deltas (``bit << al``; the target bit
    of every DC value is zero entering the scan, so |= == +=).
    Parity: entropy/progressive._dc_scan refinement branch."""
    S = base_bits.shape[0]
    n_words = words.shape[0]
    if S == 1:
        nw = max_blocks // 32 + 2
        w0 = jnp.minimum((base_bits[0] >> 5).astype(jnp.int32),
                         jnp.int32(max(n_words - nw, 0)))
        ws = jax.lax.dynamic_slice(
            words, (w0,), (min(nw, n_words),))
        iota32 = jnp.arange(32, dtype=jnp.uint32)
        allbits = ((ws[:, None] >> (31 - iota32)[None, :]) & 1).reshape(-1)
        # Pad so the slice below stays in bounds even for degenerate
        # tiny word pools (truncated streams read zeros, like the
        # gather path's clamp).  Pad size is static.
        pad = max(64, max_blocks + 64 - min(nw, n_words) * 32)
        allbits = jnp.concatenate(
            [allbits, jnp.zeros(pad, allbits.dtype)])
        off = jnp.clip(base_bits[0].astype(jnp.int32) - w0 * 32,
                       0, allbits.shape[0] - max_blocks)
        bit = jax.lax.dynamic_slice(allbits, (off,), (max_blocks,))
        valid = jnp.arange(max_blocks, dtype=jnp.int32) < nblocks[0]
        return jnp.where(valid, bit.astype(jnp.int32) << al, 0)[None]
    slot = jnp.arange(max_blocks, dtype=jnp.int32)[None, :]
    pos = base_bits[:, None].astype(jnp.int32) + slot
    w = jnp.take(words, jnp.minimum(pos >> 5, n_words - 1))
    bit = (w >> (31 - (pos & 31).astype(jnp.uint32))) & 1
    valid = slot < nblocks[:, None]
    return jnp.where(valid, bit.astype(jnp.int32) << al, 0)


# ---------------------------------------------------------------------------
# AC scans (single-component, T.81 G.2.2 / G.2.3)
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("max_blocks", "ss", "se", "al"))
def decode_ac_first(words, base_bits, nblocks, eobrun0, lut, *,
                    max_blocks: int, ss: int, se: int, al: int):
    """AC-first scan over S lanes, block-lockstep with EOB-run state.

    Returns (out (S, max_blocks, 64) int32 natural order, err (S,) bool).
    Parity: entropy/progressive._ac_first_scan.
    """
    S = base_bits.shape[0]
    n_words = words.shape[0]
    lane64 = jax.lax.broadcasted_iota(jnp.int32, (S, 64), 1)

    w0 = (base_bits >> 5).astype(jnp.int32)
    off0 = (base_bits & 31).astype(jnp.uint32)
    state = dict(
        cur=jnp.take(words, jnp.minimum(w0, n_words - 1)),
        nxt=jnp.take(words, jnp.minimum(w0 + 1, n_words - 1)),
        off=off0, w_idx=w0 + 2,
        b=jnp.int32(0),
        eobrun=eobrun0.astype(jnp.int32),
        out=jnp.zeros((max_blocks, S, 64), jnp.int32),
        err=jnp.zeros((S,), jnp.bool_))

    def cond(s):
        return (s["b"] < max_blocks) & jnp.any(~s["err"] & (s["b"] < nblocks))

    def body(s):
        b = s["b"]
        active = ~s["err"] & (b < nblocks)
        in_eob = active & (s["eobrun"] > 0)
        eobrun = jnp.where(in_eob, s["eobrun"] - 1, s["eobrun"])
        decode = active & ~in_eob

        def ac_cond(c):
            return jnp.any(c["in"])

        def ac_body(c):
            window = _window32(c["cur"], c["nxt"], c["off"])
            entry = jnp.take(lut, (window >> 16).astype(jnp.int32)
                             ).astype(jnp.int32)
            length = (entry & 31).astype(jnp.uint32)
            sym = (entry >> 5) & 0xFF
            bad = (entry == 0) & c["in"]
            r = sym >> 4
            sz = (sym & 15).astype(jnp.uint32)
            is_eobrun = (sz == 0) & (r < 15)
            # EOB run: (1 << r) - 1 plus r raw bits (after the code).
            # The shift count must stay UNSIGNED: a signed count promotes
            # the whole shift to int32 and turns it arithmetic.
            ebits = jnp.where(
                r == 0, jnp.uint32(0),
                (window << length)
                >> (32 - jnp.maximum(r, 1).astype(jnp.uint32)))
            new_eob = (1 << r) - 1 + jnp.where(r > 0, ebits, 0).astype(
                jnp.int32)
            # Coefficient: advance run, write extend(value) << al.
            wpos = c["k"] + r
            # Parity: python raises only on a COEFFICIENT run overflow
            # (k + r > se with sz > 0); a ZRL that walks past the band
            # simply ends the block (progressive.py:156-160).
            overflow = (~is_eobrun) & (sz > 0) & (wpos > se)
            bad = bad | (overflow & c["in"])
            sz = jnp.minimum(sz, 16)
            raw = jnp.where(
                sz == 0, jnp.uint32(0),
                (window << length) >> (32 - jnp.maximum(sz, 1)))
            val = _extend(raw, sz.astype(jnp.int32)) << al
            live = c["in"] & ~bad
            do_write = live & ~is_eobrun & (sz > 0)
            idx = jnp.clip(wpos, 0, 63)
            acc = c["acc"] + jnp.where(
                do_write[:, None] & (lane64 == idx[:, None]),
                val[:, None], 0)
            k = jnp.where(
                live & ~is_eobrun,
                jnp.where(sz > 0, wpos + 1, c["k"] + 16),  # coef / ZRL
                c["k"])
            adv = jnp.where(
                live,
                length + jnp.where(is_eobrun, r.astype(jnp.uint32), sz),
                0)
            eob = jnp.where(live & is_eobrun, new_eob, c["eob"])
            offp = c["off"] + adv
            need = offp >= 32
            loaded = jnp.take(words, jnp.minimum(c["w_idx"], n_words - 1))
            in_next = live & ~is_eobrun & (k <= se)
            return dict(
                cur=jnp.where(need, c["nxt"], c["cur"]),
                nxt=jnp.where(need, loaded, c["nxt"]),
                off=offp - jnp.where(need, 32, 0).astype(jnp.uint32),
                w_idx=c["w_idx"] + need, k=k, acc=acc, eob=eob,
                err=c["err"] | bad, **{"in": in_next})

        ac0 = dict(cur=s["cur"], nxt=s["nxt"], off=s["off"],
                   w_idx=s["w_idx"],
                   k=jnp.full((S,), ss, jnp.int32),
                   acc=jnp.zeros((S, 64), jnp.int32),
                   eob=jnp.zeros((S,), jnp.int32),
                   err=s["err"])
        ac0["in"] = decode
        ac = jax.lax.while_loop(ac_cond, ac_body, ac0)

        # A fresh EOB run covers THIS block too (python: eobrun = n - 1
        # consumed next blocks; here the break happened inside this block).
        eobrun = jnp.where(decode & (ac["eob"] > 0), ac["eob"], eobrun)
        out = jax.lax.dynamic_update_slice(s["out"], ac["acc"][None],
                                           (b, 0, 0))
        return dict(
            cur=ac["cur"], nxt=ac["nxt"], off=ac["off"], w_idx=ac["w_idx"],
            b=b + 1, eobrun=eobrun, out=out, err=ac["err"])

    s = jax.lax.while_loop(cond, body, state)
    out = jnp.take(s["out"].transpose(1, 0, 2), jnp.asarray(ZIGZAG_INV),
                   axis=2)
    return out, s["err"]


@functools.partial(
    jax.jit, static_argnames=("max_blocks", "ss", "se", "al"))
def decode_ac_refine(words, base_bits, nblocks, eobrun0, lut, plane_rows,
                     row_idx, *, max_blocks: int, ss: int, se: int,
                     al: int):
    """AC refinement scan over S lanes, block-lockstep (T.81 G.2.3).

    plane_rows: (n_plane_blocks + 1, 64) int32 CURRENT coefficient rows in
      ZIGZAG order (history decides bit consumption), row n_plane_blocks
      zeros (padding target).
    row_idx: (S, max_blocks) int32 plane row of each lane's block slot
      (n_plane_blocks for padded slots).

    Inner iterations are BATCHED: one correction bit per nonzero-history
    band position would cost up to 63 iterations per block; instead each
    iteration distributes up to 32 window bits across the positions by
    RANK (a cumulative count over the history mask), so a block costs
    ~#symbols + ceil(#correction_bits / 32) iterations — measured ~8x
    fewer for the dense final refinement scans.

    Returns (delta (S, max_blocks, 64) int32 natural order — add to the
    plane, err (S,) bool).  Parity: entropy/progressive._ac_refine_scan.
    """
    S = base_bits.shape[0]
    n_words = words.shape[0]
    lane64 = jax.lax.broadcasted_iota(jnp.int32, (S, 64), 1)
    p1 = 1 << al
    CAP = 32  # correction bits consumed per batched iteration

    w0 = (base_bits >> 5).astype(jnp.int32)
    off0 = (base_bits & 31).astype(jnp.uint32)
    state = dict(
        cur=jnp.take(words, jnp.minimum(w0, n_words - 1)),
        nxt=jnp.take(words, jnp.minimum(w0 + 1, n_words - 1)),
        off=off0, w_idx=w0 + 2,
        b=jnp.int32(0),
        eobrun=eobrun0.astype(jnp.int32),
        out=jnp.zeros((max_blocks, S, 64), jnp.int32),
        err=jnp.zeros((S,), jnp.bool_))

    def cond(s):
        return (s["b"] < max_blocks) & jnp.any(~s["err"] & (s["b"] < nblocks))

    def body(s):
        b = s["b"]
        active = ~s["err"] & (b < nblocks)
        rows = jnp.take(row_idx, b, axis=1)
        cur_vals = jnp.take(plane_rows, rows, axis=0)   # (S, 64) zigzag
        hist_nz = cur_vals != 0
        corr_step = jnp.where(cur_vals > 0, p1, -p1)
        # Python's correct() guards (nz & p1) == 0 — always true on
        # conformant streams; honored exactly for parity.
        guard_ok = (cur_vals & p1) == 0
        in_eob0 = s["eobrun"] > 0

        # Per-event inner loop.  Phases: 0 = symbol probe, 1 = RUN
        # (zero-run walk with batched corrections), 2 = TAIL (batched
        # corrections to band end).
        def ev_cond(c):
            return jnp.any(c["in"])

        def ev_body(c):
            window = _window32(c["cur"], c["nxt"], c["off"])
            live = c["in"]
            sym_phase = live & (c["phase"] == 0)

            # --- SYM: one probe (unchanged semantics)
            entry = jnp.take(lut, (window >> 16).astype(jnp.int32)
                             ).astype(jnp.int32)
            length = (entry & 31).astype(jnp.uint32)
            sym = (entry >> 5) & 0xFF
            r_s = sym >> 4
            sz = sym & 15
            bad = sym_phase & ((entry == 0) | ((sz != 0) & (sz != 1)))
            is_eobrun = (sz == 0) & (r_s < 15)
            ebits = jnp.where(
                r_s == 0, jnp.uint32(0),
                (window << length)
                >> (32 - jnp.maximum(r_s, 1).astype(jnp.uint32)))
            new_eob = (1 << r_s) + jnp.where(
                r_s > 0, ebits, 0).astype(jnp.int32)
            nv_bit = (window << length) >> 31
            newval_s = jnp.where(sz == 1,
                                 jnp.where(nv_bit == 1, p1, -p1), 0)
            sym_adv = length + jnp.where(
                is_eobrun, r_s.astype(jnp.uint32),
                jnp.where(sz == 1, jnp.uint32(1), jnp.uint32(0)))

            # --- RUN / TAIL: batched correction distribution
            pos_phase = live & (c["phase"] != 0)
            is_run = c["phase"] == 1
            valid = (lane64 >= c["k"][:, None]) & (lane64 <= se)
            nzv = valid & hist_nz
            zv = valid & ~hist_nz
            zrank = jnp.cumsum(zv.astype(jnp.int32), axis=1)
            # RUN stop: the (r+1)-th zero-history position (newval site).
            stop = zv & (zrank == (c["r"] + 1)[:, None]) & is_run[:, None]
            has_stop = stop.any(axis=1)
            p_stop = jnp.min(jnp.where(stop, lane64, 64), axis=1)
            # Correctable positions this phase: nonzero-history, before
            # the stop (RUN) or to band end (TAIL).
            lim = jnp.where(is_run & has_stop, p_stop, 64)
            crossed = nzv & (lane64 < lim[:, None])
            crank = jnp.cumsum(crossed.astype(jnp.int32), axis=1) \
                - crossed.astype(jnp.int32)           # 0-based ranks
            n_cross = jnp.sum(crossed.astype(jnp.int32), axis=1)
            take_n = jnp.minimum(n_cross, CAP)
            use = crossed & (crank < take_n[:, None])
            bit = (window[:, None]
                   >> (31 - jnp.minimum(crank, 31)).astype(jnp.uint32)) & 1
            do_corr = pos_phase[:, None] & use & (bit == 1) & guard_ok
            delta = jnp.where(do_corr, corr_step, 0)
            partial = n_cross > CAP
            # Partial chunk: resume after the CAP-th correction.
            j_cut = jnp.min(jnp.where(
                crossed & (crank == (take_n - 1)[:, None]), lane64, 64),
                axis=1)
            k_resume = jnp.minimum(j_cut + 1, 64)
            zeros_used = jnp.sum(
                (zv & (lane64 <= j_cut[:, None])).astype(jnp.int32),
                axis=1)
            # Full chunk outcomes.
            place = is_run & has_stop & (c["newval"] != 0)
            delta = delta + jnp.where(
                (pos_phase & place & ~partial)[:, None]
                & (lane64 == p_stop[:, None]),
                c["newval"][:, None], 0)
            k_full = jnp.where(is_run & has_stop, p_stop + 1, 65)
            acc = c["acc"] + jnp.where(pos_phase[:, None], delta, 0)

            # --- state transitions
            phase = c["phase"]
            k = c["k"]
            r = c["r"]
            nv = c["newval"]
            eob = c["eob"]
            # SYM outcomes
            phase = jnp.where(sym_phase,
                              jnp.where(is_eobrun, 2, 1), phase)
            eob = jnp.where(sym_phase & is_eobrun, new_eob, eob)
            r = jnp.where(sym_phase & ~is_eobrun, r_s, r)
            nv = jnp.where(sym_phase & ~is_eobrun, newval_s, nv)
            # RUN/TAIL outcomes
            k = jnp.where(pos_phase,
                          jnp.where(partial, k_resume, k_full), k)
            r = jnp.where(pos_phase & is_run & partial,
                          r - zeros_used, r)
            phase = jnp.where(pos_phase & ~partial & is_run & has_stop,
                              0, phase)
            blk_done = pos_phase & ~partial & (
                (is_run & (~has_stop | (k_full > se)))
                | (~is_run))
            in_next = live & ~bad & ~blk_done & ~(
                sym_phase & jnp.zeros_like(bad))
            in_next = in_next & ~(pos_phase & ~partial & is_run
                                  & has_stop & (p_stop + 1 > se))

            adv = jnp.where(sym_phase, sym_adv,
                            take_n.astype(jnp.uint32))
            adv = jnp.where(live & ~bad, adv, 0)
            offp = c["off"] + adv
            need = offp >= 32
            loaded = jnp.take(words, jnp.minimum(c["w_idx"], n_words - 1))
            return dict(
                cur=jnp.where(need, c["nxt"], c["cur"]),
                nxt=jnp.where(need, loaded, c["nxt"]),
                off=offp - jnp.where(need, 32, 0).astype(jnp.uint32),
                w_idx=c["w_idx"] + need,
                phase=phase, k=k, r=r, newval=nv, eob=eob, acc=acc,
                err=c["err"] | bad, **{"in": in_next})

        ev0 = dict(cur=s["cur"], nxt=s["nxt"], off=s["off"],
                   w_idx=s["w_idx"],
                   phase=jnp.where(in_eob0, 2, 0).astype(jnp.int32),
                   k=jnp.full((S,), ss, jnp.int32),
                   r=jnp.zeros((S,), jnp.int32),
                   newval=jnp.zeros((S,), jnp.int32),
                   eob=jnp.zeros((S,), jnp.int32),
                   acc=jnp.zeros((S, 64), jnp.int32),
                   err=s["err"])
        ev0["in"] = active
        ev = jax.lax.while_loop(ev_cond, ev_body, ev0)

        eobrun = jnp.where(
            active,
            jnp.where(in_eob0, s["eobrun"] - 1,
                      jnp.maximum(ev["eob"] - 1, 0)),
            s["eobrun"])
        out = jax.lax.dynamic_update_slice(s["out"], ev["acc"][None],
                                           (b, 0, 0))
        return dict(
            cur=ev["cur"], nxt=ev["nxt"], off=ev["off"], w_idx=ev["w_idx"],
            b=b + 1, eobrun=eobrun, out=out, err=ev["err"])

    s = jax.lax.while_loop(cond, body, state)
    out = jnp.take(s["out"].transpose(1, 0, 2), jnp.asarray(ZIGZAG_INV),
                   axis=2)
    return out, s["err"]


@functools.partial(
    jax.jit, static_argnames=("T", "ss", "se", "al", "n_blocks"))
def decode_ac_refine_emit(words, base_bits, nblocks, eobrun0, mcu_first,
                          lut, zz_rows, np0, *, T: int, ss: int,
                          se: int, al: int, n_blocks: int):
    """Emission-style AC refinement (T.81 G.2.3): ONE flat event loop.

    The lockstep refine kernel (decode_ac_refine) iterates block slots in
    unison, paying sum-over-slots of the max-over-lanes per-block event
    count (measured 2.6-4.4x the balanced ideal on the 12 MP corpus
    sample).  Here every lane advances through its OWN event stream —
    one lax.scan step per event — and the trip count is the max lane
    total, which event-balanced lane boundaries push to ~the mean.

    An EVENT is one of:
      * SYM: decode one symbol (EOB-run / ZRL / coefficient) AND
        distribute up to ``32 - symbol_bits`` correction bits of the
        phase it opens (merged rule — most blocks cost ~#symbols
        events);
      * RUN/TAIL continuation: distribute up to 32 more correction bits
        toward the pending zero-run stop / band end.
    EOB-run-covered blocks cost ceil(n_corrections / 32) events; covered
    blocks with NO nonzero-history band positions are skipped for free
    via ``nextp`` (next processable block in flat block space, computed
    from the scan-start plane).  The native skeleton counts events per
    block with the SAME rule (jd_prog_skeleton_ac, ABI 19), so the event
    schedule is host-predictable: the caller gathers each block's delta
    from the emitted per-event accumulator at its precomputed block-done
    step (see _refine_emit_apply) — no per-lane scatters anywhere.

    Args:
      words: (N,) uint32 big-endian word pool (whole scan, shared).
      base_bits / nblocks / eobrun0 / mcu_first: (S,) lane tables —
        absolute start bit, block count, pending EOB run entering the
        lane, and the lane's first block in flat (row-major unpadded)
        block space.
      lut: (65536,) uint16 AC table.
      zz_rows: (n_blocks + 1, 64) int32 — scan-start coefficient rows
        in ZIGZAG order, ordered by FLAT block index (row m == block m;
        the caller pre-gathers the component plane into this order),
        last row zeros.  History decides bit consumption.  COLUMN 0
        (the DC slot — never read by an AC band, ss >= 1) carries
        nextp[m + 1]: the next flat block index > m with nonzero band
        history (n_blocks if none), so the block-advance skip needs no
        extra per-event gather.
      np0: (S,) int32 — nextp at each lane's first block (inclusive),
        for the lane-entry skip.

    Returns (acc_ys (T, S, 64) int32 per-event accumulator snapshots in
    ZIGZAG order, err (S,) bool, end_blk (S,) int32).
    Parity: entropy/progressive._ac_refine_scan.
    """
    S = base_bits.shape[0]
    n_words = words.shape[0]
    n_rows_zz = zz_rows.shape[0]
    lane64 = jax.lax.broadcasted_iota(jnp.int32, (S, 64), 1)
    p1 = 1 << al

    w0 = (base_bits >> 5).astype(jnp.int32)
    off0 = (base_bits & 31).astype(jnp.uint32)

    # Lane init replicates the block-advance rule for lanes entering
    # mid-EOB-run: skip straight to the first processable covered block,
    # or past the run when none has corrections.
    eob_end0 = eobrun0.astype(jnp.int32) - 1          # lane-local
    in_run0 = eob_end0 >= 0
    np0l = (np0 - mcu_first).astype(jnp.int32)
    blk0 = jnp.where(in_run0,
                     jnp.where(np0l <= eob_end0, np0l, eob_end0 + 1),
                     0)
    phase0 = jnp.where(in_run0 & (np0l <= eob_end0), 2, 0)

    carry0 = dict(
        cur=jnp.take(words, jnp.minimum(w0, n_words - 1)),
        nxt=jnp.take(words, jnp.minimum(w0 + 1, n_words - 1)),
        off=off0, w_idx=w0 + 2,
        blk=blk0,
        k=jnp.full((S,), ss, jnp.int32),
        phase=phase0.astype(jnp.int32),   # 0 SYM, 1 RUN, 2 TAIL
        r=jnp.zeros((S,), jnp.int32),
        newval=jnp.zeros((S,), jnp.int32),
        eob_end=eob_end0,
        acc=jnp.zeros((S, 64), jnp.int32),
        err=jnp.zeros((S,), jnp.bool_))

    def corr_dist(live, is_run, k, r1, nv1, window, shift, cap,
                  hist_nz, corr_step, guard_ok):
        """Distribute up to ``cap`` correction bits (starting ``shift``
        bits into ``window``) toward the pending zero-run stop (RUN) or
        band end (TAIL).  All outputs are gated on ``live``."""
        valid = (lane64 >= k[:, None]) & (lane64 <= se)
        nzv = valid & hist_nz
        zv = valid & ~hist_nz
        zrank = jnp.cumsum(zv.astype(jnp.int32), axis=1)
        stop = zv & (zrank == (r1 + 1)[:, None]) & is_run[:, None]
        has_stop = stop.any(axis=1)
        p_stop = jnp.min(jnp.where(stop, lane64, 64), axis=1)
        lim = jnp.where(is_run & has_stop, p_stop, 64)
        crossed = nzv & (lane64 < lim[:, None])
        crank = jnp.cumsum(crossed.astype(jnp.int32), axis=1) \
            - crossed.astype(jnp.int32)
        n_cross = jnp.sum(crossed.astype(jnp.int32), axis=1)
        take_n = jnp.clip(jnp.minimum(n_cross, cap), 0, 32)
        use = crossed & (crank < take_n[:, None])
        shifted = window << jnp.minimum(shift, 31)
        bitw = (shifted[:, None]
                >> (31 - jnp.minimum(crank, 31)).astype(jnp.uint32)) & 1
        do_corr = live[:, None] & use & (bitw == 1) & guard_ok
        delta = jnp.where(do_corr, corr_step, 0)
        partial = live & (n_cross > cap)
        j_cut = jnp.min(jnp.where(
            crossed & (crank == (take_n - 1)[:, None]), lane64, 64),
            axis=1)
        k_resume = jnp.where(take_n > 0, jnp.minimum(j_cut + 1, 64), k)
        zeros_used = jnp.where(
            take_n > 0,
            jnp.sum((zv & (lane64 <= j_cut[:, None])).astype(jnp.int32),
                    axis=1), 0)
        place = is_run & has_stop & (nv1 != 0)
        delta = delta + jnp.where(
            (live & place & ~partial)[:, None]
            & (lane64 == p_stop[:, None]),
            nv1[:, None], 0)
        k_full = jnp.where(is_run & has_stop, p_stop + 1, 65)
        k2 = jnp.where(live, jnp.where(partial, k_resume, k_full), k)
        r2 = jnp.where(live & is_run & partial, r1 - zeros_used, r1)
        blk_done = live & ~partial & ((~is_run) | (k_full > se))
        complete = live & ~partial & is_run & has_stop & (k_full <= se)
        return dict(delta=delta, partial=partial, k=k2, r=r2,
                    take_n=take_n, blk_done=blk_done, complete=complete)

    def sym_fields(window, live):
        """One refine symbol probe from the window top."""
        entry = jnp.take(lut, (window >> 16).astype(jnp.int32)
                         ).astype(jnp.int32)
        length = (entry & 31).astype(jnp.uint32)
        sym = (entry >> 5) & 0xFF
        r_s = sym >> 4
        sz = sym & 15
        bad = live & ((entry == 0) | ((sz != 0) & (sz != 1)))
        is_eobr = (sz == 0) & (r_s < 15)
        ebits = jnp.where(
            r_s == 0, jnp.uint32(0),
            (window << length)
            >> (32 - jnp.maximum(r_s, 1).astype(jnp.uint32)))
        n_eob = (1 << r_s) + jnp.where(r_s > 0, ebits, 0).astype(jnp.int32)
        nv_bit = (window << length) >> 31
        newval = jnp.where(sz == 1, jnp.where(nv_bit == 1, p1, -p1), 0)
        ok = live & ~bad
        symbits = jnp.where(
            ok,
            length + jnp.where(is_eobr, r_s.astype(jnp.uint32),
                               sz.astype(jnp.uint32)),
            jnp.uint32(0))
        return dict(bad=bad, ok=ok, is_eobr=is_eobr, n_eob=n_eob,
                    newval=newval, symbits=symbits, r=r_s)

    def step(c, _):
        active = ~c["err"] & (c["blk"] < nblocks)
        m = jnp.clip(c["blk"] + mcu_first, 0, n_rows_zz - 2)
        cur_vals = jnp.take(zz_rows, m, axis=0)        # (S, 64) zigzag
        hist_nz = cur_vals != 0
        corr_step = jnp.where(cur_vals > 0, p1, -p1)
        guard_ok = (cur_vals & p1) == 0
        window = _window32(c["cur"], c["nxt"], c["off"])

        # --- phase A: SYM probe (phase 0 lanes) merged with corrections
        needsym = active & (c["phase"] == 0)
        A = sym_fields(window, needsym)
        sym_ok = A["ok"]
        phase1 = jnp.where(sym_ok, jnp.where(A["is_eobr"], 2, 1),
                           c["phase"])
        r1 = jnp.where(sym_ok & ~A["is_eobr"], A["r"], c["r"])
        nv1 = jnp.where(sym_ok & ~A["is_eobr"], A["newval"], c["newval"])
        eob_end1 = jnp.where(sym_ok & A["is_eobr"],
                             c["blk"] + A["n_eob"] - 1, c["eob_end"])
        corr_live = active & ~A["bad"]
        is_runA = phase1 == 1
        capA = (32 - A["symbits"]).astype(jnp.int32)
        rA = corr_dist(corr_live, is_runA, c["k"], r1, nv1, window,
                       A["symbits"], capA, hist_nz, corr_step, guard_ok)
        consumedA = A["symbits"] + rA["take_n"].astype(jnp.uint32)

        # --- phase B: greedy symbol pairing (mirror of the skeleton's
        # phase_ev automaton, ABI 21): when A's event opened with a
        # symbol, completed its run inside the band and consumed <= 16
        # bits, a SECOND symbol decodes from the same window, its
        # corrections capped at the remaining bits.
        pairB = sym_ok & rA["complete"] & (consumedA <= 16)
        windowB = window << jnp.minimum(consumedA, 31)
        B = sym_fields(windowB, pairB)
        fitB = pairB & ~B["bad"] & (consumedA + B["symbits"] <= 32)
        is_runB = fitB & ~B["is_eobr"]
        rB1 = jnp.where(is_runB, B["r"], 0)
        nvB = jnp.where(is_runB, B["newval"], 0)
        capB = jnp.clip(
            32 - (consumedA + B["symbits"]).astype(jnp.int32), 0, 32)
        rB = corr_dist(fitB, is_runB, rA["k"], rB1, nvB, windowB,
                       B["symbits"], capB, hist_nz, corr_step, guard_ok)

        acc1 = c["acc"] + rA["delta"] + rB["delta"]

        # --- state merge (B outcomes override A's where B consumed)
        phase2 = jnp.where(corr_live & rA["complete"], 0, phase1)
        phase2 = jnp.where(fitB, jnp.where(B["is_eobr"], 2, 1), phase2)
        phase2 = jnp.where(fitB & rB["complete"], 0, phase2)
        k2 = jnp.where(fitB, rB["k"], rA["k"])
        r2 = jnp.where(fitB, jnp.where(B["is_eobr"], rA["r"], rB["r"]),
                       rA["r"])
        nv2 = jnp.where(fitB & ~B["is_eobr"], B["newval"], nv1)
        eob_end2 = jnp.where(fitB & B["is_eobr"],
                             c["blk"] + B["n_eob"] - 1, eob_end1)
        blk_done = rA["blk_done"] | (fitB & rB["blk_done"])

        # --- block advance (with free skip of zero-correction covered
        # blocks; matches the skeleton's zero-event accounting)
        nxt_b = c["blk"] + 1
        covered = eob_end2 >= nxt_b
        # nextp[m + 1] rides column 0 of the current block's row (the DC
        # slot an AC band never reads) — no extra gather.
        np_rel = cur_vals[:, 0] - mcu_first
        jump_tail = covered & (np_rel <= eob_end2)
        cand = jnp.where(covered,
                         jnp.where(jump_tail, np_rel, eob_end2 + 1),
                         nxt_b)
        blk2 = jnp.where(blk_done, cand, c["blk"])
        phase3 = jnp.where(blk_done,
                           jnp.where(jump_tail, 2, 0), phase2)
        k3 = jnp.where(blk_done, ss, k2)
        acc2 = jnp.where(blk_done[:, None], 0, acc1)

        adv = jnp.where(corr_live, consumedA, 0) + jnp.where(
            fitB, B["symbits"] + rB["take_n"].astype(jnp.uint32), 0)
        offp = c["off"] + adv
        need = offp >= 32
        loaded = jnp.take(words, jnp.minimum(c["w_idx"], n_words - 1))
        carry = dict(
            cur=jnp.where(need, c["nxt"], c["cur"]),
            nxt=jnp.where(need, loaded, c["nxt"]),
            off=offp - jnp.where(need, 32, 0).astype(jnp.uint32),
            w_idx=c["w_idx"] + need,
            blk=blk2, k=k3, phase=phase3, r=r2, newval=nv2,
            eob_end=eob_end2, acc=acc2,
            err=c["err"] | A["bad"] | B["bad"])
        # int16 ys halve the (T, S, 64) emission buffer: per band
        # position a scan applies at most one +-(1 << al) correction or
        # newval, and al <= 13, so |acc| <= 8192 always fits.
        return carry, acc1.astype(jnp.int16)

    end, acc_ys = jax.lax.scan(step, carry0, None, length=T)
    err = end["err"] | (end["blk"] < nblocks)
    return acc_ys, err, end["blk"]


@functools.partial(jax.jit, static_argnames=("T", "ss", "se", "al"))
def decode_ac_first_emit(words, base_bits, nblocks, eobrun0, lut, *,
                         T: int, ss: int, se: int, al: int):
    """Emission-style AC-first scan: one symbol per step, and an EOB run
    advances the block counter in ONE step (the lockstep form iterates
    every skipped block slot and pays the max-over-lanes slot skew).
    ``T`` must be >= every lane's total symbol count (the AC skeleton
    counts it exactly; EOB-skipped blocks count zero).

    Returns (pos (T, S) int32 — lane-local ``blk * 64 + natural_index``
    or -1, val (T, S) int32 already ``<< al``, err (S,) bool,
    n_done (S,) int32).  Parity: entropy/progressive._ac_first_scan.
    """
    S = base_bits.shape[0]
    n_words = words.shape[0]
    zig = jnp.asarray(ZIGZAG.astype(np.int32))

    w0 = (base_bits >> 5).astype(jnp.int32)
    off0 = (base_bits & 31).astype(jnp.uint32)
    carry0 = dict(
        cur=jnp.take(words, jnp.minimum(w0, n_words - 1)),
        nxt=jnp.take(words, jnp.minimum(w0 + 1, n_words - 1)),
        off=off0, w_idx=w0 + 2,
        blk=jnp.minimum(eobrun0.astype(jnp.int32), nblocks),
        k=jnp.full((S,), ss, jnp.int32),
        err=jnp.zeros((S,), jnp.bool_))

    def step(c, _):
        active = ~c["err"] & (c["blk"] < nblocks)
        window = _window32(c["cur"], c["nxt"], c["off"])
        entry = jnp.take(lut, (window >> 16).astype(jnp.int32)
                         ).astype(jnp.int32)
        length = (entry & 31).astype(jnp.uint32)
        sym = (entry >> 5) & 0xFF
        bad = (entry == 0) & active
        r = sym >> 4
        sz = (sym & 15).astype(jnp.uint32)
        is_eob = (sz == 0) & (r < 15)
        ebits = jnp.where(
            r == 0, jnp.uint32(0),
            (window << length)
            >> (32 - jnp.maximum(r, 1).astype(jnp.uint32)))
        n_eob = (1 << r) - 1 + jnp.where(r > 0, ebits, 0).astype(
            jnp.int32)
        wpos = c["k"] + r
        overflow = (~is_eob) & (sz > 0) & (wpos > se)
        bad = bad | (overflow & active)
        szc = jnp.minimum(sz, 16)
        raw = jnp.where(
            szc == 0, jnp.uint32(0),
            (window << length) >> (32 - jnp.maximum(szc, 1)))
        val = _extend(raw, szc.astype(jnp.int32)) << al
        live = active & ~bad
        do_write = live & ~is_eob & (sz > 0)
        nat = jnp.take(zig, jnp.clip(wpos, 0, 63))
        pos = jnp.where(do_write, c["blk"] * 64 + nat, -1)

        k1 = jnp.where(is_eob, ss,
                       jnp.where(sz > 0, wpos + 1, c["k"] + 16))
        blk_in = jnp.where(is_eob, c["blk"] + 1 + n_eob, c["blk"])
        end_blk = live & ~is_eob & (k1 > se)
        blk = jnp.where(live, blk_in + end_blk, c["blk"])
        k = jnp.where(live, jnp.where(end_blk | is_eob, ss, k1), c["k"])

        adv = jnp.where(
            live,
            length + jnp.where(is_eob, r.astype(jnp.uint32), szc), 0)
        offp = c["off"] + adv
        need = offp >= 32
        loaded = jnp.take(words, jnp.minimum(c["w_idx"], n_words - 1))
        carry = dict(
            cur=jnp.where(need, c["nxt"], c["cur"]),
            nxt=jnp.where(need, loaded, c["nxt"]),
            off=offp - jnp.where(need, 32, 0).astype(jnp.uint32),
            w_idx=c["w_idx"] + need, blk=blk, k=k,
            err=c["err"] | bad)
        return carry, (pos, jnp.where(do_write, val, 0))

    end, (pos, val) = jax.lax.scan(step, carry0, None, length=T)
    return pos, val, end["err"], jnp.minimum(end["blk"], nblocks)


# ---------------------------------------------------------------------------
# Emission-refine application + event-balanced lanes
# ---------------------------------------------------------------------------

def _balanced_lane_edges(weights: np.ndarray, S: int) -> np.ndarray:
    """Lane boundaries (S + 1 edges over flat block space) equalizing
    per-lane weight sums — per-block emission event counts from the
    native skeleton.  Pushes the emission kernels' trip count (max lane
    sum) to ~the mean instead of the uniform-stride max (measured
    1.3-2.9x on the corpus progressive samples)."""
    n = len(weights)
    cum = np.cumsum(weights.astype(np.int64))
    total = int(cum[-1]) if n else 0
    tgt = (np.arange(1, S, dtype=np.int64) * total) // S
    inner = np.searchsorted(cum, tgt, side="left")
    edges = np.concatenate([[0], inner, [n]])
    return np.maximum.accumulate(edges)


def _lane_weight_max(weights: np.ndarray, edges: np.ndarray) -> int:
    cum = np.concatenate([[0], np.cumsum(weights.astype(np.int64))])
    sums = cum[edges[1:]] - cum[edges[:-1]]
    return int(sums.max()) if len(sums) else 0


def _refine_emit_prep(plane, *, ss, se, cols_u, plane_cols, n_blocks):
    """Replicated precompute for the emission refine scan: the
    scan-start history in flat block order and the next-processable
    table.  Returns (zz_m (n_blocks + 1, 64) int32 zigzag rows with
    nextp[m + 1] stuffed into the unread DC column — see
    decode_ac_refine_emit, nextp (n_blocks + 1,) int32)."""
    m_all = jnp.arange(n_blocks, dtype=jnp.int32)
    rows_m = (m_all // cols_u) * plane_cols + (m_all % cols_u)
    zz = jnp.take(plane, jnp.asarray(ZIGZAG), axis=1)
    zz_m = jnp.concatenate(
        [jnp.take(zz, rows_m, axis=0), jnp.zeros((1, 64), jnp.int32)])
    band_nz = jnp.any(zz_m[:-1, ss:se + 1] != 0, axis=1)
    idx = jnp.where(band_nz, m_all, n_blocks)
    nextp = jnp.flip(
        jax.lax.associative_scan(jnp.minimum, jnp.flip(idx)))
    nextp = jnp.concatenate(
        [nextp, jnp.full((2,), n_blocks, jnp.int32)])
    zz_m = zz_m.at[:, 0].set(nextp[1:])
    return zz_m, nextp


def _refine_emit_core(words, base_bits, n_per, eobrun0, mcu_first, lut,
                      ev, zz_m, nextp, *, T, max_blocks, ss, se, al,
                      cols_u, plane_cols, n_rows1):
    """Traced body of one emission refine scan: returns (partial
    (n_rows1, 64) natural-order delta plane to ADD, err (S,)).

    The partial-accumulator form keeps the mesh path trivial (lanes
    shard, partials psum).  ``ev``: (n_blocks,) per-block event counts
    (uint8/int32, skeleton ABI 19) — the deterministic schedule that
    maps every block to its block-done step in the emitted accumulator
    stream.
    """
    S = base_bits.shape[0]
    n_rows = n_rows1 - 1
    n_blocks = ev.shape[0]

    np0 = jnp.take(nextp, jnp.clip(mcu_first, 0, n_blocks))
    acc_ys, err, _blk = decode_ac_refine_emit(
        words, base_bits, n_per, eobrun0, mcu_first, lut, zz_m, np0,
        T=T, ss=ss, se=se, al=al, n_blocks=n_blocks)

    evi = ev.astype(jnp.int32)
    cum = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(evi)])
    slot = jax.lax.broadcasted_iota(jnp.int32, (S, max_blocks), 1)
    m = mcu_first[:, None] + slot
    m_c = jnp.clip(m, 0, n_blocks - 1)
    t_done = (jnp.take(cum, m_c + 1)
              - jnp.take(cum, jnp.clip(mcu_first, 0, n_blocks))[:, None]
              - 1)
    has = (jnp.take(evi, m_c) > 0) & (slot < n_per[:, None])
    ys_s = acc_ys.transpose(1, 0, 2)          # (S, T, 64) int16
    delta = jnp.take_along_axis(
        ys_s, jnp.clip(t_done, 0, T - 1)[:, :, None], axis=1
    ).astype(jnp.int32)
    delta = jnp.where(has[:, :, None], delta, 0)
    delta = jnp.take(delta, jnp.asarray(ZIGZAG_INV), axis=2)
    rows_tgt = jnp.where(
        slot < n_per[:, None],
        (m_c // cols_u) * plane_cols + (m_c % cols_u), n_rows)
    part = jnp.zeros((n_rows1, 64), jnp.int32).at[
        rows_tgt.reshape(-1)].add(delta.reshape(-1, 64), mode="drop")
    return part, err


def _ac_rows_device(mcu_first, n_per, *, cols_u, plane_cols, n_rows,
                    max_blocks):
    """(S, max_blocks) int32 plane-row targets of a single-component AC
    scan — the on-device closed form of _ac_slot_map (no multi-MB host
    tgt upload over the H2D link)."""
    slot = jax.lax.broadcasted_iota(jnp.int32, (mcu_first.shape[0],
                                                max_blocks), 1)
    m = mcu_first[:, None] + slot
    tgt = (m // cols_u) * plane_cols + (m % cols_u)
    return jnp.where(slot < n_per[:, None], tgt, n_rows)


def _dc_rows_device(mcu_first, n_per, *, geom, max_blocks):
    """Per-component (ci, (S, max_blocks) int32 row targets) of a DC
    scan — the on-device closed form of _dc_slot_map.

    ``geom``: ("single", ci, cols_u, plane_cols, n_rows) or
    ("il", mcus_x, j_ci, j_v, j_h, ((ci, v, h, plane_cols, n_rows), ...))
    with j_* the per-within-MCU-block component/v/h tuples.
    """
    S = mcu_first.shape[0]
    slot = jax.lax.broadcasted_iota(jnp.int32, (S, max_blocks), 1)
    if geom[0] == "single":
        _tag, ci, cols_u, plane_cols, n_rows = geom
        m = mcu_first[:, None] + slot
        tgt = (m // cols_u) * plane_cols + (m % cols_u)
        return [(ci, jnp.where(slot < n_per[:, None], tgt, n_rows))]
    _tag, mcus_x, j_ci, j_v, j_h, comps_geo = geom
    bpm = len(j_ci)
    t = slot // bpm
    j = slot % bpm
    m = mcu_first[:, None] + t
    my = m // mcus_x
    mx = m % mcus_x
    jci = jnp.take(jnp.asarray(np.asarray(j_ci, np.int32)), j)
    jv = jnp.take(jnp.asarray(np.asarray(j_v, np.int32)), j)
    jh = jnp.take(jnp.asarray(np.asarray(j_h, np.int32)), j)
    out = []
    for ci, v, h, plane_cols, n_rows in comps_geo:
        tgt = (my * v + jv) * plane_cols + (mx * h + jh)
        mine = (jci == ci) & (slot < (n_per * bpm)[:, None])
        out.append((ci, jnp.where(mine, tgt, n_rows)))
    return out


# ---------------------------------------------------------------------------
# Scan application + whole-frame orchestration
# ---------------------------------------------------------------------------

def _dc_slot_map(hdr, scan, mcu_first, n_per, max_blocks):
    """Per-(lane, slot) plane-row targets for a DC scan.

    Returns ``[(ci, row_tgt (S, max_blocks) int64)]`` per frame component
    in the scan — rows index the component's flat (rows*cols,) block
    grid; out-of-range marks slots belonging to other components or lane
    padding (dropped by the scatter)."""
    comps = hdr.components
    S = len(mcu_first)
    interleaved = len(scan.comp_indices) > 1
    slot = np.arange(max_blocks, dtype=np.int64)[None, :]
    mcu_of = mcu_first[:, None]  # (S, 1)
    out = []
    if not interleaved:
        ci = scan.comp_indices[0]
        rows_u, cols_u = comp_dims_unpadded(hdr, ci)
        plane_cols = hdr.mcus_x * comps[ci].h
        m = mcu_of + slot
        r, c = m // cols_u, m % cols_u
        tgt = r * plane_cols + c
        n_rows = (hdr.mcus_y * comps[ci].v) * plane_cols
        tgt = np.where(slot < n_per[:, None], tgt, n_rows)
        return [(ci, tgt)]
    # Interleaved: slot = t * bpm + j; j -> (ci, v, h) in scan order.
    blocks = [(ci, v, h)
              for ci in scan.comp_indices
              for v in range(comps[ci].v) for h in range(comps[ci].h)]
    bpm = len(blocks)
    t = slot // bpm
    j = slot % bpm
    m = mcu_of + t
    my, mx = m // hdr.mcus_x, m % hdr.mcus_x
    j_ci = np.array([b[0] for b in blocks])
    j_v = np.array([b[1] for b in blocks])
    j_h = np.array([b[2] for b in blocks])
    for ci in sorted(set(scan.comp_indices)):
        c = comps[ci]
        plane_cols = hdr.mcus_x * c.h
        n_rows = (hdr.mcus_y * c.v) * plane_cols
        row = my * c.v + j_v[j]
        col = mx * c.h + j_h[j]
        tgt = row * plane_cols + col
        mine = (j_ci[j] == ci) & (slot < (n_per * bpm)[:, None])
        out.append((ci, np.where(mine, tgt, n_rows)))
    return out


def _ac_slot_map(hdr, scan, mcu_first, n_per, max_blocks):
    """(S, max_blocks) plane-row targets for a single-component AC scan."""
    ci = scan.comp_indices[0]
    c = hdr.components[ci]
    rows_u, cols_u = comp_dims_unpadded(hdr, ci)
    plane_cols = hdr.mcus_x * c.h
    n_rows = (hdr.mcus_y * c.v) * plane_cols
    slot = np.arange(max_blocks, dtype=np.int64)[None, :]
    m = mcu_first[:, None] + slot
    tgt = (m // cols_u) * plane_cols + (m % cols_u)
    return ci, np.where(slot < n_per[:, None], tgt, n_rows), n_rows


def _scan_block_comp(hdr, scan):
    if len(scan.comp_indices) == 1:
        return (0,)
    return tuple(
        k for k, ci in enumerate(scan.comp_indices)
        for _ in range(hdr.components[ci].v * hdr.components[ci].h))


# JD_PROG_TRACE=1 appends ("prep"/"dispatch", [scan kinds], ms) tuples
# here from decode_progressive_hybrid — in-process phase attribution for
# the perf tools.
PROG_TRACE: list = []


class _MeshHolder:
    """Hashable Mesh wrapper for jit static args (mirror of
    parallel.sharded._MeshHolder; duplicated to avoid a circular
    import)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __hash__(self):
        return hash((tuple(self.mesh.shape.items()),
                     tuple(d.id for d in self.mesh.devices.flat)))

    def __eq__(self, other):
        return (isinstance(other, _MeshHolder)
                and self.mesh.shape == other.mesh.shape
                and [d.id for d in self.mesh.devices.flat]
                == [d.id for d in other.mesh.devices.flat])


def _emit_global_scatter(plane, pos, val, tgt, max_blocks):
    """Scatter emission-kernel (pos, val) pairs into the flat plane:
    lane-local ``blk * 64 + nat`` maps to plane row ``tgt[lane, blk]``.
    Out-of-range blk (EOB runs past the lane) and pos = -1 drop."""
    S = tgt.shape[0]
    n_total = plane.shape[0] * 64
    blk = pos >> 6
    nat = pos & 63
    lane = jax.lax.broadcasted_iota(jnp.int32, pos.shape, pos.ndim - 1)
    row = jnp.take(tgt.reshape(-1),
                   jnp.clip(lane * max_blocks + blk, 0,
                            S * max_blocks - 1))
    gpos = jnp.where((pos >= 0) & (blk < max_blocks),
                     row * 64 + nat, n_total)
    flat = plane.reshape(-1).at[gpos.reshape(-1)].add(
        val.reshape(-1), mode="drop")
    return flat.reshape(plane.shape)


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "max_blocks", "al", "first"),
    donate_argnums=(0,))
def _apply_dc_scan(planes_t, words, base_bits, nblocks, pred0, luts2d,
                   tgts_t, *, block_comp, max_blocks, al, first):
    """ONE device program per DC scan — thin wrapper over _chain_step
    (the chain-fused path traces many scans into one program)."""
    planes = list(planes_t)
    m = ("dc", block_comp, max_blocks, al, first,
         tuple(range(len(planes_t))))
    planes, err = _chain_step(
        planes, m, (words, base_bits, nblocks, pred0, luts2d, tgts_t),
        None)
    return tuple(planes), err


@functools.partial(
    jax.jit,
    static_argnames=("block_comp", "max_blocks", "al", "first",
                     "mesh_holder"),
    donate_argnums=(0,))
def _apply_dc_scan_mesh(planes_t, words, base_bits, nblocks, pred0,
                        luts2d, tgts_t, *, block_comp, max_blocks, al,
                        first, mesh_holder):
    """Mesh-sharded DC scan (lanes over all mesh axes, psum column
    reduction) — thin wrapper over _chain_step."""
    planes = list(planes_t)
    m = ("dc", block_comp, max_blocks, al, first,
         tuple(range(len(planes_t))))
    planes, err = _chain_step(
        planes, m, (words, base_bits, nblocks, pred0, luts2d, tgts_t),
        mesh_holder.mesh)
    return tuple(planes), err


@functools.partial(
    jax.jit,
    static_argnames=("max_blocks", "ss", "se", "al", "first", "t_sym"),
    donate_argnums=(0,))
def _apply_ac_scan(plane, words, base_bits, nblocks, eobrun0, lut, tgt,
                   *, max_blocks, ss, se, al, first, t_sym=None):
    """ONE device program per AC scan — thin wrapper over _chain_step."""
    m = ("ac", max_blocks, ss, se, al, first, t_sym, 0)
    planes, err = _chain_step(
        [plane], m, (words, base_bits, nblocks, eobrun0, lut, tgt), None)
    return planes[0], err


@functools.partial(
    jax.jit,
    static_argnames=("max_blocks", "ss", "se", "al", "first",
                     "mesh_holder", "t_sym"),
    donate_argnums=(0,))
def _apply_ac_scan_mesh(plane, words, base_bits, nblocks, eobrun0, lut,
                        tgt, *, max_blocks, ss, se, al, first,
                        mesh_holder, t_sym=None):
    """Mesh-sharded AC scan — thin wrapper over _chain_step."""
    m = ("ac", max_blocks, ss, se, al, first, t_sym, 0)
    planes, err = _chain_step(
        [plane], m, (words, base_bits, nblocks, eobrun0, lut, tgt),
        mesh_holder.mesh)
    return planes[0], err


def apply_scan_device(hdr: FrameHeader, scan: ScanHeader, planes,
                      lanes=None, err_sink: list | None = None,
                      mesh=None):
    """Apply ONE progressive scan to device-resident flat planes.

    ``planes``: list of (n_blocks_c + 1, 64) int32 device arrays in
    NATURAL coefficient order (last row is the scatter-drop pad).
    ``lanes``: optional (base_bits, n_per, mcu_first, eobrun0, pred0)
    overriding the restart-segment lane table (the DRI=0 skeleton path).
    ``err_sink``: when given, the per-lane error flags are APPENDED to it
    as a device array instead of being fetched here — callers check once
    per frame (one host sync instead of one per scan; see
    check_errors()).  ``mesh``: optional jax Mesh — lanes then shard
    over ALL mesh axes under shard_map (planes replicated; disjoint
    partial scatters reduce with one psum).  Returns the updated planes;
    without a sink, raises JPEGError when any lane errors.
    """
    comps = hdr.components
    interleaved = len(scan.comp_indices) > 1
    if scan.ss == 0:
        if interleaved:
            n_mcus = hdr.mcus_x * hdr.mcus_y
        else:
            rows_u, cols_u = comp_dims_unpadded(hdr, scan.comp_indices[0])
            n_mcus = rows_u * cols_u
    else:
        if interleaved:
            raise JPEGError("progressive: AC scans must be single-component")
        rows_u, cols_u = comp_dims_unpadded(hdr, scan.comp_indices[0])
        n_mcus = rows_u * cols_u

    t_sym = None
    if lanes is None:
        base_bits, n_per, mcu_first = segment_lanes(scan, n_mcus)
        S = len(base_bits)
        eobrun0 = np.zeros(S, np.int32)
        pred0 = np.zeros((S, len(scan.comp_indices)), np.int32)
    else:
        base_bits, n_per, mcu_first, eobrun0, pred0 = lanes[:5]
        if len(lanes) > 5:
            t_sym = lanes[5]
        S = len(base_bits)
    if mesh is not None:
        # Pad the lane axis to the mesh size (padded lanes decode
        # nothing; their slot targets drop).
        ms = int(np.prod(list(mesh.shape.values())))
        Sp = -(-max(S, 1) // ms) * ms
        if Sp != S:
            pad = Sp - S
            base_bits = np.concatenate([base_bits, np.zeros(pad, np.int64)])
            n_per = np.concatenate([n_per, np.zeros(pad, n_per.dtype)])
            mcu_first = np.concatenate(
                [mcu_first, np.full(pad, 1 << 40, np.int64)])
            eobrun0 = np.concatenate([eobrun0, np.zeros(pad, np.int32)])
            pred0 = np.concatenate(
                [pred0, np.zeros((pad, pred0.shape[1]), np.int32)])
            S = Sp
    words = jnp.asarray(scan_words(scan))
    block_comp = _scan_block_comp(hdr, scan)
    bpm = len(block_comp)
    max_mcus = int(n_per.max()) if len(n_per) else 0

    if scan.ss == 0:
        max_blocks = max_mcus * bpm
        nblocks = (n_per.astype(np.int64) * bpm).astype(np.int32)
        if scan.ah == 0:
            luts2d = jnp.asarray(np.stack([
                build_lut(scan.dc_specs[scan.dc_table_ids[k]])
                for k in range(len(scan.comp_indices))]))
        else:
            luts2d = jnp.zeros((1, 1), jnp.uint16)  # unused in refine
        slot_map = _dc_slot_map(hdr, scan, mcu_first, n_per, max_blocks)
        cis = [ci for ci, _t in slot_map]
        planes_t = tuple(planes[ci] for ci in cis)
        tgts_t = tuple(jnp.asarray(t) for _ci, t in slot_map)
        kw = dict(block_comp=block_comp, max_blocks=max_blocks,
                  al=scan.al, first=scan.ah == 0)
        if mesh is not None:
            out_t, err = _apply_dc_scan_mesh(
                planes_t, words, jnp.asarray(base_bits),
                jnp.asarray(nblocks), jnp.asarray(pred0), luts2d,
                tgts_t, mesh_holder=_MeshHolder(mesh), **kw)
        else:
            out_t, err = _apply_dc_scan(
                planes_t, words, jnp.asarray(base_bits),
                jnp.asarray(nblocks), jnp.asarray(pred0), luts2d,
                tgts_t, **kw)
        for ci, pl in zip(cis, out_t):
            planes[ci] = pl
    else:
        lut = build_lut(scan.ac_specs[scan.ac_table_ids[0]])
        ci, tgt, n_rows = _ac_slot_map(hdr, scan, mcu_first, n_per,
                                       max_mcus)
        kw = dict(max_blocks=max_mcus, ss=scan.ss, se=scan.se,
                  al=scan.al, first=scan.ah == 0, t_sym=t_sym)
        args = (planes[ci], words, jnp.asarray(base_bits),
                jnp.asarray(n_per.astype(np.int32)),
                jnp.asarray(eobrun0), jnp.asarray(lut),
                jnp.asarray(tgt.astype(np.int32)))
        if mesh is not None:
            planes[ci], err = _apply_ac_scan_mesh(
                *args, mesh_holder=_MeshHolder(mesh), **kw)
        else:
            planes[ci], err = _apply_ac_scan(*args, **kw)
    if err_sink is not None:
        err_sink.append(err)
    elif bool(np.asarray(err).any()):
        raise JPEGError(
            f"device progressive scan failed in lanes "
            f"{np.flatnonzero(np.asarray(err))[:8]}")
    return planes


def check_errors(err_sink: list) -> None:
    """Fetch all deferred per-scan error flags with one device sync;
    raises JPEGError naming the first failing scan."""
    if not err_sink:
        return
    flags = np.asarray(jnp.stack([e.any() for e in err_sink]))
    if flags.any():
        raise JPEGError(
            f"device progressive decode failed in scan(s) "
            f"{np.flatnonzero(flags)[:8].tolist()}")


def decode_progressive_device(hdr: FrameHeader, as_device: bool = False,
                              mesh=None, err_sink: list | None = None):
    """Decode ALL scans of a progressive frame with device lane kernels.

    Lanes come from restart segments; a DRI=0 scan runs as one lane
    (callers with the native lib use entropy_spec.decode_progressive_hybrid,
    which feeds skeleton lanes instead).  Output matches
    entropy/progressive.decode_progressive bit-exactly: per-component
    (rows_c, cols_c, 64) int32 planes on the padded dense grid.
    """
    planes = []
    shapes = []
    for ci in range(len(hdr.components)):
        rows = hdr.mcus_y * hdr.components[ci].v
        cols = hdr.mcus_x * hdr.components[ci].h
        shapes.append((rows, cols))
        planes.append(jnp.zeros((rows * cols + 1, 64), jnp.int32))
    errs: list = []
    for scan in hdr.scans:
        planes = apply_scan_device(hdr, scan, planes, err_sink=errs,
                                   mesh=mesh)
    if err_sink is not None:
        err_sink.extend(errs)
    else:
        check_errors(errs)
    out = [p[:-1].reshape(r, c, 64) for p, (r, c) in zip(planes, shapes)]
    if as_device:
        return out
    return [np.asarray(p) for p in out]


def decode_progressive_hybrid(hdr: FrameHeader, as_device: bool = False,
                              target_lanes: int | None = None,
                              mesh=None, err_sink: list | None = None):
    """DRI=0 progressive decode with DEVICE lanes from native skeleton
    scans: the host walks each scan position-only (jd_prog_skeleton_*,
    maintaining per-component nonzero bitmaps so refinement bit
    consumption never needs the coefficient planes), and the device
    kernels decode ~``target_lanes`` parallel lanes per scan from the
    recorded (bit, predictor / EOB-run) states.  All coefficient stores
    happen on device; planes never leave HBM.

    Requires the native lib, 8-bit precision and single-segment scans —
    callers fall back to :func:`decode_progressive_device` (segment
    lanes) otherwise.  Output bit-exact vs entropy/progressive.py.
    """
    import os

    from ..entropy import native

    if hdr.precision != 8:
        raise JPEGError("progressive hybrid path is 8-bit only")
    if any(len(s.seg_offsets) != 2 for s in hdr.scans):
        raise JPEGError(
            "progressive hybrid path requires DRI=0 scans "
            "(restart-segmented scans take segment lanes)")
    if target_lanes is None:
        target_lanes = int(os.environ.get("JD_PROG_LANES", "512"))

    n_comps = len(hdr.components)
    shapes = []
    for ci in range(n_comps):
        rows = hdr.mcus_y * hdr.components[ci].v
        cols = hdr.mcus_x * hdr.components[ci].h
        shapes.append((rows, cols))

    # Scans partition into INDEPENDENT chains writing disjoint
    # coefficient sets — all DC scans (k=0 only) and each component's AC
    # scans (its k>=1 band); refinements depend only on earlier scans of
    # the same chain (see entropy/native._scan_chains).  Each chain runs
    # on its own thread with its OWN zero plane accumulators (skeleton
    # walks release the GIL; jax dispatch is thread-safe), so chain B's
    # host skeletons overlap chain A's device programs; the final merge
    # is one exact add per component (disjoint coefficients).
    chains: dict = {}
    for scan in hdr.scans:
        key = "dc" if scan.ss == 0 else ("ac", scan.comp_indices[0])
        chains.setdefault(key, []).append(scan)

    ms = (int(np.prod(list(mesh.shape.values())))
          if mesh is not None else 1)
    use_emit_refine = os.environ.get("JD_PROG_REFINE", "emit") \
        != "lockstep"

    trace = PROG_TRACE if os.environ.get("JD_PROG_TRACE") else None

    def run_chain(scans):
        # Host half: skeleton walks + lane tables per scan, then fused
        # device programs apply them (per-scan programs paid one link
        # round trip each).  Slot maps are closed forms computed ON
        # DEVICE ("dcd"/"ace"/"acr" kinds) — host-built tgt maps
        # cost up to ~14 MB of host-to-device upload per scan.
        #
        # Chains of >= 3 scans split into TWO programs balanced by scan
        # bytes: the first half's device execution overlaps the second
        # half's (serial, CPU-bound) skeleton walks — on the 12 MP
        # sample the luma chain's prep is ~95 ms of the critical path.
        # JD_PROG_CHAIN_SPLIT=1 restores the single fused program.
        import time as _time

        planes = [jnp.zeros((r * c + 1, 64), jnp.int32)
                  for r, c in shapes]
        nzmaps: dict[int, np.ndarray] = {}
        holder = _MeshHolder(mesh) if mesh is not None else None
        n_split = int(os.environ.get("JD_PROG_CHAIN_SPLIT", "2"))
        if os.environ.get("JD_PROG_FUSE", "1") == "0":
            # Per-scan programs (A/B reference: JD_PROG_FUSE=0).
            errs = []
            for scan in scans:
                m, inp = hybrid_scan_prep(
                    hdr, scan, nzmaps, target_lanes=target_lanes,
                    ms=ms, use_emit_refine=use_emit_refine)
                planes, err = _chain_step(planes, m, inp, mesh)
                errs.append(err)
            return planes, errs
        groups = [scans]
        if n_split > 1 and len(scans) >= 3:
            sizes = np.cumsum([len(s.data) for s in scans])
            k = min(n_split, len(scans))
            cuts = [int(np.searchsorted(sizes, sizes[-1] * j / k)) + 1
                    for j in range(1, k)]
            edges = sorted({min(max(c, 1), len(scans) - 1)
                            for c in cuts})
            edges = [0] + edges + [len(scans)]
            groups = [scans[a:b] for a, b in zip(edges[:-1], edges[1:])
                      if b > a]
        flags_all = []
        for group in groups:
            t0 = _time.perf_counter()
            metas, inputs = [], []
            for scan in group:
                m, inp = hybrid_scan_prep(
                    hdr, scan, nzmaps, target_lanes=target_lanes,
                    ms=ms, use_emit_refine=use_emit_refine)
                metas.append(m)
                inputs.append(inp)
            if trace is not None:
                trace.append(("prep", [m[0] for m in metas],
                              (_time.perf_counter() - t0) * 1e3))
                t0 = _time.perf_counter()
            planes_t, flags = _apply_chain(
                tuple(planes), tuple(inputs), meta=tuple(metas),
                mesh_holder=holder)
            planes = list(planes_t)
            flags_all.append(flags)
            if trace is not None:
                trace.append(("dispatch", [m[0] for m in metas],
                              (_time.perf_counter() - t0) * 1e3))
        return planes, flags_all

    # Largest chain first: on a small-core host the heaviest chain's
    # serial skeleton walks are the critical path — start them before
    # the cheap chroma chains contend for cores.
    chain_list = sorted(chains.values(),
                        key=lambda sc: -sum(len(s.data) for s in sc))
    # Threaded chains are safe only when the programs carry no
    # collectives across devices (no mesh, or a one-device mesh): every
    # device must enqueue collective programs in the same order, across
    # the processes of jax.distributed and the GPUs of one process alike.
    can_thread = len(chain_list) > 1 and (mesh is None or mesh.size == 1)
    if can_thread:
        from concurrent.futures import ThreadPoolExecutor

        # 2 workers (= this box's cores): the heaviest chain's serial
        # skeleton walks should not timeshare with every chroma chain.
        with ThreadPoolExecutor(min(2, len(chain_list))) as ex:
            results = list(ex.map(run_chain, chain_list))
    else:
        results = [run_chain(ch) for ch in chain_list]

    errs = [e for _pl, es in results for e in es]
    if err_sink is not None:
        # Deferred: the caller folds/fetches the flags after its own
        # downstream dispatches — avoids one blocking link round trip
        # between entropy and pixel stages.
        err_sink.extend(errs)
    else:
        check_errors(errs)
    planes = list(results[0][0])
    for pl_t, _es in results[1:]:
        planes = [a + b for a, b in zip(planes, pl_t)]

    out = [p[:-1].reshape(r, c, 64) for p, (r, c) in zip(planes, shapes)]
    if as_device:
        return out
    return [np.asarray(p) for p in out]


def _bucket_trip(t: int) -> int:
    """Eighth-pow2 trip-count bucket: caps trip padding at ~12% (the
    12 MP sample's refine scan measured 2146 events -> 2304 instead of
    the quarter-pow2 2560) while keeping compiled variants O(log)."""
    t = max(16, int(t))
    step = max(16, 1 << max(t.bit_length() - 4, 0))
    return -(-t // step) * step


def _stride_lanes(bits: np.ndarray, stride: int, n_mcus: int, *,
                  preds: np.ndarray | None = None,
                  eobrun: np.ndarray | None = None):
    """Lane table from per-stride skeleton records."""
    L = len(bits)
    n_per = np.full(L, stride, np.int32)
    if L:
        n_per[-1] = n_mcus - stride * (L - 1)
    mcu_first = np.arange(L, dtype=np.int64) * stride
    eob0 = eobrun if eobrun is not None else np.zeros(L, np.int32)
    pred0 = preds if preds is not None else np.zeros((L, 1), np.int32)
    return bits, n_per, mcu_first, eob0, pred0


def _pad_lane_tables(lanes, ms):
    """Pad a (base_bits, n_per, mcu_first, eobrun0, pred0) lane tuple to
    a multiple of the mesh size (padded lanes decode nothing)."""
    base_bits, n_per, mcu_first, eobrun0, pred0 = lanes
    S = len(base_bits)
    Sp = -(-max(S, 1) // ms) * ms
    if Sp != S:
        pad = Sp - S
        base_bits = np.concatenate([base_bits, np.zeros(pad, np.int64)])
        n_per = np.concatenate([n_per, np.zeros(pad, n_per.dtype)])
        mcu_first = np.concatenate(
            [mcu_first, np.zeros(pad, mcu_first.dtype)])
        eobrun0 = np.concatenate([eobrun0, np.zeros(pad, np.int32)])
        pred0 = np.concatenate(
            [pred0, np.zeros((pad, pred0.shape[1]), np.int32)])
    return base_bits, n_per, mcu_first, eobrun0, pred0


def hybrid_scan_prep(hdr: FrameHeader, scan: ScanHeader, nzmaps: dict, *,
                     target_lanes: int, ms: int = 1,
                     use_emit_refine: bool = True):
    """Host half of one hybrid (DRI=0 skeleton-lane) progressive scan:
    native skeleton walk + lane tables + device inputs.  Returns
    (meta, inputs) for :func:`_chain_step`.

    ``nzmaps`` persists each component's per-block band bitmap across
    its AC scan chain.  Slot maps ship as closed-form statics in the
    meta ("dcd"/"ace"/"acr" kinds) and are computed on device.
    """
    from ..entropy import native

    comps = hdr.components
    S_lanes = -(-target_lanes // ms) * ms
    if scan.ss == 0:
        interleaved = len(scan.comp_indices) > 1
        if interleaved:
            n_mcus = hdr.mcus_x * hdr.mcus_y
        else:
            r, c = comp_dims_unpadded(hdr, scan.comp_indices[0])
            n_mcus = r * c
        if scan.ah == 0:
            stride = max(1, -(-n_mcus // target_lanes))
            bits, preds = native.prog_skeleton_dc(hdr, scan, stride)
            lanes = _stride_lanes(bits, stride, n_mcus, preds=preds)
        else:
            lanes = segment_lanes(scan, n_mcus) + (
                np.zeros(1, np.int32),
                np.zeros((1, len(scan.comp_indices)), np.int32))
        base_bits, n_per, mcu_first, eobrun0, pred0 = \
            _pad_lane_tables(lanes, ms)
        block_comp = _scan_block_comp(hdr, scan)
        bpm = len(block_comp)
        max_blocks = int(n_per.max()) * bpm
        nblocks = (n_per.astype(np.int64) * bpm).astype(np.int32)
        if scan.ah == 0:
            luts2d = jnp.asarray(np.stack([
                build_lut(scan.dc_specs[scan.dc_table_ids[k]])
                for k in range(len(scan.comp_indices))]))
        else:
            luts2d = jnp.zeros((1, 1), jnp.uint16)
        if interleaved:
            blocks = [(ci, v, h) for ci in scan.comp_indices
                      for v in range(comps[ci].v)
                      for h in range(comps[ci].h)]
            comps_geo = tuple(
                (ci, comps[ci].v, comps[ci].h, hdr.mcus_x * comps[ci].h,
                 (hdr.mcus_y * comps[ci].v) * (hdr.mcus_x * comps[ci].h))
                for ci in sorted(set(scan.comp_indices)))
            geom = ("il", hdr.mcus_x,
                    tuple(b[0] for b in blocks),
                    tuple(b[1] for b in blocks),
                    tuple(b[2] for b in blocks), comps_geo)
        else:
            ci = scan.comp_indices[0]
            rows_u, cols_u = comp_dims_unpadded(hdr, ci)
            plane_cols = hdr.mcus_x * comps[ci].h
            n_rows = (hdr.mcus_y * comps[ci].v) * plane_cols
            geom = ("single", ci, cols_u, plane_cols, n_rows)
        meta = ("dcd", block_comp, max_blocks, scan.al, scan.ah == 0,
                geom)
        inp = (jnp.asarray(scan_words(scan)), jnp.asarray(base_bits),
               jnp.asarray(nblocks), jnp.asarray(pred0), luts2d,
               jnp.asarray(mcu_first.astype(np.int32)),
               jnp.asarray(n_per.astype(np.int32)))
        return meta, inp

    ci = scan.comp_indices[0]
    r, c = comp_dims_unpadded(hdr, ci)
    n_blocks = r * c
    nzmap = nzmaps.get(ci)
    if nzmap is None:
        nzmap = nzmaps.setdefault(ci, np.zeros(n_blocks, np.uint64))
    plane_cols = hdr.mcus_x * comps[ci].h
    if scan.ah == 0 or use_emit_refine:
        # Emission kinds: per-block weights at stride 1, event-balanced
        # lane boundaries, exact bucketed T.  Boundary weights are
        # clamped to >= 1 so a lane cannot swallow an unbounded run of
        # zero-event blocks (bounds the (S, max_b) slot arrays); T uses
        # the TRUE event sums.
        bits, eob, wts = native.prog_skeleton_ac(
            hdr, scan, 1, nzmap, want_syms=True)
        edges = _balanced_lane_edges(np.maximum(wts, 1), S_lanes)
        base_bits = bits[edges[:-1]]
        eobrun0 = eob[edges[:-1]].astype(np.int32)
        n_per = np.diff(edges).astype(np.int32)
        mcu_first = edges[:-1].astype(np.int32)
        T = _bucket_trip(max(_lane_weight_max(wts, edges), 16))
        max_b = _bucket_trip(max(int(n_per.max()), 1))
        common = (jnp.asarray(scan_words(scan)), jnp.asarray(base_bits),
                  jnp.asarray(n_per), jnp.asarray(eobrun0))
        lut = jnp.asarray(build_lut(scan.ac_specs[scan.ac_table_ids[0]]))
        mcu_first_j = jnp.asarray(mcu_first)
        if scan.ah == 0:
            return (("ace", max_b, scan.ss, scan.se, scan.al, T, ci, c,
                     plane_cols),
                    (*common, lut, mcu_first_j))
        ev = (wts.astype(np.uint8) if wts.max() < 256
              else wts.astype(np.int32))
        return (("acr", max_b, scan.ss, scan.se, scan.al, T, ci, c,
                 plane_cols),
                (*common, mcu_first_j, lut, jnp.asarray(ev)))
    # Legacy lockstep refine (JD_PROG_REFINE=lockstep, the A/B
    # reference path).
    stride = max(1, -(-n_blocks // target_lanes))
    bits, eob = native.prog_skeleton_ac(hdr, scan, stride, nzmap)
    lanes = _stride_lanes(bits, stride, n_blocks, eobrun=eob)
    base_bits, n_per, mcu_first, eobrun0, _p0 = \
        _pad_lane_tables(lanes, ms)
    max_mcus = int(n_per.max())
    ci2, tgt, _n_rows = _ac_slot_map(hdr, scan, mcu_first, n_per,
                                     max_mcus)
    meta = ("ac", max_mcus, scan.ss, scan.se, scan.al, False, None, ci2)
    inp = (jnp.asarray(scan_words(scan)), jnp.asarray(base_bits),
           jnp.asarray(n_per.astype(np.int32)), jnp.asarray(eobrun0),
           jnp.asarray(build_lut(scan.ac_specs[scan.ac_table_ids[0]])),
           jnp.asarray(tgt.astype(np.int32)))
    return meta, inp


def decode_progressive_lanes(hdr: FrameHeader, as_device: bool = False,
                             mesh=None, err_sink: list | None = None):
    """Best available device-lane progressive decode: native skeleton
    lanes when possible, segment lanes otherwise.  With ``mesh``, lanes
    shard over all mesh axes (shard_map + psum plane reduction).

    ``err_sink``: when given, per-scan error flags are APPENDED as
    device arrays instead of being checked here (one host sync saved;
    call :func:`check_errors` on the sink after the downstream
    dispatches)."""
    if hdr.precision != 8:
        # The device DC kernels (and the Python oracle) implement the
        # 8-bit size categories; keep non-8-bit progressive on the host
        # path rather than erroring from the kernels.
        from ..entropy import progressive

        planes = progressive.decode_progressive(hdr)
        if as_device:
            return [jnp.asarray(pl) for pl in planes]
        return planes
    if all(len(s.seg_offsets) == 2 for s in hdr.scans):
        try:
            from ..entropy import native

            if native.available():
                return decode_progressive_hybrid(hdr, as_device=as_device,
                                                 mesh=mesh,
                                                 err_sink=err_sink)
        except ImportError:
            pass
    return decode_progressive_device(hdr, as_device=as_device, mesh=mesh,
                                     err_sink=err_sink)


# ---------------------------------------------------------------------------
# Chain-fused scan application: one device program per independent chain
# ---------------------------------------------------------------------------
#
# Each dispatched program pays a launch and a host round trip that can
# dwarf these kernels, so the hybrid path traces a WHOLE chain's scans
# into one jitted program.


def _chain_step(planes, m, inp, mesh):
    """Apply one scan (traced inline) to the planes list.  ``m`` is the
    static descriptor, ``inp`` the dynamic arrays (see
    decode_progressive_hybrid.run_chain).

    Kinds: "dc"/"ac" carry host-built slot maps (the segment-lane path);
    "dcd"/"ace"/"acr" are the hybrid skeleton-lane forms — slot maps are
    computed ON DEVICE from (mcu_first, n_per) closed forms (host-built
    tgt maps cost up to ~14 MB of upload per scan), and
    "acr" is the emission AC-refine (event-balanced lanes, deterministic
    schedule commit)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axes = tuple(mesh.axis_names) if mesh is not None else ()
    lane = P(axes) if mesh is not None else None
    kind = m[0]
    if kind in ("dc", "dcd"):
        if kind == "dc":
            _, block_comp, max_blocks, al, first, cis = m
            words, base, nblocks, pred0, luts2d, tgts_t = inp
            geom = mcu_first = n_per = None
        else:
            _, block_comp, max_blocks, al, first, geom = m
            words, base, nblocks, pred0, luts2d, mcu_first, n_per = inp
            cis = ((geom[1],) if geom[0] == "single"
                   else tuple(g[0] for g in geom[5]))
            tgts_t = None
        if mesh is None:
            if kind == "dcd":
                tgts_t = tuple(t for _ci, t in _dc_rows_device(
                    mcu_first, n_per, geom=geom, max_blocks=max_blocks))
            if first:
                vals, err = decode_dc_first(
                    words, base, nblocks, pred0, luts2d,
                    block_comp=block_comp, max_blocks=max_blocks, al=al)
            else:
                vals = dc_refine_bits(words, base, nblocks, max_blocks,
                                      al)
                err = jnp.zeros(base.shape, jnp.bool_)
            for ci, tgt in zip(cis, tgts_t):
                planes[ci] = planes[ci].at[tgt.reshape(-1), 0].add(
                    vals.reshape(-1), mode="drop")
            return planes, err
        n_rows_t = tuple(planes[ci].shape[0] for ci in cis)

        def local(words_l, base_l, nb_l, pred_l, luts_l, *rest):
            if kind == "dcd":
                mcu_l, np_l = rest
                tgts_l = [t for _ci, t in _dc_rows_device(
                    mcu_l, np_l, geom=geom, max_blocks=max_blocks)]
            else:
                tgts_l = list(rest)
            if first:
                vals, err = decode_dc_first(
                    words_l, base_l, nb_l, pred_l, luts_l,
                    block_comp=block_comp, max_blocks=max_blocks, al=al)
            else:
                vals = dc_refine_bits(words_l, base_l, nb_l, max_blocks,
                                      al)
                err = jnp.zeros(base_l.shape, jnp.bool_)
            outs = []
            for tgt_l, n_rows in zip(tgts_l, n_rows_t):
                col = jnp.zeros((n_rows,), jnp.int32).at[
                    tgt_l.reshape(-1)].add(vals.reshape(-1), mode="drop")
                outs.append(jax.lax.psum(col, axes))
            return (*outs, err)

        if kind == "dcd":
            rest_in = (mcu_first, n_per)
            rest_specs = (lane, lane)
        else:
            rest_in = tuple(tgts_t)
            rest_specs = tuple([P(axes, None)] * len(tgts_t))
        res = shard_map(
            local, mesh=mesh,
            in_specs=(P(None), lane, lane, P(axes, None), P(None, None),
                      *rest_specs),
            out_specs=(*([P(None)] * len(cis)), lane),
            check_vma=False,
        )(words, base, nblocks, pred0, luts2d, *rest_in)
        cols, err = res[:-1], res[-1]
        for ci, col in zip(cis, cols):
            planes[ci] = planes[ci].at[:, 0].add(col)
        return planes, err

    if kind == "ace":
        _, max_blocks, ss, se, al, T, ci, cols_u, plane_cols = m
        words, base, n_per, eob0, lut, mcu_first = inp
        n_rows1 = planes[ci].shape[0]
        if mesh is None:
            pos, val, err, _nd = decode_ac_first_emit(
                words, base, n_per, eob0, lut, T=T, ss=ss, se=se, al=al)
            tgt = _ac_rows_device(
                mcu_first, n_per, cols_u=cols_u, plane_cols=plane_cols,
                n_rows=n_rows1 - 1, max_blocks=max_blocks)
            planes[ci] = _emit_global_scatter(planes[ci], pos, val, tgt,
                                              max_blocks)
            return planes, err

        def local_ace(words_l, base_l, np_l, eob_l, lut_l, mcu_l):
            pos, val, err, _nd = decode_ac_first_emit(
                words_l, base_l, np_l, eob_l, lut_l,
                T=T, ss=ss, se=se, al=al)
            tgt_l = _ac_rows_device(
                mcu_l, np_l, cols_u=cols_u, plane_cols=plane_cols,
                n_rows=n_rows1 - 1, max_blocks=max_blocks)
            part = _emit_global_scatter(
                jnp.zeros((n_rows1, 64), jnp.int32), pos, val, tgt_l,
                max_blocks)
            return jax.lax.psum(part, axes), err

        part, err = shard_map(
            local_ace, mesh=mesh,
            in_specs=(P(None), lane, lane, lane, P(None), lane),
            out_specs=(P(None, None), lane),
            check_vma=False,
        )(words, base, n_per, eob0, lut, mcu_first)
        planes[ci] = planes[ci] + part
        return planes, err

    if kind == "acr":
        _, max_blocks, ss, se, al, T, ci, cols_u, plane_cols = m
        words, base, n_per, eob0, mcu_first, lut, ev = inp
        n_rows1 = planes[ci].shape[0]
        n_blocks = ev.shape[0]
        zz_m, nextp = _refine_emit_prep(
            planes[ci], ss=ss, se=se, cols_u=cols_u,
            plane_cols=plane_cols, n_blocks=n_blocks)
        kw = dict(T=T, max_blocks=max_blocks, ss=ss, se=se, al=al,
                  cols_u=cols_u, plane_cols=plane_cols, n_rows1=n_rows1)
        if mesh is None:
            part, err = _refine_emit_core(
                words, base, n_per, eob0, mcu_first, lut, ev, zz_m,
                nextp, **kw)
            planes[ci] = planes[ci] + part
            return planes, err

        def local_acr(words_l, base_l, np_l, eob_l, mcu_l, lut_l, ev_l,
                      zz_l, nextp_l):
            part, err = _refine_emit_core(
                words_l, base_l, np_l, eob_l, mcu_l, lut_l, ev_l, zz_l,
                nextp_l, **kw)
            return jax.lax.psum(part, axes), err

        part, err = shard_map(
            local_acr, mesh=mesh,
            in_specs=(P(None), lane, lane, lane, lane, P(None), P(None),
                      P(None, None), P(None)),
            out_specs=(P(None, None), lane),
            check_vma=False,
        )(words, base, n_per, eob0, mcu_first, lut, ev, zz_m, nextp)
        planes[ci] = planes[ci] + part
        return planes, err

    _, max_blocks, ss, se, al, first, t_sym, ci = m
    words, base, nblocks, eob0, lut, tgt = inp
    if mesh is None:
        if first and t_sym is not None:
            pos, val, err, _nd = decode_ac_first_emit(
                words, base, nblocks, eob0, lut,
                T=t_sym, ss=ss, se=se, al=al)
            planes[ci] = _emit_global_scatter(planes[ci], pos, val, tgt,
                                              max_blocks)
            return planes, err
        if first:
            delta, err = decode_ac_first(
                words, base, nblocks, eob0, lut,
                max_blocks=max_blocks, ss=ss, se=se, al=al)
        else:
            zz_rows = jnp.take(planes[ci], jnp.asarray(ZIGZAG), axis=1)
            delta, err = decode_ac_refine(
                words, base, nblocks, eob0, lut, zz_rows, tgt,
                max_blocks=max_blocks, ss=ss, se=se, al=al)
        planes[ci] = planes[ci].at[tgt.reshape(-1)].add(
            delta.reshape(-1, 64), mode="drop")
        return planes, err
    n_rows1 = planes[ci].shape[0]
    zz = (jnp.take(planes[ci], jnp.asarray(ZIGZAG), axis=1)
          if not first else jnp.zeros((1, 64), jnp.int32))

    def local(words_l, base_l, nb_l, eob_l, lut_l, zz_l, tgt_l):
        if first and t_sym is not None:
            pos, val, err, _nd = decode_ac_first_emit(
                words_l, base_l, nb_l, eob_l, lut_l,
                T=t_sym, ss=ss, se=se, al=al)
            part = _emit_global_scatter(
                jnp.zeros((n_rows1, 64), jnp.int32), pos, val, tgt_l,
                max_blocks)
            return jax.lax.psum(part, axes), err
        if first:
            delta, err = decode_ac_first(
                words_l, base_l, nb_l, eob_l, lut_l,
                max_blocks=max_blocks, ss=ss, se=se, al=al)
        else:
            delta, err = decode_ac_refine(
                words_l, base_l, nb_l, eob_l, lut_l, zz_l, tgt_l,
                max_blocks=max_blocks, ss=ss, se=se, al=al)
        part = jnp.zeros((n_rows1, 64), jnp.int32).at[
            tgt_l.reshape(-1)].add(delta.reshape(-1, 64), mode="drop")
        return jax.lax.psum(part, axes), err

    part, err = shard_map(
        local, mesh=mesh,
        in_specs=(P(None), lane, lane, lane, P(None), P(None, None),
                  P(axes, None)),
        out_specs=(P(None, None), lane),
        check_vma=False,
    )(words, base, nblocks, eob0, lut, zz, tgt)
    planes[ci] = planes[ci] + part
    return planes, err


@functools.partial(
    jax.jit, static_argnames=("meta", "mesh_holder"), donate_argnums=(0,))
def _apply_chain(planes_t, scan_inputs, *, meta, mesh_holder=None):
    """ONE device program for a whole chain of scans (traced in order);
    returns (planes, per-scan any-err flags)."""
    planes = list(planes_t)
    flags = []
    mesh = mesh_holder.mesh if mesh_holder is not None else None
    for m, inp in zip(meta, scan_inputs):
        planes, err = _chain_step(planes, m, inp, mesh)
        flags.append(err.any())
    return tuple(planes), jnp.stack(flags)

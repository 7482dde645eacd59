"""First-generation on-device entropy decoder (ablation harness only).

Historical v1 of the device Huffman decode: a per-segment decoder (fori
over MCUs, unrolled blocks, while over AC symbols) vmapped over segments.
Superseded in the production package by the block-lockstep decoder
(jpeg_decoder_tpu.ops.entropy_flat); kept here so the ablation stays
reproducible (tools/entropy_microbench.py --variants v1).

Output is bit-identical to entropy.python_ref / entropy.native (asserted
in tests/test_entropy_jax.py).
"""

from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jpeg_decoder_tpu.ops.scan_prep import (  # noqa: E402
    luts_for_scan, prepare_scan)
from jpeg_decoder_tpu.types import (  # noqa: E402
    FrameHeader, JPEGError, ScanHeader, ZIGZAG_INV)


def _peek32(words: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Next 32 bits at absolute bit position ``pos`` as uint32."""
    w = (pos >> 5).astype(jnp.int32)
    off = (pos & 31).astype(jnp.uint32)
    w0 = jax.lax.dynamic_index_in_dim(words, w, keepdims=False)
    w1 = jax.lax.dynamic_index_in_dim(words, w + 1, keepdims=False)
    return jnp.where(off == 0, w0,
                     (w0 << off) | (w1 >> (32 - jnp.maximum(off, 1))))


def _extend(value: jnp.ndarray, size: jnp.ndarray) -> jnp.ndarray:
    """JPEG sign extension (parity: jpeg.cpp:340-343)."""
    value = value.astype(jnp.int32)
    half = jnp.where(size > 0, 1 << jnp.maximum(size - 1, 0), 0)
    return jnp.where((size > 0) & (value < half),
                     value - ((1 << size) - 1), value)


def _decode_block(words, pos, pred, dc_lut, ac_lut, err):
    """Decode one 8x8 block.  Returns (pos, pred, block_zz(64,), err)."""
    lane = jax.lax.broadcasted_iota(jnp.int32, (64,), 0)

    # ---- DC (parity: jpeg.cpp:324-345) ----
    window = _peek32(words, pos)
    entry = jax.lax.dynamic_index_in_dim(
        dc_lut, (window >> 16).astype(jnp.int32), keepdims=False)
    length = (entry & 31).astype(jnp.uint32)
    size = (entry >> 5).astype(jnp.uint32)
    err = err | (entry == 0) | (size > 11)
    raw = jnp.where(
        size == 0, jnp.uint32(0),
        (window << length) >> (32 - jnp.maximum(size, 1))).astype(jnp.int32)
    pos = pos + length + size
    diff = _extend(raw, size.astype(jnp.int32))
    pred = pred + diff
    block = jnp.where(lane == 0, pred, 0)

    # ---- AC loop (parity: jpeg.cpp:347-401), static bound 64 ----
    def cond(c):
        _pos, i, _blk, done, _err = c
        return jnp.logical_not(done) & (i < 64)

    def body(c):
        pos, i, blk, done, err = c
        window = _peek32(words, pos)
        entry = jax.lax.dynamic_index_in_dim(
            ac_lut, (window >> 16).astype(jnp.int32), keepdims=False)
        length = (entry & 31).astype(jnp.uint32)
        sym = entry >> 5
        err = err | (entry == 0)
        is_eob = sym == 0x00
        run = jnp.where(sym == 0xF0, 16, sym >> 4)
        csize = (sym & 0x0F).astype(jnp.uint32)
        i_new = i + run
        overflow = (i_new > 64) | ((csize > 0) & (i_new >= 64)) | (csize > 10)
        err = err | (~is_eob & overflow)
        raw = jnp.where(
            csize == 0, jnp.uint32(0),
            (window << length) >> (32 - jnp.maximum(csize, 1))
        ).astype(jnp.int32)
        pos = pos + length + csize
        coeff = _extend(raw, csize.astype(jnp.int32))
        write = (~is_eob) & (csize > 0) & (~overflow)
        idx = jnp.clip(i_new, 0, 63)
        blk = blk + jnp.where(write & (lane == idx), coeff, 0)
        i_next = jnp.where(is_eob, 64, jnp.where(write, i_new + 1, i_new))
        return (pos, i_next, blk, done | is_eob, err)

    pos, _, block, _, err = jax.lax.while_loop(
        cond, body, (pos, jnp.int32(1), block, jnp.bool_(False), err))
    return pos, pred, block, err


def make_segment_decoder(block_comp: tuple[int, ...], n_comps: int,
                         max_mcus: int):
    """Build a single-segment decoder for a fixed scan geometry."""
    bpm = len(block_comp)

    def decode_segment(words, n_mcus, dc_luts, ac_luts):
        out = jnp.zeros((max_mcus * bpm, 64), jnp.int32)
        preds = jnp.zeros((n_comps,), jnp.int32)
        pos = jnp.uint32(0)
        err = jnp.bool_(False)

        def mcu_body(m, carry):
            pos, preds, out, err = carry
            active = m < n_mcus

            def do(carry):
                pos, preds, out, err = carry
                for k, ci in enumerate(block_comp):
                    pos, pred, blk, err = _decode_block(
                        words, pos, preds[ci], dc_luts[ci], ac_luts[ci], err)
                    preds = preds.at[ci].set(pred)
                    out = jax.lax.dynamic_update_slice(
                        out, blk[None, :], (m * bpm + k, 0))
                return (pos, preds, out, err)

            return jax.lax.cond(active, do, lambda c: c,
                                (pos, preds, out, err))

        pos, preds, out, err = jax.lax.fori_loop(
            0, max_mcus, mcu_body, (pos, preds, out, err))
        out = jnp.take(out, jnp.asarray(ZIGZAG_INV), axis=1)
        return out, err

    return decode_segment


@functools.partial(jax.jit, static_argnames=("block_comp", "n_comps",
                                             "max_mcus"))
def decode_segments(words, seg_nmcus, dc_luts, ac_luts, *,
                    block_comp: tuple[int, ...], n_comps: int,
                    max_mcus: int):
    """vmapped multi-segment decode (v1)."""
    decoder = make_segment_decoder(block_comp, n_comps, max_mcus)
    return jax.vmap(decoder, in_axes=(0, 0, None, None))(
        words, seg_nmcus, dc_luts, ac_luts)


def decode_scan_baseline(hdr: FrameHeader, scan: ScanHeader) -> np.ndarray:
    """Common-backend-signature wrapper (v1, ablation only)."""
    words, nm, block_comp, max_mcus, lay = prepare_scan(hdr, scan)
    dc, ac = luts_for_scan(hdr, scan)
    out, err = decode_segments(
        jnp.asarray(words), jnp.asarray(nm), jnp.asarray(dc), jnp.asarray(ac),
        block_comp=block_comp, n_comps=len(hdr.components), max_mcus=max_mcus)
    if bool(np.asarray(err).any()):
        bad = np.flatnonzero(np.asarray(err))
        raise JPEGError(f"device entropy decode failed in segments {bad[:8]}")
    bpm = len(block_comp)
    out = np.asarray(out).reshape(-1, 64)
    return out[: lay.n_mcus * bpm]

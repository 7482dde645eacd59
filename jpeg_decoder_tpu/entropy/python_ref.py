"""Bit-exact reference-semantics entropy decoder (pure Python + LUT).

This is the correctness anchor for the whole framework: it reproduces the
reference decode semantics (jpeg.cpp:300-446) exactly — DC differential
coding with sign extension ``coeff -= (1<<len)-1`` (jpeg.cpp:340-343), EOB /
ZRL run-length AC decoding (jpeg.cpp:347-401), zig-zag placement into
natural-order blocks, restart-interval DC resets and byte alignment
(jpeg.cpp:419-425) — but uses the O(1) 16-bit LUT probe instead of the
reference's per-bit linear scan (jpeg.cpp:300-320), i.e. the same algorithm
the device kernel runs.

It is intentionally slow (pure Python); the production host path is the C++
backend in :mod:`jpeg_decoder_tpu.entropy.native`, and the device paths are
the lane kernels in :mod:`jpeg_decoder_tpu.ops.entropy_flat`.  All three emit
identical coefficient planes, so backends are swappable (SURVEY.md §7).
"""

from __future__ import annotations

import numpy as np

from ..huffman import build_lut
from ..layout import scan_layout
from ..types import FrameHeader, JPEGError, ScanHeader, ZIGZAG

_ZZ = ZIGZAG.tolist()


class BitReader:
    """MSB-first bit reader over unstuffed bytes (parity: BitStream,
    file.hpp:122-165).  Reads beyond the end return zero bits."""

    __slots__ = ("data", "pos", "end", "_cap")

    def __init__(self, data: bytes, start_byte: int = 0,
                 end_byte: int | None = None):
        # Pad so peek16/getbits never index out of range; reads past the
        # end return zero bits indefinitely (clamped below) — a decoder
        # running past the stream end sees zeros, never an IndexError.
        self.data = data + b"\x00\x00\x00\x00"
        self.pos = start_byte * 8
        self.end = (len(data) if end_byte is None else end_byte) * 8
        self._cap = len(data)

    def peek16(self) -> int:
        byte = min(self.pos >> 3, self._cap)
        bitoff = self.pos & 7
        d = self.data
        v = (d[byte] << 16) | (d[byte + 1] << 8) | d[byte + 2]
        return (v >> (8 - bitoff)) & 0xFFFF

    def getbits(self, n: int) -> int:
        """Read n (<=16) bits MSB-first (parity: getBitN, file.hpp:146-158)."""
        byte = min(self.pos >> 3, self._cap)
        bitoff = self.pos & 7
        d = self.data
        v = (d[byte] << 24) | (d[byte + 1] << 16) | (d[byte + 2] << 8) | d[byte + 3]
        self.pos += n
        return (v >> (32 - bitoff - n)) & ((1 << n) - 1)

    def align(self):
        """Discard partial byte (parity: BitStream::align, file.hpp:159-162)."""
        self.pos = (self.pos + 7) & ~7


def receive_extend(value: int, size: int) -> int:
    """JPEG sign extension, exactly as the reference computes it
    (jpeg.cpp:340-343): values below half-range map to negatives."""
    if size != 0 and value < (1 << (size - 1)):
        value -= (1 << size) - 1
    return value


def decode_block(reader: BitReader, dc_lut, ac_lut, block, pred: int,
                 max_dc: int = 11, max_ac: int = 10) -> int:
    """Decode one 8x8 block into ``block`` (natural order), returning the new
    DC predictor.  Parity: decodeMCUComponent (jpeg.cpp:322-403).
    ``max_dc``/``max_ac``: coefficient size-category limits — (11, 10) for
    8-bit frames, (15, 14) for 12-bit extended (T.81 Table F.1)."""
    t = dc_lut[reader.peek16()]
    length = t & 31
    if length == 0:
        raise JPEGError("invalid DC Huffman code")
    reader.pos += length
    size = t >> 5
    if size > max_dc:
        raise JPEGError("invalid DC coefficient size")
    diff = receive_extend(reader.getbits(size), size) if size else 0
    pred += diff
    block[0] = pred

    i = 1
    while i < 64:
        t = ac_lut[reader.peek16()]
        length = t & 31
        if length == 0:
            raise JPEGError("invalid AC Huffman code")
        reader.pos += length
        sym = t >> 5
        if sym == 0x00:  # EOB — rest of block stays zero
            break
        run = 16 if sym == 0xF0 else sym >> 4
        size = sym & 0x0F
        if i + run > 64 or (size != 0 and i + run >= 64):
            raise JPEGError("AC run overflows block")
        i += run
        if size:
            if size > max_ac:
                raise JPEGError("invalid AC coefficient size")
            block[_ZZ[i]] = receive_extend(reader.getbits(size), size)
            i += 1
    return pred


def decode_scan_baseline(hdr: FrameHeader, scan: ScanHeader) -> np.ndarray:
    """Decode a full baseline interleaved scan to scan-order coefficients.

    Returns ``(total_blocks, 64)`` int32, natural coefficient order —
    the pre-dequantization coefficient plane.
    """
    layout = scan_layout(hdr)
    comps = hdr.components
    # LUTs as plain Python lists: ~3x faster element indexing than ndarray.
    dc_luts = {tid: build_lut(spec).tolist()
               for tid, spec in scan.dc_specs.items()}
    ac_luts = {tid: build_lut(spec).tolist()
               for tid, spec in scan.ac_specs.items()}

    # Per within-MCU block: (comp index, dc_lut, ac_lut).
    per_mcu = []
    for ci, c in enumerate(comps):
        for _ in range(c.v * c.h):
            per_mcu.append((ci, dc_luts[c.td], ac_luts[c.ta]))

    n_mcus = layout.n_mcus
    bpm = layout.blocks_per_mcu
    out = np.zeros((n_mcus * bpm, 64), dtype=np.int32)
    out_list = out  # numpy row views are fine: few writes per block
    max_dc, max_ac = (15, 14) if hdr.precision > 8 else (11, 10)

    data_bytes = scan.data.tobytes()
    seg_offsets = scan.seg_offsets
    n_segments = len(seg_offsets) - 1
    ri = scan.restart_interval
    expected_segments = -(-n_mcus // ri) if ri else 1
    if n_segments != expected_segments:
        raise JPEGError(
            f"restart-segment count {n_segments} does not match DRI "
            f"{ri} over {n_mcus} MCUs (expected {expected_segments})")

    mcu = 0
    for s in range(n_segments):
        reader = BitReader(data_bytes, int(seg_offsets[s]), int(seg_offsets[s + 1]))
        preds = [0] * len(comps)
        seg_mcus = min(ri, n_mcus - mcu) if ri else n_mcus
        for _ in range(seg_mcus):
            base = mcu * bpm
            for k, (ci, dc_lut, ac_lut) in enumerate(per_mcu):
                row = out_list[base + k]
                preds[ci] = decode_block(reader, dc_lut, ac_lut, row,
                                         preds[ci], max_dc, max_ac)
            mcu += 1
    if mcu != n_mcus:
        raise JPEGError("scan ended before all MCUs decoded")
    return out


def decode_scan_resilient(hdr: FrameHeader, scan: ScanHeader) -> np.ndarray:
    """Best-effort decode of a scan whose restart-segment count disagrees
    with DRI (corrupted/nonconforming streams the strict backends reject).

    libjpeg-style policy — marker positions are ground truth: segment s
    covers MCUs [s*DRI, (s+1)*DRI); surplus segments are ignored, missing
    segments leave their MCUs zero, and a decode error inside a segment
    zero-fills only the rest of that segment (the next restart marker
    resynchronizes).  Well-formed streams decode identically to
    decode_scan_baseline.  VERDICT r1 item 7.
    """
    layout = scan_layout(hdr)
    comps = hdr.components
    dc_luts = {tid: build_lut(spec).tolist()
               for tid, spec in scan.dc_specs.items()}
    ac_luts = {tid: build_lut(spec).tolist()
               for tid, spec in scan.ac_specs.items()}
    per_mcu = []
    for ci, c in enumerate(comps):
        for _ in range(c.v * c.h):
            per_mcu.append((ci, dc_luts[c.td], ac_luts[c.ta]))

    n_mcus = layout.n_mcus
    bpm = layout.blocks_per_mcu
    out = np.zeros((n_mcus * bpm, 64), dtype=np.int32)
    max_dc, max_ac = (15, 14) if hdr.precision > 8 else (11, 10)
    data_bytes = scan.data.tobytes()
    seg_offsets = np.asarray(scan.seg_offsets, np.int64)
    n_segments = len(seg_offsets) - 1
    ri = scan.restart_interval or n_mcus

    for s in range(n_segments):
        first = s * ri
        if first >= n_mcus:
            break  # surplus segments: ignored
        seg_mcus = min(ri, n_mcus - first)
        seg_end_bits = int(seg_offsets[s + 1]) * 8
        reader = BitReader(data_bytes, int(seg_offsets[s]),
                           int(seg_offsets[s + 1]))
        preds = [0] * len(comps)
        for m in range(first, first + seg_mcus):
            if reader.pos > seg_end_bits:
                break  # segment bits exhausted: rest stays zero
            base = m * bpm
            try:
                for k, (ci, dc_lut, ac_lut) in enumerate(per_mcu):
                    row = out[base + k]
                    preds[ci] = decode_block(reader, dc_lut, ac_lut, row,
                                             preds[ci], max_dc, max_ac)
            except JPEGError:
                out[base: base + bpm] = 0  # drop the partial MCU
                break  # resync at the next restart marker
    return out


def scan_to_comp_planes(hdr: FrameHeader, scan_coefs: np.ndarray):
    """Gather scan-order blocks into dense per-component planes
    ``(rows_c, cols_c, 64)`` int32 (the SoA coefficient planes)."""
    layout = scan_layout(hdr)
    planes = []
    for ci in range(len(hdr.components)):
        rows, cols = layout.comp_shapes[ci]
        planes.append(scan_coefs[layout.comp_src[ci]].reshape(rows, cols, 64))
    return planes


def decode_scan_sequential_into(hdr: FrameHeader, scan: ScanHeader,
                                planes: list) -> None:
    """Decode one sequential (full-spectrum) scan over a component subset
    into caller-owned padded per-component planes (T.81 A.2: a scan with
    several components interleaves their MCUs over the frame grid; a
    single-component scan traverses that component's unpadded block grid
    non-interleaved).  Beyond the reference, which accepts only the single
    fully-interleaved scan (jpeg.cpp:858-862)."""
    from ..layout import comp_dims_unpadded

    comps = hdr.components
    sc = scan.comp_indices
    dc_luts = {tid: build_lut(spec).tolist()
               for tid, spec in scan.dc_specs.items()}
    ac_luts = {tid: build_lut(spec).tolist()
               for tid, spec in scan.ac_specs.items()}
    data_bytes = scan.data.tobytes()
    seg_offsets = scan.seg_offsets
    n_segments = len(seg_offsets) - 1
    ri = scan.restart_interval

    interleaved = len(sc) > 1
    if interleaved:
        n_units = hdr.mcus_x * hdr.mcus_y
        per_mcu = []
        for k, ci in enumerate(sc):
            c = comps[ci]
            for bv in range(c.v):
                for bh in range(c.h):
                    per_mcu.append((k, ci, bv, bh,
                                    dc_luts[scan.dc_table_ids[k]],
                                    ac_luts[scan.ac_table_ids[k]]))
    else:
        ci0 = sc[0]
        rows_u, cols_u = comp_dims_unpadded(hdr, ci0)
        n_units = rows_u * cols_u
        dc_lut0 = dc_luts[scan.dc_table_ids[0]]
        ac_lut0 = ac_luts[scan.ac_table_ids[0]]

    expected = -(-n_units // ri) if ri else 1
    if n_segments != expected:
        raise JPEGError(
            f"restart-segment count {n_segments} does not match DRI {ri}")

    max_dc, max_ac = (15, 14) if hdr.precision > 8 else (11, 10)
    unit = 0
    for s in range(n_segments):
        reader = BitReader(data_bytes, int(seg_offsets[s]),
                           int(seg_offsets[s + 1]))
        preds = [0] * len(sc)
        seg_units = min(ri, n_units - unit) if ri else n_units
        for _ in range(seg_units):
            if interleaved:
                my, mx = divmod(unit, hdr.mcus_x)
                for k, ci, bv, bh, dc_lut, ac_lut in per_mcu:
                    c = comps[ci]
                    row = planes[ci][my * c.v + bv, mx * c.h + bh]
                    row[:] = 0
                    preds[k] = decode_block(reader, dc_lut, ac_lut, row,
                                            preds[k], max_dc, max_ac)
            else:
                r, c_ = divmod(unit, cols_u)
                row = planes[ci0][r, c_]
                row[:] = 0
                preds[0] = decode_block(reader, dc_lut0, ac_lut0, row,
                                        preds[0], max_dc, max_ac)
            unit += 1
    if unit != n_units:
        raise JPEGError("scan ended before all blocks decoded")

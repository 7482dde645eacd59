"""Core data model for the JPEG decode engine.

Design notes
------------
The reference decoder (see /root/reference/jpeg.cpp) keeps decoder state as an
AoS ``MCU`` union array (reference include/types.hpp:32-67).  This decoder
instead uses a structure-of-arrays layout: per-component dense block planes of
shape ``(n_blocks_rows, n_block_cols, 64)`` int32, which is the HBM-resident
"coefficient plane" that conformance bit-exactness is defined on.

This module holds the frame/scan/table dataclasses produced by the host parser
(:mod:`jpeg_decoder_tpu.io.parser`) and consumed by entropy and pixel stages.

Reference parity notes are cited as ``jpeg.cpp:<line>`` / ``<header>.hpp:<line>``
of the reference throughout this package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

#: Zig-zag scan order: ZIGZAG[i] = natural (row-major) index of the i-th
#: coefficient in zig-zag order.  Matches reference types.hpp:23-31.
ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10,
        17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

#: Inverse permutation: natural index -> zig-zag position.
ZIGZAG_INV = np.argsort(ZIGZAG).astype(np.int32)

# Marker byte values (second byte of 0xFFxx).  Mirrors the marker taxonomy of
# reference file.hpp:167-181, extended with the full SOF family.
M_SOI = 0xD8
M_EOI = 0xD9
M_SOS = 0xDA
M_DQT = 0xDB
M_DNL = 0xDC
M_DRI = 0xDD
M_DHT = 0xC4
M_SOF0 = 0xC0  # baseline sequential
M_SOF1 = 0xC1  # extended sequential
M_SOF2 = 0xC2  # progressive (reference rejects, jpeg.cpp:69-73; we support it)
M_SOF9 = 0xC9  # extended sequential, arithmetic coding
M_SOF10 = 0xCA  # progressive, arithmetic coding
M_DAC = 0xCC  # arithmetic conditioning (L/U for DC, Kx for AC)
M_APP0 = 0xE0
M_APP15 = 0xEF
M_COM = 0xFE
M_RST0 = 0xD0
M_RST7 = 0xD7
M_TEM = 0x01


class JPEGError(ValueError):
    """Raised on malformed JPEG streams.

    The reference calls ``exit(1)`` on malformed input (25+ sites, e.g.
    jpeg.cpp:42, 71, 158).  This decoder raises typed exceptions instead so a
    bad image fails one image, not the batch.
    """


@dataclasses.dataclass
class HuffmanSpec:
    """A DHT-table spec: BITS counts and HUFFVAL symbols (ITU-T T.81 B.2.4.2).

    ``counts[i]`` = number of codes of length ``i+1`` (i in 0..15).
    Parity: reference jpeg.cpp:148-196 + huffman.hpp:8-48.
    """

    table_class: int  # 0 = DC, 1 = AC
    table_id: int
    counts: np.ndarray  # (16,) uint8
    symbols: np.ndarray  # (n,) uint8

    def __post_init__(self):
        if int(self.counts.sum()) != len(self.symbols):
            raise JPEGError("DHT: counts do not match number of symbols")
        if len(self.symbols) > 256:
            raise JPEGError("DHT: too many symbols")


@dataclasses.dataclass
class QuantTable:
    """Dequantization table, stored in **natural (row-major) order**.

    The reference de-zigzags at parse time (types.hpp:88-90) and stores int.
    We keep the same convention.  The reference has a 16-bit-precision
    truncation bug (jpeg.cpp:213-219, high byte lost) which we deliberately do
    NOT reproduce (SURVEY.md "quirks to not reproduce").
    """

    table_id: int
    values: np.ndarray  # (64,) int32, natural order


@dataclasses.dataclass
class Component:
    """One SOF color component (parity: reference ColorComponent,
    types.hpp:69-77, populated at jpeg.cpp:88-136 and jpeg.cpp:241-248)."""

    comp_id: int
    h: int  # horizontal sampling factor
    v: int  # vertical sampling factor
    tq: int  # quantization table id
    td: int = 0  # DC huffman table id (from SOS)
    ta: int = 0  # AC huffman table id (from SOS)


@dataclasses.dataclass
class ScanHeader:
    """One SOS header.  Baseline images have exactly one scan with
    (ss, se, ah, al) = (0, 63, 0, 0) (enforced by the reference at
    jpeg.cpp:255-264); progressive images have many."""

    comp_indices: list[int]  # indices into FrameHeader.components, scan order
    dc_table_ids: list[int]
    ac_table_ids: list[int]
    ss: int  # spectral selection start
    se: int  # spectral selection end
    ah: int  # successive approximation high
    al: int  # successive approximation low
    # Entropy-coded data for this scan, after byte-unstuffing, RST removal.
    data: Optional[np.ndarray] = None  # (n,) uint8 clean bytes
    # Same bytes with >= 256 zero bytes of tail padding (the native
    # decoder's 64-bit window contract) — avoids a per-decode copy.
    data_padded: Optional[np.ndarray] = None
    # Byte offsets (into `data`) where each restart segment begins. Always
    # starts with 0.  Segment k spans [seg_offsets[k], seg_offsets[k+1]).
    seg_offsets: Optional[np.ndarray] = None  # (n_segments+1,) int64
    # Huffman-table snapshots taken at SOS time: progressive streams redefine
    # DHT tables between scans, so per-scan resolution is required (the
    # reference is single-scan and keeps globals, jpeg.cpp:24-25).
    dc_specs: Optional[dict] = None  # {table_id: HuffmanSpec}
    ac_specs: Optional[dict] = None
    # Arithmetic conditioning snapshots (DAC, T.81 B.2.4.3): DC tables map
    # id -> (L, U), AC tables map id -> Kx.  Defaults (0, 1) / 5 apply to
    # any table never named in a DAC segment (F.1.4.4.1.4).
    dc_cond: Optional[dict] = None
    ac_cond: Optional[dict] = None
    # DRI snapshot at SOS time (DRI may change between scans).
    restart_interval: int = 0


@dataclasses.dataclass
class FrameHeader:
    """Parsed frame state: the analogue of the reference ``Image`` member
    block (jpeg.cpp:21-34)."""

    width: int
    height: int
    precision: int
    progressive: bool
    components: list[Component]
    quant_tables: dict[int, QuantTable]
    dc_tables: dict[int, HuffmanSpec]
    ac_tables: dict[int, HuffmanSpec]
    restart_interval: int
    scans: list[ScanHeader]
    zero_based_ids: bool = False  # reference quirk jpeg.cpp:91-104
    # True for SOF9/SOF10 frames (T.81 arithmetic entropy coding).
    arithmetic: bool = False
    # APP14 "Adobe" color-transform flag: 0 = stored as-is (RGB / CMYK),
    # 1 = YCbCr, 2 = YCCK; None when no Adobe marker is present.
    adobe_transform: int | None = None
    saw_jfif: bool = False
    # EXIF orientation tag (1-8; APP1 IFD0 tag 0x0112) — None when absent.
    exif_orientation: int | None = None
    # Embedded ICC profile (APP2 "ICC_PROFILE" chunks, reassembled).
    icc_profile: bytes | None = None

    @property
    def colorspace(self) -> str:
        """Source colorspace ('gray' | 'ycbcr' | 'rgb' | 'ycck' | 'cmyk'),
        matching libjpeg's jdapimin default_decompress_parms heuristics:
        for 3 components a JFIF marker forces YCbCr, else the Adobe
        transform flag decides, else component IDs ('R','G','B' means
        stored RGB); for 4 components the Adobe flag decides (2 = YCCK),
        defaulting to CMYK."""
        n = len(self.components)
        if n == 1:
            return "gray"
        if n == 3:
            if self.saw_jfif:
                return "ycbcr"
            if self.adobe_transform == 0:
                return "rgb"
            if self.adobe_transform is None and [
                    c.comp_id for c in self.components] == [82, 71, 66]:
                return "rgb"
            return "ycbcr"
        if self.adobe_transform == 2:
            return "ycck"
        return "cmyk"

    # ---- Derived geometry (parity: jpeg.cpp:77-80, 118-125) ----
    @property
    def h_max(self) -> int:
        return max(c.h for c in self.components)

    @property
    def v_max(self) -> int:
        return max(c.v for c in self.components)

    @property
    def mcu_width(self) -> int:
        """8x8 block columns covering the image width (jpeg.cpp:77)."""
        return (self.width + 7) // 8

    @property
    def mcu_height(self) -> int:
        """8x8 block rows covering the image height (jpeg.cpp:78)."""
        return (self.height + 7) // 8

    @property
    def mcus_x(self) -> int:
        """Number of MCUs horizontally."""
        return (self.mcu_width + self.h_max - 1) // self.h_max

    @property
    def mcus_y(self) -> int:
        """Number of MCUs vertically."""
        return (self.mcu_height + self.v_max - 1) // self.v_max

    @property
    def mcu_width_real(self) -> int:
        """Block columns padded up to a sampling-factor multiple
        (jpeg.cpp:118-121)."""
        return self.mcus_x * self.h_max

    @property
    def mcu_height_real(self) -> int:
        """Block rows padded up to a sampling-factor multiple
        (jpeg.cpp:122-125)."""
        return self.mcus_y * self.v_max

    def comp_block_grid(self, ci: int) -> tuple[int, int]:
        """Dense per-component block-grid shape (rows, cols).

        The reference scatters all components into one sparse
        (mcuHeightReal, mcuWidthReal) grid (jpeg.cpp:432); this decoder uses
        dense per-component planes instead (SoA layout, SURVEY.md §7).
        """
        c = self.components[ci]
        return (self.mcus_y * c.v, self.mcus_x * c.h)

    @property
    def blocks_per_mcu(self) -> int:
        return sum(c.h * c.v for c in self.components)

    @property
    def n_mcus(self) -> int:
        return self.mcus_x * self.mcus_y

    @property
    def total_scan_blocks(self) -> int:
        """Total 8x8 blocks decoded by one full (interleaved) scan."""
        return self.n_mcus * self.blocks_per_mcu

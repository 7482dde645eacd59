"""All-NumPy float64 reference of the decode (no JAX).

The plain reference that device results are checked against: coefficient
planes from the pure-Python entropy decoders, then dequantize,
the orthonormal 8x8 IDCT in float64 rounded once, libjpeg "fancy" (or
nearest-neighbour) chroma upsampling with the same integer arithmetic as
:func:`jpeg_decoder_tpu.ops.pixel.upsample_fancy`, and YCbCr -> RGB in
float64 truncated toward zero, as the reference decoder's colour stage
does (jpeg.cpp:521-535).  8-bit frames only.

Tolerance against the device pipeline (``idct="fast"`` or ``"kron"``): the
float32 IDCT may round a sample one count away from the float64 value at a
rounding tie, fancy upsampling keeps a one-count difference at one count,
and the colour matrix (largest coefficient 1.772) can turn one count of
chroma plus one of luma into 2.772 counts before truncation, so RGB agrees
within 3 counts; in practice almost every sample agrees exactly.
"""

from __future__ import annotations

import numpy as np

#: Orthonormal IDCT basis, M[p, u] = a(u) cos((2p+1) u pi / 16).
IDCT_M = np.array([[(np.sqrt(1 / 8) if u == 0 else 0.5)
                    * np.cos((2 * p + 1) * u * np.pi / 16)
                    for u in range(8)] for p in range(8)])

#: Largest |device - reference| RGB difference the module docstring allows.
RGB_TOLERANCE = 3


def idct_blocks(deq: np.ndarray) -> np.ndarray:
    """(..., 64) dequantized coefficients -> (..., 64) int64 samples."""
    blocks = deq.reshape(-1, 8, 8).astype(np.float64)
    out = np.matmul(np.matmul(IDCT_M, blocks), IDCT_M.T)
    return np.rint(out).astype(np.int64).reshape(deq.shape)


def _to_plane(blocks: np.ndarray) -> np.ndarray:
    rows, cols = blocks.shape[:2]
    return (blocks.reshape(rows, cols, 8, 8).swapaxes(1, 2)
            .reshape(rows * 8, cols * 8))


def upsample_fancy(x: np.ndarray, vy: int, vx: int) -> np.ndarray:
    """libjpeg triangular upsampling of an int64 sample plane."""
    if vy not in (1, 2) or vx not in (1, 2):
        return np.repeat(np.repeat(x, vy, 0), vx, 1)
    if (vy, vx) == (2, 2):
        up = np.vstack([x[:1], x[:-1]])
        dn = np.vstack([x[1:], x[-1:]])
        cols = np.stack([3 * x + up, 3 * x + dn], 1).reshape(-1, x.shape[1])
        lf = np.hstack([cols[:, :1], cols[:, :-1]])
        rt = np.hstack([cols[:, 1:], cols[:, -1:]])
        ev, od = (3 * cols + lf + 8) >> 4, (3 * cols + rt + 7) >> 4
        return np.stack([ev, od], 2).reshape(cols.shape[0], -1)
    if vy == 2:
        up = np.vstack([x[:1], x[:-1]])
        dn = np.vstack([x[1:], x[-1:]])
        x = np.stack([(3 * x + up + 1) >> 2, (3 * x + dn + 2) >> 2],
                     1).reshape(-1, x.shape[1])
    if vx == 2:
        lf = np.hstack([x[:, :1], x[:, :-1]])
        rt = np.hstack([x[:, 1:], x[:, -1:]])
        x = np.stack([(3 * x + lf + 1) >> 2, (3 * x + rt + 2) >> 2],
                     2).reshape(x.shape[0], -1)
    return x


def pixel_pipeline(planes, qtables, *, height: int, width: int,
                   samplings, upsample: str = "fancy",
                   color: str = "auto") -> np.ndarray:
    """NumPy twin of ``ops.pixel.pixel_pipeline`` for 8-bit gray, YCbCr
    and stored-RGB frames: (height, width, 3) uint8."""
    pix = []
    for plane, q, (vy, vx) in zip(planes, qtables, samplings):
        deq = np.asarray(plane, np.int64) * np.asarray(q, np.int64)
        img = _to_plane(idct_blocks(deq))
        if (vy, vx) != (1, 1):
            img = img[: -(-height // vy), : -(-width // vx)]
            img = (upsample_fancy(img, vy, vx) if upsample == "fancy"
                   else np.repeat(np.repeat(img, vy, 0), vx, 1))
        pix.append(img)
    if color == "auto":
        color = {1: "gray", 3: "ycbcr"}[len(pix)]
    h = min(p.shape[0] for p in pix)
    w = min(p.shape[1] for p in pix)
    pix = [p[:h, :w].astype(np.float64) for p in pix]
    if color == "gray":
        rgb = np.stack([pix[0] + 128] * 3, -1)
    elif color == "rgb":
        rgb = np.stack([p + 128 for p in pix], -1)
    elif color == "ycbcr":
        y, cb, cr = pix
        rgb = np.stack([y + 1.402 * cr + 128,
                        y - 0.344 * cb - 0.714 * cr + 128,
                        y + 1.772 * cb + 128], -1)
    else:
        raise ValueError(f"pixel_ref does not cover colorspace {color!r}")
    return np.clip(np.trunc(rgb), 0, 255).astype(np.uint8)[:height, :width]


def reference_planes(hdr):
    """Quantized coefficient planes from the pure-Python entropy decoders
    (``entropy/python_ref.py``; ``entropy/progressive.py`` for progressive
    frames): independent of the native and device entropy code that
    device results come from."""
    from ..models import decoder

    return decoder.decode_to_planes(hdr, entropy="python")


def decode(blob: bytes, *, upsample: str = "fancy",
           planes=None) -> np.ndarray:
    """Blob -> RGB with the Python entropy reference (or the given
    ``reference_planes``) and this NumPy pixel stage."""
    from ..io import parser

    hdr = parser.parse(blob)
    if hdr.precision != 8:
        raise ValueError("pixel_ref covers 8-bit frames only")
    if planes is None:
        planes = reference_planes(hdr)
    return pixel_pipeline(
        planes, [hdr.quant_tables[c.tq].values for c in hdr.components],
        height=hdr.height, width=hdr.width,
        samplings=[(hdr.v_max // c.v, hdr.h_max // c.h)
                   for c in hdr.components],
        upsample=upsample, color=hdr.colorspace)

"""Device pixel pipeline: dequantize -> 8x8 IDCT -> upsample + YCbCr->RGB.

IDCT modes:

* ``exact`` — reproduces the reference's AAN float butterfly with int32
  truncating stores between the column and row passes (jpeg.cpp:594-753), so
  final pixels are bit-exact with the reference decoder.  Elementwise over
  blocks; all ops are IEEE f32 adds/muls in the same order as the C++
  source.
* ``fast`` — the orthonormal 2-D IDCT as two 8x8 contractions
  (``M @ X @ M^T``), batched over all blocks as matrix products.
* ``kron`` — dequantize + IDCT fused into ONE ``(N, 64) @ (64, 64)``
  product with the Kronecker basis ``M (x) M``.

``fast`` and ``kron`` ask for ``MATMUL_PRECISION`` (``HIGHEST``): a float32
product may otherwise run in TF32 on a GPU, which keeps ~11 significant
bits, while dequantized coefficients reach the thousands — the rounding
error would then exceed one count.  In full float32 both round the true
(float64) transform once, so they stay within +-1 count of it, the bound
tests/test_pixel.py asserts.  ``exact`` truncates after each 1-D pass as
the reference does and sits within 3 counts of the true transform.

Chroma upsampling: the reference does fused nearest-neighbor upsampling from
the MCU's own chroma block (jpeg.cpp:517-520).  For sampling factors in
{1, 2} this is exactly ``pixel[y, x] -> chroma[y // v_max, x // h_max]`` on
global pixel coordinates (see SURVEY.md §2 #15), i.e. a plain ``jnp.repeat``.

Color conversion (jpeg.cpp:521-535): R = Y + 1.402 Cr + 128, etc., computed
in f32 and truncated toward zero on int conversion, then clamped to [0, 255].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Constants (parity: reference types.hpp:5-19 — computed in f64, stored f32)
# ---------------------------------------------------------------------------
_M0 = np.float32(2.0 * np.cos(1.0 / 16.0 * 2.0 * np.pi))
_M1 = np.float32(2.0 * np.cos(2.0 / 16.0 * 2.0 * np.pi))
_M3 = _M1
_M5 = np.float32(2.0 * np.cos(3.0 / 16.0 * 2.0 * np.pi))
_M2 = np.float32(_M0 - _M5)
_M4 = np.float32(_M0 + _M5)

_S = [np.float32(np.cos(0.0) / np.sqrt(8.0))] + [
    np.float32(np.cos(k / 16.0 * np.pi) / 2.0) for k in range(1, 8)
]

#: Orthonormal IDCT basis: IDCT_M[p, u] = a(u) * cos((2p+1) u pi / 16),
#: a(0) = 1/sqrt(8), a(u>0) = 1/2.  out = M @ X @ M^T.
IDCT_M = np.zeros((8, 8), dtype=np.float64)
for _p in range(8):
    for _u in range(8):
        a = np.sqrt(1.0 / 8.0) if _u == 0 else 0.5
        IDCT_M[_p, _u] = a * np.cos((2 * _p + 1) * _u * np.pi / 16.0)
IDCT_M_F32 = IDCT_M.astype(np.float32)

#: Precision of the float32 IDCT products (module docstring).
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def dequantize(coefs: jnp.ndarray, qtable: jnp.ndarray) -> jnp.ndarray:
    """int32 coefficient plane (..., 64) * natural-order qtable (64,).

    Parity: dequantizeMCUComponent (jpeg.cpp:563-569) — plain int multiply.
    The result is THE conformance surface: bit-exactness of this plane vs the
    reference is asserted by the golden tests.
    """
    return coefs * qtable.astype(jnp.int32)


def _aan_1d(x: jnp.ndarray) -> jnp.ndarray:
    """One scaled-AAN 1-D IDCT pass along axis -2 of f32 input (..., 8, k).

    Mirrors inverseDCTComponent's column pass (jpeg.cpp:596-663) op-for-op so
    f32 rounding matches the reference bit-for-bit.
    """
    g0 = x[..., 0, :] * _S[0]
    g1 = x[..., 4, :] * _S[4]
    g2 = x[..., 2, :] * _S[2]
    g3 = x[..., 6, :] * _S[6]
    g4 = x[..., 5, :] * _S[5]
    g5 = x[..., 1, :] * _S[1]
    g6 = x[..., 7, :] * _S[7]
    g7 = x[..., 3, :] * _S[3]

    f4 = g4 - g7
    f5 = g5 + g6
    f6 = g5 - g6
    f7 = g4 + g7

    e2 = g2 - g3
    e3 = g2 + g3
    e5 = f5 - f7
    e7 = f5 + f7
    e8 = f4 + f6

    d2 = e2 * _M1
    d4 = f4 * _M2
    d5 = e5 * _M3
    d6 = f6 * _M4
    d8 = e8 * _M5

    c0 = g0 + g1
    c1 = g0 - g1
    c2 = d2 - e3
    c3 = e3
    c4 = d4 + d8
    c5 = d5 + e7
    c6 = d6 - d8
    c7 = e7
    c8 = c5 - c6

    b0 = c0 + c3
    b1 = c1 + c2
    b2 = c1 - c2
    b3 = c0 - c3
    b4 = c4 - c8
    b5 = c8
    b6 = c6 - c7
    b7 = c7

    return jnp.stack(
        [b0 + b7, b1 + b6, b2 + b5, b3 + b4,
         b3 - b4, b2 - b5, b1 - b6, b0 - b7],
        axis=-2,
    )


def idct_exact(blocks: jnp.ndarray) -> jnp.ndarray:
    """Bit-exact reference IDCT on int32 blocks (..., 8, 8) -> int32.

    Column pass, truncate to int32 (C++ float->int truncates toward zero,
    jpeg.cpp:655-662), then row pass, truncate again (jpeg.cpp:723-730).
    """
    x = blocks.astype(jnp.float32)
    cols = _aan_1d(x).astype(jnp.int32)  # truncating store between passes
    rows = _aan_1d(cols.astype(jnp.float32).swapaxes(-1, -2))
    return rows.astype(jnp.int32).swapaxes(-1, -2)


def idct_fast(blocks: jnp.ndarray) -> jnp.ndarray:
    """Batched orthonormal IDCT: out = M @ X @ M^T, rounded to int32.

    Contracted as two dense float32 products over all blocks at once, at
    ``MATMUL_PRECISION`` (module docstring); within +-1 count of the
    float64 transform (asserted in tests/test_pixel.py).
    """
    m = jnp.asarray(IDCT_M_F32)
    x = blocks.astype(jnp.float32)
    y = jnp.einsum("pu,...uv,qv->...pq", m, x, m,
                   preferred_element_type=jnp.float32,
                   precision=MATMUL_PRECISION)
    return jnp.round(y).astype(jnp.int32)


#: (64, 64) Kronecker IDCT basis: KRON[p*8+q, u*8+v] = M[p,u] * M[q,v], so
#: vec(M X M^T) = KRON @ vec(X) for row-major 8x8 blocks.
IDCT_KRON = np.kron(IDCT_M, IDCT_M).astype(np.float32)


def idct_kron(blocks: jnp.ndarray, qtable: jnp.ndarray) -> jnp.ndarray:
    """Fused dequantize + IDCT as one (N, 64) @ (64, 64) float32 product.

    blocks: (N, 64) int32 quantized coefficients (natural order).
    qtable: (64,) int32.  Returns (N, 64) int32 pixel-domain samples.
    Four times the multiply-adds of the separable form in one dense
    product with contraction 64; XLA fuses the dequantize into the
    product's operand.  ``MATMUL_PRECISION`` keeps it within +-1 count of
    the float64 transform (module docstring).
    """
    deq = (blocks * qtable.astype(jnp.int32)).astype(jnp.float32)
    out = jnp.dot(deq, jnp.asarray(IDCT_KRON).T,
                  preferred_element_type=jnp.float32,
                  precision=MATMUL_PRECISION)
    return jnp.round(out).astype(jnp.int32)


def blocks_to_plane(plane: jnp.ndarray) -> jnp.ndarray:
    """(rows, cols, 64) block plane -> (rows*8, cols*8) pixel plane."""
    rows, cols = plane.shape[0], plane.shape[1]
    return (plane.reshape(rows, cols, 8, 8)
                 .swapaxes(1, 2)
                 .reshape(rows * 8, cols * 8))


def upsample_nn(plane: jnp.ndarray, vy: int, vx: int) -> jnp.ndarray:
    """Nearest-neighbor chroma upsampling (parity: jpeg.cpp:517-520; global
    coordinate equivalence derived in SURVEY.md §2 #15)."""
    if vy > 1:
        plane = jnp.repeat(plane, vy, axis=0)
    if vx > 1:
        plane = jnp.repeat(plane, vx, axis=1)
    return plane


def _interleave(a: jnp.ndarray, b: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Interleave two equal-shape arrays along ``axis`` (a first)."""
    stacked = jnp.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def _shift_down(x: jnp.ndarray, edge_rows) -> jnp.ndarray:
    """Row i+1 of ``x`` with edge replication at the LAST VALID row.

    ``edge_rows``: the valid row count — the static array height, or a
    traced scalar < height when the plane carries geometry-bucket padding
    (the filter must replicate at the true image edge, not the pad edge).
    """
    down = jnp.concatenate([x[1:], x[-1:]], axis=0)
    if edge_rows is None or (isinstance(edge_rows, int)
                             and edge_rows == x.shape[0]):
        return down
    iota = jax.lax.broadcasted_iota(jnp.int32, (x.shape[0], 1), 0)
    return jnp.where(iota + 1 >= edge_rows, x, down)


def _shift_right(x: jnp.ndarray, edge_cols) -> jnp.ndarray:
    """Column j+1 of ``x`` with edge replication at the last valid column."""
    right = jnp.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    if edge_cols is None or (isinstance(edge_cols, int)
                             and edge_cols == x.shape[1]):
        return right
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, x.shape[1]), 1)
    return jnp.where(iota + 1 >= edge_cols, x, right)


def upsample_fancy(plane: jnp.ndarray, vy: int, vx: int,
                   edge=None) -> jnp.ndarray:
    """libjpeg-style 'fancy' triangular chroma upsampling (jdsample.c
    semantics, re-derived): 3:1 triangle filter with centered sample grid.

    Operates on unshifted (level-shift-free) samples: the +128 offset
    commutes exactly through the integer rounding because 4*128 and 16*128
    are multiples of the rounding divisors.

    ``edge``: optional traced (rows, cols) true sample extent when the
    plane is geometry-bucket padded — the triangle filter's edge
    replication then happens at the TRUE image edge (bit-exact with the
    unpadded pipeline inside the true region; see BatchDecoder bucketing).

    Capability beyond the reference (which fuses nearest-neighbor only,
    jpeg.cpp:517-520); enables tight conformance vs PIL/libjpeg output.
    """
    x = plane.astype(jnp.int32)
    e_r, e_c = edge if edge is not None else (None, None)
    # libjpeg's fancy path exists only for the (2,1)/(1,2)/(2,2) ratios
    # (jdsample.c); ANY other ratio — including mixed ones like (2,4) —
    # falls back to plain replication on both axes (int_upsample).
    # Verified against PIL: filtering one axis of a mixed ratio deviates
    # from libjpeg by ~2x the factor-2 tolerance.
    if vy not in (1, 2) or vx not in (1, 2):
        return upsample_nn(plane, vy, vx).astype(jnp.int32)
    if vy == 2 and vx == 2:
        up = jnp.concatenate([x[:1], x[:-1]], axis=0)
        down = _shift_down(x, e_r)
        rows_a = 3 * x + up      # contributes to output row 2i
        rows_b = 3 * x + down    # contributes to output row 2i+1
        cols = _interleave(rows_a, rows_b, axis=0)  # (2r, c), 0..1020 scale
        left = jnp.concatenate([cols[:, :1], cols[:, :-1]], axis=1)
        right = _shift_right(cols, e_c)
        even = (3 * cols + left + 8) >> 4
        odd = (3 * cols + right + 7) >> 4
        return _interleave(even, odd, axis=1)
    out = x
    if vy == 2:
        up = jnp.concatenate([out[:1], out[:-1]], axis=0)
        down = _shift_down(out, e_r)
        even = (3 * out + up + 1) >> 2
        odd = (3 * out + down + 2) >> 2
        out = _interleave(even, odd, axis=0)
    if vx == 2:
        left = jnp.concatenate([out[:, :1], out[:, :-1]], axis=1)
        right = _shift_right(out, e_c)
        even = (3 * out + left + 1) >> 2
        odd = (3 * out + right + 2) >> 2
        out = _interleave(even, odd, axis=1)
    return out


def _ycbcr_channels(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray,
                    precision: int = 8):
    """YCbCr -> clamped int32 (r, g, b) planes with reference f32 op order
    and truncating int conversion (jpeg.cpp:521-535).  For 12-bit frames
    (T.81 extended) the level shift is 2048 and the clamp 0..4095."""
    center = float(1 << (precision - 1))
    maxv = (1 << precision) - 1
    yf = y.astype(jnp.float32)
    cbf = cb.astype(jnp.float32)
    crf = cr.astype(jnp.float32)
    r = yf + jnp.float32(1.402) * crf + jnp.float32(center)
    g = yf - jnp.float32(0.344) * cbf - jnp.float32(0.714) * crf + jnp.float32(center)
    b = yf + jnp.float32(1.772) * cbf + jnp.float32(center)
    rgb = jnp.stack([r, g, b], axis=-1)
    # C++ float->int conversion truncates toward zero; clamp after.
    return jnp.clip(rgb.astype(jnp.int32), 0, maxv)


def _sample_dtype(precision: int):
    return jnp.uint8 if precision <= 8 else jnp.uint16


def ycbcr_to_rgb(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray,
                 precision: int = 8) -> jnp.ndarray:
    """Color conversion (jpeg.cpp:521-535); output uint8 (H, W, 3)
    (uint16 for 12-bit frames)."""
    return _ycbcr_channels(y, cb, cr, precision).astype(
        _sample_dtype(precision))


def gray_to_rgb(y: jnp.ndarray, precision: int = 8) -> jnp.ndarray:
    v = jnp.clip(y + (1 << (precision - 1)), 0,
                 (1 << precision) - 1).astype(_sample_dtype(precision))
    return jnp.stack([v, v, v], axis=-1)


def _level_shift_u8(p: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(p + 128, 0, 255)


def cmyk_to_rgb(cmyk: jnp.ndarray) -> jnp.ndarray:
    """(H, W, 4) int32 CMYK (PIL convention: 0 = no ink) -> uint8 RGB.

    Bit-exact reimplementation of Pillow's ``cmyk2rgb`` (libImaging/
    Convert.c): ``out = nk - MULDIV255(in, nk)`` with ``nk = 255 - K`` and
    the ``(t + (t >> 8)) >> 8`` rounding of MULDIV255, so our RGB view of
    a CMYK JPEG matches ``PIL.Image.open(...).convert("RGB")`` exactly
    given identical CMYK samples."""
    nk = 255 - cmyk[..., 3:4]
    t = cmyk[..., :3] * nk + 128
    scaled = (t + (t >> 8)) >> 8
    return jnp.clip(nk - scaled, 0, 255).astype(jnp.uint8)


def decoded_to_cmyk(pix: list, color: str) -> jnp.ndarray:
    """Per-component decoded sample planes -> (H, W, 4) int32 CMYK in the
    PIL/Adobe-inverted convention (0 = no ink), i.e. exactly what
    ``np.array(PIL.Image.open(f))`` yields for the same JPEG.

    * ``ycck`` (Adobe transform 2): libjpeg's ycck_cmyk_convert computes
      C = 255 - R(y,cb,cr), M = 255 - G, Y = 255 - B, K as stored; PIL
      then inverts all four channels (rawmode ``CMYK;I``) — the
      composition is (R, G, B, 255 - K_stored).
    * ``cmyk`` (transform 0 / no Adobe marker): samples stored as-is;
      PIL's inversion gives 255 - stored."""
    if color == "ycck":
        rgbish = _ycbcr_channels(pix[0], pix[1], pix[2])
        k = 255 - _level_shift_u8(pix[3])
        return jnp.concatenate([rgbish, k[..., None]], axis=-1)
    return jnp.stack([255 - _level_shift_u8(p) for p in pix], axis=-1)


def pixel_pipeline_impl(planes, qtables, *, height: int, width: int,
                        samplings: tuple, idct: str = "exact",
                        upsample: str = "nn",
                        color: str = "auto",
                        out_cmyk: bool = False,
                        precision: int = 8,
                        true_dims=None) -> jnp.ndarray:
    """Full pixel pipeline on per-component coefficient planes.

    Args:
      planes: tuple of (rows_c, cols_c, 64) int32 quantized-coefficient
        planes, one per component (scan order layout from layout.py).
      qtables: tuple of (64,) int32 natural-order quant tables per component.
      height/width: output crop.
      samplings: tuple of (v_repeat, h_repeat) per component — the
        upsampling factors h_max//h_c, v_max//v_c.
      idct: "exact" (bit-exact vs reference), "fast" (separable matrix
        products) or "kron" (fused dequantize + Kronecker product).
      color: source colorspace — "auto" (by component count), "gray",
        "ycbcr", "rgb" (stored as-is), "ycck", or "cmyk".
      out_cmyk: for 4-component sources, return the (H, W, 4) CMYK plane
        (PIL-inverted convention) instead of converting to RGB.
      true_dims: optional traced (true_height, true_width) scalars when
        ``height``/``width`` are GEOMETRY-BUCKET dims and the planes carry
        zero-padding blocks beyond the image's real extent (BatchDecoder
        bucketing: one compiled program serves many image sizes).  The
        fancy upsampler's edge replication then happens at the true
        image edge, so pixels inside (true_height, true_width) are
        bit-identical to the unpadded pipeline; the caller crops.

    Returns (height, width, 3) uint8 RGB (or (H, W, 4) CMYK).
    """
    pix = []
    for plane, q, (vy, vx) in zip(planes, qtables, samplings):
        rows, cols = plane.shape[0], plane.shape[1]
        if idct == "kron":
            # Fused dequant+IDCT as one (N, 64) @ (64, 64) product.
            out = idct_kron(plane.reshape(rows * cols, 64), q)
            img = blocks_to_plane(out.reshape(rows, cols, 64))
        else:
            idct_fn = idct_exact if idct == "exact" else idct_fast
            deq = dequantize(plane, q)
            blocks = idct_fn(deq.reshape(*deq.shape[:-1], 8, 8))
            img = blocks_to_plane(blocks.reshape(rows, cols, 64))
        if (vy, vx) != (1, 1):
            # Upsample from the component's UNPADDED sample grid (T.81
            # A.1.1: ceil(dim / factor)), like libjpeg: the padded MCU
            # region beyond it is never meaningful — non-interleaved
            # scans do not even code those blocks — and the fancy
            # filter's edge replication must happen at the true edge.
            img = img[: -(-height // vy), : -(-width // vx)]
            if upsample == "nn":
                img = upsample_nn(img, vy, vx)
            else:
                edge = None
                if true_dims is not None:
                    th, tw = true_dims
                    edge = ((th + vy - 1) // vy, (tw + vx - 1) // vx)
                img = upsample_fancy(img, vy, vx, edge=edge)
        pix.append(img)
    if color == "auto":
        color = {1: "gray", 3: "ycbcr", 4: "cmyk"}.get(len(pix), "ycbcr")
    if precision != 8 and color in ("rgb", "ycck", "cmyk"):
        raise ValueError(
            "12-bit decode is supported for gray/YCbCr frames only")
    if len(pix) == 1:
        rgb = gray_to_rgb(pix[0], precision)
    else:
        h = min(p.shape[0] for p in pix)
        w = min(p.shape[1] for p in pix)
        pix = [p[:h, :w] for p in pix]
        if color == "rgb":
            rgb = jnp.stack(
                [_level_shift_u8(p) for p in pix], axis=-1).astype(jnp.uint8)
        elif color in ("ycck", "cmyk"):
            cmyk = decoded_to_cmyk(pix, color)
            if out_cmyk:
                return cmyk[:height, :width].astype(jnp.uint8)
            rgb = cmyk_to_rgb(cmyk)
        else:
            rgb = ycbcr_to_rgb(pix[0], pix[1], pix[2], precision)
    return rgb[:height, :width]


#: Jitted pipeline.  Note: XLA fusion may contract mul+add into FMA, which can
#: flip the odd truncation boundary by one count vs the reference (observed:
#: <=3 samples per megapixel, max diff 1).  For byte-perfect conformance use
#: ``strict=True`` in decode(), which evaluates this op-by-op (eager) where
#: every f32 op rounds individually, matching the reference C++ exactly.
pixel_pipeline = jax.jit(
    pixel_pipeline_impl,
    static_argnames=("height", "width", "samplings", "idct", "upsample",
                     "color", "out_cmyk", "precision"))


@functools.partial(jax.jit, static_argnames=(
    "comp_shapes", "height", "width", "samplings", "idct", "upsample",
    "color", "out_cmyk", "precision"))
def pixel_pipeline_from_scan(blocks, qtables, comp_srcs, *,
                             comp_shapes: tuple, height: int, width: int,
                             samplings: tuple, idct: str = "fast",
                             upsample: str = "fancy",
                             color: str = "auto",
                             out_cmyk: bool = False,
                             precision: int = 8) -> jnp.ndarray:
    """Pixel pipeline taking raw scan-order blocks (N, 64) int32 plus
    per-component gather maps — plane assembly happens ON DEVICE (one gather
    per component), so the host ships the entropy decoder's output buffer
    verbatim.  This is the production single-image path."""
    planes = tuple(
        jnp.take(blocks, src, axis=0).reshape(rows, cols, 64)
        for src, (rows, cols) in zip(comp_srcs, comp_shapes))
    return pixel_pipeline_impl(
        planes, qtables, height=height, width=width,
        samplings=samplings, idct=idct, upsample=upsample,
        color=color, out_cmyk=out_cmyk, precision=precision)

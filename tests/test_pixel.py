"""Unit tests for the pixel pipeline ops (dequant / IDCT / upsample / color)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jpeg_decoder_tpu.ops import pixel as P


def test_dequantize():
    coefs = jnp.arange(64, dtype=jnp.int32).reshape(1, 64)
    q = jnp.full((64,), 3, jnp.int32)
    out = np.asarray(P.dequantize(coefs, q))
    assert out.tolist() == [(np.arange(64) * 3).tolist()]


def test_idct_dc_only():
    # DC-only block: IDCT of X[0,0]=v is flat v/8
    blk = np.zeros((8, 8), np.int32)
    blk[0, 0] = 800
    out = np.asarray(P.idct_exact(jnp.asarray(blk)))
    assert np.all(np.abs(out - 100) <= 1)
    out_f = np.asarray(P.idct_fast(jnp.asarray(blk)))
    assert np.all(np.abs(out_f - 100) <= 1)


def test_idct_fast_vs_exact_random():
    rng = np.random.default_rng(1)
    blocks = rng.integers(-1024, 1024, size=(256, 8, 8)).astype(np.int32)
    # sparsify like real coefficient data
    mask = rng.random((256, 8, 8)) < 0.2
    blocks = np.where(mask, blocks, 0).astype(np.int32)
    e = np.asarray(P.idct_exact(jnp.asarray(blocks)))
    f = np.asarray(P.idct_fast(jnp.asarray(blocks)))
    # float64 ground truth
    M = P.IDCT_M
    want = np.einsum("pu,nuv,qv->npq", M, blocks.astype(np.float64), M)
    # exact truncates after each 1-D pass (reference semantics): the first
    # truncation (up to 1) is amplified by the second pass, so within 3
    assert np.abs(e - want).max() <= 3.0
    # fast rounds once: within 1
    assert np.abs(f - want).max() <= 1.0
    assert np.abs(e - f).max() <= 3


def test_idct_matches_scipy_style_reference():
    # Compare against a float64 direct IDCT-II (orthonormal)
    rng = np.random.default_rng(2)
    blk = rng.integers(-512, 512, size=(8, 8)).astype(np.int32)
    M = P.IDCT_M  # float64 basis
    want = M @ blk.astype(np.float64) @ M.T
    got = np.asarray(P.idct_fast(jnp.asarray(blk)))
    assert np.abs(got - want).max() <= 1.0


def test_blocks_to_plane_layout():
    plane = np.arange(2 * 3 * 64, dtype=np.int32).reshape(2, 3, 64)
    img = np.asarray(P.blocks_to_plane(jnp.asarray(plane)))
    assert img.shape == (16, 24)
    # pixel (r, c) of block (br, bc) = plane[br, bc, (r%8)*8 + c%8]
    assert img[0, 0] == plane[0, 0, 0]
    assert img[3, 10] == plane[0, 1, 3 * 8 + 2]
    assert img[9, 17] == plane[1, 2, 1 * 8 + 1]


def test_upsample_nn():
    x = jnp.asarray(np.arange(6).reshape(2, 3))
    up = np.asarray(P.upsample_nn(x, 2, 2))
    assert up.shape == (4, 6)
    assert up[0, 0] == up[1, 1] == 0
    assert up[2, 4] == up[3, 5] == 5


def test_color_convert_clamps_and_truncates():
    y = jnp.asarray(np.array([[200, -300]], np.int32))
    cb = jnp.asarray(np.array([[0, 0]], np.int32))
    cr = jnp.asarray(np.array([[100, 0]], np.int32))
    rgb = np.asarray(P.ycbcr_to_rgb(y, cb, cr))
    # r = 200 + 140.2 + 128 = 468.2 -> clamp 255
    assert rgb[0, 0, 0] == 255
    # y=-300: -300 + 128 = -172 -> clamp 0
    assert rgb[0, 1, 0] == 0


def test_gray_to_rgb():
    y = jnp.asarray(np.array([[0, 127, 200]], np.int32))
    rgb = np.asarray(P.gray_to_rgb(y))
    assert rgb.shape == (1, 3, 3)
    assert rgb[0, 1, 0] == 255  # 127 + 128 = 255
    assert rgb[0, 2, 0] == 255  # clamped
    assert rgb[0, 0, 0] == 128


def test_upsample_fancy_constant_field():
    # A constant field must stay constant under triangular upsampling.
    x = jnp.full((4, 6), 77, jnp.int32)
    for vy, vx in [(2, 2), (1, 2), (2, 1)]:
        up = np.asarray(P.upsample_fancy(x, vy, vx))
        assert up.shape == (4 * vy, 6 * vx)
        assert np.all(up == 77), (vy, vx)


def test_upsample_fancy_h2v1_weights():
    # Interior samples: out[2i] = (3x[i] + x[i-1] + 1) >> 2,
    #                   out[2i+1] = (3x[i] + x[i+1] + 2) >> 2
    x = jnp.asarray(np.array([[0, 100, 200]], np.int32))
    up = np.asarray(P.upsample_fancy(x, 1, 2))
    assert up.tolist() == [[0, 25, 75, 125, 175, 200]]


def test_upsample_fancy_level_shift_commutes():
    # The +128 level shift must commute exactly through the int rounding.
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, size=(6, 8)).astype(np.int32)
    a = np.asarray(P.upsample_fancy(jnp.asarray(x), 2, 2)) + 128
    b = np.asarray(P.upsample_fancy(jnp.asarray(x + 128), 2, 2))
    assert np.array_equal(a, b)


def test_pixel_pipeline_idct_kron_mode():
    # Full pipeline with the fused Kronecker IDCT must track "fast" within
    # one count per sample.  The comparison is on the upsampled sample
    # planes (color="rgb" stores them level-shifted, unconverted): the
    # YCbCr->RGB matrix can turn a one-count chroma difference into up to
    # three counts of R, G or B, so RGB is not where the IDCT bound lives.
    from conftest import corpus_path
    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.models.decoder import decode_to_planes

    hdr = parser.parse_file(corpus_path("img2.jpg"))
    planes = tuple(jnp.asarray(p) for p in
                   decode_to_planes(hdr, entropy="python"))
    qts = tuple(jnp.asarray(hdr.quant_tables[c.tq].values)
                for c in hdr.components)
    samp = tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                 for c in hdr.components)
    a, b = (np.asarray(P.pixel_pipeline(
        planes, qts, height=hdr.height, width=hdr.width, samplings=samp,
        idct=mode, upsample="fancy", color="rgb"))
        for mode in ("fast", "kron"))
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_idct_kron_matches_fast():
    rng = np.random.default_rng(1)
    blocks = rng.integers(-512, 512, size=(300, 64)).astype(np.int32)
    q = rng.integers(1, 40, size=(64,)).astype(np.int32)
    fast = np.asarray(P.idct_fast(
        (jnp.asarray(blocks) * q).reshape(-1, 8, 8))).reshape(-1, 64)
    kron = np.asarray(P.idct_kron(jnp.asarray(blocks), jnp.asarray(q)))
    assert np.abs(fast - kron).max() <= 1


def test_idct_products_ask_for_highest_precision():
    assert P.MATMUL_PRECISION == jax.lax.Precision.HIGHEST
    blocks = jnp.zeros((4, 64), jnp.int32)
    for fn in (lambda: P.idct_fast(blocks.reshape(-1, 8, 8)),
               lambda: P.idct_kron(blocks, jnp.ones((64,), jnp.int32))):
        text = jax.jit(fn).lower().as_text()
        assert "HIGHEST" in text, text[:400]


@pytest.fixture(scope="module")
def megapixel_plane():
    """Dequantized luma blocks of the 1.1 MP corpus photo (img5.jpg)."""
    from conftest import corpus_path
    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.models.decoder import decode_to_planes

    hdr = parser.parse_file(corpus_path("img5.jpg"))
    y = decode_to_planes(hdr)[0]
    q = hdr.quant_tables[hdr.components[0].tq].values
    assert y.shape[0] * y.shape[1] * 64 >= 1_000_000
    return y.reshape(-1, 64), q


@pytest.mark.parametrize("mode", ["fast", "kron"])
def test_idct_within_one_count_on_megapixel_plane(megapixel_plane, mode):
    """``fast`` and ``kron`` round the float64 transform once: within +-1
    count of it on a real >= 1 MP plane; ``exact`` (reference truncation
    semantics) sits within 3 counts of the same transform, so the modes
    differ from it by at most 3."""
    blocks, q = megapixel_plane
    deq = blocks.astype(np.int64) * q
    want = np.matmul(np.matmul(P.IDCT_M, deq.reshape(-1, 8, 8)),
                     P.IDCT_M.T).reshape(-1, 64)
    if mode == "fast":
        got = np.asarray(P.idct_fast(
            jnp.asarray(deq.reshape(-1, 8, 8), jnp.int32))).reshape(-1, 64)
    else:
        got = np.asarray(P.idct_kron(jnp.asarray(blocks),
                                     jnp.asarray(q)))
    exact = np.asarray(P.idct_exact(
        jnp.asarray(deq.reshape(-1, 8, 8), jnp.int32))).reshape(-1, 64)
    assert np.abs(got - want).max() <= 1.0
    assert np.abs(exact - want).max() <= 3.5
    assert np.abs(got - exact).max() <= 3

"""4-component CMYK / YCCK (Adobe APP14) conformance.

Capability beyond the reference decoder, which hard-exits on any component
count other than 3 (jpeg.cpp:83-87).  Oracle: PIL/libjpeg on the same
bytes — PIL exposes Adobe CMYK JPEGs in the inverted convention (rawmode
``CMYK;I``), which `decode(colorspace="cmyk")` reproduces, and
`decode()`'s RGB output reimplements Pillow's cmyk2rgb bit-exactly, so RGB
differences are bounded by IDCT/color-arithmetic implementation deltas
alone (same tolerance class as the 3-component PIL comparisons).
"""

import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from conftest import corpus_path
from jpeg_decoder_tpu import decode  # noqa: E402
from jpeg_decoder_tpu.io import parser  # noqa: E402
from jpeg_decoder_tpu.types import JPEGError  # noqa: E402


# IDCT + color-arithmetic implementation tolerance vs libjpeg (islow,
# fixed-point color) — matches the bound used by the other PIL oracles.
TOL = 5


def _pil_cmyk_fixture(tmp_path, name="cmyk_photo.jpg"):
    """PIL-written CMYK JPEG (Adobe transform 0) from a corpus photo."""
    path = tmp_path / name
    Image.open(corpus_path("img2.jpg")).convert("CMYK").save(
        str(path), quality=92)
    return str(path)


def _smooth_planes(rng, h, w, n):
    planes = []
    for _ in range(n):
        a = rng.normal(size=(h // 8 + 1, w // 8 + 1))
        up = np.kron(a, np.ones((8, 8)))[:h, :w]
        planes.append(np.clip(128 + 80 * up, 0, 255))
    return planes


def test_cmyk_transform0_vs_pil(tmp_path):
    path = _pil_cmyk_fixture(tmp_path)
    hdr = parser.parse_file(path)
    assert len(hdr.components) == 4
    assert hdr.adobe_transform == 0
    assert hdr.colorspace == "cmyk"

    pil = Image.open(path)
    assert pil.mode == "CMYK"

    got = decode(path, colorspace="cmyk", upsample="fancy").rgb
    want = np.array(pil)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= TOL

    got_rgb = decode(path, upsample="fancy").rgb
    want_rgb = np.array(pil.convert("RGB"))
    assert np.abs(got_rgb.astype(int) - want_rgb.astype(int)).max() <= TOL


def test_ycck_transform2_vs_pil(tmp_path):
    rng = np.random.default_rng(7)
    planes = _smooth_planes(rng, 120, 88, 4)
    blob, _ = encode(None, raw_planes=planes, samplings=((1, 1),) * 4,
                     quality=95, app14_transform=2)
    path = tmp_path / "ycck.jpg"
    path.write_bytes(blob)

    hdr = parser.parse(blob)
    assert hdr.adobe_transform == 2
    assert hdr.colorspace == "ycck"

    pil = Image.open(io.BytesIO(blob))
    assert pil.mode == "CMYK"
    got = decode(blob, colorspace="cmyk").rgb
    assert np.abs(got.astype(int) - np.array(pil).astype(int)).max() <= TOL

    got_rgb = decode(blob).rgb
    want_rgb = np.array(pil.convert("RGB"))
    assert np.abs(got_rgb.astype(int) - want_rgb.astype(int)).max() <= TOL


def test_cmyk_subsampled_and_restarts(tmp_path):
    """4-component with mixed sampling factors + restart intervals."""
    rng = np.random.default_rng(11)
    planes = _smooth_planes(rng, 96, 112, 4)
    blob, _ = encode(None, raw_planes=planes,
                     samplings=((2, 2), (1, 1), (1, 1), (2, 2)),
                     quality=95, restart_interval=3, app14_transform=2)
    pil = Image.open(io.BytesIO(blob))
    assert pil.mode == "CMYK"
    got = decode(blob, colorspace="cmyk", upsample="fancy").rgb
    want = np.array(pil)
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    # Compounded deltas (IDCT + fixed-point YCCK color + upsample
    # rounding) push the worst pixel slightly past the flat-sampling
    # bound; the error stays tightly distributed.
    assert diff.max() <= TOL + 3
    assert diff.mean() <= 1.5


def test_cmyk_entropy_backends_agree(tmp_path):
    path = _pil_cmyk_fixture(tmp_path)
    a = decode(path, entropy="python", keep_planes=True)
    b = decode(path, entropy="native", keep_planes=True)
    for pa, pb in zip(a.quantized_planes, b.quantized_planes):
        np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(a.rgb, b.rgb)


def test_rgb_stored_adobe_transform0():
    rgb = np.array(
        Image.open(corpus_path("img2.jpg")).convert("RGB"))[:96, :96]
    planes = [rgb[..., i].astype(np.float64) for i in range(3)]
    blob, _ = encode(None, raw_planes=planes, samplings=((1, 1),) * 3,
                     quality=95, app14_transform=0)
    hdr = parser.parse(blob)
    assert hdr.colorspace == "rgb"
    pil = Image.open(io.BytesIO(blob))
    assert pil.mode == "RGB"
    got = decode(blob).rgb
    want = np.array(pil.convert("RGB"))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= TOL


def test_jfif_precedence_over_component_count():
    """JFIF 3-component streams remain YCbCr (libjpeg precedence rule)."""
    hdr = parser.parse_file(corpus_path("img.jpg"))
    assert hdr.saw_jfif
    assert hdr.colorspace == "ycbcr"


def test_colorspace_cmyk_rejected_for_3comp():
    with pytest.raises(JPEGError, match="4-component"):
        decode(corpus_path("img.jpg"), colorspace="cmyk")


def test_cmyk_batch_decoder(tmp_path):
    """BatchDecoder groups by colorspace and decodes CMYK correctly."""
    from jpeg_decoder_tpu.models.batch import BatchDecoder

    cmyk_path = _pil_cmyk_fixture(tmp_path)
    blobs = [open(cmyk_path, "rb").read(),
             open(corpus_path("img2.jpg"), "rb").read()]
    items = BatchDecoder(upsample="fancy").decode(blobs)
    assert all(it.error is None for it in items)
    pil_rgb = np.array(Image.open(cmyk_path).convert("RGB"))
    got = np.asarray(items[0].rgb)
    assert np.abs(got.astype(int) - pil_rgb.astype(int)).max() <= TOL
    ref = decode(corpus_path("img2.jpg"), idct="fast",
                 upsample="fancy").rgb
    got1 = np.asarray(items[1].rgb)
    assert got1.shape == ref.shape

"""Metadata handling beyond the reference decoder: EXIF orientation
(APP1 IFD0 tag 0x0112) and ICC profile reassembly (APP2 chunks).

The reference parses JFIF APP0 only and skips other APPn segments
(jpeg.cpp:37-65, 884-889).  Oracle: PIL for both the tag values and the
``exif_transpose`` pixel semantics.
"""

import io

import numpy as np
import pytest
from PIL import Image, ImageOps

from conftest import corpus_path
from jpeg_decoder_tpu import decode
from jpeg_decoder_tpu.io import parser
from jpeg_decoder_tpu.models.decoder import apply_exif_orientation



def _fixture(orientation: int) -> bytes:
    im = Image.open(corpus_path("img2.jpg")).convert("RGB")
    im = im.crop((0, 0, 64, 48))
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    im.save(buf, format="JPEG", quality=90, exif=exif)
    return buf.getvalue()


@pytest.mark.parametrize("orientation", list(range(1, 9)))
def test_exif_orientation_matches_pil(orientation):
    blob = _fixture(orientation)
    hdr = parser.parse(blob)
    assert hdr.exif_orientation == orientation

    pil = ImageOps.exif_transpose(Image.open(io.BytesIO(blob)))
    want = np.array(pil)
    got = decode(blob, orientation="respect", upsample="fancy",
                 idct="fast").rgb
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 3


def test_orientation_ignore_is_default():
    blob = _fixture(6)
    res = decode(blob)
    # Sensor order: 64x48, not the display-transposed 48x64.
    assert res.rgb.shape == (48, 64, 3)
    assert res.header.exif_orientation == 6


def test_apply_orientation_shapes():
    arr = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    for o in (5, 6, 7, 8):
        assert apply_exif_orientation(arr, o).shape == (3, 2, 3)
    for o in (None, 1, 2, 3, 4):
        assert apply_exif_orientation(arr, o).shape == (2, 3, 3)


def test_malformed_exif_is_ignored():
    blob = bytearray(_fixture(6))
    i = blob.find(b"Exif\x00\x00")
    blob[i + 6: i + 8] = b"XX"  # corrupt the TIFF byte-order mark
    hdr = parser.parse(bytes(blob))
    assert hdr.exif_orientation is None
    decode(bytes(blob))  # still decodes


def test_icc_profile_roundtrip():
    im = Image.open(corpus_path("img2.jpg")).convert("RGB")
    profile = b"\x00" * 16 + b"fake-icc-profile-payload" * 40
    buf = io.BytesIO()
    im.save(buf, format="JPEG", quality=85, icc_profile=profile)
    blob = buf.getvalue()
    pil_profile = Image.open(io.BytesIO(blob)).info.get("icc_profile")
    hdr = parser.parse(blob)
    assert hdr.icc_profile == pil_profile


def test_no_metadata_on_corpus():
    hdr = parser.parse_file(corpus_path("img.jpg"))
    assert hdr.exif_orientation is None
    assert hdr.icc_profile is None

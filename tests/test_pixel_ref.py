"""The all-NumPy float64 pixel reference (ops/pixel_ref.py) against the
device pipeline, and its stated RGB tolerance."""

import numpy as np
import pytest

from conftest import corpus_path
from jpeg_decoder_tpu import decode
from jpeg_decoder_tpu.ops import pixel_ref


def _blob(name):
    with open(corpus_path(name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("idct", ["fast", "kron"])
@pytest.mark.parametrize("name", ["img.jpg", "img4.jpg", "img6.jpg"])
def test_reference_matches_pipeline(name, idct):
    blob = _blob(name)
    ref = pixel_ref.decode(blob)
    got = decode(blob, idct=idct, upsample="fancy").rgb
    assert ref.shape == got.shape and ref.dtype == got.dtype
    d = np.abs(ref.astype(int) - got.astype(int))
    assert d.max() <= pixel_ref.RGB_TOLERANCE
    assert d.mean() < 0.05  # nearly every sample agrees exactly


def test_reference_nearest_neighbour_upsampling():
    blob = _blob("img2.jpg")
    ref = pixel_ref.decode(blob, upsample="nn")
    got = decode(blob, idct="fast", upsample="nn").rgb
    assert np.abs(ref.astype(int) - got.astype(int)).max() <= (
        pixel_ref.RGB_TOLERANCE)


def test_reference_fancy_matches_device_upsampler():
    """Integer fancy upsampling is exact: same arithmetic both sides."""
    import jax.numpy as jnp

    from jpeg_decoder_tpu.ops import pixel as P

    rng = np.random.default_rng(4)
    x = rng.integers(-128, 128, size=(9, 13)).astype(np.int64)
    for vy, vx in [(2, 2), (1, 2), (2, 1), (1, 1)]:
        want = pixel_ref.upsample_fancy(x, vy, vx)
        got = np.asarray(P.upsample_fancy(jnp.asarray(x, jnp.int32), vy, vx))
        assert np.array_equal(want, got), (vy, vx)


def test_reference_rejects_12_bit():
    from tools.encoder import encode

    rgb = np.zeros((16, 16, 3), np.uint16)
    blob, _ = encode(rgb, precision=12)
    with pytest.raises(ValueError):
        pixel_ref.decode(blob)


@pytest.mark.parametrize("name", ["img2.jpg", "img4.jpg",
                                  "prograssive-sample-2.jpg"])
def test_reference_planes_use_no_native_entropy(name, monkeypatch):
    """The reference's coefficients come from the pure-Python decoders,
    so a fault in the native entropy library cannot hide in a comparison
    against it."""
    from jpeg_decoder_tpu.entropy import native
    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.models.decoder import decode_to_planes

    hdr = parser.parse(_blob(name))
    want = decode_to_planes(hdr, entropy="auto")

    def banned(*a, **k):
        raise AssertionError("native entropy decoder called")

    for fn in ("decode_scan_baseline", "decode_scan_resilient",
               "decode_scan_subset", "decode_progressive"):
        monkeypatch.setattr(native, fn, banned)
    got = pixel_ref.reference_planes(hdr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)

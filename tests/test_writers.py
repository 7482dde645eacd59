"""Output-sink tests: BMP round-trip, PPM, PNG."""

import numpy as np
import pytest

from jpeg_decoder_tpu.io import writers


def test_bmp_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    for w in (7, 8, 9, 10):  # exercise all padding cases
        rgb = rng.integers(0, 256, size=(5, w, 3), dtype=np.uint8)
        p = tmp_path / f"x{w}.bmp"
        writers.write_bmp(p, rgb)
        back = writers.read_bmp(p)
        assert np.array_equal(back, rgb)


def test_ppm(tmp_path):
    rgb = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    p = tmp_path / "x.ppm"
    writers.write_ppm(p, rgb)
    raw = open(p, "rb").read()
    assert raw.startswith(b"P6\n3 2\n255\n")
    assert raw.endswith(rgb.tobytes())


def test_png_roundtrip(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, size=(4, 6, 3), dtype=np.uint8)
    p = tmp_path / "x.png"
    writers.write_image(p, rgb)
    back = np.asarray(Image.open(p).convert("RGB"))
    assert np.array_equal(back, rgb)



def test_png_without_pillow_raises_clearly(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    rgb = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(RuntimeError, match="Pillow"):
        writers.write_png(str(tmp_path / "x.png"), rgb)
    writers.write_image(str(tmp_path / "x.bmp"), rgb)  # needs no Pillow


def test_decode_paths_need_no_pillow(monkeypatch):
    """BatchDecoder and decode_batch_sharded run with Pillow unimportable
    (the GPU machine's baseline phases must not need it)."""
    import sys

    from conftest import corpus_path
    from jpeg_decoder_tpu.models.batch import BatchDecoder
    from jpeg_decoder_tpu.parallel import mesh as mesh_mod
    from jpeg_decoder_tpu.parallel.sharded import decode_batch_sharded

    blob = open(corpus_path("img2.jpg"), "rb").read()
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert BatchDecoder().decode([blob])[0].ok
    import jax

    mesh = mesh_mod.make_mesh((1, 1), ("data", "seg"),
                              devices=jax.devices()[:1])
    assert decode_batch_sharded([blob], mesh)[0].ok

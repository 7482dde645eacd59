"""The seeded corpus generator (tools/corpus.py): deterministic output and
the geometry each name records (BASELINE.md for the reference names)."""

import numpy as np
import pytest

import corpus
from jpeg_decoder_tpu.io import parser


def test_photo_is_deterministic_and_seeded():
    a = corpus.photo(120, 80, seed=5)
    assert a.shape == (80, 120, 3) and a.dtype == np.uint8
    assert np.array_equal(a, corpus.photo(120, 80, seed=5))
    assert not np.array_equal(a, corpus.photo(120, 80, seed=6))


def test_photo_is_not_white_noise():
    """Neighbouring pixels correlate strongly, as in a photograph."""
    img = corpus.photo(256, 192, seed=1).astype(np.float64)
    x, y = img[:, :-1].ravel(), img[:, 1:].ravel()
    assert np.corrcoef(x, y)[0, 1] > 0.9


def test_encoding_is_deterministic():
    spec = corpus.SPECS["img2.jpg"]
    assert corpus.encode_spec(spec, 7) == corpus.encode_spec(spec, 7)


@pytest.mark.parametrize("name", sorted(corpus.SPECS))
def test_corpus_name_has_recorded_geometry(name):
    width, height, samplings, ri, progressive = corpus.SPECS[name]
    hdr = parser.parse_file(corpus.path(name, 0))
    assert (hdr.width, hdr.height) == (width, height)
    assert tuple((c.h, c.v) for c in hdr.components) == samplings
    assert hdr.restart_interval == ri
    assert hdr.progressive == progressive
    assert hdr.precision == 8 and len(hdr.components) == 3
    if not progressive:
        n_seg = len(hdr.scans[0].seg_offsets) - 1
        mcus = -(-width // (8 * samplings[0][0])) * -(-height // (
            8 * samplings[0][1]))
        assert n_seg == (-(-mcus // ri) if ri else 1)


def test_photo_batch_cycles_baseline_shapes():
    blobs = corpus.photo_batch(7, seed=0)
    shapes = [(h.width, h.height) for h in map(parser.parse, blobs)]
    want = [corpus.SPECS[n][:2] for n in corpus.BASELINE]
    assert shapes == want + want[:1]
    assert blobs[0] != blobs[6]  # same shape, different photo

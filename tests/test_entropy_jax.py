"""scan_prep host packing + the v1 ablation decoder vs python_ref.

The v1 vmapped decoder was demoted from the production package to
tools/entropy_jax_v1.py (superseded by ops/entropy_flat's block-lockstep
decoder); its conformance stays pinned here so
the ablation comparison in tools/entropy_microbench.py remains valid.
"""

import os
import sys

import numpy as np
import pytest

from conftest import CORPUS, corpus_path
from jpeg_decoder_tpu.entropy import python_ref
from jpeg_decoder_tpu.io import parser
from jpeg_decoder_tpu.ops import scan_prep
from jpeg_decoder_tpu.types import JPEGError

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import entropy_jax_v1  # noqa: E402


def test_pack_words():
    w = scan_prep.pack_words(np.array([0xAB, 0xCD, 0xEF, 0x01, 0x23],
                                      np.uint8))
    assert w[0] == 0xABCDEF01
    assert w[1] == 0x23000000


@pytest.mark.parametrize("name", ["img2.jpg", "img4.jpg"])
def test_v1_matches_python(name):
    hdr = parser.parse_file(corpus_path(name))
    scan = hdr.scans[0]
    ref = python_ref.decode_scan_baseline(hdr, scan)
    got = entropy_jax_v1.decode_scan_baseline(hdr, scan)
    assert np.array_equal(ref, got), f"{name}: v1 device != python"


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in CORPUS
                                  if n not in ("img2.jpg", "img4.jpg")])
def test_v1_matches_python_full_corpus(name):
    hdr = parser.parse_file(corpus_path(name))
    scan = hdr.scans[0]
    ref = python_ref.decode_scan_baseline(hdr, scan)
    got = entropy_jax_v1.decode_scan_baseline(hdr, scan)
    assert np.array_equal(ref, got), f"{name}: v1 device != python"


def test_v1_corrupt_stream_flags_error():
    hdr = parser.parse_file(corpus_path("img4.jpg"))
    scan = hdr.scans[0]
    import dataclasses

    bad = scan.data.copy()
    bad[5:50] = 0xFF
    bad_scan = dataclasses.replace(scan, data=bad)
    with pytest.raises(JPEGError):
        entropy_jax_v1.decode_scan_baseline(hdr, bad_scan)

"""Sharding equivalence (SURVEY.md §4.3-4.4): single-device decode output ==
N-way segment-sharded output, exactly, on an 8-virtual-device CPU mesh.
shard_map code is identical on a CPU mesh and a GPU mesh."""

import io

import numpy as np
import pytest
from PIL import Image

from conftest import corpus_path
from jpeg_decoder_tpu import decode
from jpeg_decoder_tpu.entropy import python_ref
from jpeg_decoder_tpu.io import parser
from jpeg_decoder_tpu.ops import scan_prep
from jpeg_decoder_tpu.parallel import mesh as mesh_mod
from jpeg_decoder_tpu.parallel import sharded


@pytest.fixture(scope="module")
def mesh24():
    return mesh_mod.make_mesh((2, 4), ("data", "seg"))


@pytest.fixture(scope="module")
def mesh18():
    return mesh_mod.make_mesh((1, 8), ("data", "seg"))


def test_segment_sharded_equals_python_img4(mesh18):
    # img4.jpg: the corpus image with DRI=100 -> 50 restart segments.
    hdr = parser.parse_file(corpus_path("img4.jpg"))
    ref = python_ref.decode_scan_baseline(hdr, hdr.scans[0])
    got = sharded.decode_scan_sharded(hdr, hdr.scans[0], mesh18)
    assert np.array_equal(ref, got)


def test_segment_sharded_single_segment_image(mesh18):
    # DRI=0 image: one segment; sharded path must still be exact.
    hdr = parser.parse_file(corpus_path("img2.jpg"))
    ref = python_ref.decode_scan_baseline(hdr, hdr.scans[0])
    got = sharded.decode_scan_sharded(hdr, hdr.scans[0], mesh18)
    assert np.array_equal(ref, got)


def _reencode_with_restarts(path, blocks):
    rgb = np.asarray(Image.open(path).convert("RGB"))
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=88, subsampling=2,
                              restart_marker_blocks=blocks)
    return buf.getvalue()


@pytest.mark.parametrize("blocks", [1, 7, 64])
def test_synthetic_dri_variants(mesh18, blocks):
    # Re-encode a corpus image with different restart intervals (SURVEY.md
    # §4.3: "synthetically re-encoded DRI variants").
    data = _reencode_with_restarts(corpus_path("img2.jpg"), blocks)
    hdr = parser.parse(data)
    assert hdr.restart_interval == blocks
    ref = python_ref.decode_scan_baseline(hdr, hdr.scans[0])
    got = sharded.decode_scan_sharded(hdr, hdr.scans[0], mesh18)
    assert np.array_equal(ref, got)


def test_full_step_batch_matches_single(mesh24):
    hdr = parser.parse_file(corpus_path("img4.jpg"))
    words, nm, _bc, _mm, _lay = scan_prep.prepare_scan(hdr, hdr.scans[0])
    batch = 5  # not divisible by 'data' axis: exercises batch padding
    rgb, err, _err_img = sharded.full_decode_step(
        hdr, np.stack([words] * batch), np.stack([nm] * batch), mesh24,
        idct="fast", upsample="nn")
    assert not bool(np.asarray(err).any())
    ref = decode(corpus_path("img4.jpg"), entropy="python",
                 idct="fast", upsample="nn").rgb
    rgb = np.asarray(rgb)
    assert rgb.shape[0] == batch
    for i in range(batch):
        assert np.array_equal(rgb[i], ref), f"batch element {i}"


def test_batch_pixel_pipeline_dp(mesh24):
    hdr = parser.parse_file(corpus_path("img2.jpg"))
    from jpeg_decoder_tpu.models import decoder as dec

    planes = dec.decode_to_planes(hdr, entropy="python")
    B = 8
    batch = tuple(np.stack([p] * B) for p in planes)
    qtables = tuple(hdr.quant_tables[c.tq].values for c in hdr.components)
    rgb = sharded.batch_pixel_pipeline(batch, qtables, hdr, mesh24,
                                       idct="fast", upsample="fancy")
    ref = decode(corpus_path("img2.jpg"), entropy="python",
                 idct="fast", upsample="fancy").rgb
    rgb = np.asarray(rgb)
    assert rgb.shape == (B, hdr.height, hdr.width, 3)
    for i in range(B):
        assert np.array_equal(rgb[i], ref)


def test_spec_lanes_sharded_across_devices(mesh24, corpus_sync_window):
    """VERDICT r2 item 2: DRI=0 speculative chunk lanes are PLACED across
    the mesh (not run on the default device) and stay bit-exact."""
    from jpeg_decoder_tpu import decode as decode_one
    from jpeg_decoder_tpu.parallel.sharded import _spec_group_dispatch

    blob = open(corpus_path("img.jpg"), "rb").read()
    hdr = parser.parse(blob)
    assert hdr.restart_interval == 0
    scans = [h.scans[0] for h in (parser.parse(blob),) * 3]
    rgb, ok = _spec_group_dispatch(hdr, list(scans), mesh24,
                                   idct="fast", upsample="nn")
    assert bool(np.asarray(ok).all()), "device splice must succeed"
    # The rgb output is computed from lane work sharded over all 8 devices;
    # jit keeps the result sharded over 'data'.
    assert len(rgb.sharding.device_set) >= 2, rgb.sharding
    ref = decode_one(blob, idct="fast", upsample="nn").rgb
    got = np.asarray(rgb)
    for i in range(3):
        assert np.array_equal(got[i], ref), f"batch element {i}"


def test_decode_batch_sharded_dri0_mesh24(mesh24):
    """DRI=0 blobs through the full batch API on a 2x4 mesh: chunk lanes
    shard over 'seg', images over 'data'; bit-exact vs single decode."""
    from jpeg_decoder_tpu import decode as decode_one
    from jpeg_decoder_tpu.parallel.sharded import decode_batch_sharded

    blobs = [open(corpus_path(n), "rb").read()
             for n in ("img.jpg", "img2.jpg", "img3.jpg")]
    items = decode_batch_sharded(blobs * 2, mesh24, idct="fast",
                                 upsample="nn")
    for it, b in zip(items, blobs * 2):
        assert it.error is None
        ref = decode_one(b, idct="fast", upsample="nn").rgb
        assert np.array_equal(np.asarray(it.rgb), ref)


def test_decode_batch_sharded(mesh18):
    """Fully device-resident blob batch: host does parse+unstuff only;
    output identical to the single-image decode() path, per-image
    isolation for bad blobs."""
    from jpeg_decoder_tpu import decode as decode_one
    from jpeg_decoder_tpu.parallel.sharded import decode_batch_sharded

    blobs = [open(corpus_path(n), "rb").read()
             for n in ("img.jpg", "img2.jpg", "img4.jpg")]
    items = decode_batch_sharded(blobs, mesh18, idct="fast", upsample="nn")
    for it, b in zip(items, blobs):
        assert it.error is None
        ref = decode_one(b, idct="fast", upsample="nn").rgb
        assert np.array_equal(np.asarray(it.rgb), ref)
    items = decode_batch_sharded([blobs[0], b"garbage"], mesh18)
    assert items[0].error is None and items[1].error is not None


def test_hybrid_lanes_sharded_across_devices(mesh24):
    """Hybrid DRI=0 decode (host skeleton -> device true-start lanes):
    lanes are PLACED across the mesh and output stays bit-exact."""
    from jpeg_decoder_tpu import decode as decode_one
    from jpeg_decoder_tpu.parallel.sharded import _hybrid_group_dispatch

    blob = open(corpus_path("img.jpg"), "rb").read()
    hdr = parser.parse(blob)
    assert hdr.restart_interval == 0
    scans = [parser.parse(blob).scans[0] for _ in range(3)]
    rgb, ok = _hybrid_group_dispatch(hdr, scans, mesh24,
                                     idct="fast", upsample="nn")
    assert bool(np.asarray(ok).all())
    assert len(rgb.sharding.device_set) >= 2, rgb.sharding
    ref = decode_one(blob, idct="fast", upsample="nn").rgb
    got = np.asarray(rgb)
    for i in range(3):
        assert np.array_equal(got[i], ref), f"batch element {i}"


def test_decode_batch_sharded_spec_forced(mesh24, monkeypatch):
    """JD_DEVICE_ENTROPY=spec keeps the zero-host-cycles speculative path
    selectable, bit-exact."""
    from jpeg_decoder_tpu import decode as decode_one
    from jpeg_decoder_tpu.parallel.sharded import decode_batch_sharded

    monkeypatch.setenv("JD_DEVICE_ENTROPY", "spec")
    blob = open(corpus_path("img2.jpg"), "rb").read()
    items = decode_batch_sharded([blob] * 2, mesh24, idct="fast",
                                 upsample="nn")
    ref = decode_one(blob, idct="fast", upsample="nn").rgb
    for it in items:
        assert it.error is None
        assert np.array_equal(np.asarray(it.rgb), ref)


def _truncated_blob(blob: bytes) -> bytes:
    """Remove the middle half of the entropy body (parseable, but the
    skeleton scan detects the truncation)."""
    sos = blob.find(b"\xff\xda")
    body = sos + 2 + int.from_bytes(blob[sos + 2: sos + 4], "big")
    eoi = blob.rfind(b"\xff\xd9")
    cut_a = body + (eoi - body) // 4
    cut_b = body + 3 * (eoi - body) // 4
    return blob[:cut_a] + blob[cut_b:]


def test_decode_batch_sharded_truncated_stream_best_effort(mesh18):
    """A truncated DRI=0 stream falls off the hybrid path (the skeleton
    scan detects the overrun) into the speculative chain, which decodes
    best-effort — neighbors in the same geometry group stay exact."""
    from jpeg_decoder_tpu import decode as decode_one
    from jpeg_decoder_tpu.io.parser import parse
    from jpeg_decoder_tpu.ops import entropy_spec
    from jpeg_decoder_tpu.parallel.sharded import decode_batch_sharded

    blob = open(corpus_path("img2.jpg"), "rb").read()
    hdr = parse(blob)
    bad_blob = _truncated_blob(blob)
    assert parse(bad_blob).width == hdr.width  # same geometry group
    bad_hdr = parse(bad_blob)
    with pytest.raises(Exception):
        entropy_spec.decode_scan_hybrid(bad_hdr, bad_hdr.scans[0])

    items = decode_batch_sharded([blob, bad_blob, blob], mesh18,
                                 idct="fast", upsample="nn")
    ref = decode_one(blob, idct="fast", upsample="nn").rgb
    assert items[0].error is None
    assert np.array_equal(np.asarray(items[0].rgb), ref)
    assert items[2].error is None
    assert np.array_equal(np.asarray(items[2].rgb), ref)
    # The truncated image decodes best-effort via the speculative chain
    # (premature-EOF streams fill from zero bits, libjpeg-style).
    assert items[1].error is None
    assert np.asarray(items[1].rgb).shape == ref.shape


def test_decode_batch_sharded_fallback_failure_isolated(mesh18,
                                                       monkeypatch):
    """If the per-image fallback itself raises, only that image errors —
    the rest of its geometry group still decodes (per-image isolation in
    _spec_group_finalize)."""
    from jpeg_decoder_tpu import decode as decode_one
    from jpeg_decoder_tpu.io.parser import parse
    from jpeg_decoder_tpu.ops import entropy_spec
    from jpeg_decoder_tpu.parallel.sharded import decode_batch_sharded
    from jpeg_decoder_tpu.types import JPEGError

    blob = open(corpus_path("img2.jpg"), "rb").read()
    bad_blob = _truncated_blob(blob)
    assert parse(bad_blob).width == parse(blob).width

    def boom(*a, **k):
        raise JPEGError("fallback failed (test)")

    monkeypatch.setattr(entropy_spec, "decode_scan_speculative", boom)
    items = decode_batch_sharded([blob, bad_blob, blob], mesh18,
                                 idct="fast", upsample="nn")
    ref = decode_one(blob, idct="fast", upsample="nn").rgb
    assert items[0].error is None
    assert np.array_equal(np.asarray(items[0].rgb), ref)
    assert items[2].error is None
    assert np.array_equal(np.asarray(items[2].rgb), ref)
    assert items[1].error is not None, "failed fallback must fail alone"

"""Device speculative chunk-parallel decode (ops/entropy_spec.py).

The DRI=0 corpus images (5 of 6) decode chunk-parallel bit-exactly, the
gap fallback keeps correctness when synchronization is made impossible,
and degenerate chunkings behave.
"""

import numpy as np
import pytest

from conftest import CORPUS, corpus_path

from jpeg_decoder_tpu.io import parser
from jpeg_decoder_tpu.entropy import python_ref
from jpeg_decoder_tpu.ops import entropy_spec
from jpeg_decoder_tpu.types import JPEGError

from tools.encoder import encode

DRI0 = [n for n in CORPUS if n != "img4.jpg"]  # img4 has DRI=100


@pytest.mark.parametrize("name", DRI0)
def test_corpus_bit_exact(name):
    hdr = parser.parse_file(corpus_path(name))
    scan = hdr.scans[0]
    ref = python_ref.decode_scan_baseline(hdr, scan)
    got = entropy_spec.decode_scan_speculative(hdr, scan)
    assert np.array_equal(got, ref)


def test_small_chunks_stress_sync():
    hdr = parser.parse_file(corpus_path("img3.jpg"))
    scan = hdr.scans[0]
    ref = python_ref.decode_scan_baseline(hdr, scan)
    got = entropy_spec.decode_scan_speculative(hdr, scan, chunk_bytes=1024)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("ovf", [0, 16])
def test_gap_fallback_exact(ovf):
    """With a tiny/zero overflow window lanes cannot synchronize; the host
    sequential fallback must still make the result exact (the C++ phase-3
    guarantee, jpeg_entropy.cpp:425-430)."""
    hdr = parser.parse_file(corpus_path("img2.jpg"))
    scan = hdr.scans[0]
    ref = python_ref.decode_scan_baseline(hdr, scan)
    got = entropy_spec.decode_scan_speculative(
        hdr, scan, chunk_bytes=2048, ovf_bytes=ovf)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("samplings", [
    ((1, 1), (1, 1), (1, 1)),
    ((2, 2), (1, 1), (1, 1)),
    ((2, 1), (1, 2), (1, 1)),
])
def test_synthetic_bit_exact(samplings):
    rng = np.random.default_rng(21)
    rgb = rng.integers(0, 256, (160, 200, 3), np.uint8)
    blob, _ = encode(rgb, samplings=samplings)
    hdr = parser.parse(blob)
    scan = hdr.scans[0]
    ref = python_ref.decode_scan_baseline(hdr, scan)
    got = entropy_spec.decode_scan_speculative(hdr, scan, chunk_bytes=1024)
    assert np.array_equal(got, ref)


def test_single_chunk_degenerate():
    """A stream shorter than one chunk runs as one lane (plain decode)."""
    rng = np.random.default_rng(22)
    blob, _ = encode(rng.integers(0, 256, (24, 24, 3), np.uint8))
    hdr = parser.parse(blob)
    scan = hdr.scans[0]
    assert np.array_equal(
        entropy_spec.decode_scan_speculative(hdr, scan),
        python_ref.decode_scan_baseline(hdr, scan))


def test_rejects_restart_streams():
    hdr = parser.parse_file(corpus_path("img4.jpg"))
    with pytest.raises(JPEGError):
        entropy_spec.decode_scan_speculative(hdr, hdr.scans[0])


@pytest.mark.parametrize("name", DRI0)
@pytest.mark.parametrize("chunk", [1024, 2048, 4096])
def test_device_splice_succeeds_no_fallback(name, chunk, corpus_sync_window):
    """With the window the corpus needs (conftest.CORPUS_SYNC_X), the device
    splice must succeed on every corpus image — the host splice is a
    correctness net, not the shipped path.  Pins the
    error-restart speculation (an aborted lane byte-aligns and retries
    instead of parking) and the skew-sized record caps; without them most
    corpus images silently fell back to the host."""
    from jpeg_decoder_tpu.ops import entropy_spec as es

    hdr = parser.parse_file(corpus_path(name))
    scan = hdr.scans[0]
    flags = {}
    orig = es._spec_pipeline

    def capture(*a, **k):
        r = orig(*a, **k)
        flags["ok"] = bool(r[1])
        return r

    es._spec_pipeline = capture
    try:
        got = es.decode_scan_speculative(hdr, scan, chunk_bytes=chunk)
    finally:
        es._spec_pipeline = orig
    assert flags["ok"], "device splice fell back to host"
    assert np.array_equal(got, python_ref.decode_scan_baseline(hdr, scan))


@pytest.mark.parametrize("name", DRI0)
def test_spec_batch_pipeline(name, corpus_sync_window):
    """The batched speculative pipeline (one program for B images)
    matches python_ref with every image's device splice succeeding."""
    import jax.numpy as jnp

    from jpeg_decoder_tpu.layout import scan_layout
    from jpeg_decoder_tpu.ops import entropy_flat
    from jpeg_decoder_tpu.ops import entropy_spec as es

    hdr = parser.parse_file(corpus_path(name))
    scans = [hdr.scans[0]] * 3
    pools, base, lim, act, cap, C = es.prepare_spec_batch(hdr, scans)
    luts = entropy_flat.merged_luts(hdr, hdr.scans[0]).reshape(
        2 * len(hdr.components), 65536)
    lay = scan_layout(hdr)
    bc = tuple(ci for ci, c in enumerate(hdr.components)
               for _ in range(c.v * c.h))
    blocks, ok = es._spec_pipeline_batch(
        jnp.asarray(pools), jnp.asarray(base), jnp.asarray(lim),
        jnp.asarray(act), jnp.asarray(luts), block_comp=bc,
        n_comps=len(hdr.components), cap=cap, n_mcus=lay.n_mcus, C=C)
    assert np.asarray(ok).all()
    ref = python_ref.decode_scan_baseline(hdr, hdr.scans[0])
    for b in np.asarray(blocks):
        assert np.array_equal(b, ref)


# ---------------------------------------------------------------------------
# Hybrid decode: host skeleton scan -> device lanes from TRUE MCU starts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DRI0)
def test_hybrid_corpus_bit_exact(name):
    hdr = parser.parse_file(corpus_path(name))
    scan = hdr.scans[0]
    ref = python_ref.decode_scan_baseline(hdr, scan)
    got = entropy_spec.decode_scan_hybrid(hdr, scan)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("lanes", [1, 3, 64, 1000])
def test_hybrid_lane_counts(lanes):
    """Lane-count edge cases (lockstep form): 1 lane (degenerate),
    non-dividing counts (remainder lane), more lanes than saturating."""
    hdr = parser.parse_file(corpus_path("img2.jpg"))
    scan = hdr.scans[0]
    ref = python_ref.decode_scan_baseline(hdr, scan)
    got = entropy_spec.decode_scan_hybrid(
        hdr, scan, max_lanes_total=lanes, kernel="lockstep")
    assert np.array_equal(got, ref)


def test_hybrid_skeleton_positions_match_python():
    """The native skeleton scan's recorded MCU start bits equal the ones
    the pure-Python decoder passes through."""
    from jpeg_decoder_tpu.entropy import native
    from jpeg_decoder_tpu.huffman import build_lut
    from jpeg_decoder_tpu.layout import scan_layout

    hdr = parser.parse_file(corpus_path("img2.jpg"))
    scan = hdr.scans[0]
    lay = scan_layout(hdr)
    stride = 7
    bits = native.skeleton_scan(hdr, scan, stride)

    reader = python_ref.BitReader(scan.data.tobytes())
    dc_luts = {c.td: build_lut(scan.dc_specs[c.td]).tolist()
               for c in hdr.components}
    ac_luts = {c.ta: build_lut(scan.ac_specs[c.ta]).tolist()
               for c in hdr.components}
    block = np.zeros(64, np.int64)
    expected = []
    for m in range(lay.n_mcus):
        if m % stride == 0:
            expected.append(reader.pos)
        for c in hdr.components:
            for _ in range(c.v * c.h):
                block[:] = 0
                python_ref.decode_block(reader, dc_luts[c.td],
                                        ac_luts[c.ta], block, 0, 11, 10)
    assert list(bits) == expected


def test_hybrid_batch_pipeline():
    """The batched hybrid pipeline (one program for B images) matches
    python_ref for every image."""
    import jax.numpy as jnp

    from jpeg_decoder_tpu.layout import scan_layout
    from jpeg_decoder_tpu.ops import entropy_flat
    from jpeg_decoder_tpu.ops import entropy_spec as es

    hdr = parser.parse_file(corpus_path("img3.jpg"))
    scans = [hdr.scans[0]] * 3
    pools, starts, nm, stride, C, skel_ok = es.prepare_hybrid_batch(
        hdr, scans)
    assert skel_ok.all()
    luts = entropy_flat.merged_luts(hdr, hdr.scans[0]).reshape(
        2 * len(hdr.components), 65536)
    lay = scan_layout(hdr)
    bc = tuple(ci for ci, c in enumerate(hdr.components)
               for _ in range(c.v * c.h))
    blocks, bad = es._hybrid_pipeline_batch(
        jnp.asarray(pools), jnp.asarray(starts), jnp.asarray(nm),
        jnp.asarray(luts), block_comp=bc, n_comps=len(hdr.components),
        stride=stride, n_mcus=lay.n_mcus, C=C)
    assert not np.asarray(bad).any()
    ref = python_ref.decode_scan_baseline(hdr, hdr.scans[0])
    for b in np.asarray(blocks):
        assert np.array_equal(b, ref)


def test_hybrid_corrupt_stream_raises():
    """A corrupt stream fails the skeleton scan (host), not the device."""
    hdr = parser.parse_file(corpus_path("img2.jpg"))
    scan = hdr.scans[0]
    bad = np.array(scan.data, np.uint8).copy()
    bad[len(bad) // 2: len(bad) // 2 + 64] = 0xFF  # invalid prefix run
    scan.data = bad
    with pytest.raises(JPEGError):
        entropy_spec.decode_scan_hybrid(hdr, scan)


@pytest.mark.parametrize("name", DRI0)
def test_hybrid_balanced_corpus_bit_exact(name):
    """Byte-balanced lanes + flat scalar-commit kernel: bit-exact."""
    import jax.numpy as jnp

    from jpeg_decoder_tpu.layout import scan_layout
    from jpeg_decoder_tpu.ops import entropy_flat
    from jpeg_decoder_tpu.ops import entropy_spec as es

    hdr = parser.parse_file(corpus_path(name))
    scans = [hdr.scans[0]] * 2
    pools, starts, nm, max_nm, C, src, ok = \
        es.prepare_hybrid_batch_balanced(hdr, scans)
    assert ok.all()
    lay = scan_layout(hdr)
    bc = tuple(ci for ci, c in enumerate(hdr.components)
               for _ in range(c.v * c.h))
    luts = entropy_flat.merged_luts(hdr, hdr.scans[0])
    blocks, bad = es._hybrid_pipeline_batch_flat(
        jnp.asarray(pools), jnp.asarray(starts), jnp.asarray(nm),
        jnp.asarray(src), jnp.asarray(luts), block_comp=bc,
        n_comps=len(hdr.components), max_nm=max_nm, n_mcus=lay.n_mcus,
        C=C, precision=hdr.precision)
    assert not np.asarray(bad).any()
    ref = python_ref.decode_scan_baseline(hdr, hdr.scans[0])
    for b in np.asarray(blocks):
        assert np.array_equal(b, ref)


def test_hybrid_balanced_lane_cap():
    """A tight lane-size cap (cap_factor=1 forces every boundary to the
    cap) still covers all MCUs and stays exact."""
    import jax.numpy as jnp

    from jpeg_decoder_tpu.layout import scan_layout
    from jpeg_decoder_tpu.ops import entropy_flat
    from jpeg_decoder_tpu.ops import entropy_spec as es

    hdr = parser.parse_file(corpus_path("img2.jpg"))
    scans = [hdr.scans[0]]
    pools, starts, nm, max_nm, C, src, ok = \
        es.prepare_hybrid_batch_balanced(hdr, scans, cap_factor=1)
    assert ok.all()
    lay = scan_layout(hdr)
    assert int(nm.sum()) == lay.n_mcus
    assert int(nm.max()) <= -(-lay.n_mcus // C) + 1
    bc = tuple(ci for ci, c in enumerate(hdr.components)
               for _ in range(c.v * c.h))
    luts = entropy_flat.merged_luts(hdr, hdr.scans[0])
    blocks, bad = es._hybrid_pipeline_batch_flat(
        jnp.asarray(pools), jnp.asarray(starts), jnp.asarray(nm),
        jnp.asarray(src), jnp.asarray(luts), block_comp=bc,
        n_comps=len(hdr.components), max_nm=max_nm, n_mcus=lay.n_mcus,
        C=C, precision=hdr.precision)
    assert not np.asarray(bad).any()
    ref = python_ref.decode_scan_baseline(hdr, hdr.scans[0])
    assert np.array_equal(np.asarray(blocks)[0], ref)


def test_flat_scalar_commit_matches_block_commit():
    """decode_flat's scalar-commit mode emits the same blocks as the
    block-commit mode (restart-segment lanes, img4)."""
    import jax.numpy as jnp

    from jpeg_decoder_tpu.ops import entropy_flat

    hdr = parser.parse_file(corpus_path("img4.jpg"))
    scan = hdr.scans[0]
    pool, base, nblocks, mb, bc, lay = \
        entropy_flat.prepare_scan_flat(hdr, scan)
    luts = entropy_flat.merged_luts(hdr, scan)
    outs = {}
    for mode in ("block", "scalar"):
        out, err, *_ = entropy_flat.decode_flat(
            jnp.asarray(pool), jnp.asarray(base), jnp.asarray(nblocks),
            jnp.full(base.shape, 2**30, jnp.int32), jnp.asarray(luts),
            block_comp=bc, n_comps=len(hdr.components), max_blocks=mb,
            commit=mode)
        assert not np.asarray(err).any()
        outs[mode] = np.asarray(out)
    assert np.array_equal(outs["block"], outs["scalar"])


@pytest.mark.parametrize("name", DRI0)
def test_hybrid_emit_corpus_bit_exact(name):
    """Symbol-balanced lanes + emission kernel: bit-exact."""
    import jax.numpy as jnp

    from jpeg_decoder_tpu.layout import scan_layout
    from jpeg_decoder_tpu.ops import entropy_flat
    from jpeg_decoder_tpu.ops import entropy_spec as es

    hdr = parser.parse_file(corpus_path(name))
    scans = [hdr.scans[0]] * 2
    pools, starts, nm, lane_off, T, _T2, C, seg_first, ok = \
        es.prepare_hybrid_batch_emit(hdr, scans)
    assert ok.all()
    lay = scan_layout(hdr)
    assert (nm.sum(axis=1) == lay.n_mcus).all()
    bc = tuple(ci for ci, c in enumerate(hdr.components)
               for _ in range(c.v * c.h))
    luts = entropy_flat.merged_luts(hdr, hdr.scans[0])
    blocks, bad = es._hybrid_pipeline_batch_emit(
        jnp.asarray(pools), jnp.asarray(starts), jnp.asarray(nm),
        jnp.asarray(lane_off), jnp.asarray(seg_first), jnp.asarray(luts),
        block_comp=bc,
        n_comps=len(hdr.components), T=T, n_mcus=lay.n_mcus, C=C,
        precision=hdr.precision)
    assert not np.asarray(bad).any()
    ref = python_ref.decode_scan_baseline(hdr, hdr.scans[0])
    for b in np.asarray(blocks):
        assert np.array_equal(b, ref)


def test_hybrid_emit_tight_T_flags_error():
    """An underestimated trip count T must flag the image (n_done short),
    never emit wrong data silently."""
    import jax.numpy as jnp

    from jpeg_decoder_tpu.layout import scan_layout
    from jpeg_decoder_tpu.ops import entropy_flat
    from jpeg_decoder_tpu.ops import entropy_spec as es

    hdr = parser.parse_file(corpus_path("img2.jpg"))
    scans = [hdr.scans[0]]
    pools, starts, nm, lane_off, T, _T2, C, seg_first, ok = \
        es.prepare_hybrid_batch_emit(hdr, scans)
    lay = scan_layout(hdr)
    bc = tuple(ci for ci, c in enumerate(hdr.components)
               for _ in range(c.v * c.h))
    luts = entropy_flat.merged_luts(hdr, hdr.scans[0])
    _blocks, bad = es._hybrid_pipeline_batch_emit(
        jnp.asarray(pools), jnp.asarray(starts), jnp.asarray(nm),
        jnp.asarray(lane_off), jnp.asarray(seg_first), jnp.asarray(luts),
        block_comp=bc,
        n_comps=len(hdr.components), T=64, n_mcus=lay.n_mcus, C=C,
        precision=hdr.precision)
    assert np.asarray(bad).all()


def test_skeleton_symbol_counts_consistent():
    """Per-MCU symbol counts are positive and at least 1 DC probe + 1
    per block; summed they bound the emission trip count."""
    from jpeg_decoder_tpu.entropy import native
    from jpeg_decoder_tpu.layout import scan_layout

    hdr = parser.parse_file(corpus_path("img3.jpg"))
    scan = hdr.scans[0]
    lay = scan_layout(hdr)
    bits, syms = native.skeleton_scan(hdr, scan, 1, want_syms=True)
    assert len(bits) == lay.n_mcus and len(syms) == lay.n_mcus
    assert (syms >= lay.blocks_per_mcu).all()  # >= 1 probe per block
    # Total probes can't exceed total stream bits / 2 (min 2 bits/code
    # in any canonical table with >1 symbol) and must exceed blocks.
    assert syms.sum() >= lay.n_mcus * lay.blocks_per_mcu
    assert syms.sum() <= len(scan.data) * 8


def test_hybrid_emit_restart_stream():
    """Restart streams decode through the emission path: per-segment
    skeletons, segment starts forced as lane boundaries, segmented DC
    prefix sum — bit-exact vs python_ref, MCU-granular parallelism."""
    from jpeg_decoder_tpu.layout import scan_layout
    from jpeg_decoder_tpu.ops import entropy_spec as es

    hdr = parser.parse_file(corpus_path("img4.jpg"))
    scan = hdr.scans[0]
    assert scan.restart_interval > 0
    ref = python_ref.decode_scan_baseline(hdr, scan)
    got = es.decode_scan_hybrid(hdr, scan)
    assert np.array_equal(got, ref)

    lay = scan_layout(hdr)
    bpm = lay.blocks_per_mcu
    pools, starts, nm, lane_off, T, _T2, C, seg_first, ok = \
        es.prepare_hybrid_batch_emit(hdr, [scan])
    assert ok.all()
    # Every segment start is a lane boundary (a lane never crosses the
    # byte-alignment gap at a restart marker).
    n_seg = len(scan.seg_offsets) - 1
    m_lo = set((lane_off[0][nm[0] > 0] // (bpm * 64)).tolist())
    for s in range(n_seg):
        assert s * scan.restart_interval in m_lo


def test_hybrid_emit_restart_mcu_granular():
    """A stream with FEW long segments still fills many balanced lanes:
    parallelism is MCU-granular, not segment-granular."""
    import io as _io

    from PIL import Image

    from jpeg_decoder_tpu.ops import entropy_spec as es

    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (256, 320, 3), np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=90, subsampling=2,
                              restart_marker_blocks=300)
    hdr = parser.parse(buf.getvalue())
    scan = hdr.scans[0]
    n_seg = len(scan.seg_offsets) - 1
    assert 1 < n_seg < 8
    ref = python_ref.decode_scan_baseline(hdr, scan)
    got = es.decode_scan_hybrid(hdr, scan)
    assert np.array_equal(got, ref)
    pools, starts, nm, lane_off, T, _T2, C, seg_first, ok = \
        es.prepare_hybrid_batch_emit(hdr, [scan])
    assert ok.all()
    assert int((nm[0] > 0).sum()) > n_seg

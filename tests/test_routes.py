"""decode_batch_sharded reports the route each image took (BatchItem.route),
so a caller can tell device routes from the per-image host fallback."""

import numpy as np
import pytest

from conftest import corpus_path
from jpeg_decoder_tpu.parallel import mesh as mesh_mod
from jpeg_decoder_tpu.parallel.sharded import decode_batch_sharded


@pytest.fixture(scope="module")
def mesh11():
    import jax

    return mesh_mod.make_mesh((1, 1), ("data", "seg"),
                              devices=jax.devices()[:1])


def _blob(name):
    with open(corpus_path(name), "rb") as f:
        return f.read()


def test_routes_baseline_progressive_and_host(mesh11):
    from tools.encoder import encode

    arith, _ = encode(np.full((16, 24, 3), 90, np.uint8), arithmetic=True)
    blobs = [_blob("img2.jpg"), _blob("img4.jpg"),
             _blob("prograssive-sample-2.jpg"), arith, b"\xff\xd8junk"]
    items = decode_batch_sharded(blobs, mesh11, idct="fast")
    routes = [it.route for it in items]
    assert routes[0] in ("hybrid", "hybrid-dyn")
    assert routes[1] in ("hybrid", "hybrid-dyn")      # restart, emission
    assert routes[2] == "progressive"
    assert routes[3] == "host"          # arithmetic: host entropy path
    assert items[4].error is not None and routes[4] is None


def test_restart_lockstep_route_is_reported(mesh11, monkeypatch):
    monkeypatch.setenv("JD_RESTART_EMIT_MAX_LANES", "0")
    items = decode_batch_sharded([_blob("img4.jpg")], mesh11, idct="fast")
    assert items[0].ok and items[0].route == "lockstep"


def test_batch_decoder_items_carry_no_route():
    from jpeg_decoder_tpu.models.batch import BatchDecoder

    items = BatchDecoder().decode([_blob("img2.jpg")])
    assert items[0].ok and items[0].route is None


def test_multi_device_meshes_dispatch_from_one_thread(monkeypatch):
    """Programs with collectives over several devices must be enqueued in
    one order on every device: two threads dispatching them concurrently
    can deadlock a GPU collective.  On a multi-device mesh every group
    and every progressive chain dispatches from the calling thread."""
    import threading

    import jax

    from jpeg_decoder_tpu.ops import entropy_prog
    from jpeg_decoder_tpu.parallel import sharded

    seen = []

    def spy(fn):
        def wrapped(*a, **k):
            seen.append(threading.current_thread())
            return fn(*a, **k)
        return wrapped

    for name in ("_hybrid_group_dispatch", "_hybrid_group_dispatch_dyn",
                 "full_decode_step"):
        monkeypatch.setattr(sharded, name, spy(getattr(sharded, name)))
    monkeypatch.setattr(entropy_prog, "_apply_chain",
                        spy(entropy_prog._apply_chain))
    monkeypatch.setattr(entropy_prog, "_chain_step",
                        spy(entropy_prog._chain_step))
    monkeypatch.setenv("JD_RESTART_EMIT_MAX_LANES", "0")
    mesh = mesh_mod.make_mesh((2, 2), ("data", "seg"),
                              devices=jax.devices()[:4])
    blobs = [_blob("img2.jpg"), _blob("img4.jpg"), _blob("img.jpg"),
             _blob("prograssive-sample-2.jpg")]
    items = decode_batch_sharded(blobs, mesh, idct="fast")
    assert all(it.ok for it in items)
    assert {it.route for it in items} >= {"lockstep", "progressive"}
    assert len(seen) >= 3
    assert all(t is threading.main_thread() for t in seen)


def _python_planes(blob):
    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.models.decoder import decode_to_planes

    return decode_to_planes(parser.parse(blob), entropy="python")


@pytest.mark.parametrize("restart_route", ["emission", "lockstep"])
def test_keep_planes_are_the_routes_coefficients(mesh11, monkeypatch,
                                                 restart_route):
    """keep_planes hands back the planes of the very programs that made
    each image's RGB, on every device route, cropped to the image's own
    geometry; they equal the Python reference decoder's."""
    if restart_route == "lockstep":
        monkeypatch.setenv("JD_RESTART_EMIT_MAX_LANES", "0")
    # img.jpg and img3.jpg share a pow-2 MCU bucket but not a geometry:
    # they take the bucketed (hybrid-dyn) route together.  Forcing restart
    # streams onto lockstep lanes also turns bucketing off.
    blobs = [_blob(n) for n in ("img.jpg", "img3.jpg", "img2.jpg",
                                "img4.jpg", "prograssive-sample-2.jpg")]
    items = decode_batch_sharded(blobs, mesh11, idct="fast",
                                 keep_planes=True)
    want_routes = (["hybrid", "hybrid", "hybrid", "lockstep"]
                   if restart_route == "lockstep" else
                   ["hybrid-dyn", "hybrid-dyn", "hybrid", "hybrid"])
    want_routes.append("progressive")
    assert [it.route for it in items] == want_routes
    for it, blob in zip(items, blobs):
        ref = _python_planes(blob)
        assert len(it.planes) == len(ref)
        for got, want in zip(it.planes, ref):
            assert np.array_equal(np.asarray(got), want), it.route
    plain = decode_batch_sharded(blobs, mesh11, idct="fast")
    assert all(it.planes is None for it in plain)
    for a, b in zip(items, plain):
        assert np.array_equal(np.asarray(a.rgb), np.asarray(b.rgb))

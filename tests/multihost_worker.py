"""Worker process for the multi-host (N-process CPU) sharding tests.

Usage: python multihost_worker.py <process_id> <num_processes> <port> \
           [local_devices=4] [batch=4]

Each process contributes ``local_devices`` virtual CPU devices to a global
(num_processes, local_devices) mesh and runs the single-jit full decode
step on a MIXED-GEOMETRY workload (VERDICT r1 item 8): a batch of
img4.jpg (4:4:4, DRI=100) and a batch of a synthetic 4:2:0 DRI stream —
each geometry is one ``full_decode_step`` call, images sharded across
processes ('data' ~ DCN) and restart segments across local devices
('seg' ~ ICI).  Each process validates its addressable output shards
against the bit-exact host decoder, prints per-geometry wall times, and
prints MULTIHOST_OK on success.
"""

import os
import sys
import time

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
local_devices = int(sys.argv[4]) if len(sys.argv) > 4 else 4
batch = int(sys.argv[5]) if len(sys.argv) > 5 else 4

os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={local_devices}")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jpeg_decoder_tpu.parallel import multihost  # noqa: E402

multihost.initialize(f"127.0.0.1:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == local_devices * nproc, len(jax.devices())

import numpy as np  # noqa: E402

from jpeg_decoder_tpu.entropy import python_ref  # noqa: E402
from jpeg_decoder_tpu.io import parser  # noqa: E402
from jpeg_decoder_tpu.ops import pixel as pixel_ops  # noqa: E402
from jpeg_decoder_tpu.ops import scan_prep  # noqa: E402
from jpeg_decoder_tpu.parallel import sharded  # noqa: E402
from jpeg_decoder_tpu import layout as layout_mod  # noqa: E402

mesh = multihost.global_mesh()
assert dict(mesh.shape) == {"data": nproc, "seg": local_devices}, mesh.shape


def geometry_workload():
    """Two decode geometries: the corpus DRI image and a synthetic 4:2:0
    DRI stream (different sampling, bpm, segment count)."""
    from tools import corpus
    from tools.encoder import encode

    yield "img4-4:4:4", corpus.read("img4.jpg")

    rng = np.random.default_rng(42)
    rgb = rng.integers(0, 256, (96, 144, 3), np.uint8)
    blob, _ = encode(rgb, samplings=((2, 2), (1, 1), (1, 1)),
                     restart_interval=6)
    yield "synth-4:2:0", blob


ok = True
for name, blob in geometry_workload():
    hdr = parser.parse(blob)
    lay = layout_mod.scan_layout(hdr)
    words, nm, _bc, _mm, _lay = scan_prep.prepare_scan(hdr, hdr.scans[0])
    t0 = time.perf_counter()
    rgb, err, _err_img = sharded.full_decode_step(
        hdr, np.stack([words] * batch), np.stack([nm] * batch), mesh,
        idct="fast", upsample="nn")
    jax.block_until_ready(rgb)
    dt = time.perf_counter() - t0

    scan_coefs = python_ref.decode_scan_baseline(hdr, hdr.scans[0])
    planes = tuple(
        scan_coefs[lay.comp_src[ci]].reshape(*lay.comp_shapes[ci], 64)
        for ci in range(len(hdr.components)))
    qts = tuple(hdr.quant_tables[c.tq].values for c in hdr.components)
    samplings = tuple(
        (hdr.v_max // c.v, hdr.h_max // c.h) for c in hdr.components)
    expected = np.asarray(pixel_ops.pixel_pipeline(
        planes, qts, height=hdr.height, width=hdr.width,
        samplings=samplings, idct="fast", upsample="nn"))

    n_bad = 0
    for shard in rgb.addressable_shards:
        got = np.asarray(shard.data)
        for row in range(got.shape[0]):
            if not np.array_equal(got[row], expected):
                n_bad += 1
    for shard in err.addressable_shards:
        if np.asarray(shard.data).any():
            n_bad += 1
    if n_bad:
        ok = False
    print(f"GEOM {name}: batch={batch} mesh={nproc}x{local_devices} "
          f"compile+run {dt:.2f}s bad_shards={n_bad}", flush=True)

# ---- Phase 2: the blob-level serving API across processes ----
# decode_batch_sharded with a MIXED batch (two baseline sizes sharing a
# geometry bucket, one progressive frame, one corrupt blob).  Device
# programs (incl. the progressive scan kernels' psum reductions) must
# enqueue in the same order on every process; flags gather via
# process_allgather.
import io

from PIL import Image
from jax.experimental import multihost_utils

from jpeg_decoder_tpu import decode as _decode_one


def _blob(w, h, seed, progressive=False):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(h // 8 + 1, w // 8 + 1, 3))
    arr = np.kron(base, np.ones((8, 8, 1)))[:h, :w].astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=88,
                              progressive=progressive)
    return buf.getvalue()


blobs = [_blob(120, 96, 1), _blob(88, 128, 2),
         _blob(96, 80, 3, progressive=True), b"\xff\xd8garbage"]
t0 = time.perf_counter()
items = sharded.decode_batch_sharded(blobs, mesh, idct="fast",
                                     upsample="nn")
dt = time.perf_counter() - t0
n_bad = 0
for it, blob in zip(items, blobs):
    if blob == blobs[-1]:
        if it.error is None:
            n_bad += 1
        continue
    if it.error is not None:
        n_bad += 1
        continue
    got = np.asarray(multihost_utils.process_allgather(
        it.rgb_batch, tiled=True))[it.batch_index]
    got = got[: it.header.height, : it.header.width]
    exp = _decode_one(blob, entropy="python", idct="fast",
                      upsample="nn").rgb
    if not np.array_equal(got, exp):
        n_bad += 1
if n_bad:
    ok = False
print(f"BATCH-API: mesh={nproc}x{local_devices} {dt:.2f}s "
      f"bad={n_bad}", flush=True)

print("MULTIHOST_OK" if ok else "MULTIHOST_MISMATCH", flush=True)
sys.exit(0 if ok else 1)

"""Example: multi-chip sharded decode over a ('data', 'seg') mesh.

Restart segments are JPEG's native unit of parallelism (DC predictors
reset at every RSTn marker), so a single image's entropy decode shards
across devices with zero communication in the hot loop; images shard over
the 'data' axis.  This example runs on a virtual CPU device pool so it
works anywhere; on several GPUs the same code runs over NVLink.

Run:  python examples/sharded_decode.py [n_devices]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N = int(sys.argv[1]) if len(sys.argv) > 1 else 8
import re  # noqa: E402

flags = os.environ.get("XLA_FLAGS", "")
want = f"--xla_force_host_platform_device_count={N}"
if "--xla_force_host_platform_device_count" in flags:
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+",
                   want, flags)
else:
    flags = f"{flags} {want}"
os.environ["XLA_FLAGS"] = flags

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from jpeg_decoder_tpu import decode  # noqa: E402
from jpeg_decoder_tpu.io import parser  # noqa: E402
from jpeg_decoder_tpu.ops import scan_prep  # noqa: E402
from jpeg_decoder_tpu.parallel import mesh as mesh_mod  # noqa: E402
from jpeg_decoder_tpu.parallel import sharded  # noqa: E402
from tools import corpus  # noqa: E402


def main():
    path = corpus.path("img4.jpg")  # DRI=100 -> 50 segments
    hdr = parser.parse_file(path)
    scan = hdr.scans[0]
    print(f"{path}: {hdr.width}x{hdr.height}, "
          f"{len(scan.seg_offsets) - 1} restart segments")

    shape = (2, N // 2) if N % 2 == 0 and N > 1 else (1, N)
    mesh = mesh_mod.make_mesh(shape, ("data", "seg"))
    print(f"mesh: {dict(mesh.shape)} over {N} devices")

    words, nm, _bc, _mm, _lay = scan_prep.prepare_scan(hdr, scan)
    batch = 4
    rgb, err, err_img = sharded.full_decode_step(
        hdr, np.stack([words] * batch), np.stack([nm] * batch), mesh,
        idct="fast", upsample="nn")
    assert not bool(np.asarray(err_img).any())

    ref = decode(path, entropy="python", idct="fast", upsample="nn").rgb
    assert np.array_equal(np.asarray(rgb)[0], np.asarray(ref))
    print(f"sharded decode of batch {batch}: bit-exact vs host decoder "
          f"({rgb.shape})")

    # The blob-level API: host does parse+unstuff only; everything else
    # (entropy, assembly, pixels) is one device program per geometry group.
    blobs = [corpus.read(n) for n in ("img.jpg", "img2.jpg", "img4.jpg")]
    items = sharded.decode_batch_sharded(blobs, mesh, idct="fast",
                                         upsample="nn")
    for it, b in zip(items, blobs):
        assert it.error is None
        assert np.array_equal(
            np.asarray(it.rgb),
            decode(b, entropy="python", idct="fast", upsample="nn").rgb)
    print(f"decode_batch_sharded: {len(blobs)} blobs, device-resident, "
          f"bit-exact vs host decoder")


if __name__ == "__main__":
    main()

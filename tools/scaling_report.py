#!/usr/bin/env python
"""Sharded-decode validation across mesh sizes.

Wall-clock scaling of the segment-sharded program needs real chips (this
box's N-virtual-CPU-device mesh multiplexes 2 physical cores, so timing an
8-way mesh here is meaningless).  What IS verifiable without a pod, and what
this tool checks, is that the multi-chip program — shard_map'ed entropy,
psum error aggregation, XLA-collective plane assembly, DP batch — compiles,
runs, and stays bit-exact at every mesh shape up to 32 devices.

Usage: python tools/scaling_report.py
"""

import io
import os
import sys
import time

N_MAX = 32
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={N_MAX} "
    + os.environ.get("XLA_FLAGS", ""))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jpeg_decoder_tpu import decode  # noqa: E402
from jpeg_decoder_tpu.io import parser  # noqa: E402
from jpeg_decoder_tpu.ops import scan_prep  # noqa: E402
from jpeg_decoder_tpu.parallel import mesh as mesh_mod, sharded  # noqa: E402


def make_workload():
    from tools import corpus

    rgb = np.asarray(Image.open(corpus.path("img5.jpg"))
                     .convert("RGB"))
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=85, subsampling=2,
                              restart_marker_blocks=10)
    return buf.getvalue()


def main():
    blob = make_workload()
    hdr = parser.parse(blob)
    words, nm, _bc, _mm, lay = scan_prep.prepare_scan(hdr, hdr.scans[0])
    batch = 4
    words_b = np.stack([words] * batch)
    nm_b = np.stack([nm] * batch)
    expected = decode(blob, entropy="native", idct="fast",
                      upsample="nn").rgb
    print(f"workload: {batch} x {hdr.width}x{hdr.height} 4:2:0, "
          f"{words.shape[0]} segments each\n")
    print("| mesh (data x seg) | compile+run | bit-exact |")
    print("|---|---|---|")
    for shape in [(1, 1), (1, 4), (2, 4), (2, 8), (4, 8)]:
        n = shape[0] * shape[1]
        if n > N_MAX:
            break
        mesh = mesh_mod.make_mesh(shape, ("data", "seg"),
                                  devices=jax.devices()[:n])
        t0 = time.perf_counter()
        rgb, err, _err_img = sharded.full_decode_step(hdr, words_b, nm_b, mesh,
                                            idct="fast", upsample="nn")
        rgb = np.asarray(rgb)
        dt = time.perf_counter() - t0
        ok = (not np.asarray(err).any()
              and all(np.array_equal(rgb[i], expected)
                      for i in range(batch)))
        print(f"| {shape[0]}x{shape[1]} | {dt:.1f}s | "
              f"{'yes' if ok else 'NO'} |")


if __name__ == "__main__":
    main()

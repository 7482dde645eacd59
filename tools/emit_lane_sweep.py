#!/usr/bin/env python
"""Lane-count sweep for the emission hybrid kernel on the device.

The emission buffer total (T x S) is ~constant in S (T ~ total_syms/C),
so if the per-step cost is loop-overhead-dominated rather than
gather-bound, more lanes => fewer steps => faster, until the 2S-element
gather cost per step catches up.  One process, interleaved variants.

Run: timeout 1200 python tools/emit_lane_sweep.py [B] [imgname...]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import jax

    from jpeg_decoder_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from jpeg_decoder_tpu.entropy import python_ref
    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.layout import scan_layout
    from jpeg_decoder_tpu.ops import entropy_flat
    from jpeg_decoder_tpu.ops import entropy_spec as es

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    names = sys.argv[2:] or ["img5.jpg"]
    dev = jax.devices()[0]
    print("device:", dev, " B =", B)

    for name in names:
        from tools import corpus

        path = corpus.path(name)
        hdr = parser.parse_file(path)
        lay = scan_layout(hdr)
        bc = tuple(ci for ci, c in enumerate(hdr.components)
                   for _ in range(c.v * c.h))
        mp = hdr.width * hdr.height * B / 1e6
        luts = entropy_flat.merged_luts(hdr, hdr.scans[0])
        luts_j = jax.device_put(jnp.asarray(luts), dev)
        ref = python_ref.decode_scan_baseline(hdr, hdr.scans[0])

        for C_want in (64, 128, 256, 512):
            if C_want > lay.n_mcus:
                continue
            scans = [parser.parse_file(path).scans[0] for _ in range(B)]
            (pools, starts, nm, off, T, _T2, C, seg_first, ok) = \
                es.prepare_hybrid_batch_emit(
                    hdr, scans, max_chunks=C_want, target_steps=64)
            assert ok.all()
            args = (jax.device_put(jnp.asarray(pools), dev),
                    jax.device_put(jnp.asarray(starts), dev),
                    jax.device_put(jnp.asarray(nm), dev),
                    jax.device_put(jnp.asarray(off), dev),
                    jax.device_put(jnp.asarray(seg_first), dev), luts_j)

            def run():
                b, bad = es._hybrid_pipeline_batch_emit(
                    *args, block_comp=bc, n_comps=len(hdr.components),
                    T=T, n_mcus=lay.n_mcus, C=C, precision=hdr.precision)
                b.block_until_ready()
                return b, bad

            blocks, bad = run()
            assert not np.asarray(bad).any()
            assert np.array_equal(np.asarray(blocks[0]), ref)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                best = min(best, time.perf_counter() - t0)
            print(f"{name}: C={C:4d} S={B*C:6d} T={T:5d}: "
                  f"{best*1e3:7.1f} ms ({mp/best:6.1f} MP/s, "
                  f"{best/T*1e6:5.1f} us/step)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

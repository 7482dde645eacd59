#!/usr/bin/env python
"""Isolate the cost of the lockstep decoder's record mode (speculative
trace bookkeeping) by decoding IDENTICAL lanes with record_mcus=1 vs 0.

If record mode is ~2.5x slower per iteration, the spec pipeline's gap to
the restart-mode rate is bookkeeping, not algorithm."""

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

    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.layout import scan_layout
    from jpeg_decoder_tpu.ops import entropy_flat, entropy_spec

    from tools import corpus

    blob = corpus.read("img5.jpg")
    hdr = parser.parse(blob)
    lay = scan_layout(hdr)
    block_comp = tuple(ci for ci, c in enumerate(hdr.components)
                       for _ in range(c.v * c.h))
    bpm = len(block_comp)
    luts = entropy_flat.merged_luts(hdr, hdr.scans[0]).reshape(
        2 * len(hdr.components), 65536)
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    scans = [parser.parse(blob).scans[0] for _ in range(B)]
    pools, base, lim, act, cap, C = entropy_spec.prepare_spec_batch(
        hdr, scans, chunk_bytes=2048, ovf_bytes=1170, max_chunks=256)
    img_base = (np.arange(B, dtype=np.int64) * pools.shape[1] * 32)[:, None]
    pool_j = jnp.asarray(pools).reshape(-1)
    base_j = jnp.asarray((img_base + base).reshape(-1).astype(np.int32))
    lim_j = jnp.asarray((img_base + lim).reshape(-1).astype(np.int32))
    nblk_j = jnp.where(jnp.asarray(act.reshape(-1)), cap * bpm, 0)
    luts_j = jnp.asarray(luts)
    mp = hdr.width * hdr.height * B / 1e6
    print(f"img5 B={B} lanes={B*C} cap={cap}", flush=True)

    # Record mode first; its per-lane block counts then drive the plain
    # run's nblocks so both decode IDENTICAL work (plain mode has no bit
    # limits — it would otherwise run every lane to cap*bpm).
    nd = None
    for mode in ("record", "plain"):
        kw = dict(block_comp=block_comp, n_comps=len(hdr.components),
                  max_blocks=cap * bpm, precision=hdr.precision)
        if mode == "record":
            kw.update(dc_diff=True, record_mcus=1, max_mcus=cap)
            nblk = nblk_j
        else:
            nblk = jnp.asarray(nd)

        def run(rep):
            # Perturb the last pool word (beyond every lane's bit limit)
            # so no runtime can serve a repeat call from a cached result
            # and fake a ~0 ms timing.
            p = pool_j.at[-1].set(jnp.uint32(rep))
            out, err, n_done, *_ = entropy_flat.decode_lockstep(
                p, base_j, nblk, lim_j, luts_j, **kw)
            return out, n_done

        out, n_done = run(999)
        out.block_until_ready()
        best = 1e9
        for rep in range(3):
            t0 = time.perf_counter()
            out, n_done = run(rep)
            out.block_until_ready()
            best = min(best, time.perf_counter() - t0)
        nd = np.asarray(n_done)
        print(f"  {mode:6s}: {best*1e3:7.1f} ms  {mp/best:6.1f} MP/s "
              f"(trip~{nd.max()} avg {nd.mean():.0f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

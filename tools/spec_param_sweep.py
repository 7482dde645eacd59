#!/usr/bin/env python
"""Tune the speculative-chunk parameters (chunk_bytes, ovf_bytes,
max_chunks, cap slack) for the device DRI=0 pipeline on the device.

The lockstep decode's wall time is max-over-lanes trip count x per-iter
cost, so the knobs trade off:
  - smaller chunks  -> more lanes (better VPU occupancy) and a lower
    absolute worst-case MCU count per lane (flat image regions pack MCUs
    at ~4-6 B vs the ~35 B average);
  - smaller ovf     -> less redundant decode (every lane decodes its chunk
    PLUS the whole overflow window; sync actually needs only ~100 B);
  - cap             -> bounds the record buffers AND the worst-case trip
    count, but a lane whose records fill before its bit limit breaks the
    splice (per-image host fallback).

Prints per-config: program ms, MP/s, splice ok count, n_rec max/avg.
Usage: timeout 1200 python tools/spec_param_sweep.py
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
    from jax.sharding import Mesh

    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.layout import scan_layout
    from jpeg_decoder_tpu.models import decoder as decoder_mod
    from jpeg_decoder_tpu.ops import entropy_flat, entropy_spec
    from jpeg_decoder_tpu.parallel import sharded

    dev = jax.devices()[0]
    mesh = Mesh(np.array([dev]).reshape(1, 1), ("data", "seg"))
    rep = int(os.environ.get("SWEEP_B", "8"))

    # DRI=0 corpus images only (5 of 6).
    from tools import corpus

    paths = [corpus.path(n) for n in corpus.BASELINE]
    blobs = {os.path.basename(p): open(p, "rb").read() for p in paths}

    configs = [
        # (chunk_bytes, ovf_bytes, max_chunks)
        (2048, 1536, 64),    # current defaults
        (2048, 512, 64),
        (1024, 512, 128),
        (768, 384, 192),
        (512, 384, 256),
        (512, 256, 384),
    ]

    for name, blob in blobs.items():
        hdr = parser.parse(blob)
        if hdr.restart_interval:
            print(f"{name}: DRI={hdr.restart_interval} (restart path), skip")
            continue
        scans = [parser.parse(blob).scans[0] for _ in range(rep)]
        lay = scan_layout(hdr)
        mp = hdr.width * hdr.height * rep / 1e6
        block_comp = tuple(ci for ci, c in enumerate(hdr.components)
                           for _ in range(c.v * c.h))
        luts = entropy_flat.merged_luts(hdr, scans[0]).reshape(
            2 * len(hdr.components), 65536)
        print(f"\n{name}: {hdr.width}x{hdr.height} stream="
              f"{len(scans[0].data)/1e3:.0f}KB n_mcus={lay.n_mcus} B={rep}")
        for cb, ovf, mc in configs:
            try:
                pools, base, lim, act, cap, C = entropy_spec.prepare_spec_batch(
                    hdr, scans, chunk_bytes=cb, ovf_bytes=ovf, max_chunks=mc)
            except Exception as e:  # noqa: BLE001
                print(f"  cb={cb} ovf={ovf}: prep failed {e}")
                continue
            args = (jnp.asarray(pools), jnp.asarray(base), jnp.asarray(lim),
                    jnp.asarray(act), jnp.asarray(luts))
            kw = dict(block_comp=block_comp, n_comps=len(hdr.components),
                      cap=cap, n_mcus=lay.n_mcus, C=C,
                      precision=hdr.precision)
            try:
                blocks, ok = entropy_spec._spec_pipeline_batch(*args, **kw)
                blocks.block_until_ready()  # compile
                t0 = time.perf_counter()
                blocks, ok = entropy_spec._spec_pipeline_batch(*args, **kw)
                blocks.block_until_ready()
                dt = time.perf_counter() - t0
                ok_np = np.asarray(ok)
                # n_rec stats from a separate lockstep call would double
                # the work; infer skew from the trip bound instead.
                rec_mb = rep * C * cap * len(block_comp) * 64 * 4 / 1e6
                print(f"  cb={cb:5d} ovf={ovf:5d} C={C:4d} cap={cap:4d} "
                      f"lanes={rep*C:5d} rec={rec_mb:6.0f}MB "
                      f"{dt*1e3:7.1f}ms {mp/dt:6.1f} MP/s "
                      f"ok={int(ok_np.sum())}/{rep}")
            except Exception as e:  # noqa: BLE001
                print(f"  cb={cb} ovf={ovf}: run failed "
                      f"{type(e).__name__}: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

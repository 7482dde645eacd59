#!/usr/bin/env python
"""Stage-split profile of the fully device-resident batch decode path
(parallel/sharded.decode_batch_sharded) on the device.

The lockstep entropy kernel alone runs far faster than the whole
blobs->device-RGB path; this tool times each stage so the gap is
attributed, not guessed:

  parse+prep   host: parser.parse + prepare_spec_batch / prepare_scan
  H2D          device_put of pools/luts (blocking put + sync)
  program      the fused decode program(s), inputs already on device
  ok-fetch     the per-image splice-ok / error fetch

Usage: timeout 600 python tools/device_path_profile.py [batch_per_image]
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

    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.ops import entropy_flat, entropy_spec
    from jpeg_decoder_tpu.parallel import sharded
    from jpeg_decoder_tpu.layout import scan_layout
    from jax.sharding import Mesh

    rep = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = jax.devices()[0]
    mesh = Mesh(np.array([dev]).reshape(1, 1), ("data", "seg"))
    print("device:", dev)

    from tools import corpus

    paths = [corpus.path(n) for n in corpus.BASELINE]
    blobs = [open(p, "rb").read() for p in paths]

    # ---- whole-path timing ----
    t0 = time.perf_counter()
    items = sharded.decode_batch_sharded(blobs * rep, mesh)
    for arr in {id(i.rgb_batch): i.rgb_batch for i in items
                if i.rgb_batch is not None}.values():
        arr.block_until_ready()
    dt = time.perf_counter() - t0
    total_mp = sum(i.header.width * i.header.height / 1e6
                   for i in items if i.header)
    print(f"[cold] decode_batch_sharded: {total_mp:.1f} MP in {dt:.2f}s "
          f"= {total_mp/dt:.1f} MP/s (includes compile)")
    for k in range(2):
        t0 = time.perf_counter()
        items = sharded.decode_batch_sharded(blobs * rep, mesh)
        for arr in {id(i.rgb_batch): i.rgb_batch for i in items
                    if i.rgb_batch is not None}.values():
            arr.block_until_ready()
        dt = time.perf_counter() - t0
        print(f"[warm {k}] {total_mp/dt:.1f} MP/s ({dt:.2f}s)")
    errs = [i for i in items if i.error is not None]
    print("errors:", len(errs))

    # ---- per-stage split for ONE DRI=0 group (img.jpg x rep) ----
    blob = blobs[0]
    t0 = time.perf_counter()
    hdrs = [parser.parse(blob) for _ in range(rep)]
    t_parse = time.perf_counter() - t0
    hdr = hdrs[0]
    scans = [h.scans[0] for h in hdrs]
    mp = hdr.width * hdr.height * rep / 1e6

    t0 = time.perf_counter()
    pools, base, lim, act, cap, C = entropy_spec.prepare_spec_batch(
        hdr, scans)
    t_prep = time.perf_counter() - t0
    lay = scan_layout(hdr)
    block_comp = tuple(
        ci for ci, c in enumerate(hdr.components) for _ in range(c.v * c.h))
    luts = entropy_flat.merged_luts(hdr, scans[0]).reshape(
        2 * len(hdr.components), 65536)
    print(f"group: B={rep} C={C} cap={cap} n_mcus={lay.n_mcus} "
          f"pool={pools.nbytes/1e6:.1f}MB "
          f"records~{rep*C*cap*len(block_comp)*64*4/1e6:.0f}MB")

    t0 = time.perf_counter()
    pools_j = jax.device_put(jnp.asarray(pools), dev)
    base_j = jax.device_put(jnp.asarray(base), dev)
    lim_j = jax.device_put(jnp.asarray(lim), dev)
    act_j = jax.device_put(jnp.asarray(act), dev)
    luts_j = jax.device_put(jnp.asarray(luts), dev)
    for a in (pools_j, base_j, lim_j, act_j, luts_j):
        a.block_until_ready()
    t_h2d = time.perf_counter() - t0

    def run():
        blocks_b, ok = entropy_spec._spec_pipeline_batch(
            pools_j, base_j, lim_j, act_j, luts_j,
            block_comp=block_comp, n_comps=len(hdr.components), cap=cap,
            n_mcus=lay.n_mcus, C=C, precision=hdr.precision)
        return blocks_b, ok

    t0 = time.perf_counter()
    blocks_b, ok = run()
    blocks_b.block_until_ready()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks_b, ok = run()
    blocks_b.block_until_ready()
    t_entropy = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok_np = np.asarray(ok)
    t_fetch = time.perf_counter() - t0

    t0 = time.perf_counter()
    rgb = sharded._spec_group_rgb(hdr, scans, idct="fast", upsample="fancy")
    rgb.block_until_ready()
    t_full_group = time.perf_counter() - t0

    print(f"stage split (one DRI=0 group, {mp:.1f} MP):")
    print(f"  parse          {t_parse*1e3:8.1f} ms")
    print(f"  prep           {t_prep*1e3:8.1f} ms")
    print(f"  H2D            {t_h2d*1e3:8.1f} ms "
          f"({(pools.nbytes+luts.nbytes)/1e6:.1f} MB)")
    print(f"  spec program   {t_entropy*1e3:8.1f} ms "
          f"(first call incl compile: {t_compile*1e3:.0f} ms) "
          f"-> {mp/t_entropy:.1f} MP/s")
    print(f"  ok fetch       {t_fetch*1e3:8.1f} ms (ok={ok_np.tolist()})")
    print(f"  whole group    {t_full_group*1e3:8.1f} ms "
          f"-> {mp/t_full_group:.1f} MP/s (spec+splice+pixel, warm)")

    # ---- hybrid path split for the same group (skeleton + true starts) --
    t0 = time.perf_counter()
    hp_pools, hp_starts, hp_nm, stride, hC, skel_ok = \
        entropy_spec.prepare_hybrid_batch(hdr, scans)
    t_hprep = time.perf_counter() - t0
    assert skel_ok.all()
    bc = block_comp

    def hrun():
        return entropy_spec._hybrid_pipeline_batch(
            jnp.asarray(hp_pools), jnp.asarray(hp_starts),
            jnp.asarray(hp_nm), luts_j, block_comp=bc,
            n_comps=len(hdr.components), stride=stride,
            n_mcus=lay.n_mcus, C=hC, precision=hdr.precision)

    t0 = time.perf_counter()
    hb, hbad = hrun()
    hb.block_until_ready()
    t_hcompile = time.perf_counter() - t0
    t0 = time.perf_counter()
    hb, hbad = hrun()
    hb.block_until_ready()
    t_hyb = time.perf_counter() - t0
    t0 = time.perf_counter()
    rgb, hok = sharded._hybrid_group_dispatch(
        hdr, scans, mesh, idct="fast", upsample="fancy")
    rgb.block_until_ready()
    t_hfull = time.perf_counter() - t0
    print(f"hybrid split (same group, B={rep} C={hC} stride={stride}):")
    print(f"  skeleton+prep  {t_hprep*1e3:8.1f} ms "
          f"-> {mp/t_hprep:.1f} MP/s host-side")
    print(f"  hybrid program {t_hyb*1e3:8.1f} ms "
          f"(first call incl compile+H2D: {t_hcompile*1e3:.0f} ms) "
          f"-> {mp/t_hyb:.1f} MP/s")
    print(f"  whole group    {t_hfull*1e3:8.1f} ms "
          f"-> {mp/t_hfull:.1f} MP/s (prep+H2D+entropy+pixel, warm)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

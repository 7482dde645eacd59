#!/usr/bin/env python
"""A/B the two hybrid DRI=0 device kernels on the device, one process.

  lockstep : equal-MCU lanes, block-lockstep kernel
             (ops.entropy_spec._hybrid_pipeline_batch) — trip count is
             sum-over-slots of the max-over-lanes block symbol count,
             measured ~3.5x the balanced ideal on the corpus.
  flat     : byte-balanced lanes, flat symbol loop with scalar commit
             (_hybrid_pipeline_batch_flat) — trip count is the max lane
             total, ~1.1-1.4x ideal, at one extra scatter per iteration.

Both variants time in the SAME process back to back (a card's clocks and
neighbours differ between runs; never compare separate runs).

Run: timeout 900 python tools/hybrid_kernel_ab.py [B] [imgname ...]
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
    names = sys.argv[2:] or ["img.jpg", "img5.jpg"]
    dev = jax.devices()[0]
    print("device:", dev, " B =", B)

    for name in names:
        from tools import corpus

        path = corpus.path(name)
        hdr = parser.parse_file(path)
        scans = [parser.parse_file(path).scans[0] for _ in range(B)]
        lay = scan_layout(hdr)
        bc = tuple(ci for ci, c in enumerate(hdr.components)
                   for _ in range(c.v * c.h))
        mp = hdr.width * hdr.height * B / 1e6
        luts = entropy_flat.merged_luts(hdr, scans[0])
        ref = python_ref.decode_scan_baseline(hdr, scans[0])

        # ---- lockstep (equal-MCU lanes) ----
        pools, starts, nm, stride, C, ok = es.prepare_hybrid_batch(
            hdr, scans)
        assert ok.all()
        args_l = (jax.device_put(jnp.asarray(pools), dev),
                  jax.device_put(jnp.asarray(starts), dev),
                  jax.device_put(jnp.asarray(nm), dev),
                  jax.device_put(jnp.asarray(luts.reshape(
                      2 * len(hdr.components), 65536)), dev))

        def run_l():
            b, bad = es._hybrid_pipeline_batch(
                *args_l, block_comp=bc, n_comps=len(hdr.components),
                stride=stride, n_mcus=lay.n_mcus, C=C,
                precision=hdr.precision)
            b.block_until_ready()
            return b, bad

        blocks, bad = run_l()
        assert not np.asarray(bad).any()
        assert np.array_equal(np.asarray(blocks[0]), ref)
        t_l = min(_t(run_l) for _ in range(3))

        # ---- flat (byte-balanced lanes, scalar commit) ----
        (pools2, starts2, nm2, max_nm, C2, src,
         ok2) = es.prepare_hybrid_batch_balanced(hdr, scans)
        assert ok2.all()
        args_f = (jax.device_put(jnp.asarray(pools2), dev),
                  jax.device_put(jnp.asarray(starts2), dev),
                  jax.device_put(jnp.asarray(nm2), dev),
                  jax.device_put(jnp.asarray(src), dev),
                  jax.device_put(jnp.asarray(luts), dev))

        def run_f():
            b, bad = es._hybrid_pipeline_batch_flat(
                *args_f, block_comp=bc, n_comps=len(hdr.components),
                max_nm=max_nm, n_mcus=lay.n_mcus, C=C2,
                precision=hdr.precision)
            b.block_until_ready()
            return b, bad

        blocks, bad = run_f()
        assert not np.asarray(bad).any()
        assert np.array_equal(np.asarray(blocks[0]), ref)
        t_f = min(_t(run_f) for _ in range(3))

        # ---- emit (symbol-balanced lanes, no in-loop stores) ----
        (pools3, starts3, nm3, off3, T, _T2, C3, seg3,
         ok3) = es.prepare_hybrid_batch_emit(hdr, scans)
        assert ok3.all()
        args_e = (jax.device_put(jnp.asarray(pools3), dev),
                  jax.device_put(jnp.asarray(starts3), dev),
                  jax.device_put(jnp.asarray(nm3), dev),
                  jax.device_put(jnp.asarray(off3), dev),
                  jax.device_put(jnp.asarray(seg3), dev),
                  jax.device_put(jnp.asarray(luts), dev))

        def run_e():
            b, bad = es._hybrid_pipeline_batch_emit(
                *args_e, block_comp=bc, n_comps=len(hdr.components),
                T=T, n_mcus=lay.n_mcus, C=C3, precision=hdr.precision)
            b.block_until_ready()
            return b, bad

        blocks, bad = run_e()
        assert not np.asarray(bad).any()
        assert np.array_equal(np.asarray(blocks[0]), ref)
        t_e = min(_t(run_e) for _ in range(3))

        print(f"{name}: {mp:.1f} MP  "
              f"lockstep C={C} stride={stride}: {t_l*1e3:7.1f} ms "
              f"({mp/t_l:6.1f} MP/s)   "
              f"flat C={C2} max_nm={max_nm}: {t_f*1e3:7.1f} ms "
              f"({mp/t_f:6.1f} MP/s)   "
              f"emit C={C3} T={T}: {t_e*1e3:7.1f} ms "
              f"({mp/t_e:6.1f} MP/s)   emit/lockstep {t_l/t_e:.2f}x",
              flush=True)
    return 0


def _t(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    sys.exit(main())

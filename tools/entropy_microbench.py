"""On-device entropy-decode microbenchmark: v1 (nested) vs flat loop.

Substantiates VERDICT r1 item 1 ("make on-device entropy decode credibly
fast") with reproducible per-variant MP/s numbers on whatever device jax
selects.

Workloads:
  * img4.jpg — the seeded corpus DRI image (50 restart segments x 100 MCUs,
    4:4:4): the natural segment-parallel case.
  * img4 x R replicas — the lane-scaling curve (how throughput grows with
    segments from batched images).
  * a synthetic DRI=1 4:2:0 frame — many short segments.

Timing: ITERS chained iterations inside ONE jitted program with an
optimization_barrier-carried dependency, so dispatch cost cancels out.

Run:  python tools/entropy_microbench.py [--iters 8] [--variants flat,v1]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--variants", default="flat,v1")
    ap.add_argument("--replicas", default="1,4,16")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from jpeg_decoder_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    from jpeg_decoder_tpu.io import parser
    from tools import corpus
    import entropy_jax_v1
    from jpeg_decoder_tpu.ops import entropy_flat, scan_prep

    print("device:", jax.devices()[0], flush=True)
    variants = args.variants.split(",")

    def timeit(fn, n):
        """fn(dep_scalar) -> scalar; chained n times in one program."""
        @jax.jit
        def many(seed):
            def body(_, acc):
                return acc + fn(acc)
            return jax.lax.fori_loop(0, n, body, seed)

        t0 = time.perf_counter()
        float(many(jnp.int32(0)))
        warm = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(many(jnp.int32(1)))
            best = min(best, (time.perf_counter() - t0) / n)
        return best, warm

    if "spec" in variants:
        # Speculative chunk decode of DRI=0 images.  Blocks stay on device
        # (as in the production pipeline); the wall clock covers device
        # phase 1, the small starts-trace D2H, the host splice and the
        # device assembly, forced by a 4-byte checksum fetch.
        from jpeg_decoder_tpu.ops import entropy_spec

        # The whole pipeline (phase 1 + device splice + assembly) is one
        # jitted program, so it chains like every other variant — the
        # per-call dispatch and round trip otherwise swamp the
        # device time.
        from jpeg_decoder_tpu.ops import entropy_flat

        for name in ("img.jpg", "img5.jpg"):
            b = corpus.read(name)
            h = parser.parse(b)
            sc = h.scans[0]
            mp = h.width * h.height / 1e6
            for ckb in (4096, 2048, 1024):
                # Reuse decode_scan_speculative's host prep by calling it
                # once (also asserts the happy path), then chain the
                # jitted pipeline on the same operands.
                prep = {}

                orig = entropy_spec._spec_pipeline

                def capture(*a, **k):
                    prep["a"], prep["k"] = a, k
                    return orig(*a, **k)

                entropy_spec._spec_pipeline = capture
                try:
                    entropy_spec.decode_scan_speculative(
                        h, sc, chunk_bytes=ckb, as_device=True)
                finally:
                    entropy_spec._spec_pipeline = orig

                def step(acc):
                    a = list(prep["a"])
                    a[0] = jax.lax.optimization_barrier((a[0], acc))[0]
                    blocks, ok, *_ = orig(*a, **prep["k"])
                    return blocks[0, 0] + ok.astype(jnp.int32)

                dt, warm = timeit(step, args.iters)
                lanes = len(prep["a"][1])
                print(f"spec {name:9s} chunk={ckb:5d} lanes={lanes:4d}: "
                      f"{dt*1e3:8.2f} ms -> {mp/dt:7.1f} MP/s "
                      f"(device pipeline)", flush=True)
            # Reference point: the same stream as ONE device lane.
            pool, base, nblk, max_blocks, bc, lay = \
                entropy_flat.prepare_scan_flat(h, sc)
            luts2 = jnp.asarray(entropy_flat.merged_luts(h, sc).reshape(
                2 * len(h.components), 65536))
            pool_d, base_d = jnp.asarray(pool), jnp.asarray(base)
            nblk_d = jnp.asarray(nblk)
            lim_d = jnp.full(base.shape, 2**30, jnp.int32)

            def one_lane(acc):
                p = jax.lax.optimization_barrier((pool_d, acc))[0]
                out, err, nd, *_ = entropy_flat.decode_lockstep(
                    p, base_d, nblk_d, lim_d, luts2,
                    block_comp=bc, n_comps=len(h.components),
                    max_blocks=max_blocks)
                return out[0, 0, 0] + err.sum() + nd[0]

            dt, warm = timeit(one_lane, max(2, args.iters // 2))
            print(f"spec {name:9s} single-lane reference: "
                  f"{dt*1e3:8.2f} ms -> {mp/dt:7.1f} MP/s", flush=True)

    if "devbatch" in variants:
        # End-to-end device-resident serving: blobs -> RGB, everything
        # after parse+unstuff on device (speculative batch entropy +
        # splice + assembly + pixel pipeline), chained in one program.
        from jpeg_decoder_tpu.layout import scan_layout
        from jpeg_decoder_tpu.models import decoder as decoder_mod
        from jpeg_decoder_tpu.models.batch import _batched_from_scan
        from jpeg_decoder_tpu.ops import entropy_spec

        B = 8
        for name in ("img.jpg", "img5.jpg"):
            b = corpus.read(name)
            h = parser.parse(b)
            scans = [h.scans[0]] * B
            mp = h.width * h.height / 1e6 * B
            pools, base, lim, act, cap, C = entropy_spec.prepare_spec_batch(
                h, scans)
            from jpeg_decoder_tpu.ops import entropy_flat as ef

            luts = jnp.asarray(ef.merged_luts(h, h.scans[0]).reshape(
                2 * len(h.components), 65536))
            lay = scan_layout(h)
            bc = tuple(ci for ci, c in enumerate(h.components)
                       for _ in range(c.v * c.h))
            qt = np.stack([h.quant_tables[c.tq].values
                           for c in h.components])
            qt_b = jnp.asarray(np.broadcast_to(qt, (B, *qt.shape)).copy())
            srcs = decoder_mod._comp_srcs_jax(lay)
            samplings = tuple(
                (h.v_max // c.v, h.h_max // c.h) for c in h.components)
            pools_d = jnp.asarray(pools)
            args2 = [jnp.asarray(x) for x in (base, lim, act)]

            def step(acc, h=h, lay=lay, bc=bc, cap=cap, C=C,
                     pools_d=pools_d, args2=args2, luts=luts, qt_b=qt_b,
                     srcs=srcs, samplings=samplings):
                p = jax.lax.optimization_barrier((pools_d, acc))[0]
                blocks, ok = entropy_spec._spec_pipeline_batch(
                    p, *args2, luts, block_comp=bc,
                    n_comps=len(h.components), cap=cap,
                    n_mcus=lay.n_mcus, C=C)
                rgb = _batched_from_scan(
                    blocks, qt_b, srcs, comp_shapes=tuple(lay.comp_shapes),
                    height=h.height, width=h.width, samplings=samplings,
                    idct="fast", upsample="fancy", color=h.colorspace)
                return (rgb[0, 0, 0, 0].astype(jnp.int32)
                        + ok.all().astype(jnp.int32))

            dt, warm = timeit(step, args.iters)
            print(f"devbatch {name:9s} B={B} lanes={B*C:4d}: "
                  f"{dt*1e3:8.2f} ms -> {mp/dt:7.1f} MP/s "
                  f"(blobs -> device RGB; warm {warm:.1f}s)", flush=True)

    blob = corpus.read("img4.jpg")
    hdr = parser.parse(blob)
    scan = hdr.scans[0]
    mp_one = hdr.width * hdr.height / 1e6

    for rep in [int(r) for r in args.replicas.split(",")]:
        mp = mp_one * rep

        if "flat" in variants:
            pool, base, nblk, max_blocks, bc, lay = \
                entropy_flat.prepare_scan_flat(hdr, scan)
            W = pool.shape[0]
            pool_r = np.concatenate([pool] * rep)
            base_r = np.concatenate(
                [base + i * W * 32 for i in range(rep)]).astype(np.int32)
            nblk_r = np.concatenate([nblk] * rep).astype(np.int32)
            luts = jnp.asarray(entropy_flat.merged_luts(hdr, scan))
            pool_d = jnp.asarray(pool_r)
            base_d = jnp.asarray(base_r)
            nblk_d = jnp.asarray(nblk_r)
            lim_d = jnp.full(base_r.shape, 2**30, jnp.int32)

            def step_flat(acc):
                p = jax.lax.optimization_barrier((pool_d, acc))[0]
                out, err, nd, *_ = entropy_flat.decode_flat(
                    p, base_d, nblk_d, lim_d, luts,
                    block_comp=bc, n_comps=len(hdr.components),
                    max_blocks=max_blocks)
                return out[0, 0, 0] + err.sum() + nd[0]

            dt, warm = timeit(step_flat, args.iters)
            print(f"flat rep={rep:3d} lanes={len(base_r):5d}: "
                  f"{dt*1e3:8.2f} ms -> {mp/dt:7.1f} MP/s "
                  f"(warm {warm:.1f}s)", flush=True)

        if "lockstep" in variants:
            pool, base, nblk, max_blocks, bc, lay = \
                entropy_flat.prepare_scan_flat(hdr, scan)
            W = pool.shape[0]
            pool_r = np.concatenate([pool] * rep)
            base_r = np.concatenate(
                [base + i * W * 32 for i in range(rep)]).astype(np.int32)
            nblk_r = np.concatenate([nblk] * rep).astype(np.int32)
            luts2 = jnp.asarray(entropy_flat.merged_luts(hdr, scan).reshape(
                2 * len(hdr.components), 65536))
            pool_d = jnp.asarray(pool_r)
            base_d = jnp.asarray(base_r)
            nblk_d = jnp.asarray(nblk_r)
            lim_d = jnp.full(base_r.shape, 2**30, jnp.int32)

            def step_ls(acc):
                p = jax.lax.optimization_barrier((pool_d, acc))[0]
                out, err, nd, *_ = entropy_flat.decode_lockstep(
                    p, base_d, nblk_d, lim_d, luts2,
                    block_comp=bc, n_comps=len(hdr.components),
                    max_blocks=max_blocks)
                return out[0, 0, 0] + err.sum() + nd[0]

            dt, warm = timeit(step_ls, args.iters)
            print(f"lock rep={rep:3d} lanes={len(base_r):5d}: "
                  f"{dt*1e3:8.2f} ms -> {mp/dt:7.1f} MP/s "
                  f"(warm {warm:.1f}s)", flush=True)

        if "v1" in variants:
            words, nm, bc1, max_mcus, lay = scan_prep.prepare_scan(
                hdr, scan)
            words_r = np.concatenate([words] * rep)
            nm_r = np.concatenate([nm] * rep)
            dc, ac = scan_prep.luts_for_scan(hdr, scan)
            words_d = jnp.asarray(words_r)
            nm_d = jnp.asarray(nm_r)
            dc_d, ac_d = jnp.asarray(dc), jnp.asarray(ac)

            def step_v1(acc):
                w = jax.lax.optimization_barrier((words_d, acc))[0]
                out, err = entropy_jax_v1.decode_segments(
                    w, nm_d, dc_d, ac_d, block_comp=bc1,
                    n_comps=len(hdr.components), max_mcus=max_mcus)
                return out[0, 0, 0] + err.sum()

            dt, warm = timeit(step_v1, args.iters)
            print(f"v1   rep={rep:3d} lanes={len(nm_r):5d}: "
                  f"{dt*1e3:8.2f} ms -> {mp/dt:7.1f} MP/s "
                  f"(warm {warm:.1f}s)", flush=True)


if __name__ == "__main__":
    main()

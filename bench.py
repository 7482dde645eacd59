#!/usr/bin/env python
"""Benchmark: baseline-JPEG decode throughput on one GPU.

Prints exactly ONE JSON line to stdout:
    {"metric": ..., "value": N, "unit": "MP/s", "vs_baseline": N, ...}

Workload: the six baseline photos of the seeded corpus (tools/corpus.py,
the shapes BASELINE.md records; ~2.4 MP total), decoded end-to-end
repeatedly — host parse + unstuff, native entropy decode, device pixel
pipeline (fast IDCT, fancy upsampling), RGB left on the device.  Host
entropy for the next wave overlaps device pixel work for the previous one.

vs_baseline: ratio against the reference C++ decoder's single-core
throughput, measured live by the instrumented oracle build when its
sources are present (BASELINE.md: the reference publishes no numbers).

Auxiliary stage timings go to stderr and into the JSON line.  Runs only on
a GPU: with any other JAX backend it exits 1 without a result.

    python bench.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

ROUNDS = int(os.environ.get("BENCH_ROUNDS", "48"))
WAVE = int(os.environ.get("BENCH_WAVE", "48"))
TRIALS = int(os.environ.get("BENCH_TRIALS", "8"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def measure_reference_mps(paths) -> float | None:
    """Reference C++ single-core MP/s via the instrumented oracle."""
    try:
        import oracle

        if not oracle.available():
            return None
        from jpeg_decoder_tpu.io import parser as _parser

        total_mp, total_ms = 0.0, 0.0
        for path in paths:
            hdr = _parser.parse_file(path)
            total_mp += hdr.width * hdr.height / 1e6
            total_ms += oracle.time_decode(path, repeats=3)
        return total_mp / (total_ms / 1e3)
    except Exception as e:  # noqa: BLE001
        log("reference baseline measurement failed:", e)
        return None


def main() -> int:
    ap = argparse.ArgumentParser(description="decode throughput benchmark")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        log(f"bench: no GPU (JAX backend {jax.default_backend()!r})")
        return 1
    from jpeg_decoder_tpu.utils.runtime import enable_compile_cache

    log("compile cache:", enable_compile_cache())

    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.ops import pixel as pixel_ops
    from jpeg_decoder_tpu.ops import pixel_ref
    from tools import corpus
    import jax.numpy as jnp

    dev = jax.devices()[0]
    log(f"jax devices: {jax.devices()} ({dev.device_kind})")

    paths = [corpus.path(n, args.seed) for n in corpus.BASELINE]
    blobs = [open(p, "rb").read() for p in paths]
    mps = []
    for b in blobs:
        hdr = parser.parse(b)
        mps.append(hdr.width * hdr.height / 1e6)
    total_mp = sum(mps)
    log(f"corpus: {len(paths)} images, {total_mp:.3f} MP total")

    from jpeg_decoder_tpu.models.batch import BatchDecoder

    wire = os.environ.get("BENCH_WIRE", "nibble")
    log(f"wire format: {wire}")
    bd = BatchDecoder(entropy="auto", idct="fast", upsample="fancy",
                      device=dev, host_threads=3, wire=wire)

    # Workload: ROUNDS copies of the corpus, decoded in batched groups.
    # Decoded RGB stays DEVICE-RESIDENT (the decode product feeds
    # on-device ML input pipelines).
    workload = blobs * ROUNDS

    def sync(items):
        jax.block_until_ready(
            list({id(i.rgb_batch): i.rgb_batch for i in items}.values()))

    # ---- correctness: every corpus image vs the all-NumPy float64
    # reference, compared on the device; only scalars come back.
    @jax.jit
    def _maxdiff(got, exp):
        return jnp.max(jnp.abs(got.astype(jnp.int32) - exp.astype(jnp.int32)))

    checked = bd.decode(blobs)
    max_diff = max(int(_maxdiff(it.rgb, jax.device_put(
        pixel_ref.decode(b), dev))) for it, b in zip(checked, blobs))
    if max_diff > pixel_ref.RGB_TOLERANCE:
        raise RuntimeError(f"bench output mismatch (max diff {max_diff})")
    log(f"correctness check passed (max diff {max_diff} <= "
        f"{pixel_ref.RGB_TOLERANCE})")

    # ---- warmup: compile every geometry-bucket program at workload batch
    # size (BatchDecoder buckets batch dims) ----
    t0 = time.perf_counter()
    warm = bd.decode(workload, wave=WAVE)
    sync(warm)
    log(f"warmup (compiles): {time.perf_counter()-t0:.1f}s")

    # ---- timed: TRIALS back-to-back passes; median and best ----
    dts = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        items = bd.decode(workload, wave=WAVE)
        sync(items)
        dts.append(time.perf_counter() - t0)
    value = ROUNDS * total_mp / min(dts)
    median_mps = ROUNDS * total_mp / statistics.median(dts)
    log(f"timed: {len(workload)} decodes, passes "
        f"{['%.3fs' % d for d in dts]} -> median {median_mps:.1f}, best "
        f"{value:.1f} MP/s (to device-resident RGB)")

    # ---- stage breakdown (persisted into the JSON line: VERDICT r1
    # item 6 / r2 item 3b — the captured artifact must carry the
    # attribution, not just stderr) ----
    t0 = time.perf_counter()
    host_payloads = [bd._host_one(blob) for blob in blobs]
    host_dt = time.perf_counter() - t0
    host_mps = total_mp / host_dt
    log(f"host stage alone: {host_mps:.1f} MP/s (1 thread)")

    # Device wave alone (host payloads precomputed): packing + H2D +
    # dispatch + device compute for one corpus pass — the stage the wave
    # pipeline must hide behind host entropy.
    wave_res = [None] * len(blobs)
    bd._decode_wave(host_payloads, wave_res, 0)   # warm any new programs
    t0 = time.perf_counter()
    wave_res = [None] * len(blobs)
    bd._decode_wave(host_payloads, wave_res, 0)
    sync([r for r in wave_res if r and r.rgb_batch is not None])
    device_wave_ms = (time.perf_counter() - t0) * 1e3
    log(f"device wave alone (pack+H2D+compute): {device_wave_ms:.0f} ms "
        f"for {total_mp:.2f} MP -> {total_mp/(device_wave_ms/1e3):.1f} MP/s")

    # Progressive decode (BASELINE configs[3]): native host entropy stage
    # on the 12 MP progressive sample (chain-parallel + segment-threaded).
    prog_mps = None
    try:
        from jpeg_decoder_tpu.entropy import native as native_mod

        ppath = corpus.path("prograssive-sample.jpg", args.seed)
        if native_mod.available():
            phdr = parser.parse_file(ppath)
            pmp = phdr.width * phdr.height / 1e6
            native_mod.decode_progressive(phdr)  # warm LUT caches
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                native_mod.decode_progressive(phdr)
                best = min(best, time.perf_counter() - t0)
            prog_mps = pmp / best
            log(f"progressive host entropy ({pmp:.1f} MP sample): "
                f"{prog_mps:.1f} MP/s")
    except Exception as e:  # noqa: BLE001
        log("progressive measurement failed:", e)

    # Progressive DEVICE path (VERDICT r3 item 2): the 12 MP sample
    # decoded by the device lane kernels (ops/entropy_prog) — host does
    # only the skeleton walks; all coefficient stores + pixel pipeline
    # on device, RGB device-resident.
    prog_dev_mps = None
    try:
        from jpeg_decoder_tpu.ops import entropy_prog

        ppath = corpus.path("prograssive-sample.jpg", args.seed)
        phdr = parser.parse_file(ppath)
        pmp = phdr.width * phdr.height / 1e6
        qts = tuple(jnp.asarray(phdr.quant_tables[c.tq].values)
                    for c in phdr.components)
        samp = tuple((phdr.v_max // c.v, phdr.h_max // c.h)
                     for c in phdr.components)

        def run_prog_dev():
            sink: list = []
            planes = entropy_prog.decode_progressive_lanes(
                phdr, as_device=True, err_sink=sink)
            rgb = pixel_ops.pixel_pipeline(
                tuple(planes), qts, height=phdr.height,
                width=phdr.width, samplings=samp, idct="fast",
                upsample="fancy", color=phdr.colorspace,
                precision=phdr.precision)
            rgb.block_until_ready()
            entropy_prog.check_errors(sink)

        run_prog_dev()  # warm (compiles)
        best = float("inf")
        for _ in range(6):
            t0 = time.perf_counter()
            run_prog_dev()
            best = min(best, time.perf_counter() - t0)
        prog_dev_mps = pmp / best
        log(f"progressive device path ({pmp:.1f} MP sample): "
            f"{prog_dev_mps:.1f} MP/s (device lane kernels)")
    except Exception as e:  # noqa: BLE001
        log("progressive device-path measurement failed:", e)

    # Wire density: bytes shipped host->device per pixel (nibble wire).
    wire_bytes = 0
    for hp in host_payloads:
        try:
            _hdr, payload = hp
            for part in payload if isinstance(payload, tuple) else ():
                wire_bytes += getattr(part, "nbytes", 0)
        except Exception:  # noqa: BLE001
            pass
    wire_bpp = wire_bytes / (total_mp * 1e6) if wire_bytes else None

    # ---- fully device-resident path (decode_batch_sharded): blobs ->
    # device RGB with entropy decode ON DEVICE (VERDICT r2 item 1's
    # number of record; the host-entropy path above is the default
    # serving path on CPU-rich hosts) ----
    dev_path_mps = dev_path_host_ms = None
    try:
        from jax.sharding import Mesh

        from jpeg_decoder_tpu.parallel import sharded as sharded_mod

        mesh = Mesh(np.array([dev]).reshape(1, 1), ("data", "seg"))
        drounds = int(os.environ.get("BENCH_DEVICE_ROUNDS", "16"))
        dwork = blobs * drounds
        dmp = total_mp * drounds

        def run_devpath():
            items = sharded_mod.decode_batch_sharded(dwork, mesh)
            sync([i for i in items if i.rgb_batch is not None])
            return items

        run_devpath()  # warm (compiles)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run_devpath()
            best = min(best, time.perf_counter() - t0)
        dev_path_mps = dmp / best
        # Host-attributable share: parse + unstuff + lane prep (hybrid
        # skeleton scan for DRI=0 groups — what decode_batch_sharded runs).
        from jpeg_decoder_tpu.entropy import native as native_mod
        from jpeg_decoder_tpu.ops import entropy_spec as espec
        from jpeg_decoder_tpu.ops import scan_prep as sprep

        use_hybrid = native_mod.available()
        hyb_kernel = os.environ.get("JD_HYBRID_KERNEL", "emit")
        t0 = time.perf_counter()
        for blob in dwork:
            hdr = parser.parse(blob)
            if hdr.restart_interval:
                sprep.prepare_scan(hdr, hdr.scans[0])
            elif use_hybrid and hyb_kernel == "emit":
                # Match what decode_batch_sharded dispatches by default
                # (ADVICE r3): the emit prep's per-segment skeleton +
                # lane-boundary work IS the host cost of the path.
                espec.prepare_hybrid_batch_emit(hdr, [hdr.scans[0]],
                                                threads=1)
            elif use_hybrid:
                espec.prepare_hybrid_batch(hdr, [hdr.scans[0]], threads=1)
            else:
                espec.prepare_spec_batch(hdr, [hdr.scans[0]])
        dev_path_host_ms = (time.perf_counter() - t0) * 1e3
        log(f"device-resident path: {dev_path_mps:.1f} MP/s "
            f"({dmp:.1f} MP best of 3; host prep {dev_path_host_ms:.0f} ms"
            f" of {best*1e3:.0f} ms; the rest is H2D + device programs)")
    except Exception as e:  # noqa: BLE001
        log("device-path measurement failed:", e)

    # ---- device stage rates: chained iterations inside ONE jitted
    # program (optimization_barrier-carried dependency), one scalar
    # fetch, so dispatch and host round trips cancel out of the per-
    # iteration time.
    onchip: dict = {}
    try:
        from jpeg_decoder_tpu.ops import entropy_flat, entropy_spec

        oiters = int(os.environ.get("BENCH_ONCHIP_ITERS", "6"))

        def timeit_chained(fn, iters=oiters):
            @jax.jit
            def many(seed):
                def body(_, acc):
                    return acc + fn(acc)
                return jax.lax.fori_loop(0, iters, body, seed)

            float(many(jnp.int32(0)))  # warm/compile
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                float(many(jnp.int32(1)))
                best = min(best, (time.perf_counter() - t0) / iters)
            return best

        # (a) lockstep entropy kernel on the corpus DRI image (img4, 50
        # restart segments) x8 replicas -> 400 lanes, kernel only.
        b4 = next(b for b in blobs if parser.parse(b).restart_interval)
        h4 = parser.parse(b4)
        pool, base, nblk, maxb, bc4, lay4 = \
            entropy_flat.prepare_scan_flat(h4, h4.scans[0])
        R = 8
        pool_r = np.tile(pool, R)
        base_r = np.concatenate(
            [base + r * len(pool) * 32 for r in range(R)]).astype(np.int32)
        nblk_r = np.tile(nblk, R)
        luts2 = jnp.asarray(entropy_flat.merged_luts(
            h4, h4.scans[0]).reshape(2 * len(h4.components), 65536))
        pool_d = jnp.asarray(pool_r)
        base_d = jnp.asarray(base_r)
        nblk_d = jnp.asarray(nblk_r)
        lim_d = jnp.full(base_r.shape, 2**30, jnp.int32)
        mp4 = R * h4.width * h4.height / 1e6

        def lockstep_step(acc):
            p = jax.lax.optimization_barrier((pool_d, acc))[0]
            out, err, nd, *_ = entropy_flat.decode_lockstep(
                p, base_d, nblk_d, lim_d, luts2, block_comp=bc4,
                n_comps=len(h4.components), max_blocks=maxb)
            return out[0, 0, 0] + err.sum() + nd[0]

        dt = timeit_chained(lockstep_step)
        onchip["entropy_onchip_lockstep_mps"] = round(mp4 / dt, 1)

        # (b) hybrid emission pipeline (skeleton-lane DRI=0 route) on
        # img5 x4: the FULL device program — emission kernel + scatter +
        # segmented DC prefix sum (what decode_batch_sharded dispatches).
        b5 = max(blobs, key=lambda b: len(b))
        h5 = parser.parse(b5)
        (pools, starts_rel, nm_lane, lane_off, T, T2, C, seg_first,
         skel_ok) = entropy_spec.prepare_hybrid_batch_emit(
            h5, [h5.scans[0]] * 4)
        assert skel_ok.all()
        from jpeg_decoder_tpu.layout import scan_layout as _scan_layout
        lay5 = _scan_layout(h5)
        bc5 = tuple(ci for ci, c in enumerate(h5.components)
                    for _ in range(c.v * c.h))
        luts5 = jnp.asarray(entropy_flat.merged_luts(h5, h5.scans[0]))
        pair = entropy_spec.use_pair_kernel()
        hyb_args = tuple(jnp.asarray(a) for a in (
            pools, starts_rel, nm_lane, lane_off, seg_first))
        mp5 = 4 * h5.width * h5.height / 1e6

        def hybrid_step(acc):
            p = jax.lax.optimization_barrier((hyb_args[0], acc))[0]
            blocks, bad = entropy_spec._hybrid_pipeline_batch_emit(
                p, *hyb_args[1:], luts5, block_comp=bc5,
                n_comps=len(h5.components), T=(T2 if pair else T),
                n_mcus=lay5.n_mcus, C=C, precision=h5.precision,
                pair=pair)
            return blocks[0, 0, 0] + bad.sum().astype(jnp.int32)

        dt = timeit_chained(hybrid_step)
        onchip["entropy_onchip_hybrid_mps"] = round(mp5 / dt, 1)

        # (b2) speculative (zero-host-cycles) pipeline on the same
        # images — the A/B of record vs the hybrid route (VERDICT r4
        # item 6): same process, same chained technique, same workload.
        luts2_5 = jnp.asarray(entropy_flat.merged_luts(
            h5, h5.scans[0]).reshape(2 * len(h5.components), 65536))
        (spools, sbase, slim, sact, scap, sC) = \
            entropy_spec.prepare_spec_batch(h5, [h5.scans[0]] * 4)
        spec_args = tuple(jnp.asarray(a)
                          for a in (spools, sbase, slim, sact))

        def spec_step(acc):
            p = jax.lax.optimization_barrier((spec_args[0], acc))[0]
            blocks, ok = entropy_spec._spec_pipeline_batch(
                p, *spec_args[1:], luts2_5, block_comp=bc5,
                n_comps=len(h5.components), cap=scap,
                n_mcus=lay5.n_mcus, C=sC, precision=h5.precision)
            return blocks[0, 0, 0] + ok.sum().astype(jnp.int32)

        dt = timeit_chained(spec_step)
        onchip["entropy_onchip_spec_mps"] = round(mp5 / dt, 1)

        # (c) fused pixel pipeline (dequant + kron IDCT + fancy upsample
        # + color) on a synthetic 8 MP 4:2:0 frame, device-resident.
        from jpeg_decoder_tpu.ops import pixel as _pix

        side = 2880
        ly, lc = side // 8, side // 16
        rng = np.random.default_rng(0)
        py = jnp.asarray(rng.integers(-512, 512, (ly, ly, 64)), jnp.int32)
        pc = jnp.asarray(rng.integers(-256, 256, (lc, lc, 64)), jnp.int32)
        q64 = jnp.asarray(np.full(64, 3), jnp.int32)
        mp_pix = side * side / 1e6

        def pixel_step(acc):
            y = jax.lax.optimization_barrier((py, acc))[0]
            rgb = _pix.pixel_pipeline(
                (y, pc, pc), (q64, q64, q64), height=side, width=side,
                samplings=((1, 1), (2, 2), (2, 2)), idct="fast",
                upsample="fancy", color="ycbcr")
            return rgb[0, 0, 0].astype(jnp.int32)

        dt = timeit_chained(pixel_step)
        onchip["pixel_onchip_mps"] = round(mp_pix / dt, 1)
        log(f"device stages: lockstep "
            f"{onchip['entropy_onchip_lockstep_mps']} MP/s, hybrid "
            f"{onchip['entropy_onchip_hybrid_mps']} MP/s, spec "
            f"{onchip['entropy_onchip_spec_mps']} MP/s, pixel "
            f"{onchip['pixel_onchip_mps']} MP/s")

    except Exception as e:  # noqa: BLE001
        log("on-chip stage measurement failed:", e)

    ref_mps = measure_reference_mps(paths)
    log(f"reference C++ single-core: "
        f"{ref_mps:.1f} MP/s" if ref_mps else "reference baseline: n/a")

    out = {
        "metric": "aggregate_baseline_decode_throughput_1gpu",
        "value": round(value, 2),
        "unit": "MP/s",
        "vs_baseline": round(value / ref_mps, 2) if ref_mps else None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "median_mps": round(median_mps, 2),
        "passes_s": [round(d, 4) for d in dts],
        "max_diff_vs_reference": max_diff,
        "host_stage_mps_1thread": round(host_mps, 1),
        "device_wave_ms": round(device_wave_ms, 1),
        "progressive_host_entropy_mps": (
            round(prog_mps, 1) if prog_mps else None),
        "progressive_device_path_mps": (
            round(prog_dev_mps, 1) if prog_dev_mps else None),
        "device_path_mps": (
            round(dev_path_mps, 2) if dev_path_mps else None),
        "device_path_host_prep_ms": (
            round(dev_path_host_ms, 1) if dev_path_host_ms else None),
        "wire_bytes_per_px": round(wire_bpp, 3) if wire_bpp else None,
        "reference_mps": round(ref_mps, 1) if ref_mps else None,
        "wire": wire,
        **onchip,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Smoke run of the decode path on the GPU, end to end, at real sizes.

    python chip_smoke.py [--seed N] [--report PATH]   # one GPU
    python chip_smoke.py --chips 4 [--seed N]         # phase (e) only

Inputs come from the seeded corpus (tools/corpus.py).  Phases, each checked
against a plain in-repo reference; any failure raises and the script exits
non-zero (every check raises; none is an ``assert`` that ``-O`` strips):

  (a) host-entropy serving path: BatchDecoder on 48 photos at the six
      BASELINE shapes plus one 12 MP 4:2:0 frame; RGB vs the all-NumPy
      float64 reference (ops/pixel_ref.py: Python entropy decoders, NumPy
      pixel stage), compared on the device.
  (b) device-entropy path: decode_batch_sharded on a (1, 1) mesh on the
      same batch plus a 12 MP restart frame; every image on a device
      route; the coefficient planes each route's programs produced
      (keep_planes) bit-exact vs entropy/python_ref.py, counted per
      route; RGB vs phase (a).  Restart images run once on the emission
      route and once on the lockstep route; each route is timed beside
      BatchDecoder on the same images.
  (c) progressive device lanes on a 12 MP progressive frame, planes vs
      entropy/progressive.py (needs Pillow to make the frame; says so
      when it cannot run).
  (d) pixel stage at 8 MP: idct fast / kron / exact timed; fast and kron
      within 1 count of the float64 transform, on the photo and on random
      blocks with dequantized values up to 3840; the cost and the error
      of default matmul precision beside HIGHEST; strict exact decode
      byte-identical on the GPU and on the CPU.
  (e) (--chips 4 only) decode_batch_sharded over (1,4), (2,2) and (4,1)
      meshes of four GPUs vs the one-GPU result, on the default routes
      (whole batch) and with restart images forced onto lockstep lanes.

Runs in one process on the card.  Exits non-zero, printing no result, when
JAX has no GPU.  The last stdout line is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

PHOTOS = 48
IDCT_MODES = ("exact", "fast", "kron")
DEVICE_ROUTES = {"hybrid", "hybrid-dyn", "lockstep", "spec", "progressive"}


def log(*a):
    print(*a, flush=True)


def _check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def _mp(hdrs) -> float:
    return sum(h.width * h.height for h in hdrs) / 1e6


def _block(items):
    import jax

    jax.block_until_ready([i.rgb_batch for i in items
                           if i.rgb_batch is not None])


def _timed(fn, reps: int):
    """Median and all wall times (s) of ``reps`` calls; fn must block."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts


@contextlib.contextmanager
def _env(name, value):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


@functools.cache
def _absdiff_fn():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def one(a, b):
        d = jnp.abs(a.astype(jnp.int32) - b.astype(jnp.int32))
        return jnp.max(d), jnp.sum(d, dtype=jnp.float32)

    return one


def _diff_stats(pairs):
    """Max and mean |a - b| over (device RGB, reference) pairs, computed on
    the device; only the scalars come back."""
    import jax

    outs, n = [], 0
    for a, b in pairs:
        b = jax.device_put(np.asarray(b), next(iter(a.devices())))
        outs.append(_absdiff_fn()(a, b))
        n += int(np.prod(b.shape))
    maxes = [int(o[0]) for o in outs]
    sums = sum(float(o[1]) for o in outs)
    return max(maxes), sums / n


def _mismatches(dev, ref) -> int:
    import jax
    import jax.numpy as jnp

    ref = jax.device_put(np.asarray(ref, np.int32), next(iter(dev.devices())))
    return int(jnp.sum(dev.reshape(ref.shape) != ref))


def phase_a(seed, ctx):
    from jpeg_decoder_tpu.entropy import native
    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.models.batch import BatchDecoder
    from jpeg_decoder_tpu.ops import pixel_ref
    from tools import corpus

    _check(native.available(), (
        "native host entropy library unavailable: BatchDecoder would fall "
        "back to the Python decoder"))
    blobs = corpus.photo_batch(PHOTOS, seed) + [corpus.read("large.jpg", seed)]
    hdrs = [parser.parse(b) for b in blobs]
    mp = _mp(hdrs)
    bd = BatchDecoder(entropy="auto", idct="fast", upsample="fancy")
    t0 = time.perf_counter()
    items = bd.decode(blobs)
    _block(items)
    first = time.perf_counter() - t0
    bad = [(i, it.error) for i, it in enumerate(items) if not it.ok]
    _check(not bad, f"BatchDecoder errors: {bad[:3]}")
    med, ts = _timed(lambda: _block(bd.decode(blobs)), 3)
    t0 = time.perf_counter()
    ref_planes = [pixel_ref.reference_planes(h) for h in hdrs]
    refs = [pixel_ref.decode(b, planes=p) for b, p in zip(blobs, ref_planes)]
    ref_s = time.perf_counter() - t0
    rgbs = [it.rgb for it in items]
    mx, mean = _diff_stats(zip(rgbs, refs))
    log(f"phase a: BatchDecoder(auto, fast, fancy) {len(blobs)} images "
        f"{mp:.2f} MP: first call {first:.2f} s (compiles), median "
        f"{med * 1e3:.1f} ms -> {mp / med:.1f} MP/s (passes "
        f"{[round(t * 1e3, 1) for t in ts]} ms); vs NumPy float64 "
        f"reference: max {mx}, mean {mean:.5f} (tolerance max <= "
        f"{pixel_ref.RGB_TOLERANCE}); reference took {ref_s:.1f} s")
    _check(mx <= pixel_ref.RGB_TOLERANCE, f"phase a: max diff {mx}")
    ctx.update(blobs=blobs, hdrs=hdrs, refs=refs, ref_planes=ref_planes,
               a_rgb=rgbs, bd=bd)
    return {"images": len(blobs), "mp": mp, "median_s": med,
            "mps": mp / med, "first_call_s": first, "max_diff": mx,
            "mean_diff": mean}


def _plane_mismatches(items, ref_planes):
    """Coefficient-plane mismatches per route: the planes each item's
    route programs produced (keep_planes) vs the Python reference."""
    out = collections.Counter()
    for it, ref in zip(items, ref_planes):
        _check(it.planes is not None and len(it.planes) == len(ref),
               f"route {it.route}: no planes kept")
        out[it.route] += sum(_mismatches(d, r)
                             for d, r in zip(it.planes, ref))
    return dict(out)


def phase_b(seed, ctx):
    import jax
    from jax.sharding import Mesh

    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.ops import pixel_ref
    from jpeg_decoder_tpu.parallel.sharded import decode_batch_sharded
    from tools import corpus

    rst = corpus.read("large-rst.jpg", seed)
    hdr_rst = parser.parse(rst)
    blobs = ctx["blobs"] + [rst]
    hdrs = ctx["hdrs"] + [hdr_rst]
    mp = _mp(hdrs)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seg"))
    run = functools.partial(decode_batch_sharded, mesh=mesh)

    t0 = time.perf_counter()
    items = run(blobs)
    _block(items)
    first = time.perf_counter() - t0
    bad = [(i, it.error) for i, it in enumerate(items) if not it.ok]
    _check(not bad, f"decode_batch_sharded errors: {bad[:3]}")
    routes = collections.Counter(it.route for it in items)
    log(f"phase b: routes {dict(routes)}")
    _check(set(routes) <= DEVICE_ROUTES, f"host fallback: {dict(routes)}")
    med, ts = _timed(lambda: _block(run(blobs)), 3)

    # The same call with the planes kept: routes, planes and RGB all come
    # from the programs that decoded each image.
    planes_rst = pixel_ref.reference_planes(hdr_rst)
    ref_planes = ctx["ref_planes"] + [planes_rst]
    t0 = time.perf_counter()
    kept = run(blobs, keep_planes=True)
    _block(kept)
    _check([it.route for it in kept] == [it.route for it in items],
           "keep_planes changed the routes")
    planes = _plane_mismatches(kept, ref_planes)
    log(f"phase b: coefficient-plane mismatches vs python_ref per route "
        f"over {len(kept)} images: {planes} "
        f"({time.perf_counter() - t0:.1f} s)")
    _check(not any(planes.values()), f"plane mismatches {planes}")
    ref_rst = pixel_ref.decode(rst, planes=planes_rst)
    pairs = list(zip([it.rgb for it in kept], ctx["a_rgb"] + [ref_rst]))
    mx, mean = _diff_stats(pairs)
    log(f"phase b: decode_batch_sharded (1,1) mesh {len(blobs)} images "
        f"{mp:.2f} MP: first call {first:.2f} s, median {med * 1e3:.1f} ms "
        f"-> {mp / med:.1f} MP/s (passes {[round(t * 1e3, 1) for t in ts]} "
        f"ms); RGB vs phase a (and the NumPy reference for the restart "
        f"frame): max {mx}, mean {mean:.5f}")
    _check(mx <= pixel_ref.RGB_TOLERANCE, f"phase b: max diff {mx}")

    # Lockstep route for the restart images (the emission route is the
    # default above), checked against the NumPy reference.
    rst_idx = [i for i, h in enumerate(hdrs) if h.restart_interval]
    rst_blobs = [blobs[i] for i in rst_idx]
    with _env("JD_RESTART_EMIT_MAX_LANES", "0"):
        lk = run(rst_blobs, keep_planes=True)
        _block(lk)
    lk_routes = collections.Counter(it.route for it in lk)
    _check(set(lk_routes) == {"lockstep"} and all(it.ok for it in lk), (
        f"lockstep run: {dict(lk_routes)}"))
    lk_planes = _plane_mismatches(lk, [ref_planes[i] for i in rst_idx])
    refs = ctx["refs"] + [ref_rst]
    mx_l, mean_l = _diff_stats(
        (it.rgb, refs[i]) for it, i in zip(lk, rst_idx))
    log(f"phase b: lockstep route on {len(rst_blobs)} restart images: "
        f"plane mismatches {lk_planes}; RGB max {mx_l}, mean {mean_l:.5f} "
        f"vs NumPy reference")
    _check(not any(lk_planes.values()), f"plane mismatches {lk_planes}")
    _check(mx_l <= pixel_ref.RGB_TOLERANCE, f"lockstep route: max diff {mx_l}")
    planes.update(lk_planes)

    # Per-route wall times beside BatchDecoder on the same images.
    groups = {
        "dri0-photos": [i for i in range(PHOTOS)
                        if not hdrs[i].restart_interval],
        "restart-photos": [i for i in range(PHOTOS)
                           if hdrs[i].restart_interval],
        "large-dri0": [PHOTOS],
        "large-restart": [PHOTOS + 1],
    }
    bd = ctx["bd"]
    per_route = {}
    for name, idx in groups.items():
        gb = [blobs[i] for i in idx]
        gmp = _mp(hdrs[i] for i in idx)
        row = {"images": len(idx), "mp": gmp}
        modes = [("default", None)]
        if hdrs[idx[0]].restart_interval:
            modes.append(("lockstep", "0"))
        for mode, env in modes:
            with (_env("JD_RESTART_EMIT_MAX_LANES", env) if env
                  else contextlib.nullcontext()):
                its = run(gb)
                _block(its)
                r = sorted(collections.Counter(i.route for i in its))
                m, _ = _timed(lambda: _block(run(gb)), 3)
            row[f"sharded_{mode}"] = {"routes": r, "median_s": m,
                                      "mps": gmp / m}
        _block(bd.decode(gb))
        m, _ = _timed(lambda: _block(bd.decode(gb)), 3)
        row["batchdecoder"] = {"median_s": m, "mps": gmp / m}
        per_route[name] = row
        log(f"phase b route {name}: " + json.dumps(row))

    return {"images": len(blobs), "mp": mp, "median_s": med,
            "mps": mp / med, "first_call_s": first, "routes": dict(routes),
            "max_diff": mx, "mean_diff": mean, "per_route": per_route,
            "plane_mismatches": planes}


def phase_c(seed, ctx):
    import jax
    from jax.sharding import Mesh

    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.ops import pixel_ref
    from jpeg_decoder_tpu.parallel.sharded import decode_batch_sharded
    from tools import corpus

    try:
        import PIL  # noqa: F401
    except ImportError:
        log("phase c: NOT RUN — Pillow is not importable here, and the "
            "12 MP progressive frame is made by Pillow's encoder")
        return {"ran": False, "reason": "Pillow not importable"}
    blob = corpus.read("prograssive-sample.jpg", seed)
    hdr = parser.parse(blob)
    _check(hdr.progressive, "corpus frame is not progressive")
    mp = _mp([hdr])
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seg"))
    t0 = time.perf_counter()
    items = decode_batch_sharded([blob], mesh)
    _block(items)
    first = time.perf_counter() - t0
    _check(items[0].ok and items[0].route == "progressive", (
        items[0].route, items[0].error))
    med, ts = _timed(lambda: _block(decode_batch_sharded([blob], mesh)), 3)
    ref_planes = pixel_ref.reference_planes(hdr)  # entropy/progressive.py
    kept = decode_batch_sharded([blob], mesh, keep_planes=True)
    mism = _plane_mismatches(kept, [ref_planes])["progressive"]
    mx, mean = _diff_stats([(kept[0].rgb,
                             pixel_ref.decode(blob, planes=ref_planes))])
    log(f"phase c: progressive {hdr.width}x{hdr.height} ({len(hdr.scans)} "
        f"scans) via decode_batch_sharded: first call {first:.2f} s, "
        f"median {med * 1e3:.1f} ms -> {mp / med:.1f} MP/s; plane "
        f"mismatches vs entropy/progressive.py: {mism}; RGB vs NumPy "
        f"reference max {mx}, mean {mean:.5f}")
    _check(mism == 0 and mx <= pixel_ref.RGB_TOLERANCE,
           f"phase c: {mism} plane mismatches, max diff {mx}")
    return {"ran": True, "mp": mp, "median_s": med, "mps": mp / med,
            "first_call_s": first, "plane_mismatches": mism,
            "max_diff": mx, "mean_diff": mean}


def phase_d(seed, ctx):
    import jax
    import jax.numpy as jnp

    from jpeg_decoder_tpu import decode
    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.models.decoder import decode_to_planes
    from jpeg_decoder_tpu.ops import pixel as P
    from jpeg_decoder_tpu.ops import pixel_ref
    from tools import corpus

    blob = corpus.read("square-8mp.jpg", seed)
    hdr = parser.parse(blob)
    mp = _mp([hdr])
    planes = decode_to_planes(hdr)
    qts = [hdr.quant_tables[c.tq].values for c in hdr.components]
    samp = tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                 for c in hdr.components)
    jplanes = tuple(jnp.asarray(p) for p in planes)
    jqts = tuple(jnp.asarray(q) for q in qts)
    kw = dict(height=hdr.height, width=hdr.width, samplings=samp,
              upsample="fancy")
    # color="rgb" keeps the upsampled sample planes (level shift only):
    # the surface the +-1 IDCT bound is stated on.
    ref_rgb = pixel_ref.pixel_pipeline(planes, qts, color="ycbcr", **kw)
    ref_samples = pixel_ref.pixel_pipeline(planes, qts, color="rgb", **kw)

    def pipeline(idct, color):
        return jax.jit(functools.partial(
            P.pixel_pipeline_impl, idct=idct, color=color, **kw))

    out = {}
    samples = {}
    for idct in IDCT_MODES:
        fn = pipeline(idct, "ycbcr")
        t0 = time.perf_counter()
        rgb = fn(jplanes, jqts).block_until_ready()
        first = time.perf_counter() - t0
        med, ts = _timed(lambda: fn(jplanes, jqts).block_until_ready(), 20)
        mx, mean = _diff_stats([(rgb, ref_rgb)])
        samples[idct] = pipeline(idct, "rgb")(jplanes, jqts)
        smx, _ = _diff_stats([(samples[idct], ref_samples)])
        out[idct] = {"median_s": med, "mps": mp / med, "first_call_s": first,
                     "rgb_max_diff": mx, "rgb_mean_diff": mean,
                     "sample_max_diff_vs_float64": smx}
        log(f"phase d: idct={idct} 8 MP pixel stage median "
            f"{med * 1e3:.3f} ms -> {mp / med:.1f} MP/s; samples vs float64 "
            f"transform max {smx}; RGB vs NumPy reference max {mx}, mean "
            f"{mean:.5f}")
    approx = [m for m in IDCT_MODES if m != "exact"]
    for idct in approx:
        _check(out[idct]["sample_max_diff_vs_float64"] <= 1,
               f"idct={idct} is more than 1 count from the float64 IDCT")
        out[idct]["sample_max_diff_vs_exact"], _ = _diff_stats(
            [(samples[idct], samples["exact"])])
    log("phase d: |mode - exact| sample max: " + json.dumps(
        {k: out[k]["sample_max_diff_vs_exact"] for k in approx}))

    # Random blocks with dequantized values up to 3840 (quantized
    # coefficients in [-64, 64) times table entries in [1, 60), the case of
    # tests/test_gpu.py), at HIGHEST and at the default precision.
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-64, 64, size=(1 << 18, 64)).astype(np.int32)
    q = rng.integers(1, 60, size=(64,)).astype(np.int32)
    deq = (blocks.astype(np.int64) * q).reshape(-1, 8, 8).astype(np.float64)
    want = np.matmul(np.matmul(P.IDCT_M, deq), P.IDCT_M.T).reshape(-1, 64)
    jb, jq = jnp.asarray(blocks), jnp.asarray(q)
    jwant = jnp.asarray(want.astype(np.float32))
    stress = {}
    saved = P.MATMUL_PRECISION
    try:
        for prec in ("HIGHEST", "DEFAULT"):
            P.MATMUL_PRECISION = getattr(jax.lax.Precision, prec)
            fns = {
                "fast": jax.jit(lambda b, q: P.idct_fast(
                    (b * q).reshape(-1, 8, 8)).reshape(-1, 64)),
                "kron": jax.jit(lambda b, q: P.idct_kron(b, q)),
            }
            for idct, fn in fns.items():
                got = fn(jb, jq).astype(jnp.float32)
                stress[f"{idct}_{prec}"] = float(jnp.max(jnp.abs(got - jwant)))
    finally:
        P.MATMUL_PRECISION = saved
    log(f"phase d: random blocks (dequantized up to 3840), max |IDCT - "
        f"float64| by mode and precision: {json.dumps(stress)}")
    for idct in approx:
        _check(stress[f"{idct}_HIGHEST"] <= 1.0,
               f"idct={idct} at HIGHEST is more than 1 count from float64 "
               f"on random blocks")
    out["random_blocks_max_diff"] = stress

    # Cost of HIGHEST: the same products at the default precision.
    P.MATMUL_PRECISION = jax.lax.Precision.DEFAULT
    try:
        for idct in ("fast", "kron"):
            fn = pipeline(idct, "ycbcr")
            fn(jplanes, jqts).block_until_ready()
            med, _ = _timed(lambda: fn(jplanes, jqts).block_until_ready(),
                            20)
            smx, smean = _diff_stats(
                [(pipeline(idct, "rgb")(jplanes, jqts), ref_samples)])
            out[idct]["default_precision"] = {
                "median_s": med, "mps": mp / med,
                "sample_max_diff_vs_float64": smx,
                "sample_mean_diff_vs_float64": smean}
            log(f"phase d: idct={idct} at DEFAULT precision median "
                f"{med * 1e3:.3f} ms; samples vs float64 max {smx}, mean "
                f"{smean:.5f}")
    finally:
        P.MATMUL_PRECISION = saved

    # Strict exact decode: eager op-by-op, byte-identical GPU vs CPU.
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    gpu_rgb = decode(blob, idct="exact", upsample="fancy", strict=True).rgb
    cpu_rgb = decode(blob, idct="exact", upsample="fancy", strict=True,
                     device=cpu).rgb
    same = bool(np.array_equal(gpu_rgb, cpu_rgb))
    log(f"phase d: strict exact decode GPU == CPU byte-identical: {same} "
        f"({time.perf_counter() - t0:.1f} s)")
    _check(same, "strict exact decode differs between GPU and CPU")
    out["strict_gpu_equals_cpu"] = same
    out["mp"] = mp
    return out


def phase_e(seed, ctx):
    import jax

    import __graft_entry__ as graft
    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.parallel import mesh as mesh_mod
    from jpeg_decoder_tpu.parallel.sharded import decode_batch_sharded
    from tools import corpus

    devices = jax.devices()
    _check(len(devices) >= 4, f"--chips 4 needs 4 GPUs, JAX has {devices}")
    devices = devices[:4]
    fix, _refs, corrupt, what = graft.multichip_fixtures()
    batch = (corpus.photo_batch(PHOTOS, seed)
             + [corpus.read("large.jpg", seed),
                corpus.read("large-rst.jpg", seed)])
    blobs = fix + batch
    one = mesh_mod.make_mesh((1, 1), ("data", "seg"), devices=devices[:1])
    t0 = time.perf_counter()
    base = decode_batch_sharded(blobs, one)
    _block(base)
    base_rgb = [np.asarray(it.rgb) if it.ok else None for it in base]
    log(f"phase e: one-GPU decode of {len(blobs)} blobs "
        f"{time.perf_counter() - t0:.1f} s")
    # The lockstep pass takes only the restart images: every other image
    # routes as on the default pass, which already covers it.
    restart = [k for k, b in enumerate(blobs) if b is not corrupt
               and parser.parse(b).restart_interval]
    results = {}
    for shape in ((1, 4), (2, 2), (4, 1)):
        mesh = mesh_mod.make_mesh(shape, ("data", "seg"), devices=devices)
        for mode, env, idx in (("default", None, range(len(blobs))),
                               ("lockstep", "0", restart)):
            sub = [blobs[k] for k in idx]
            with (_env("JD_RESTART_EMIT_MAX_LANES", env) if env
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                items = decode_batch_sharded(sub, mesh)
                _block(items)
                first = time.perf_counter() - t0
                t0 = time.perf_counter()
                _block(decode_batch_sharded(sub, mesh))
                warm = time.perf_counter() - t0
            mx, ndiff = 0, 0
            for it, k in zip(items, idx):
                if blobs[k] is corrupt:
                    _check(it.error is not None, "corrupt blob not isolated")
                    continue
                _check(it.ok, f"mesh {shape}: {it.error}")
                d = np.abs(np.asarray(it.rgb).astype(np.int32)
                           - base_rgb[k].astype(np.int32))
                mx, ndiff = max(mx, int(d.max())), ndiff + int((d > 0).sum())
            routes = collections.Counter(it.route for it in items
                                         if it.ok)
            _check(set(routes) <= DEVICE_ROUTES, dict(routes))
            if mode == "lockstep":
                _check(set(routes) == {"lockstep"}, dict(routes))
            key = f"{shape[0]}x{shape[1]}-{mode}"
            results[key] = {"blobs": len(sub), "first_call_s": first,
                            "warm_s": warm, "max_diff_vs_1gpu": mx,
                            "samples_differing": ndiff,
                            "routes": dict(routes)}
            log(f"phase e: mesh {shape} {mode}: " + json.dumps(results[key]))
            # One count: a different mesh compiles different fusions,
            # which may contract a multiply-add differently (ops/pixel.py).
            _check(mx <= 1, f"mesh {shape} {mode}: max diff {mx}")
    log(f"phase e: {len(blobs)} blobs ({what} + {len(batch)} corpus "
        f"images) on 4 GPUs match the one-GPU decode")
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--report", default=None,
                    help="also write every phase's numbers as JSON here")
    args = ap.parse_args()
    phases = ([phase_e] if args.chips == 4
              else [phase_a, phase_b, phase_c, phase_d])

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    from jpeg_decoder_tpu.utils.runtime import enable_compile_cache

    cache = enable_compile_cache()
    dev = jax.devices()[0]
    log(f"jax {jax.__version__}; devices {len(jax.devices())} x "
        f"{dev.device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {cache}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip()
    log(f"card: {card}")

    ctx: dict = {}
    report = {"card": card, "jax": jax.__version__, "seed": args.seed,
              "xla_flags": os.environ.get("XLA_FLAGS", ""), "phases": {}}
    for phase in phases:
        t0 = time.perf_counter()
        report["phases"][phase.__name__] = phase(args.seed, ctx)
        log(f"{phase.__name__} done in {time.perf_counter() - t0:.1f} s")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Per-scan on-chip cost attribution for the progressive device path.

VERDICT r4 weak-item 1: the 12 MP progressive sample runs ~600 ms on
chip but only the DC-first kernel (9.3 ms) was measured in isolation.
This tool times EVERY scan's device program separately with the chained-
iterations technique (N reps inside one jitted fori_loop, scalar fetch),
so the AC-refine / AC-first / DC split is measured, not guessed.

Also reports each scan's host skeleton cost and lane-table stats
(event-count skew across lanes) to size the expected win from
emission-style refine + event-balanced lane boundaries.

Usage: timeout 900 python tools/prog_scan_profile.py [image] [--reps 4]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None,
                    help="progressive JPEG (default: the seeded corpus's "
                         "12 MP progressive frame)")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--lanes", type=int,
                    default=int(os.environ.get("JD_PROG_LANES", "512")))
    args = ap.parse_args()
    if args.image is None:
        from tools import corpus

        args.image = corpus.path("prograssive-sample.jpg")

    import jax

    from jpeg_decoder_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.entropy import native
    from jpeg_decoder_tpu.huffman import build_lut
    from jpeg_decoder_tpu.layout import comp_dims_unpadded
    from jpeg_decoder_tpu.ops import entropy_prog as ep

    dev = jax.devices()[0]
    print("device:", dev, flush=True)

    hdr = parser.parse(open(args.image, "rb").read())
    print(f"{hdr.width}x{hdr.height}, {len(hdr.scans)} scans, "
          f"precision {hdr.precision}")

    target_lanes = args.lanes
    shapes = []
    for ci in range(len(hdr.components)):
        shapes.append((hdr.mcus_y * hdr.components[ci].v,
                       hdr.mcus_x * hdr.components[ci].h))

    # Build every scan's lane table + kernel inputs via the SAME prep
    # the hybrid path uses (ops.entropy_prog.hybrid_scan_prep), timing
    # the host half (skeleton walks, balanced edges, H2D enqueues).
    nzmaps: dict[int, np.ndarray] = {}
    scan_rows = []
    for si, scan in enumerate(hdr.scans):
        t0 = time.perf_counter()
        m, inp = ep.hybrid_scan_prep(hdr, scan, nzmaps,
                                     target_lanes=target_lanes)
        host_ms = (time.perf_counter() - t0) * 1e3
        kind = {"dcd": "dc", "ace": "ac-first", "acr": "ac-refine",
                "ac": "ac-lockstep", "dc": "dc"}[m[0]]
        if m[0] in ("dc", "dcd"):
            kind = "dc-first" if m[4] else "dc-refine"
        S = inp[1].shape[0]
        skew = f"T={m[5]}" if m[0] in ("ace", "acr") else ""
        ncomp = ",".join(str(cc) for cc in scan.comp_indices)
        scan_rows.append(dict(
            si=si, kind=kind, m=m, inp=inp, host_ms=host_ms,
            desc=(f"scan {si:2d} {kind:9s} comp[{ncomp}] "
                  f"ss={scan.ss} se={scan.se} ah={scan.ah} al={scan.al} "
                  f"S={S} bytes={len(scan.data)}"),
            skew=skew))
        print(f"{scan_rows[-1]['desc']}  host {host_ms:.0f} ms  {skew}",
              flush=True)

    # Device timing: chain `reps` applications of each scan program inside
    # one jitted loop; fetch one scalar.  Plane state is WRONG after rep 1
    # (refine re-applied) but the instruction stream is identical — this
    # is a timing harness, not a decode.
    import functools

    @functools.partial(jax.jit, static_argnames=("m", "reps"))
    def chained(planes_t, inp, *, m, reps):
        def body(_, carry):
            planes = list(carry)
            planes, _err = ep._chain_step(planes, m, inp, None)
            return tuple(planes)
        out = jax.lax.fori_loop(0, reps, body, planes_t)
        return sum(p[0, 0] for p in out)

    total_dev = 0.0
    kind_ms: dict[str, float] = {}
    for row in scan_rows:
        m, inp = row["m"], row["inp"]
        planes = tuple(jnp.zeros((r * c + 1, 64), jnp.int32)
                       for r, c in shapes)
        # warmup/compile BOTH static-reps variants before timing
        t0 = time.perf_counter()
        float(chained(planes, inp, m=m, reps=1))
        float(chained(planes, inp, m=m, reps=1 + args.reps))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        v = chained(planes, inp, m=m, reps=1 + args.reps)
        float(v)
        t1 = time.perf_counter() - t0
        # subtract the 1-rep call cost measured again (dispatch+link):
        t0 = time.perf_counter()
        v = chained(planes, inp, m=m, reps=1)
        float(v)
        t_base = time.perf_counter() - t0
        per = max(t1 - t_base, 0.0) / args.reps * 1e3
        total_dev += per
        kind_ms[row["kind"]] = kind_ms.get(row["kind"], 0.0) + per
        print(f"{row['desc']}  dev {per:7.1f} ms/scan "
              f"(compile {compile_s:.1f}s)", flush=True)

    print("\n--- per-kind device totals ---")
    for k, v in sorted(kind_ms.items(), key=lambda kv: -kv[1]):
        print(f"{k:10s} {v:8.1f} ms")
    host_total = sum(r["host_ms"] for r in scan_rows)
    print(f"device total {total_dev:.1f} ms   host skeleton total "
          f"{host_total:.1f} ms")


if __name__ == "__main__":
    main()

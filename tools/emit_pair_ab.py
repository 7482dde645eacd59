"""A/B: paired emission kernel (decode_emit2) vs decode_emit, real chip.

VERDICT r3 item 5: the emission kernel is bound by per-step costs at the
measured optimum lane count.  decode_emit2 decodes up to two symbols per
step from the same 32-bit window — this tool measures whether halving
steps (at one extra dependent LUT gather per step) wins, and finds the
usable step-count ratio.

Usage: python tools/emit_pair_ab.py [image ...]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

from jpeg_decoder_tpu.utils.runtime import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402

from jpeg_decoder_tpu.io import parser  # noqa: E402
from jpeg_decoder_tpu.layout import scan_layout  # noqa: E402
from jpeg_decoder_tpu.ops import entropy_flat, entropy_spec  # noqa: E402


def _dense(pos, val, n_slots):
    """Scatter emitted (pos, val) pairs to a dense per-lane plane."""
    S = pos.shape[-1]
    lane_off = (jnp.arange(S, dtype=jnp.int32) * n_slots)
    flat_pos = jnp.where(pos >= 0, pos + lane_off, S * n_slots)
    out = jnp.zeros((S * n_slots,), jnp.int32)
    return out.at[flat_pos.reshape(-1)].add(
        val.reshape(-1), mode="drop").reshape(S, n_slots)


def bench_one(path, reps=30):
    hdr = parser.parse_file(path)
    scan = hdr.scans[0]
    lay = scan_layout(hdr)
    (pools, starts, nm_lane, _off, T, _T2, C, _segf,
     skel_ok) = entropy_spec.prepare_hybrid_batch_emit(hdr, [scan])
    assert skel_ok[0]
    block_comp = tuple(
        ci for ci, c in enumerate(hdr.components) for _ in range(c.v * c.h))
    bpm = len(block_comp)
    luts = jnp.asarray(entropy_flat.merged_luts(hdr, scan))
    words = jnp.asarray(pools[0])
    base = jnp.asarray(starts[0].astype(np.int32))
    nblocks = jnp.asarray((nm_lane[0] * bpm).astype(np.int32))
    n_slots = int(nm_lane[0].max()) * bpm * 64
    mp = hdr.width * hdr.height / 1e6
    kw = dict(block_comp=block_comp, n_comps=len(hdr.components), T=T)

    p1, v1, e1, nd1 = entropy_flat.decode_emit(words, base, nblocks, luts,
                                               **kw)
    assert not bool(np.asarray(e1).any())
    d1 = _dense(p1, v1, n_slots)

    # Find the smallest workable paired step count (eighth steps of T).
    T2 = None
    for frac in (0.5, 0.5625, 0.625, 0.6875, 0.75, 0.875, 1.0):
        t_try = int(np.ceil(T * frac / 64) * 64)
        kw2 = dict(kw)
        kw2["T"] = t_try
        p2, v2, e2, nd2 = entropy_flat.decode_emit2(words, base, nblocks,
                                                    luts, **kw2)
        ok = (not bool(np.asarray(e2).any())
              and bool(np.asarray(nd2 == nblocks).all()))
        if ok:
            d2 = _dense(p2, v2, n_slots)
            same = bool(np.asarray((d1 == d2).all()))
            if not same:
                print(f"  MISMATCH at T2={t_try}")
                return
            T2 = t_try
            break
    assert T2 is not None

    def timeit(fn, n=reps):
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        r[0].block_until_ready()
        return (time.perf_counter() - t0) / n

    t1 = timeit(lambda: entropy_flat.decode_emit(
        words, base, nblocks, luts, **kw))
    kw2 = dict(kw)
    kw2["T"] = T2
    t2 = timeit(lambda: entropy_flat.decode_emit2(
        words, base, nblocks, luts, **kw2))
    name = os.path.basename(path)
    print(f"{name}: {mp:.2f} MP, C={C} T={T} T2={T2} "
          f"(pair rate {1 - T2/T:.0%})")
    print(f"  emit : {t1*1e3:7.2f} ms  {mp/t1:7.1f} MP/s")
    print(f"  emit2: {t2*1e3:7.2f} ms  {mp/t2:7.1f} MP/s  "
          f"({t1/t2:.2f}x)")


def main():
    from tools import corpus

    paths = sys.argv[1:] or [corpus.path(n) for n in corpus.BASELINE]
    print("device:", jax.devices()[0])
    for p in paths:
        bench_one(p)


if __name__ == "__main__":
    main()

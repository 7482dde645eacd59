#!/usr/bin/env python
"""Per-step cost of lax.scan kernels vs gather count and lane count.

The progressive per-scan profile (tools/prog_scan_profile.py) gives the
cost of one kernel iteration; when it is far above ALU cost, the per-lane
gathers are the suspects.  This tool measures a minimal scan step with k gathers of (S,) indices, with
and without an (S, 64) row gather and an (S, 64) ys emission, so the
emission refine kernel's per-event budget is designed against data.

Usage: timeout 600 python tools/scan_step_cost.py
"""

from __future__ import annotations

import functools
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

    T = 1024
    T2 = 4096
    N_WORDS = 1 << 18
    N_ROWS = 1 << 18

    @functools.partial(jax.jit,
                       static_argnames=("S", "n_gather", "row", "emit",
                                        "T"))
    def kern(words, rows64, seed, *, S, n_gather, row, emit, T):
        carry0 = dict(
            idx=(seed + jnp.arange(S, dtype=jnp.int32)) % N_WORDS,
            acc=jnp.zeros((S, 64), jnp.int32),
            x=jnp.zeros((S,), jnp.uint32))

        def step(c, _):
            x = c["x"]
            idx = c["idx"]
            for g in range(n_gather):
                v = jnp.take(words, (idx + g) % N_WORDS)
                x = x + v
                idx = (idx ^ v.astype(jnp.int32)) % N_WORDS
            acc = c["acc"]
            if row:
                r = jnp.take(rows64, idx % N_ROWS, axis=0)
                acc = acc + r
            ys = acc if emit else x
            return dict(idx=idx, acc=acc, x=x), ys

        end, ys = jax.lax.scan(step, carry0, None, length=T)
        return end["x"].sum() + (ys.sum() if emit else 0)

    rng = np.random.default_rng(0)
    words = jnp.asarray(rng.integers(0, 2**31, N_WORDS, dtype=np.int64)
                        .astype(np.uint32))
    rows64 = jnp.asarray(rng.integers(-100, 100, (N_ROWS, 64))
                         .astype(np.int32))

    def timeit(S, n_gather, row, emit, reps=3):
        # Difference two trip counts so per-call dispatch/link constants
        # cancel: per-step = (t(T2) - t(T)) / (T2 - T).
        args = dict(S=S, n_gather=n_gather, row=row, emit=emit)
        best = {T: 1e9, T2: 1e9}
        for n in (T, T2):
            float(kern(words, rows64, jnp.int32(1), **args, T=n))
            for i in range(reps):
                t0 = time.perf_counter()
                float(kern(words, rows64, jnp.int32(i), **args, T=n))
                best[n] = min(best[n], time.perf_counter() - t0)
        return (best[T2] - best[T]) / (T2 - T) * 1e6

    print("us/step (T2-T differenced):")
    print(f"{'S':>6} {'g=1':>7} {'g=2':>7} {'g=4':>7} "
          f"{'g=2+row':>8} {'g=2+row+emit':>12}")
    for S in (256, 512, 1024, 2048):
        r = [timeit(S, 1, False, False), timeit(S, 2, False, False),
             timeit(S, 4, False, False), timeit(S, 2, True, False),
             timeit(S, 2, True, True)]
        print(f"{S:>6} {r[0]:7.2f} {r[1]:7.2f} {r[2]:7.2f} "
              f"{r[3]:8.2f} {r[4]:12.2f}", flush=True)


if __name__ == "__main__":
    main()

"""Ablation bench for the flat entropy loop: which op class dominates?

Runs a stripped skeleton of the decode_flat per-symbol body with pieces
selectively disabled, on synthetic state, for a fixed trip count.  This
isolates the per-iteration cost of (a) the 64K-entry LUT gather, (b) the
stream-word refill gather, (c) the block-commit scatter, (d) the one-hot
accumulate, independent of decode semantics.

Run: python tools/entropy_ablation.py [--lanes 800] [--trips 3000]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=800)
    ap.add_argument("--trips", type=int, default=3000)
    ap.add_argument("--max-blocks", type=int, default=300)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from jpeg_decoder_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    S = args.lanes
    T = args.trips
    MB = args.max_blocks
    print(f"device: {jax.devices()[0]}  lanes={S} trips={T}", flush=True)

    rng = np.random.default_rng(0)
    luts = jnp.asarray(rng.integers(1, 8000, 6 * 65536).astype(np.uint16))
    words = jnp.asarray(rng.integers(0, 2**32, S * 80,
                                     dtype=np.uint64).astype(np.uint32))
    lanes = jnp.arange(S, dtype=jnp.int32)
    lane64 = jax.lax.broadcasted_iota(jnp.int32, (S, 64), 1)

    def run(name, use_lut, use_refill, use_scatter, use_onehot):
        def body(i, st):
            cur, nxt, off, w_idx, blk, acc, out, x = st
            window = jnp.where(off == 0, cur,
                               (cur << off) | (nxt >> (32 - jnp.maximum(off, 1))))
            w16 = (window >> 16).astype(jnp.int32)
            if use_lut:
                entry = jnp.take(luts, (x % 6) * 65536 + w16).astype(jnp.int32)
            else:
                entry = (w16 & 255) + 1
            length = (entry & 31).astype(jnp.uint32) % 12 + 1
            val = (entry >> 5) & 0xFF
            offp = off + length
            need = offp >= 32
            if use_refill:
                loaded = jnp.take(words, jnp.minimum(w_idx, words.shape[0] - 1))
            else:
                loaded = cur ^ nxt
            cur = jnp.where(need, nxt, cur)
            nxt = jnp.where(need, loaded, nxt)
            w_idx = w_idx + need
            off = offp - jnp.where(need, 32, 0).astype(jnp.uint32)
            if use_onehot:
                acc = acc + jnp.where(lane64 == (val[:, None] & 63),
                                      val[:, None], 0)
            else:
                acc = acc + val[:, None]
            commit = (val & 15) == 0
            if use_scatter == "scalar":
                # One coefficient per lane per iteration, no acc at all:
                # out viewed (S, MB*64), per-lane flat position.
                o2 = out.reshape(S, MB * 64)
                idx = jnp.where(commit, (blk % MB) * 64 + (val & 63),
                                MB * 64)
                o2 = o2.at[lanes, idx].add(val, mode="drop",
                                           unique_indices=True)
                out = o2.reshape(S, MB, 64)
            elif use_scatter == "2d":
                tgt = jnp.where(commit, blk % MB, MB)
                out = out.at[lanes, tgt].add(acc, mode="drop")
            elif use_scatter == "2d-unique":
                tgt = jnp.where(commit, blk % MB, MB)
                out = out.at[lanes, tgt].add(acc, mode="drop",
                                             unique_indices=True)
            elif use_scatter == "flat-unique":
                tgt = jnp.where(commit, lanes * MB + (blk % MB), S * MB)
                out = out.reshape(S * MB, 64).at[tgt].add(
                    acc, mode="drop", unique_indices=True).reshape(S, MB, 64)
            blk = blk + commit
            acc = jnp.where(commit[:, None], 0, acc)
            return (cur, nxt, off, w_idx, blk, acc, out, x + entry)

        @jax.jit
        def many(seed):
            st = (words[:S], words[S:2 * S],
                  jnp.zeros((S,), jnp.uint32) + seed.astype(jnp.uint32) % 7,
                  jnp.full((S,), 2, jnp.int32),
                  jnp.zeros((S,), jnp.int32),
                  jnp.zeros((S, 64), jnp.int32),
                  jnp.zeros((S, MB, 64), jnp.int32),
                  lanes + seed)
            st = jax.lax.fori_loop(0, T, body, st)
            return st[4].sum() + st[5][0, 0] + st[6][0, 0, 0] + st[7][0]

        t0 = time.perf_counter()
        float(many(jnp.int32(0)))
        warm = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(many(jnp.int32(1)))
            best = min(best, time.perf_counter() - t0)
        per_it = best / T
        print(f"{name:28s}: {best*1e3:8.2f} ms total, "
              f"{per_it*1e6:7.2f} us/iter (warm {warm:.0f}s)", flush=True)

    run("scalar scatter + no onehot", True, True, "scalar", False)
    run("full (2d scatter)", True, True, "2d", True)
    run("no scatter", True, True, False, True)


if __name__ == "__main__":
    main()

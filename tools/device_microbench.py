"""Per-stage device microbenchmark: substantiates the pipeline-rate claims
in docs/ARCHITECTURE.md with a reproducible measurement.

Times, on whatever device jax selects:
  * the fused pixel pipeline (dequant + IDCT + upsample + color) on a
    synthetic 4:2:0 frame, device-resident inputs, per IDCT mode;
  * the nibble-wire unpack (cumsum + scatter-add) alone;
  * H2D transfer of a representative wire payload.

Run:  python tools/device_microbench.py [--mp 8] [--iters 8]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mp", type=float, default=8.0,
                    help="synthetic frame size in megapixels")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from jpeg_decoder_tpu.ops import pixel as pixel_ops

    dev = jax.devices()[0]
    print(f"device: {dev}", flush=True)

    side = int((args.mp * 1e6) ** 0.5) // 16 * 16
    h = w = side
    mp = h * w / 1e6
    ly, lc = side // 8, side // 16
    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.integers(-512, 512, (ly, ly, 64)), jnp.int32)
    cb = jnp.asarray(rng.integers(-256, 256, (lc, lc, 64)), jnp.int32)
    cr = jnp.asarray(rng.integers(-256, 256, (lc, lc, 64)), jnp.int32)
    q = jnp.asarray(np.full(64, 3), jnp.int32)
    planes = tuple(jax.device_put(p, dev) for p in (y, cb, cr))
    qts = (q, q, q)

    # Each measurement runs ITERS chained iterations (loop-carried data
    # dependency) inside ONE jitted program and fetches a scalar, so
    # dispatch cost cancels out of the wall time divided by ITERS.
    from functools import partial

    def timeit_chained(make_step, n):
        @jax.jit
        def many(seed):
            def body(_, acc):
                return acc + make_step(acc)
            return jax.lax.fori_loop(0, n, body, seed)

        float(many(jnp.int32(0)))  # compile + warm
        t0 = time.perf_counter()
        r = float(many(jnp.int32(1)))
        dt = (time.perf_counter() - t0) / n
        del r
        return dt

    for idct in ("fast", "kron", "exact"):
        def step(acc, idct=idct):
            p0 = planes[0] + (acc & 1)  # loop-carried dependency
            rgb = pixel_ops.pixel_pipeline_impl(
                (p0, planes[1], planes[2]), qts, height=h, width=w,
                samplings=((1, 1), (2, 2), (2, 2)),
                idct=idct, upsample="fancy")
            return rgb[0, 0, 0].astype(jnp.int32)
        dt = timeit_chained(step, args.iters)
        print(f"pixel pipeline idct={idct:5s}: {dt*1e3:7.2f} ms "
              f"-> {mp/dt:8.0f} MP/s", flush=True)

    # nibble unpack alone: representative density ~9 nz/block
    n_blocks = ly * ly + 2 * lc * lc
    k = n_blocks * 9
    e = jnp.asarray(rng.integers(1, 255, k), jnp.uint8)
    ov = jnp.asarray(rng.integers(-100, 100, k // 5), jnp.int8)
    e_d, ov_d = jax.device_put(e, dev), jax.device_put(ov, dev)

    def unpack_step(acc):
        ei = (e_d + (acc & 1).astype(jnp.uint8)).astype(jnp.int32)
        g, vcode = ei >> 4, ei & 15
        adv = jnp.where(vcode == 0, g * 16, g)
        idx = jnp.cumsum(adv) - 1
        v4 = ((vcode + 8) & 15) - 8
        is_ov = vcode == 8
        rank = jnp.cumsum(is_ov.astype(jnp.int32)) - 1
        vals = jnp.where(is_ov, ov_d[rank].astype(jnp.int32), v4)
        flat = jnp.zeros((n_blocks * 64,), jnp.int32)
        return flat.at[idx].add(vals, mode="drop")[0]

    dt = timeit_chained(unpack_step, args.iters)
    print(f"nibble unpack ({k} entries): {dt*1e3:7.2f} ms "
          f"-> {mp/dt:8.0f} MP/s equivalent", flush=True)

    # H2D of a representative wire payload (~0.4 B/px)
    payload = rng.integers(0, 255, int(mp * 1e6 * 0.4), dtype=np.uint8)
    t0 = time.perf_counter()
    for _ in range(3):
        jax.device_put(payload, dev).block_until_ready()
    dt = (time.perf_counter() - t0) / 3
    print(f"H2D {payload.nbytes/1e6:.1f} MB wire: {dt*1e3:7.2f} ms "
          f"-> {payload.nbytes/dt/1e6:6.0f} MB/s "
          f"({mp/dt:8.0f} MP/s equivalent)", flush=True)


if __name__ == "__main__":
    main()

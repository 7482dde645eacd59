"""Example: batched JPEG decode feeding an on-device model, no host copies.

The dominant accelerator use case for a decode engine is the input pipeline
of a training/serving job: bytes arrive on the host, pixels are consumed on the
device.  ``BatchDecoder`` keeps decoded RGB device-resident, so the model
step below consumes ``rgb_batch`` directly — the only host->device traffic
is the sparse coefficient wire (~0.35 B/px), and nothing comes back except
the model output.

Run:  python examples/serving_pipeline.py [--platform cpu] [--glob PATTERN]

Without ``--glob`` it decodes the six baseline photos of the seeded corpus
(``tools/corpus.py``).
"""

import argparse
import glob
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu)")
    ap.add_argument("--glob", default=None,
                    help="JPEG files to decode (default: seeded corpus)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from jpeg_decoder_tpu.models.batch import BatchDecoder

    @jax.jit
    def model_step(rgb_batch):
        """Stand-in model: normalize + global spatial pooling + a
        projection (the point is that it runs where the pixels already
        are)."""
        x = rgb_batch.astype(jnp.float32) / 127.5 - 1.0
        feats = x.mean(axis=(1, 2))                    # (B, 3)
        w = jnp.array([[0.9, -0.2, 0.1],
                       [0.05, 1.1, -0.3],
                       [-0.4, 0.2, 0.8]], jnp.float32)
        return feats @ w                               # (B, 3) embeddings

    if args.glob:
        paths = sorted(glob.glob(args.glob))
    else:
        from tools import corpus

        paths = [corpus.path(n) for n in corpus.BASELINE]
    blobs = [open(p, "rb").read() for p in paths]
    bd = BatchDecoder(idct="fast", upsample="fancy")

    t0 = time.perf_counter()
    items = bd.decode(blobs)
    # Group items by their shared device batch and run the model per group.
    outputs = {}
    for item in items:
        if not item.ok:
            print(f"{paths[item.index]}: failed: {item.error}")
            continue
        key = id(item.rgb_batch)
        if key not in outputs:
            outputs[key] = model_step(item.rgb_batch)
        emb = outputs[key][item.batch_index]
        print(f"{paths[item.index]}: embedding {emb}")
    dt = time.perf_counter() - t0
    print(f"{len(blobs)} images decoded + embedded in {dt*1e3:.0f} ms "
          f"(pixels never left the device)")


if __name__ == "__main__":
    main()

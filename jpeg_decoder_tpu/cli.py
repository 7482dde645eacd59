"""Command-line interface.

Replaces the reference's L6 CLI (jpeg.cpp:916-929, `./a.out <image>` with no
flags) with a batch-capable argparse CLI: multiple inputs, selectable entropy
backend / IDCT mode / output format, optional coefficient dumps for
conformance debugging (the reference's verbose header narration is available
via -v).

Usage:
    python -m jpeg_decoder_tpu [options] IMAGE [IMAGE ...]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jpeg_decoder_tpu",
        description="Accelerator JPEG decoder (JAX/XLA)",
    )
    p.add_argument("inputs", nargs="+", help="input JPEG file(s)")
    p.add_argument("-o", "--output", default=None,
                   help="output file (single input) or directory; "
                        "default: alongside input as .png")
    p.add_argument("--format", choices=["png", "bmp", "ppm"], default="png")
    p.add_argument("--entropy", default="auto",
                   choices=["auto", "python", "native", "speculative",
                            "hybrid", "jax"],
                   help="entropy-decode backend")
    p.add_argument("--idct", default="fast",
                   choices=["exact", "fast", "kron"],
                   help="'exact' matches the reference C++ bit-for-bit; "
                        "'fast' and 'kron' use float32 matrix products "
                        "(within 1 count of 'exact')")
    p.add_argument("--upsample", default="nn", choices=["nn", "fancy"],
                   help="chroma upsampling: 'nn' matches the reference; "
                        "'fancy' is libjpeg-style triangular (higher quality)")
    p.add_argument("--orientation", default="ignore",
                   choices=["ignore", "respect"],
                   help="EXIF orientation: 'respect' auto-rotates like "
                        "PIL.ImageOps.exif_transpose")
    p.add_argument("--strict", action="store_true",
                   help="eager pixel pipeline for byte-perfect reference "
                        "parity (slow)")
    p.add_argument("--dump-coeffs", metavar="PREFIX", default=None,
                   help="also dump dequantized coefficient planes as "
                        "PREFIX.<image>.comp<i>.npy")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. cpu, gpu)")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v: summary; -vv: full header narration "
                        "(tables, scans) like the reference's verbose dumps")
    p.add_argument("--time", action="store_true", help="print per-image decode ms")
    p.add_argument("--profile", metavar="LOGDIR", default=None,
                   help="capture a jax.profiler trace of the decode(s)")
    p.add_argument("--resume", action="store_true",
                   help="skip inputs whose output file already exists "
                        "(restartable batch decode)")
    p.add_argument("--show", action="store_true",
                   help="open the decoded image in the system viewer "
                        "(replaces the reference's X11 display)")
    p.add_argument("--batch", action="store_true",
                   help="decode all inputs through the batched device "
                        "pipeline (geometry-grouped single dispatches)")
    p.add_argument("--device-entropy", action="store_true",
                   help="with --batch: fully device-resident path "
                        "(decode_batch_sharded) — entropy decode runs as "
                        "device lanes; host does parse+unstuff+skeleton "
                        "only")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")
    # Scope verbosity to our logger: root DEBUG would flood with jax internals.
    logging.getLogger("jpeg_decoder_tpu").setLevel(
        [logging.WARNING, logging.INFO, logging.DEBUG][min(args.verbose, 2)])
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    from .utils.runtime import enable_compile_cache

    enable_compile_cache()

    from . import decode
    from .io import writers
    from .utils import logging as jd_logging
    from .utils.config import DecodeConfig
    from .utils.profiling import StageTimer

    cfg = DecodeConfig(entropy=args.entropy, idct=args.idct,
                       upsample=args.upsample, strict=args.strict,
                       orientation=args.orientation).validate()

    timer = StageTimer()
    profile_cm = None
    if args.profile:
        from .utils.profiling import device_trace

        profile_cm = device_trace(args.profile)
        profile_cm.__enter__()

    multi = len(args.inputs) > 1
    outdir = None
    if args.output and (multi or os.path.isdir(args.output)):
        outdir = args.output
        os.makedirs(outdir, exist_ok=True)

    if args.batch:
        try:
            return _run_batch(args, timer, outdir, cfg)
        finally:
            if profile_cm is not None:
                profile_cm.__exit__(None, None, None)

    rc = 0
    total_mp = 0.0
    for path in args.inputs:
        try:
            base = os.path.splitext(os.path.basename(path))[0]
            if outdir:
                out = os.path.join(outdir, f"{base}.{args.format}")
            elif args.output:
                out = args.output
            else:
                out = os.path.join(os.path.dirname(path) or ".",
                                   f"{base}.{args.format}")
            if args.resume and os.path.exists(out):
                print(f"{path}: exists, skipped ({out})")
                continue
            t0 = time.perf_counter()
            with timer.stage("decode"):
                res = decode(path,
                             keep_planes=args.dump_coeffs is not None,
                             **cfg.decode_kwargs())
            if args.verbose:
                jd_logging.log_header(res.header)
            total_mp += res.rgb.shape[0] * res.rgb.shape[1] / 1e6
            dt = (time.perf_counter() - t0) * 1e3
            try:
                writers.write_image(out, res.rgb)
            except PermissionError:
                out = os.path.join(os.getcwd(), f"{base}.{args.format}")
                writers.write_image(out, res.rgb)
            h, w = res.rgb.shape[:2]
            msg = f"{path}: {w}x{h} -> {out}"
            if args.time:
                msg += f"  ({dt:.1f} ms, {w * h / dt / 1e3:.1f} MP/s)"
            print(msg)
            if args.show:
                from PIL import Image as _PILImage

                _PILImage.fromarray(res.rgb).show(title=base)
            if args.dump_coeffs is not None:
                import numpy as np

                for ci, plane in enumerate(res.dequantized_planes):
                    np.save(f"{args.dump_coeffs}.{base}.comp{ci}.npy", plane)
        except Exception as e:  # noqa: BLE001 — per-image isolation
            print(f"{path}: ERROR: {e}", file=sys.stderr)
            rc = 1
    if profile_cm is not None:
        profile_cm.__exit__(None, None, None)
    if args.time and total_mp:
        print(timer.report(megapixels=total_mp), file=sys.stderr)
    return rc


def _run_batch(args, timer, outdir, cfg) -> int:
    """Batched decode path: all inputs through BatchDecoder.

    Output naming matches the single-image path: -o names a FILE for a
    single input and a directory otherwise; per-input failures (unreadable
    file, malformed stream) are isolated.  --resume skips inputs whose
    output exists.  Flags the batch pipeline cannot honor are rejected
    rather than silently ignored.
    """
    import numpy as np

    from .io import writers
    from .models.batch import BatchDecoder

    for flag, name in ((args.strict, "--strict"),
                       (args.dump_coeffs, "--dump-coeffs")):
        if flag:
            print(f"{name} is not supported with --batch (use the "
                  f"per-image path)", file=sys.stderr)
            return 2

    def out_path(path: str) -> str:
        name = os.path.splitext(os.path.basename(path))[0]
        if outdir:
            return os.path.join(outdir, f"{name}.{args.format}")
        if args.output and len(args.inputs) == 1:
            return args.output
        # Default: alongside the input, matching the single-image path.
        return os.path.join(os.path.dirname(path) or ".",
                            f"{name}.{args.format}")

    rc = 0
    blobs, names = [], []
    for path in args.inputs:
        if args.resume and os.path.exists(out_path(path)):
            print(f"{path}: exists, skipped ({out_path(path)})")
            continue
        try:
            with open(path, "rb") as f:
                blobs.append(f.read())
            names.append(path)
        except OSError as e:
            print(f"{path}: ERROR: {e}", file=sys.stderr)
            rc = 1

    if not blobs:
        return rc
    t0 = time.perf_counter()
    if args.device_entropy:
        # Fully device-resident serving path: entropy decode as device
        # lanes (parallel/sharded.decode_batch_sharded), 1x1 mesh on the
        # default device; multi-chip callers use the Python API with a
        # real mesh.
        import jax
        from jax.sharding import Mesh

        from .parallel.sharded import decode_batch_sharded

        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "seg"))
        with timer.stage("batch decode (device entropy)"):
            items = decode_batch_sharded(
                blobs, mesh, idct=args.idct, upsample=args.upsample)
    else:
        bd = BatchDecoder(**cfg.batch_kwargs())
        with timer.stage("batch decode"):
            items = bd.decode(blobs)
    dt = time.perf_counter() - t0

    total_mp = 0.0
    for path, item in zip(names, items):
        if not item.ok:
            print(f"{path}: ERROR: {item.error}", file=sys.stderr)
            rc = 1
            continue
        rgb = np.asarray(item.rgb)
        total_mp += rgb.shape[0] * rgb.shape[1] / 1e6
        out = out_path(path)
        writers.write_image(out, rgb)
        print(f"{path}: {rgb.shape[1]}x{rgb.shape[0]} -> {out}")
        if args.show:
            from PIL import Image as _PILImage

            _PILImage.fromarray(rgb).show(title=os.path.basename(path))
    if args.time:
        print(f"batch: {len(blobs)} images, {total_mp:.2f} MP in "
              f"{dt*1e3:.0f} ms -> {total_mp/dt:.1f} MP/s", file=sys.stderr)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

"""Seeded test and benchmark corpus: photo-like JPEGs made from a seed.

Every image the tests, ``bench.py`` and ``chip_smoke.py`` decode comes from
here, so no run depends on files outside the repository.  The names and
geometries follow the reference corpus recorded in ``BASELINE.md``:

* ``img.jpg`` .. ``img6.jpg``: 4:2:0 DRI=0 baseline photos from 0.1 to
  1.1 MP, plus ``img4.jpg``, 800x400 4:4:4 with DRI=100 (50 restart
  segments);
* ``prograssive-sample.jpg`` (2832x4256) and ``prograssive-sample-2.jpg``
  (427x640): 4:2:0 progressive;
* ``large.jpg`` and ``large-rst.jpg``: 2832x4256 (12 MP) 4:2:0 baseline,
  DRI=0 and one MCU row per restart interval;
* ``square-8mp.jpg``: 2880x2880 (8.3 MP) 4:2:0 baseline, the pixel-stage
  frame.

Content is photo-like rather than white noise, so the entropy-coded density
resembles a real photograph: a sky/ground gradient, smooth colour fields at
two scales, hard-edged shapes and a mild grain.  Baseline frames are coded
by ``tools/encoder.py`` (NumPy only, standard Annex K tables); progressive
frames need Pillow.

Files are cached under ``<repo>/.cache/corpus/<seed>/``.  Each is written to
a unique temporary name and renamed into place, so concurrent test workers
never read a partial file; the output is deterministic, so whichever writer
wins leaves the same bytes.

    python tools/corpus.py [--seed N] [NAME ...]   # build, print paths
"""

from __future__ import annotations

import io
import os
import sys
import tempfile
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

try:
    from .encoder import encode
except ImportError:
    from encoder import encode

CACHE = os.path.join(REPO, ".cache", "corpus")

S420 = ((2, 2), (1, 1), (1, 1))
S444 = ((1, 1), (1, 1), (1, 1))

#: name -> (width, height, samplings, restart_interval, progressive)
SPECS = {
    "img.jpg": (679, 451, S420, 0, False),
    "img2.jpg": (400, 266, S420, 0, False),
    "img3.jpg": (640, 427, S420, 0, False),
    "img4.jpg": (800, 400, S444, 100, False),
    "img5.jpg": (1279, 885, S420, 0, False),
    "img6.jpg": (427, 640, S420, 0, False),
    "prograssive-sample.jpg": (2832, 4256, S420, 0, True),
    "prograssive-sample-2.jpg": (427, 640, S420, 0, True),
    "large.jpg": (2832, 4256, S420, 0, False),
    "large-rst.jpg": (2832, 4256, S420, 2832 // 16, False),
    "square-8mp.jpg": (2880, 2880, S420, 0, False),
}
#: The six baseline shapes, in ``SPECS`` order.
BASELINE = ["img.jpg", "img2.jpg", "img3.jpg", "img4.jpg", "img5.jpg",
            "img6.jpg"]
QUALITY = 85


def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) linear-interpolation weights over a coarse grid."""
    t = np.linspace(0.0, n_in - 1.0, n_out)
    i0 = np.minimum(np.floor(t).astype(np.int64), max(n_in - 2, 0))
    f = (t - i0).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    m[rows, i0] = 1.0 - f
    if n_in > 1:
        m[rows, i0 + 1] += f
    return m


def _smooth(rng, h: int, w: int, gh: int, gw: int, ch: int) -> np.ndarray:
    """(h, w, ch) smooth random field: a (gh, gw) normal grid, upsampled."""
    g = rng.standard_normal((max(gh, 2), max(gw, 2), ch)).astype(np.float32)
    ry = _interp_matrix(h, g.shape[0])
    rx = _interp_matrix(w, g.shape[1])
    return np.stack([ry @ g[..., c] @ rx.T for c in range(ch)], axis=-1)


def photo(width: int, height: int, seed: int) -> np.ndarray:
    """(height, width, 3) uint8 photo-like RGB image, deterministic in seed."""
    rng = np.random.default_rng(seed)
    h, w = height, width
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    # Sky above a horizon, ground below, blended over a soft band.
    sky = rng.uniform(90, 230, 3).astype(np.float32)
    ground = rng.uniform(30, 170, 3).astype(np.float32)
    horizon = rng.uniform(0.3, 0.7)
    mix = np.clip((yy - horizon) / 0.08 + 0.5, 0.0, 1.0)
    img = sky * (1 - mix) + ground * mix
    img = img + 28.0 * _smooth(rng, h, w, 4, 6, 3)
    img = img + 10.0 * _smooth(rng, h, w, h // 48, w // 48, 3)
    # Hard-edged objects: rectangles and ellipses with a shading ramp.
    for _ in range(int(rng.integers(8, 16))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        bh = int(rng.integers(h // 20 + 1, h // 3 + 2))
        bw = int(rng.integers(w // 20 + 1, w // 3 + 2))
        y1, x1 = min(h, y0 + bh), min(w, x0 + bw)
        colour = rng.uniform(0, 255, 3).astype(np.float32)
        ramp = np.linspace(-20, 20, y1 - y0, dtype=np.float32)[:, None, None]
        patch = colour + ramp
        if rng.random() < 0.5:
            cy, cx = (y1 - y0) / 2, (x1 - x0) / 2
            ey = (np.arange(y1 - y0)[:, None] - cy) / max(cy, 1)
            ex = (np.arange(x1 - x0)[None, :] - cx) / max(cx, 1)
            inside = (ey * ey + ex * ex <= 1.0)[..., None]
            img[y0:y1, x0:x1] = np.where(inside, patch, img[y0:y1, x0:x1])
        else:
            img[y0:y1, x0:x1] = patch
    # Grain: luminance noise, box-blurred once so it is not white.
    grain = rng.standard_normal((h + 1, w + 1)).astype(np.float32)
    grain = (grain[:-1, :-1] + grain[1:, :-1] + grain[:-1, 1:]
             + grain[1:, 1:]) * 2.5
    img = img + grain[..., None]
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def _photo_seed(name: str, seed: int) -> int:
    return (zlib.crc32(name.encode()) ^ (seed * 0x9E3779B1)) & 0xFFFFFFFF


def encode_spec(spec, photo_seed: int, quality: int = QUALITY) -> bytes:
    """JPEG bytes for one ``SPECS`` entry from the photo of ``photo_seed``."""
    width, height, samplings, ri, progressive = spec
    rgb = photo(width, height, photo_seed)
    if progressive:
        from PIL import Image

        buf = io.BytesIO()
        sub = 2 if samplings == S420 else 0
        Image.fromarray(rgb).save(buf, "JPEG", quality=quality,
                                  progressive=True, subsampling=sub)
        return buf.getvalue()
    blob, _ = encode(rgb, samplings=samplings, quality=quality,
                     restart_interval=ri)
    return blob


def _cached(rel: str, seed: int, build) -> str:
    path = os.path.join(CACHE, str(seed), rel)
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = build()
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def path(name: str, seed: int = 0) -> str:
    """Path of corpus image ``name`` for ``seed``, built on first use."""
    spec = SPECS[name]
    return _cached(name, seed,
                   lambda: encode_spec(spec, _photo_seed(name, seed)))


def read(name: str, seed: int = 0) -> bytes:
    with open(path(name, seed), "rb") as f:
        return f.read()


def photo_batch(n: int, seed: int = 0) -> list[bytes]:
    """``n`` distinct baseline photos cycling over the six BASELINE shapes
    (photo k has the shape of ``BASELINE[k % 6]``)."""
    out = []
    for k in range(n):
        name = BASELINE[k % len(BASELINE)]
        rel = os.path.join("batch", f"{k:03d}-{name}")
        p = _cached(rel, seed, lambda k=k, name=name: encode_spec(
            SPECS[name], _photo_seed(f"batch{k}", seed)))
        with open(p, "rb") as f:
            out.append(f.read())
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("names", nargs="*", default=sorted(SPECS))
    args = ap.parse_args()
    for nm in args.names:
        print(path(nm, args.seed))

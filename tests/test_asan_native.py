"""AddressSanitizer sweep of the native C++ decoder (slow).

Builds an ASAN-instrumented copy of jpeg_entropy.cpp and drives every C
entry point over the corpus plus randomized corrupted streams in a
subprocess — memory errors abort the subprocess, failing the test.  The
per-block stream-end guards bound all reads to the 256-byte padding, and
this test is what keeps that true as the decoder evolves.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "jpeg_decoder_tpu", "entropy", "native_src",
                   "jpeg_entropy.cpp")

_SWEEP = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from jpeg_decoder_tpu.entropy import native
native._LIB_PATH = {lib!r}
native._compile = lambda: {lib!r}
from jpeg_decoder_tpu.io import parser
from jpeg_decoder_tpu.types import JPEGError

def all_backends(hdr):
    scan = hdr.scans[0]
    native.decode_scan_baseline(hdr, scan)
    native.decode_scan_packed(hdr, scan)
    native.decode_scan_sparse(hdr, scan)
    native.decode_scan_nibble(hdr, scan)
    native.decode_scan_slots(hdr, scan, 16)
    native.decode_scan_subset(hdr, scan)
    native.skeleton_scan_segments(hdr, scan)  # r4: pair-sim counting
    native.emit_prep(hdr, scan)               # r5: one-call lane prep
    if len(scan.seg_offsets) == 2:
        native.decode_scan_speculative(hdr, scan)

def prog_skeletons(hdr):
    # r4 entry points: position-only progressive walks + band bitmaps.
    from jpeg_decoder_tpu.layout import comp_dims_unpadded
    nz = {{}}
    for scan in hdr.scans:
        if len(scan.seg_offsets) != 2:
            continue
        if scan.ss == 0:
            if scan.ah == 0:
                native.prog_skeleton_dc(hdr, scan, 7)
        else:
            ci = scan.comp_indices[0]
            r, c = comp_dims_unpadded(hdr, ci)
            m = nz.setdefault(ci, np.zeros(r * c, np.uint64))
            # want_syms on BOTH kinds: first-pass symbol counts and
            # the r5 refine EVENT counter (ABI 19+) both write out_syms.
            native.prog_skeleton_ac(hdr, scan, 7, m, want_syms=True)

for p in {paths!r}:
    hdr = parser.parse(np.frombuffer(open(p, 'rb').read(), np.uint8))
    if hdr.progressive:
        native.decode_progressive(hdr)
        prog_skeletons(hdr)
    else:
        all_backends(hdr)

# precision-12 skeleton + decode entry points (ABI 20; the wire-format
# decoders are 8-bit-only by design and stay host-gated)
b12 = open({blob12!r}, 'rb').read()
hdr12 = parser.parse(np.frombuffer(b12, np.uint8))
assert hdr12.precision == 12
native.decode_scan_baseline(hdr12, hdr12.scans[0])
native.skeleton_scan_segments(hdr12, hdr12.scans[0])
native.emit_prep(hdr12, hdr12.scans[0])

rng = np.random.default_rng(0)
blob = open({img2!r}, 'rb').read()
pro = open({prog2!r}, 'rb').read()
for trial in range(80):
    b = bytearray(blob if trial % 2 == 0 else pro)
    mode = trial % 3
    if mode == 0:
        b = b[:int(rng.integers(4, len(b)))]
    elif mode == 1:
        for _ in range(int(rng.integers(1, 12))):
            b[int(rng.integers(2, len(b)))] = int(rng.integers(0, 256))
    else:
        at = int(rng.integers(2, len(b) - 10))
        b[at:at + 8] = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
    try:
        hdr = parser.parse(np.frombuffer(bytes(b), np.uint8))
        if hdr.progressive:
            native.decode_progressive(hdr)
            prog_skeletons(hdr)
        else:
            all_backends(hdr)
    except Exception:
        pass
print("ASAN SWEEP OK")
"""


@pytest.mark.slow
def test_native_decoder_asan_sweep(tmp_path):
    libasan = subprocess.run(
        ["g++", "-print-file-name=libasan.so"],
        capture_output=True, text=True, check=True).stdout.strip()
    if not os.path.isabs(libasan):
        pytest.skip("libasan unavailable")
    lib = str(tmp_path / "libjd_asan.so")
    subprocess.run(
        ["g++", "-O1", "-g", "-fsanitize=address", "-shared", "-fPIC",
         "-pthread", "-std=c++17", "-o", lib, SRC],
        check=True, capture_output=True)
    env = dict(os.environ,
               LD_PRELOAD=libasan,
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1")
    from tools.encoder import encode as _encode

    rng = np.random.default_rng(2)
    img12 = np.kron(rng.integers(0, 4095, (6, 8, 3)),
                    np.ones((8, 8, 1)))[:44, :60].astype(np.uint16)
    b12, _ = _encode(img12, samplings=((2, 2), (1, 1), (1, 1)),
                     precision=12, restart_interval=2)
    blob12 = str(tmp_path / "p12.jpg")
    open(blob12, "wb").write(b12)
    from conftest import CORPUS, PROGRESSIVE_CORPUS, corpus_path

    paths = [corpus_path(n) for n in CORPUS + PROGRESSIVE_CORPUS]
    sweep = _SWEEP.format(repo=REPO, lib=lib, blob12=blob12, paths=paths,
                            img2=corpus_path("img2.jpg"),
                            prog2=corpus_path("prograssive-sample-2.jpg"))
    r = subprocess.run([sys.executable, "-c", sweep], env=env,
                       capture_output=True, text=True, timeout=420)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "ASAN SWEEP OK" in r.stdout

#!/usr/bin/env python
"""Event-count analysis for the emission AC-refine kernel design.

Runs the extended native skeleton (stride=1, want_syms) over every AC
scan of a progressive image and reports, per refine scan:

  * total emission events and the per-lane distribution under
    (a) uniform-stride lanes (today's boundaries) and
    (b) event-balanced lane boundaries,
  * the window-barrier trip count T_W = sum over W-aligned windows of
    max-over-lanes in-window events, for candidate commit widths W
    (the serial trip count the windowed emission kernel would execute),
  * the lockstep kernel's trip proxy: sum over block slots of
    max-over-lanes per-block events (what the current kernel pays).

Usage: python tools/prog_refine_events.py [image] [--lanes 512]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def lane_sums(ev: np.ndarray, edges: np.ndarray) -> np.ndarray:
    cum = np.concatenate([[0], np.cumsum(ev.astype(np.int64))])
    return cum[edges[1:]] - cum[edges[:-1]]


def window_T(ev: np.ndarray, edges: np.ndarray, W: int) -> int:
    """Serial trips of the windowed kernel: lanes advance event-by-event
    through W-block windows; a window commits when every lane passed it."""
    n_l = np.diff(edges)
    max_b = int(n_l.max())
    total = 0
    cum = np.concatenate([[0], np.cumsum(ev.astype(np.int64))])
    for w0 in range(0, max_b, W):
        lo = np.minimum(edges[:-1] + w0, edges[1:])
        hi = np.minimum(edges[:-1] + w0 + W, edges[1:])
        total += int((cum[hi] - cum[lo]).max())
    return total


def balanced_edges(ev: np.ndarray, S: int) -> np.ndarray:
    """Lane boundaries that equalize per-lane event sums (block
    granularity).  Every lane gets >= 0 blocks; edges are monotone."""
    n = len(ev)
    cum = np.cumsum(ev.astype(np.int64))
    total = int(cum[-1]) if n else 0
    tgt = (np.arange(1, S, dtype=np.int64) * total) // S
    inner = np.searchsorted(cum, tgt, side="left")
    edges = np.concatenate([[0], inner, [n]])
    return np.maximum.accumulate(edges)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None,
                    help="progressive JPEG (default: the seeded corpus's "
                         "12 MP progressive frame)")
    ap.add_argument("--lanes", type=int, default=512)
    args = ap.parse_args()
    if args.image is None:
        from tools import corpus

        args.image = corpus.path("prograssive-sample.jpg")

    from jpeg_decoder_tpu.io import parser
    from jpeg_decoder_tpu.entropy import native
    from jpeg_decoder_tpu.layout import comp_dims_unpadded

    hdr = parser.parse(open(args.image, "rb").read())
    S = args.lanes
    nzmaps: dict[int, np.ndarray] = {}
    for si, scan in enumerate(hdr.scans):
        if scan.ss == 0:
            continue
        ci = scan.comp_indices[0]
        r, c = comp_dims_unpadded(hdr, ci)
        n_blocks = r * c
        nzmap = nzmaps.setdefault(ci, np.zeros(n_blocks, np.uint64))
        bits, eob, ev = native.prog_skeleton_ac(
            hdr, scan, 1, nzmap, want_syms=True)
        kind = "ac-first" if scan.ah == 0 else "ac-refine"
        stride = max(1, -(-n_blocks // S))
        edges_u = np.arange(0, n_blocks + stride, stride)
        edges_u[-1] = n_blocks
        edges_u = edges_u[: 1 + -(-n_blocks // stride)]
        sums_u = lane_sums(ev, edges_u)
        edges_b = balanced_edges(ev, len(edges_u) - 1)
        sums_b = lane_sums(ev, edges_b)
        # lockstep proxy: slot-aligned max over lanes per block slot
        n_l = np.diff(edges_u)
        max_b = int(n_l.max())
        slot_ev = np.zeros((len(n_l), max_b), np.int64)
        for i in range(len(n_l)):
            slot_ev[i, : n_l[i]] = ev[edges_u[i]: edges_u[i + 1]]
        lockstep = int(slot_ev.max(axis=0).sum())
        print(f"scan {si:2d} {kind:9s} comp[{ci}] blocks={n_blocks} "
              f"total_ev={int(ev.sum())}")
        print(f"   uniform : max={sums_u.max()} mean={sums_u.mean():.0f}")
        print(f"   balanced: max={sums_b.max()} mean={sums_b.mean():.0f}")
        ws = {W: window_T(ev, edges_b, W) for W in (4, 8, 16, 32, 64)}
        print(f"   lockstep-proxy={lockstep}  windowT(balanced) " +
              "  ".join(f"W{W}={T}" for W, T in ws.items()))


if __name__ == "__main__":
    main()

"""Out-of-core scale benchmark: host-resident probe side streamed through
one device (BASELINE config-5 scale on a single device; engine/stream.py).

Workload: 16M-row device-resident build side (reference generator), probe
side synthesized host-side as uniform picks FROM the build keys so the
exact join cardinality is the probe count (unique build keys: every hit
matches exactly once) at any scale without an O(n log n) host shuffle.

The report carries the host-to-device gigabytes moved, so the
transfer share of the wall time can be read off.

Usage: python scripts/bench_stream.py [--outer 1000000000]
       [--inner 16000000] [--chunk 64000000] [--spill-dir DIR] [--miss F]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outer", type=int, default=1_000_000_000)
    ap.add_argument("--inner", type=int, default=16_000_000)
    ap.add_argument("--chunk", type=int, default=64_000_000)
    ap.add_argument("--spill-dir", default=None)
    ap.add_argument("--miss", type=float, default=0.0,
                    help="fraction of probe rows that miss (random keys)")
    args = ap.parse_args()

    from hash_join_codes_knl_tpu.engine.stream import stream_join
    from hash_join_codes_knl_tpu.relgen.generate import generate

    inner, _, _ = generate(seed=42, inner_tuples=args.inner,
                           outer_tuples=args.inner, mode="ref")
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    idx = rng.integers(0, args.inner, args.outer, dtype=np.uint32)
    ok = inner.keys[idx]
    del idx
    want = args.outer
    if args.miss > 0:
        nm = int(args.miss * args.outer)
        # a random u32 still hits ~inner/2^32 of the time (the build
        # keys are uniform over the whole nonzero range -- no bit mask
        # makes misses certain), so the EXACT expected count is computed
        # by membership against the sorted build keys and validation
        # stays ON for miss runs
        ok[:nm] = rng.integers(1, 2**32, nm, dtype=np.uint32)
        sk = np.sort(inner.keys)
        pos = np.searchsorted(sk, ok[:nm])
        pos[pos == len(sk)] = 0
        want = (args.outer - nm) + int((sk[pos] == ok[:nm]).sum())
        del sk, pos
    ov = ok * np.uint32(0x85EBCA77)
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    sres = stream_join(inner.keys, inner.vals, ok, ov,
                       chunk_rows=args.chunk, spill_dir=args.spill_dir)
    dt = time.perf_counter() - t0
    ok_card = sres.join_tuples == want
    h2d_gb = args.outer * 8 / 1e9
    out = {
        "metric": f"stream_join_{args.inner//10**6}Mx{args.outer//10**6}M",
        "value": round(args.outer / dt, 1),
        "unit": "probe-tuples/s/chip",
        "seconds": round(dt, 2),
        "join_tuples": sres.join_tuples,
        "cardinality_exact": ok_card,
        "chunks": len(sres.chunks),
        "chunk_rows": args.chunk,
        "h2d_gb": round(h2d_gb, 2),
        "resumed_chunks": sres.resumed_chunks,
        "hostgen_s": round(gen_s, 2),
        "spill": bool(args.spill_dir),
    }
    print(json.dumps(out))
    return 0 if ok_card else 1


if __name__ == "__main__":
    sys.exit(main())

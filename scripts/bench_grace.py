"""Out-of-core BUILD-side scale benchmark: Grace join on one device
(engine/grace.py) with NEITHER relation device-resident.

Workload: build side synthesized host-side as distinct u32 keys (the
scale axis is the partitioner, not generator semantics -- relgen parity
is proven elsewhere); probe side uniform picks FROM the build keys so
the exact join cardinality equals the probe count at any scale.

Default shape: 256M-row build x 1B-row probe.  The report carries the
transferred-GB figure so the transfer share of the wall time can be
read off.

Usage: python scripts/bench_grace.py [--build 256000000]
       [--probe 1000000000] [--f-bits 6] [--chunk 48000000]
       [--spill-dir DIR]

Default spill dir is a FRESH temp dir (removed afterwards): a reused
dir would resume the phase-1 spills and phase-2 journal and "measure"
seconds of checksum reads as if it joined 1B rows.  Pass --spill-dir
to study resume behavior; the report carries reused_sides /
resumed_partitions either way so a resumed run is never mistaken for
a measurement.
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
    ap.add_argument("--build", type=int, default=256_000_000)
    ap.add_argument("--probe", type=int, default=1_000_000_000)
    ap.add_argument("--f-bits", type=int, default=6)
    ap.add_argument("--chunk", type=int, default=48_000_000)
    ap.add_argument("--spill-dir", default=None)
    args = ap.parse_args()
    cleanup = None
    if args.spill_dir is None:
        import shutil
        import tempfile

        args.spill_dir = tempfile.mkdtemp(prefix="grace_bench_")
        cleanup = lambda: shutil.rmtree(args.spill_dir, ignore_errors=True)

    from hash_join_codes_knl_tpu.engine.grace import grace_join

    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    # distinct nonzero build keys: oversample, unique, trim
    draw = int(args.build * 1.12)
    ik = np.unique(rng.integers(1, 2**32, draw, dtype=np.uint32))
    assert len(ik) >= args.build, "raise the oversample factor"
    ik = rng.permutation(ik)[: args.build]
    iv = ik * np.uint32(0x9E3779B1)
    idx = rng.integers(0, args.build, args.probe, dtype=np.uint32)
    ok = ik[idx]
    del idx
    ov = ok * np.uint32(0x85EBCA77)
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    try:
        gres = grace_join(ik, iv, ok, ov, f_bits=args.f_bits,
                          chunk_rows=args.chunk,
                          spill_dir=args.spill_dir)
    finally:
        dt = time.perf_counter() - t0
        if cleanup:
            cleanup()
    ok_card = gres.join_tuples == args.probe
    out = {
        "metric": f"grace_join_{args.build//10**6}Mx{args.probe//10**6}M",
        "value": round(args.probe / dt, 1),
        "unit": "probe-tuples/s/chip",
        "seconds": round(dt, 2),
        "join_tuples": gres.join_tuples,
        "cardinality_exact": ok_card,
        "partitions": 1 << gres.f_bits,
        "max_build_partition": max(m.build_rows for m in gres.partitions),
        "max_probe_partition": max(m.probe_rows for m in gres.partitions),
        "transfer_gb": round((args.build + args.probe) * 8 * 2.2 / 1e9, 1),
        "hostgen_s": round(gen_s, 2),
        "reused_sides": gres.reused_sides,
        "resumed_partitions": gres.resumed_partitions,
    }
    print(json.dumps(out))
    return 0 if ok_card else 1


if __name__ == "__main__":
    sys.exit(main())

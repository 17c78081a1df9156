"""Headline benchmark: PHJ join throughput on the BASELINE workload.

Workload: 16M build x 256M probe uniform u32 relations from the reference
generator semantics (BASELINE.json config matrix).  Metric: probe tuples per
second on one GPU, steady state (after compilation, median of timed runs
that each end in block_until_ready).  vs_baseline compares against the
reference suite's best published number: PHJ at ~4.4 s on 200M x 200M on a
64-core KNL in cache mode == ~45.45M probe-tuples/s aggregate (README.md:17,
figures/perf.png; BASELINE.md).

Prints exactly one JSON line, naming the device and the card's power limit;
fails when JAX finds no GPU.  Scale can be overridden with
HJK_BENCH_INNER/HJK_BENCH_OUTER (tuple counts) for smoke runs.
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_TUPLES_PER_S = 200_000_000 / 4.4  # reference best (PHJ, KNL cache)


def main():
    inner_n = int(os.environ.get("HJK_BENCH_INNER", 16_000_000))
    outer_n = int(os.environ.get("HJK_BENCH_OUTER", 256_000_000))
    reps = int(os.environ.get("HJK_BENCH_REPS", 5))

    import jax

    from hash_join_codes_knl_tpu.engine.config import plan_join
    from hash_join_codes_knl_tpu.engine.phj import phj_join
    from hash_join_codes_knl_tpu.relation import expected_join_tuples
    from hash_join_codes_knl_tpu.relgen.generate import generate
    from hash_join_codes_knl_tpu.utils.device import (
        card_line,
        device_record,
        require_gpu,
        use_compile_cache,
    )
    from hash_join_codes_knl_tpu.utils.roofline import hbm_peak_bytes_per_s

    use_compile_cache()
    require_gpu()
    card = card_line()
    mode = "ref" if outer_n <= inner_n else "uniform"
    inner, outer, _ = generate(
        seed=42, inner_tuples=inner_n, outer_tuples=outer_n, mode=mode
    )
    plan = plan_join(inner_n, outer_n)
    args = tuple(jax.device_put(a) for a in
                 (inner.keys, inner.vals, outer.keys, outer.vals))

    def run():
        return jax.block_until_ready(phj_join(*args, plan))

    got = int(run().join_tuples)  # compile + warm
    want = expected_join_tuples(inner_n, outer_n) % (1 << 32)
    record = {
        "metric": f"phj_join_throughput_{inner_n//10**6}Mx{outer_n//10**6}M",
        "unit": "probe-tuples/s/gpu",
        "device": device_record(),
        "card": card,
    }
    if got != want:
        print(json.dumps({**record, "value": 0.0, "vs_baseline": 0.0,
                          "error": f"wrong cardinality: got {got} "
                                   f"want {want}"}))
        sys.exit(1)

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    rate = outer_n / dt
    # the bytes any implementation of the whole join must move at least
    # once (read both relations, write the aligned output) over the
    # card's peak memory bandwidth
    floor_bytes = 8 * (inner_n + outer_n) + 16 * outer_n
    pct_floor = 100 * floor_bytes / dt / hbm_peak_bytes_per_s()
    print(json.dumps({
        **record,
        "value": rate,
        "vs_baseline": rate / BASELINE_TUPLES_PER_S,
        "seconds": dt,
        "runs_s": times,
        "join_tuples": got,
        "pct_hbm_stream_floor": pct_floor,
        "plan": {"tile": plan.tile, "probe_chunks": plan.probe_chunks,
                 "p_bits": plan.p_bits},
    }))


if __name__ == "__main__":
    main()

"""Weak-scaling efficiency runs (BASELINE: >=70% at 1 chip -> N).

Scales the CPRA distributed join over 1..N devices with a FIXED per-chip
workload (weak scaling): on an M-device mesh the relations are M x the
single-chip sizes, so perfect scaling keeps seconds flat and efficiency =
t(1) / t(M).

--cpu runs the harness on the virtual 8-device CPU mesh (validates the
sharding + the math, not the silicon); on a multi-GPU host, run it as-is.

CPU-mesh note: the physical cores SERIALIZE the m virtual devices once
m exceeds them, so raw t(1)/t(m) trends to cores/m by construction.
The honest CPU-mesh metric is the serialization-corrected efficiency
(m / min(m, cores)) * t(1) / t(m) -- the sharding/collective overhead
factor (exactly what the code computes) -- reported alongside.  Per-chip
sizes stay small enough that no single collective straggles past XLA's
40 s CPU rendezvous hard timeout (one core running m device threads
staggers their arrival).

Writes scaling_results.json and prints one line per mesh size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force the 8-virtual-device CPU mesh")
    ap.add_argument("--inner", type=int, default=None,
                    help="per-chip build tuples (default 200K; 50K on --cpu)")
    ap.add_argument("--outer", type=int, default=None,
                    help="per-chip probe tuples (default 1.6M; 400K on --cpu)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="scaling_results.json")
    args = ap.parse_args()
    if args.inner is None:
        args.inner = 50_000 if args.cpu else 200_000
    if args.outer is None:
        args.outer = 400_000 if args.cpu else 1_600_000

    if args.cpu:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hash_join_codes_knl_tpu.engine.config import plan_join
    from hash_join_codes_knl_tpu.parallel.cpra import (
        make_cpra_step,
        make_cpra_steps_staged,
    )
    from hash_join_codes_knl_tpu.parallel.distributed import data_mesh
    from hash_join_codes_knl_tpu.relgen.generate import generate
    from hash_join_codes_knl_tpu.utils.timing import PhaseTimer

    n_dev = len(jax.devices())
    cores = os.cpu_count() or 1
    sizes = [m for m in (1, 2, 4, 8, 16, 32) if m <= n_dev]
    results = {}
    t1 = None
    for m in sizes:
        I, O = args.inner * m, args.outer * m
        inner, outer, _ = generate(seed=42, inner_tuples=I, outer_tuples=O,
                                   mode="uniform" if O > I else "ref")
        mesh = data_mesh(m)
        plan = plan_join(args.inner, args.outer)
        inner_cap = max(64, int(4 * I / (m * m)))
        outer_cap = max(plan.tile, int(4 * O / (m * m)))
        step = make_cpra_step(mesh, plan, inner_cap, outer_cap)
        sh = NamedSharding(mesh, P("x"))
        # device_put the NUMPY array directly: jnp.asarray first
        # commits it whole to device 0 and re-shards, doubling
        # the host-link transfer (and requiring one chip to fit it)
        dev = lambda x: jax.device_put(np.asarray(x), sh)
        ik, iv = dev(inner.keys), dev(inner.vals)
        ok, ov = dev(outer.keys), dev(outer.vals)

        def run(r):
            res, _, diag = step(ik, iv, ok, ov ^ jnp.uint32(r))
            assert int(diag[0]) == 0, "exchange overflow"
            assert int(diag[1]) == 0, "local join overflow"
            return int(np.asarray(res.join_tuples).sum())

        jt = run(0)
        ts = []
        for r in range(1, args.reps + 1):
            t0 = time.perf_counter()
            run(r)
            ts.append(time.perf_counter() - t0)
        sec = float(np.median(ts))
        # per-stage device metering (exchange vs local join, the
        # cpra2.cpp:1895-1905 copy-time split): a future real-slice run
        # needs the STAGE ratio to interpret total-efficiency numbers
        # -- exchange grows with the mesh (all_to_all) while the local
        # join should stay flat under weak scaling.  One staged pass
        # per mesh size; wall-time totals above stay the fused program.
        exch_fn, join_fn = make_cpra_steps_staged(
            mesh, plan, inner_cap, outer_cap)
        stage_meds = {"exchange": [], "local_join": []}
        for r in range(args.reps):
            timer = PhaseTimer()
            ex = timer.run("exchange", exch_fn, ik, iv, ok,
                           ov ^ jnp.uint32(100 + r))
            assert not bool(np.asarray(ex[-1]).reshape(-1)[0]), \
                "exchange overflow"
            timer.run("local_join", join_fn, *ex[:4])
            if r == 0:
                continue  # compile + warm
            for k in stage_meds:
                stage_meds[k].append(timer.phases[k])
        stages = {k: round(float(np.median(v)), 4) if v else None
                  for k, v in stage_meds.items()}
        if t1 is None:
            t1 = sec
        eff = t1 / sec
        # virtual devices beyond the host's cores time-slice: perfect
        # weak scaling there costs t1 * m/cores wall, not t1.  With
        # m <= cores the devices run in parallel and NO correction
        # applies (multiplying by m would saturate the clamp and hide
        # every real overhead).
        eff_corr = min(1.0, (m / min(m, cores)) * t1 / sec)
        results[str(m)] = {
            "devices": m,
            "outer_tuples": O,
            "seconds": round(sec, 4),
            "rows_per_s": round(O / sec, 1),
            "weak_scaling_efficiency": round(eff, 4),
            "serialization_corrected_efficiency": round(eff_corr, 4),
            "join_tuples": jt,
            "stage_seconds": stages,
        }
        print(f"mesh={m:3d}  {sec:8.4f}s  {O/sec/1e6:8.2f} M rows/s  "
              f"eff={eff:.2%}  corrected={eff_corr:.2%}", flush=True)

    if n_dev > cores:
        results["_note"] = (
            f"CPU-mesh weak scaling with {n_dev} virtual devices on "
            f"{cores} host core(s): m>{cores} devices time-slice, so raw "
            "efficiency is bounded by cores/m; serialization_corrected_"
            "efficiency multiplies by m/min(m, cores) to remove exactly "
            "that bound (no correction while m <= cores). Figures at "
            "heavy oversubscription are thrash-dominated, not the "
            "algorithm. chip_smoke.py --four runs the mesh on four GPUs.")
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

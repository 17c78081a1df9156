"""CLI drivers, argv-compatible with the reference binaries (L5).

    python -m hash_join_codes_knl_tpu.cli write <threads> <outer> <inner> [selc] [zipf]
    python -m hash_join_codes_knl_tpu.cli npj   <threads> <outer> <inner> [ratio]
    python -m hash_join_codes_knl_tpu.cli phj   <threads> <outer> <inner> [ratio]
    python -m hash_join_codes_knl_tpu.cli cpra  <threads> <outer> <inner>

Positional argv mirrors the reference mains (npj.cpp:932-935,
phj.cpp:1962-1965, write.cpp:1680-1686).  <threads> maps to the number of
mesh devices for cpra and npj (power of two; 1 = single chip; npj with
threads > 1 runs the replicated-shared-table mode, parallel/npj_dist.py).
<ratio> (the DDR/MCDRAM placement knob, npj.cpp:195, phj.cpp:101-116): a
single device has one memory tier, so for single-device runs it is
accepted for compatibility; for cpra on a multi-chip mesh it drives the
two-level tier hash that splits traffic between the two mesh halves
(utils/hashing.py hash_ratio).  Extra flags: --seed N --dir PATH --json.

write generates ik_/iv_/ok_/ov_<N>.txt; the join drivers load those files
(falling back to in-memory generation when absent), run the pipeline, verify
cardinality against the analytic formula where it is exact, and print phase
times + throughput.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _load_or_generate(args):
    """Returns (inner, outer, generated).  Only MISSING files fall back
    to in-memory generation; a truncated/corrupt file raises (silently
    regenerating would run the benchmark on different data than the
    user's files -- never-silent convention)."""
    from .relation import load_relation
    from .relgen.generate import generate

    try:
        inner = load_relation("inner", args.inner, args.dir)
        outer = load_relation("outer", args.outer, args.dir)
        return inner, outer, False
    except FileNotFoundError:
        mode = "ref" if args.outer <= args.inner else "uniform"
        inner, outer, _ = generate(
            args.seed, args.inner, args.outer, mode=mode
        )
        return inner, outer, True


def _mesh_devices(threads: int) -> int:
    """argv <threads> -> mesh device count: clamped to the attached
    devices and floored to a power of two (the collectives' contract);
    threads <= 0 degenerates to 1."""
    import jax

    n = max(1, min(threads, len(jax.devices())))
    return 1 << (n.bit_length() - 1)


def _expected_tuples(args, generated: bool):
    """Analytic expected join cardinality (npj.cpp:937-942), or None
    when the expectation is not exact: outer > inner (stochastic
    uniform outer walk), or on-disk relations whose selectivity is
    unknown (pass --selc to assert it)."""
    from .relation import expected_join_tuples

    if args.outer > args.inner:
        return None
    selc = 1.0 if generated else args.selc
    if selc is None:
        return None
    return expected_join_tuples(args.inner, args.outer, selc)


def _finish(args, alg, timer, profiling, generated, join_tuples,
            extras=None):
    """Shared epilogue: cardinality gate, profiler close, report.
    Returns the process exit code."""
    profiling.close()
    expect = _expected_tuples(args, generated)
    if expect is not None and join_tuples != expect:
        print(f"CARDINALITY MISMATCH: got {join_tuples} want {expect}",
              file=sys.stderr)
        return 1
    _report(alg, timer, args.outer, join_tuples, args.json, extras)
    return 0


def _report(alg, timer, outer_n, join_tuples, as_json, roofline=None):
    metrics = timer.metrics(
        algorithm=alg,
        outer_tuples=outer_n,
        join_tuples=join_tuples,
        tuples_per_s=round(outer_n / max(timer.total, 1e-9), 1),
    )
    if roofline:
        metrics.update(roofline)
    if as_json:
        print(json.dumps(metrics))
    else:
        for k, v in metrics.items():
            print(f"{k:>16}: {v}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="hash_join_codes_knl_tpu")
    p.add_argument("algorithm", choices=["write", "npj", "phj", "cpra"])
    p.add_argument("threads", type=int, nargs="?", default=1)
    p.add_argument("outer", type=int, nargs="?", default=200_000_000)
    p.add_argument("inner", type=int, nargs="?", default=200_000_000)
    p.add_argument("arg4", type=float, nargs="?", default=None,
                   help="ratio (joins) or selc (write)")
    p.add_argument("zipf", type=float, nargs="?", default=0.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--selc", type=float, default=None,
                   help="join selectivity of the ON-DISK relations (the "
                        "selc they were written with); enables the exact "
                        "cardinality check for file-loaded data (in-"
                        "memory generated data is always checked)")
    p.add_argument("--dir", default=".")
    p.add_argument("--json", action="store_true")
    p.add_argument("--timelog", action="store_true",
                   help="per-phase breakdown (TIMELOG analog, hj.h:69-70) "
                        "+ roofline fractions; phj runs staged jits")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of the run to DIR "
                        "(view with tensorboard/xprof)")
    p.add_argument("--chunks", type=int, default=0,
                   help="cpra: split the probe side into N chunks and "
                        "pipeline exchange with probe compute "
                        "(make_cpra_step_pipelined)")
    p.add_argument("--stream-chunk-rows", type=int, default=0,
                   help="phj: out-of-core mode -- keep the probe side in "
                        "host RAM and stream it through the device in "
                        "chunks of this many rows (engine/stream.py); "
                        "the build side stays device-resident")
    p.add_argument("--grace-bits", type=int, default=0,
                   help="phj: Grace mode -- NEITHER relation needs to "
                        "fit the device: one 2^N-way out-of-core radix "
                        "pass spills both relations to host partition "
                        "files, then per-partition merge joins stream "
                        "through the device (engine/grace.py; needs "
                        "--spill-dir; "
                        "--stream-chunk-rows sets the partition-pass "
                        "chunk size; threads > 1 runs the distributed "
                        "pass + partition-parallel joins over a mesh, "
                        "parallel/grace_dist.py)")
    p.add_argument("--spill-dir", default=None,
                   help="with --stream-chunk-rows: spill per-chunk "
                        "results + checkpoints here; a re-run resumes "
                        "from the last completed chunk")
    p.add_argument("--check", action="store_true",
                   help="phj: run the BG-debug-mode analog after the "
                        "join (oracle-free invariant re-checks: key "
                        "conservation checksums, pad hygiene, order "
                        "monotonicity; phj.cpp:1034-1041,1214-1229)")
    p.add_argument("--sorted-order", action="store_true",
                   help="npj: return/count results in home-bucket-"
                        "sorted order (the PHJ merge contract; "
                        "engine/npj.py order='sorted')")
    p.add_argument("--aggregate", action="store_true",
                   help="phj: hash-aggregate the join output (group "
                        "matched rows by probe key, sum matched build "
                        "values) and print group count + sum checksum "
                        "-- the BASELINE aggregate-on-join-output "
                        "operator as a driver stage")
    p.add_argument("--config", metavar="FILE", default=None,
                   help="JSON file of JoinPlan fields (p_bits, slots, "
                        "tile, probe_chunks, pass_bits, unique_build, "
                        "partition_impl, probe_impl, factor) -- the "
                        "runtime form of the reference's compile-time "
                        "-D knobs (makefile:1-4)")
    args = p.parse_args(argv)

    if args.algorithm == "write":
        from .relgen.generate import generate_to_dir

        selc = 1.0 if args.arg4 is None else args.arg4
        mode = (
            "zipf" if args.zipf > 0
            else ("ref" if args.outer <= args.inner else "uniform")
        )
        meta = generate_to_dir(
            args.dir, args.seed, args.inner, args.outer,
            selc=selc, zipf=args.zipf, mode=mode,
        )
        print(json.dumps({k: v for k, v in meta.items() if k != "factors"}))
        return 0

    import contextlib

    import jax.numpy as jnp

    from .utils.device import use_compile_cache
    from .utils.timing import PhaseTimer

    use_compile_cache()

    # flag-combination validation up front: a requested stage that a
    # mode cannot run must ERROR, never silently skip (the --aggregate/
    # --check epilogue lives on the in-memory phj path only, and
    # --sorted-order on the single-chip npj driver only)
    if (args.check or args.aggregate) and args.algorithm == "phj" and (
        args.stream_chunk_rows > 0 or args.grace_bits > 0
    ):
        print("--check/--aggregate are not supported with "
              "--stream-chunk-rows/--grace-bits (per-chunk results "
              "stream through spill files; aggregate the spilled "
              "columns instead)", file=sys.stderr)
        return 2
    if args.sorted_order and (args.algorithm != "npj" or args.threads > 1):
        print("--sorted-order applies to the single-chip npj driver "
              "only", file=sys.stderr)
        return 2

    profiling = contextlib.ExitStack()
    if args.profile:
        import jax

        profiling.enter_context(jax.profiler.trace(args.profile))

    inner, outer, generated = _load_or_generate(args)
    timer = PhaseTimer()
    if args.algorithm == "phj" and args.grace_bits > 0:
        # Grace mode: both relations host-resident, partitioned out of
        # core, joined per partition (engine/grace.py)
        from .engine.grace import grace_join

        if not args.spill_dir:
            print("--grace-bits needs --spill-dir", file=sys.stderr)
            return 1
        if args.threads > 1:
            # <threads> mesh devices: distributed radix pass + owner
            # all_to_all, partition-parallel joins (parallel/grace_dist)
            from .parallel.distributed import data_mesh
            from .parallel.grace_dist import grace_join_dist

            n_dev = _mesh_devices(args.threads)
            gres = timer.run(
                "grace_join", grace_join_dist, inner.keys, inner.vals,
                outer.keys, outer.vals, data_mesh(n_dev),
                f_bits=args.grace_bits,
                chunk_rows=max(
                    128, (args.stream_chunk_rows or 32_000_000) // n_dev
                ),
                spill_dir=args.spill_dir,
            )
        else:
            gres = timer.run(
                "grace_join", grace_join, inner.keys, inner.vals,
                outer.keys, outer.vals, f_bits=args.grace_bits,
                chunk_rows=args.stream_chunk_rows or 32_000_000,
                spill_dir=args.spill_dir,
            )
        return _finish(
            args, "phj-grace", timer, profiling, generated,
            gres.join_tuples,
            {"partitions": 1 << gres.f_bits,
             "max_build_partition": max(
                 (m.build_rows for m in gres.partitions), default=0),
             "max_probe_partition": max(
                 (m.probe_rows for m in gres.partitions), default=0)})
    if args.algorithm == "phj" and args.stream_chunk_rows > 0:
        # out-of-core: BOTH relations stay host-side here -- the
        # streaming driver uploads the build side itself and streams
        # the probe side chunk by chunk (engine/stream.py)
        from .engine.stream import stream_join

        sres = timer.run(
            "stream_join", stream_join, inner.keys, inner.vals,
            outer.keys, outer.vals, args.stream_chunk_rows,
            spill_dir=args.spill_dir,
        )
        return _finish(
            args, "phj-stream", timer, profiling, generated,
            sres.join_tuples,
            {"chunks": len(sres.chunks),
             "resumed_chunks": sres.resumed_chunks,
             "chunk_rows": args.stream_chunk_rows})

    if args.algorithm == "npj":
        if args.threads > 1:
            from .engine.npj import plan_npj
            from .parallel.distributed import data_mesh
            from .parallel.npj_dist import npj_join_dist

            # host arrays go straight in: the distributed driver uploads
            # with its own mesh sharding
            mesh = data_mesh(_mesh_devices(args.threads))
            _, _, join_tuples, _ = timer.run(
                "build+probe", npj_join_dist, inner.keys, inner.vals,
                outer.keys, outer.vals, mesh, plan_npj(len(inner.keys)),
            )
        else:
            from .engine.npj import npj_probe_sorted, npj_runs, plan_npj

            ik = timer.run("load_device", jnp.asarray, inner.keys)
            iv = jnp.asarray(inner.vals)
            ok = jnp.asarray(outer.keys)
            plan = plan_npj(len(ik))
            runs = timer.run("build", npj_runs, ik, iv, plan)
            if args.sorted_order:
                # output stays in home-bucket-sorted order (the PHJ
                # merge contract)
                ov = jnp.asarray(outer.vals)
                _, _, mv, mc = timer.run(
                    "probe", npj_probe_sorted, runs, ok, plan,
                    probe_vals=ov, order="sorted",
                )
            else:
                mv, mc = timer.run("probe", npj_probe_sorted, runs, ok,
                                   plan)
            join_tuples = int(np.asarray(mc, dtype=np.int64).sum())
    elif args.algorithm == "phj":
        from .engine.config import plan_join
        from .engine.phj import join as phj_engine_join
        from .engine.phj import phj_join_merge_staged

        ik = timer.run("load_device", jnp.asarray, inner.keys)
        iv = jnp.asarray(inner.vals)
        ok, ov = jnp.asarray(outer.keys), jnp.asarray(outer.vals)
        plan = plan_join(len(ik), len(ok))
        if args.config:
            import dataclasses

            with open(args.config) as f:
                overrides = json.load(f)
            if "pass_bits" in overrides:
                overrides["pass_bits"] = tuple(overrides["pass_bits"])
            plan = dataclasses.replace(plan, **overrides)
        if args.timelog and plan.probe_impl == "merge":
            res = phj_join_merge_staged(ik, iv, ok, ov, plan, timer)
            if int(np.asarray(res.build_counts)[2]) != 0:
                # the staged path runs the plan as given, so a wrong
                # unique_build declaration is reported, not re-planned
                print("PLAN-OPT VIOLATION (unique_build): re-run without "
                      "--timelog (auto downgrade) or drop the flag via "
                      "--config", file=sys.stderr)
                return 1
        else:
            # engine.phj.join downgrades a wrong unique_build and raises
            # on padded/radix overflow (never silent) -- map that to
            # exit 1
            try:
                res, plan = timer.run("partition+build+probe",
                                      phj_engine_join, ik, iv, ok, ov,
                                      plan)
            except RuntimeError as e:
                print(f"OVERFLOW: {e}; adjust --config", file=sys.stderr)
                return 1
        join_tuples = int(res.join_tuples)
        if args.check:
            from .engine.validate import validate_join_result

            stats = timer.run("check", validate_join_result, res,
                              outer.keys, plan)
            print(f"CHECK OK: {stats}", file=sys.stderr)
        if args.aggregate:
            # hash aggregate over the join output (the BASELINE
            # operator on config-5 pipelines): group matched rows by
            # probe key, sum matched build values.  Single-level
            # engine: join-output group counts approach the row count,
            # where the chunked two-level path cannot shrink partials
            # (ops/aggregate.py hash_aggregate_chunked is the
            # low-cardinality form).
            from .ops.aggregate import (
                aggregate_join_result,
                aggregate_join_result_expanded,
            )

            try:
                ng, _gk, gsum, _gc = timer.run(
                    "aggregate", aggregate_join_result, res
                )
            except ValueError:
                # M:N join output (duplicate build keys): the aligned
                # layout can't aggregate directly -- stream expand_join
                # blocks into device-side partials instead (r5; no host
                # round-trip of the expansion)
                ng, _gk, gsum, _gc = timer.run(
                    "aggregate", aggregate_join_result_expanded, res,
                    ik, iv,
                )
            g = int(ng)
            csum = int(np.asarray(gsum)[:g].astype(np.uint64).sum())
            print(f"AGGREGATE: {g} groups, sum-checksum {csum}",
                  file=sys.stderr)
    else:  # cpra
        import jax

        from .engine.config import plan_join
        from .parallel.cpra import cpra_join
        from .parallel.distributed import data_mesh

        # host arrays go straight to the cpra drivers: they device_put
        # with their own mesh sharding
        ni, no = len(inner.keys), len(outer.keys)
        n_dev = _mesh_devices(args.threads)
        mesh = data_mesh(n_dev)
        if args.chunks > 1 and n_dev > 1:
            from jax.sharding import NamedSharding, PartitionSpec
            from .parallel.cpra import make_cpra_step_pipelined

            plan = plan_join(ni // n_dev, no // n_dev)
            step = make_cpra_step_pipelined(
                mesh, plan,
                inner_cap=max(64, 4 * ni // (n_dev * n_dev)),
                outer_cap=max(plan.tile * args.chunks,
                              4 * no // (n_dev * n_dev)),
                chunks=args.chunks,
            )
            sh = NamedSharding(mesh, PartitionSpec("x"))
            dev = lambda x: jax.device_put(np.asarray(x), sh)
            res, ovf = timer.run(
                "pipelined exchange+join", step,
                dev(inner.keys), dev(inner.vals),
                dev(outer.keys), dev(outer.vals),
            )
            if bool(ovf):
                print("OVERFLOW: raise caps/chunks", file=sys.stderr)
                return 1
        elif args.timelog:
            # staged phase metering: exchange (the re-aggregation copy
            # the reference times separately, cpra2.cpp:1895-1905) vs
            # the local join
            from jax.sharding import NamedSharding, PartitionSpec
            from .parallel.cpra import make_cpra_steps_staged

            plan = plan_join(ni // n_dev, no // n_dev)
            sh = NamedSharding(mesh, PartitionSpec("x"))
            dev = lambda x: jax.device_put(np.asarray(x), sh)
            args_dev = (dev(inner.keys), dev(inner.vals),
                        dev(outer.keys), dev(outer.vals))
            slack, bias = 2.0, 1.0
            if args.arg4 is not None and n_dev >= 2:
                bias = 2.0 * max(args.arg4, 1.0 - args.arg4)
            for _ in range(3):
                icap = max(64, int(ni / n_dev**2 * slack * bias))
                ocap = max(plan.tile,
                           int(no / n_dev**2 * slack * bias))
                ex, jo = make_cpra_steps_staged(
                    mesh, plan, icap, ocap,
                    tier_ratio=args.arg4 if n_dev >= 2 else None,
                )
                # a FRESH timer per attempt: PhaseTimer accumulates by
                # name, so an overflowed attempt's run + the retry's
                # recompile would otherwise inflate the reported
                # exchange/local_join split (the whole point of staging)
                att = PhaseTimer()
                *exchanged, eovf = att.run("exchange", ex, *args_dev)
                res, jovf = att.run("local_join", jo, *exchanged)
                if not (bool(eovf) or bool(jovf)):
                    timer.phases.update(att.phases)
                    timer.timeline.extend(att.timeline)
                    break
                slack *= 2.0
            else:
                print("OVERFLOW persists after re-planning",
                      file=sys.stderr)
                return 1
        else:
            res, _ = timer.run(
                "exchange+join", cpra_join, inner.keys, inner.vals,
                outer.keys, outer.vals, mesh,
                tier_ratio=args.arg4,  # DDR/MCDRAM ratio -> group split
            )
        join_tuples = int(np.asarray(res.join_tuples).sum())

    roofline = None
    if (args.timelog and args.algorithm == "phj"
            and plan.probe_impl == "merge"):
        # merge pipeline only: the traffic model below describes its
        # sort/probe stages.  A device with no recorded memory peak (the
        # CPU included) gets no roofline fields.
        from .utils.roofline import merge_phj_traffic, roofline_report

        try:
            roofline = roofline_report(
                timer.phases,
                merge_phj_traffic(len(inner.keys), len(outer.keys)),
            )
        except KeyError:
            roofline = None
    return _finish(args, args.algorithm, timer, profiling, generated,
                   join_tuples, roofline)


if __name__ == "__main__":
    sys.exit(main())

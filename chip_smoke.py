"""Runs the join engine on the GPU and checks every result against the numpy
reference join (engine/oracle.py).

    python chip_smoke.py           # one GPU: the main path and the others
    python chip_smoke.py --four    # four GPUs: the distributed paths only

One GPU:
- main path: engine.phj.join at 16M build x 256M probe rows, uniform and
  Zipf z=1.0 probe keys from the reference generator; compile seconds,
  memory_analysis, peak device bytes and the median of three warm calls;
- npj_join in both output orders and grace_join (spilling to a temporary
  directory) at 16M x 64M;
- stream_join over the 256M-row probe side kept in host RAM;
- the padded radix mode (pass_bits=(6, 6)) at 4M x 16M, the radix pass
  against radix_partition_oracle at a 4M-row chunk, an M:N join through
  materialize_expanded, and aggregate_join_result over a join output.

Four GPUs: cpra_join (sort and radix pack) at 64M x 1B checked by the
cardinality formula; cpra_join, npj_join_dist and grace_join_dist at
16M x 256M checked by the oracle digest; exchange seconds of
make_cpra_steps_staged.

Every check is exact: results are integers.  Each phase prints one JSON
line; the card's name and power limit are printed first.  The last line
is {"ok": true, "device": {...}} when every phase passed.  Exit codes: 0
all passed, 1 a phase failed, 2 no GPU (or not enough of them) or the
package is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import traceback

import numpy as np

NI, NO = 16_000_000, 256_000_000
SEED = 42


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def workers() -> int:
    """Host processes for the reference join: the oracle is numpy on the
    host and would otherwise dominate the run."""
    return max(1, min(32, os.cpu_count() or 1))


def host_pool(n: int):
    """A pool of n spawned processes that import numpy only."""
    import multiprocessing

    return multiprocessing.get_context("spawn").Pool(n)


def device_check(n_gpus: int) -> str:
    """Requires n_gpus GPUs; returns the card line from nvidia-smi."""
    import jax

    from hash_join_codes_knl_tpu.utils.device import card_line, require_gpu

    require_gpu()
    if len(jax.devices()) < n_gpus:
        raise RuntimeError(
            f"need {n_gpus} GPUs, JAX finds {len(jax.devices())}")
    return card_line()


def _digest_aligned(keys, vals, mv, mc, pool):
    """Digest of the join rows of an aligned result with unique builds."""
    from hash_join_codes_knl_tpu.engine.oracle import digest_rows

    mc = np.asarray(mc).reshape(-1)
    if mc.max(initial=0) > 1:
        raise ValueError("multi-match rows in a unique-build join")
    m = mc == 1
    return digest_rows(np.asarray(keys).reshape(-1)[m],
                       np.asarray(vals).reshape(-1)[m],
                       np.asarray(mv).reshape(-1)[m], pool)


def _memory_analysis(compiled) -> dict:
    m = compiled.memory_analysis()
    return {a: getattr(m, a) for a in dir(m) if a.endswith("_in_bytes")}


def main_path(ni: int, no: int, zipf: float, card: str, pool,
              seed: int = SEED, reps: int = 3) -> dict:
    """engine.phj.join on generated relations, checked by the oracle
    digest (and, for uniform keys, by the cardinality formula).  Returns
    the phase record plus the relations and their oracle digest."""
    import jax

    from hash_join_codes_knl_tpu.engine.config import plan_join
    from hash_join_codes_knl_tpu.engine.oracle import (
        digest_rows,
        oracle_digest,
    )
    from hash_join_codes_knl_tpu.engine.phj import (
        join,
        materialize,
        phj_join_merge,
    )
    from hash_join_codes_knl_tpu.relation import expected_join_tuples
    from hash_join_codes_knl_tpu.relgen.generate import generate

    t0 = time.perf_counter()
    mode = "zipf" if zipf else "uniform"
    inner, outer, _ = generate(seed, ni, no, mode=mode, zipf=zipf)
    gen_s = time.perf_counter() - t0
    dev = jax.devices()[0]
    args = tuple(jax.device_put(a) for a in
                 (inner.keys, inner.vals, outer.keys, outer.vals))
    plan = plan_join(ni, no)
    t0 = time.perf_counter()
    compiled = phj_join_merge.lower(*args, plan=plan).compile()
    compile_s = time.perf_counter() - t0
    mem = _memory_analysis(compiled)
    del compiled
    t0 = time.perf_counter()
    res, plan = join(*args, plan)
    jax.block_until_ready(res)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(join(*args, plan)[0])
        times.append(time.perf_counter() - t0)
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    join_tuples = int(res.join_tuples)
    t0 = time.perf_counter()
    k, v, t = materialize(res)
    del res
    got = digest_rows(k, v, t, pool)
    del k, v, t
    digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = oracle_digest(inner.keys, inner.vals, outer.keys, outer.vals,
                         pool)
    oracle_s = time.perf_counter() - t0
    ok = got == want
    rec = {"zipf": zipf, "build_rows": ni, "probe_rows": no,
           "generate_s": gen_s, "compile_s": compile_s,
           "memory_analysis": mem, "first_call_s": first_s,
           "warm_s": times, "median_s": statistics.median(times),
           "card": card, "peak_bytes_in_use": peak,
           "join_tuples": join_tuples, "digest": got,
           "oracle_digest": want, "digest_s": digest_s,
           "oracle_s": oracle_s}
    if not zipf:
        expect = expected_join_tuples(ni, no)
        rec["expected_join_tuples"] = expect
        ok = ok and join_tuples == expect % (1 << 32) and got[0] == expect
    rec["ok"] = ok
    return rec, (inner, outer, want)


def npj_phase(inner, outer, want, pool) -> dict:
    """npj_join in both output orders against the oracle digest."""
    from hash_join_codes_knl_tpu.engine.npj import npj_join

    t0 = time.perf_counter()
    mv, mc, _ = npj_join(inner.keys, inner.vals, outer.keys, outer.vals)
    got_in = _digest_aligned(outer.keys, outer.vals, mv, mc, pool)
    input_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    k, v, mv, mc, _ = npj_join(inner.keys, inner.vals, outer.keys,
                               outer.vals, order="sorted")
    got_sorted = _digest_aligned(k, v, mv, mc, pool)
    sorted_s = time.perf_counter() - t0
    return {"ok": got_in == want and got_sorted == want,
            "input_order_digest": got_in, "sorted_order_digest": got_sorted,
            "oracle_digest": want, "input_order_s": input_s,
            "sorted_order_s": sorted_s}


def grace_phase(inner, outer, want, pool) -> dict:
    """grace_join with spill files under a temporary directory."""
    from hash_join_codes_knl_tpu.engine.grace import grace_join
    from hash_join_codes_knl_tpu.engine.oracle import add_digests

    acc = [(0, 0, 0)]

    def collect(meta, res, raw_pk):
        # one partition is small: digest it in this process
        acc[0] = add_digests(acc[0], _digest_aligned(
            raw_pk, res.probe_vals, res.match_vals, res.match_cnts, None))

    d = tempfile.mkdtemp(prefix="grace_smoke_")
    try:
        t0 = time.perf_counter()
        g = grace_join(inner.keys, inner.vals, outer.keys, outer.vals,
                       f_bits=6, chunk_rows=max(1, len(outer.keys) // 4),
                       spill_dir=d, on_partition=collect)
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"ok": acc[0] == want and g.join_tuples == want[0],
            "digest": acc[0], "oracle_digest": want, "seconds": dt,
            "join_tuples": g.join_tuples}


def stream_phase(inner, outer, want, chunk_rows, pool) -> dict:
    """stream_join with the probe side in host RAM."""
    from hash_join_codes_knl_tpu.engine.oracle import add_digests
    from hash_join_codes_knl_tpu.engine.stream import stream_join

    acc = [(0, 0, 0)]

    def collect(meta, res):
        acc[0] = add_digests(acc[0], _digest_aligned(
            res.probe_keys, res.probe_vals, res.match_vals, res.match_cnts,
            pool))

    t0 = time.perf_counter()
    s = stream_join(inner.keys, inner.vals, outer.keys, outer.vals,
                    chunk_rows, on_chunk=collect)
    dt = time.perf_counter() - t0
    return {"ok": acc[0] == want and s.join_tuples == want[0],
            "digest": acc[0], "oracle_digest": want, "seconds": dt,
            "chunks": len(s.chunks)}


def radix_pass_phase(hk_src, vals, bits: int = 6) -> dict:
    """The radix pass against radix_partition_oracle, partition by
    partition."""
    import jax.numpy as jnp

    from hash_join_codes_knl_tpu.ops.radix_partition import (
        radix_partition,
        radix_partition_oracle,
    )
    from hash_join_codes_knl_tpu.utils.hashing import np_hashed_key

    hk = np_hashed_key(np.asarray(hk_src), 0x9E3779B1)
    vals = np.asarray(vals)
    out_k, out_v, counts, ovf = radix_partition(jnp.asarray(hk),
                                                jnp.asarray(vals), bits)
    F = 1 << bits
    out_k = np.asarray(out_k).reshape(F, -1)
    out_v = np.asarray(out_v).reshape(F, -1)
    counts = np.asarray(counts)
    ok = int(ovf) == 0
    for p, (wk, wv) in enumerate(radix_partition_oracle(hk, vals, bits)):
        live = out_k[p] != 0
        pair = lambda k, v: np.sort((k.astype(np.uint64) << np.uint64(32))
                                    | v.astype(np.uint64))
        ok = (ok and int(counts[p]) == len(wk)
              and np.array_equal(pair(out_k[p][live], out_v[p][live]),
                                 pair(wk, wv)))
    return {"ok": bool(ok), "rows": len(hk), "fanout": F,
            "overflow": int(ovf)}


def padded_radix_phase(ni, no, pool, seed=SEED + 1):
    """The padded radix mode (pass_bits=(6, 6)) through join(); returns the
    phase record and the join output for the aggregate phase."""
    import dataclasses

    from hash_join_codes_knl_tpu.engine.config import plan_join
    from hash_join_codes_knl_tpu.engine.oracle import oracle_digest
    from hash_join_codes_knl_tpu.engine.phj import join
    from hash_join_codes_knl_tpu.relgen.generate import generate

    inner, outer, _ = generate(seed, ni, no, mode="uniform")
    plan = dataclasses.replace(
        plan_join(ni, no), p_bits=12, pass_bits=(6, 6),
        partition_impl="radix", probe_impl="table")
    t0 = time.perf_counter()
    res, _ = join(inner.keys, inner.vals, outer.keys, outer.vals, plan)
    got = _digest_aligned(res.probe_keys, res.probe_vals, res.match_vals,
                          res.match_cnts, pool)
    dt = time.perf_counter() - t0
    want = oracle_digest(inner.keys, inner.vals, outer.keys, outer.vals,
                         pool)
    return ({"ok": got == want, "digest": got, "oracle_digest": want,
             "seconds": dt}, (inner, outer, res))


def aggregate_phase(inner, outer, res) -> dict:
    """aggregate_join_result against a numpy group-by of the oracle rows."""
    from hash_join_codes_knl_tpu.engine.oracle import join_oracle
    from hash_join_codes_knl_tpu.ops.aggregate import aggregate_join_result

    ng, gk, sums, cnts = aggregate_join_result(res)
    ng = int(ng)
    gk, sums, cnts = (np.asarray(a)[:ng] for a in (gk, sums, cnts))
    o = np.argsort(gk)
    gk, sums, cnts = gk[o], sums[o], cnts[o]
    o = np.argsort(outer.keys, kind="stable")  # key order: faster searches
    keys, _, tabs = join_oracle(inner.keys, inner.vals, outer.keys[o],
                                outer.vals[o])
    o = np.argsort(keys, kind="stable")
    keys, tabs = keys[o], tabs[o].astype(np.uint64)
    wk, starts, wc = np.unique(keys, return_index=True, return_counts=True)
    ws = (np.add.reduceat(tabs, starts) & np.uint64(0xFFFFFFFF)
          if len(keys) else np.zeros(0, np.uint64))
    ok = (ng == len(wk) and np.array_equal(gk, wk)
          and np.array_equal(cnts, wc)
          and np.array_equal(sums.astype(np.uint64), ws))
    return {"ok": bool(ok), "groups": ng, "oracle_groups": len(wk)}


def mn_phase(n_keys, no, pool, seed=SEED + 2) -> dict:
    """A duplicate-key build through join() and materialize_expanded."""
    from hash_join_codes_knl_tpu.engine.oracle import digest_rows, oracle_digest
    from hash_join_codes_knl_tpu.engine.phj import join, materialize_expanded

    rng = np.random.default_rng(seed)
    base = np.unique(rng.integers(1, 2**32, int(n_keys * 1.1) + 16,
                                  dtype=np.uint32))[:n_keys]
    ik = np.repeat(base, rng.integers(1, 5, len(base))).astype(np.uint32)
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    ok = base[rng.integers(0, len(base), no)]
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    t0 = time.perf_counter()
    res, _ = join(ik, iv, ok, ov)
    got = digest_rows(*materialize_expanded(res, ik, iv), pool)
    dt = time.perf_counter() - t0
    want = oracle_digest(ik, iv, ok, ov, pool)
    return {"ok": got == want, "build_rows": len(ik), "probe_rows": no,
            "digest": got, "oracle_digest": want, "seconds": dt}


class Phases:
    """Runs phases, logs each one's record, and remembers any failure."""

    def __init__(self):
        self.ok = True

    def __call__(self, name, fn, *a):
        t0 = time.perf_counter()
        try:
            rec = fn(*a)
        except Exception:
            traceback.print_exc()
            log(name, ok=False, error=traceback.format_exc(limit=1))
            self.ok = False
            return None
        out = rec[0] if isinstance(rec, tuple) else rec
        log(name, **out, phase_s=time.perf_counter() - t0)
        self.ok = self.ok and bool(out["ok"])
        return rec


def run_one_gpu(card: str, pool, scale: int = 1) -> bool:
    """Every single-GPU phase; sizes are the full ones divided by scale."""
    ni, no = NI // scale, NO // scale
    phase = Phases()

    uni = phase("main_uniform", main_path, ni, no, 0.0, card, pool)
    phase("main_zipf_1.0", main_path, ni, no, 1.0, card, pool)
    if uni is not None:
        inner, outer, want = uni[1]
        phase("stream_join", stream_phase, inner, outer, want, no // 4,
              pool)
        from hash_join_codes_knl_tpu.engine.oracle import oracle_digest
        from hash_join_codes_knl_tpu.relation import Relation

        q = no // 4
        outer64 = Relation(outer.keys[:q], outer.vals[:q])
        want64 = oracle_digest(inner.keys, inner.vals, outer64.keys,
                               outer64.vals, pool)
        phase("npj_join", npj_phase, inner, outer64, want64, pool)
        phase("grace_join", grace_phase, inner, outer64, want64, pool)
        phase("radix_pass", radix_pass_phase, outer.keys[: ni // 4],
              outer.vals[: ni // 4])
        del uni, inner, outer, outer64
    rad = phase("padded_radix", padded_radix_phase, ni // 4, no // 16,
                pool)
    if rad is not None:
        phase("aggregate", aggregate_phase, *rad[1])
        del rad
    phase("mn_expand", mn_phase, ni // 16, no // 64, pool)
    return phase.ok


def cardinality_relations(ni, no, seed=SEED + 3):
    """Unique build keys and probe keys drawn from them: the cardinality
    formula gives the exact join size."""
    rng = np.random.default_rng(seed)
    ik = np.arange(1, ni + 1, dtype=np.uint32) * np.uint32(0x85EBCA77)
    iv = ik ^ np.uint32(0x5BD1E995)
    ok = ik[rng.integers(0, ni, no, dtype=np.uint32)]
    ov = ok ^ np.uint32(0x27D4EB2F)
    return ik, iv, ok, ov


def cpra_cardinality_phase(mesh, rel, pack_impl):
    """cpra_join on cardinality_relations, checked by the formula."""
    from hash_join_codes_knl_tpu.parallel.cpra import cpra_join
    from hash_join_codes_knl_tpu.relation import expected_join_tuples

    ik, iv, ok, ov = rel
    ni, no = len(ik), len(ok)
    t0 = time.perf_counter()
    res, _ = cpra_join(ik, iv, ok, ov, mesh, pack_impl=pack_impl)
    got = int(res.join_tuples)
    dt = time.perf_counter() - t0
    expect = expected_join_tuples(ni, no)
    return {"ok": got == expect % (1 << 32), "pack_impl": pack_impl,
            "build_rows": ni, "probe_rows": no, "join_tuples": got,
            "expected_join_tuples": expect, "seconds": dt}


def cpra_digest_phase(mesh, inner, outer, want, pack_impl, pool):
    from hash_join_codes_knl_tpu.engine.phj import materialize
    from hash_join_codes_knl_tpu.parallel.cpra import cpra_join

    t0 = time.perf_counter()
    res, _ = cpra_join(inner.keys, inner.vals, outer.keys, outer.vals, mesh,
                       pack_impl=pack_impl)
    from hash_join_codes_knl_tpu.engine.oracle import digest_rows

    got = digest_rows(*materialize(res), pool)
    return {"ok": got == want, "pack_impl": pack_impl, "digest": got,
            "oracle_digest": want, "seconds": time.perf_counter() - t0}


def npj_dist_phase(mesh, inner, outer, want, pool):
    from hash_join_codes_knl_tpu.parallel.npj_dist import npj_join_dist

    t0 = time.perf_counter()
    mv, mc, total, _ = npj_join_dist(inner.keys, inner.vals, outer.keys,
                                     outer.vals, mesh)
    got = _digest_aligned(outer.keys, outer.vals, mv, mc, pool)
    return {"ok": got == want and total == want[0], "digest": got,
            "oracle_digest": want, "seconds": time.perf_counter() - t0}


def grace_dist_phase(mesh, inner, outer, want, pool):
    from hash_join_codes_knl_tpu.engine.oracle import add_digests
    from hash_join_codes_knl_tpu.parallel.grace_dist import grace_join_dist

    acc = [(0, 0, 0)]

    def collect(meta, res, raw_pk):
        acc[0] = add_digests(acc[0], _digest_aligned(
            raw_pk, res.probe_vals, res.match_vals, res.match_cnts, None))

    d = tempfile.mkdtemp(prefix="grace_dist_smoke_")
    try:
        t0 = time.perf_counter()
        g = grace_join_dist(
            inner.keys, inner.vals, outer.keys, outer.vals, mesh, f_bits=6,
            chunk_rows=max(1, len(outer.keys) // 16), spill_dir=d,
            on_partition=collect)
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"ok": acc[0] == want and g.join_tuples == want[0],
            "digest": acc[0], "oracle_digest": want, "seconds": dt}


def exchange_phase(mesh, inner, outer, card, reps=3):
    """Seconds of the CPRA exchange stage (owner pack + all_to_all) and of
    the local join stage, each the median of `reps` warm calls."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from hash_join_codes_knl_tpu.engine.config import plan_join
    from hash_join_codes_knl_tpu.parallel.cpra import make_cpra_steps_staged
    from hash_join_codes_knl_tpu.parallel.distributed import shard_null_padded

    n = mesh.shape["x"]
    ni, no = len(inner.keys), len(outer.keys)
    plan = plan_join(ni // n, no // n)
    ex, jo = make_cpra_steps_staged(mesh, plan, max(64, 2 * ni // n**2),
                                    max(plan.tile, 2 * no // n**2))
    sh = NamedSharding(mesh, PartitionSpec("x"))
    args = tuple(shard_null_padded(a, n, sh) for a in
                 (inner.keys, inner.vals, outer.keys, outer.vals))
    *got, ovf = jax.block_until_ready(ex(*args))
    jax.block_until_ready(jo(*got))
    t_ex, t_jo = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        *got, ovf = jax.block_until_ready(ex(*args))
        t_ex.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        res, jovf = jax.block_until_ready(jo(*got))
        t_jo.append(time.perf_counter() - t0)
    return {"ok": not bool(ovf) and not bool(jovf), "card": card,
            "exchange_s": t_ex, "exchange_median_s": statistics.median(t_ex),
            "local_join_s": t_jo,
            "local_join_median_s": statistics.median(t_jo)}


def run_four_gpus(card: str, pool, scale: int = 1) -> bool:
    """The distributed paths on a four-device data mesh."""
    from hash_join_codes_knl_tpu.engine.oracle import oracle_digest
    from hash_join_codes_knl_tpu.parallel.distributed import data_mesh
    from hash_join_codes_knl_tpu.relgen.generate import generate

    mesh = data_mesh(4)
    phase = Phases()
    ni, no = NI // scale, NO // scale
    inner, outer, _ = generate(SEED, ni, no, mode="uniform")
    want = oracle_digest(inner.keys, inner.vals, outer.keys, outer.vals,
                         pool)
    for pack in ("sort", "radix"):
        phase(f"cpra_{pack}", cpra_digest_phase, mesh, inner, outer, want,
              pack, pool)
    phase("npj_dist", npj_dist_phase, mesh, inner, outer, want, pool)
    phase("grace_dist", grace_dist_phase, mesh, inner, outer, want, pool)
    phase("cpra_exchange", exchange_phase, mesh, inner, outer, card)
    del inner, outer
    rel = cardinality_relations(4 * ni, 4 * no)
    for pack in ("sort", "radix"):
        phase(f"cpra_{pack}_64Mx1B", cpra_cardinality_phase, mesh, rel,
              pack)
    return phase.ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU distributed phase")
    args = ap.parse_args(argv)
    try:
        import jax

        from hash_join_codes_knl_tpu.utils.device import (
            device_record,
            use_compile_cache,
        )
    except ImportError:
        traceback.print_exc()
        return 2
    cache_dir = use_compile_cache()
    # JAX records a "miss" when it writes an entry (compiles of at least
    # jax_persistent_cache_min_compile_time_secs)
    cache = {"hits": 0, "writes": 0}

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            cache["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            cache["writes"] += 1

    jax.monitoring.register_event_listener(on_event)
    n_gpus = 4 if args.four else 1
    try:
        card = device_check(n_gpus)
    except Exception as e:
        print(f"device check failed: {e}", file=sys.stderr)
        return 2
    print(card, flush=True)
    t0 = time.perf_counter()
    with host_pool(workers()) as pool:
        if args.four:
            ok = run_four_gpus(card, pool)
        else:
            ok = run_one_gpu(card, pool)
    log("done", seconds=time.perf_counter() - t0, compile_cache=cache,
        compile_cache_dir=cache_dir, host_workers=workers())
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

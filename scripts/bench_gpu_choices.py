"""Times the plain-XLA alternatives behind the engine's fixed choices.

Each row is the median of three warm calls ending in block_until_ready,
on device-generated data, at the main cell's shapes:

- probe-side ordering at 256M rows: one global 1-D key-value sort vs the
  batched (64, 4M) sort (engine/config.py plan_join's chunking rule);
- the build sort at 16M rows with one and two sort keys;
- the merge probe (ops/merge_probe.py) at 16M build x 256M probe rows for
  each jnp.searchsorted method, on globally sorted, chunk-sorted and
  unsorted probe keys;
- the radix pass (ops/radix_partition.py) at a 4M-row chunk and 64-way
  fanout against a plain 4M-row key-value sort, plus the same pass built
  from a sort of the partition id alone followed by two gathers;
- the stages of the merge join (build, probe sort, probe) at 16M x 256M,
  and the whole join with the probe's two implementations
  (ops/merge_probe.py: the Triton kernel and the plain search), alternating
  plain, kernel, kernel, plain; the kernel's block size and warps; and
  the kernel on unsorted probe keys (NPJ's input order).

Run on the card from the repository root:
    python scripts/bench_gpu_choices.py [--only NAME ...]
Prints one JSON object per line; fails when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

import hash_join_codes_knl_tpu.ops.merge_probe as mp
from hash_join_codes_knl_tpu.ops.merge_probe import build_runs
from hash_join_codes_knl_tpu.ops.radix_partition import (
    radix_partition,
    region_cap,
)
from hash_join_codes_knl_tpu.utils.device import (
    card_line,
    device_record,
    require_gpu,
    use_compile_cache,
)

NI = 16_000_000
NO = 256_000_000
CHUNKS = 64
RADIX_ROWS = 4_000_000
RADIX_BITS = 6


def timed(fn, *args, reps: int = 3) -> dict:
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(ts), "runs_s": ts,
            "first_call_s": first}


@jax.jit
def _make_relations(seed):
    kb, ki, kv = jax.random.split(jax.random.key(seed), 3)
    bhk = jax.random.bits(kb, (NI,), jnp.uint32) | jnp.uint32(1)
    idx = jax.random.randint(ki, (NO,), 0, NI)
    ohk = bhk[idx]
    ov = jax.random.bits(kv, (NO,), jnp.uint32)
    return bhk, bhk ^ jnp.uint32(0x5BD1E995), ohk, ov


def _sort1(k, v):
    return jax.lax.sort((k, v), num_keys=1)


def _sort2(k, v):
    return jax.lax.sort((k, v), num_keys=2)


def _sort_chunks(k, v):
    return jax.lax.sort((k.reshape(CHUNKS, -1), v.reshape(CHUNKS, -1)),
                        dimension=1, num_keys=1)


@jax.jit
def _radix_by_pid(hk, vals):
    """The radix pass from a sort of the partition id alone: an 8-bit
    key with the row index as payload, then two gathers."""
    F = 1 << RADIX_BITS
    n = hk.shape[0]
    cap = region_cap(n, F)
    key = jnp.where(hk != 0, (hk >> (32 - RADIX_BITS)) + 1, 0)
    key_s, perm = jax.lax.sort(
        (key.astype(jnp.uint8), jnp.arange(n, dtype=jnp.int32)), num_keys=1)
    bounds = jnp.arange(1, F + 1, dtype=jnp.uint8)
    starts = jnp.searchsorted(key_s, bounds).astype(jnp.int32)
    counts = jnp.diff(starts, append=jnp.int32(n))
    pid = key_s.astype(jnp.int32) - 1
    rank = jnp.arange(n, dtype=jnp.int32) - starts[jnp.maximum(pid, 0)]
    dest = jnp.where((pid >= 0) & (rank < cap), pid * cap + rank, F * cap)
    out_k = jnp.zeros(F * cap, jnp.uint32).at[dest].set(hk[perm],
                                                       mode="drop")
    out_v = jnp.zeros(F * cap, jnp.uint32).at[dest].set(vals[perm],
                                                        mode="drop")
    return out_k, out_v, counts, jnp.sum(jnp.maximum(counts - cap, 0))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    use_compile_cache()
    require_gpu()
    print(card_line(), flush=True)
    want = lambda name: args.only is None or name in args.only
    dev = device_record()

    def emit(name, **row):
        print(json.dumps({"row": name, **row, "device": dev}), flush=True)

    bhk, bv, ohk, ov = jax.block_until_ready(_make_relations(0))
    if want("probe_sort"):
        emit("probe_sort_1d_256M", **timed(jax.jit(_sort1), ohk, ov))
        emit("probe_sort_c64_256M", **timed(jax.jit(_sort_chunks), ohk, ov))
    if want("build_sort"):
        emit("build_sort_1key_16M", **timed(jax.jit(_sort1), bhk, bv))
        emit("build_sort_2key_16M", **timed(jax.jit(_sort2), bhk, bv))
    if want("search"):
        runs = jax.jit(build_runs)(*jax.jit(_sort1)(bhk, bv))
        os_, _ = jax.jit(_sort1)(ohk, ov)
        oc, _ = jax.jit(_sort_chunks)(ohk, ov)
        for method in ("scan", "scan_unrolled", "sort"):
            probe = jax.jit(lambda q, h, c, v, m=method:
                            mp._probe_plain(q, h, c, v, method=m))
            r = timed(probe, os_, *runs)
            mv, mc = probe(os_, *runs)
            emit(f"merge_probe_{method}_sorted", **r,
                 join_tuples=int(jnp.sum(mc)))
            emit(f"merge_probe_{method}_chunked", **timed(probe, oc, *runs))
            emit(f"merge_probe_{method}_unsorted", **timed(probe, ohk, *runs))
        del runs, os_, oc, mv, mc
    if want("radix"):
        k4, v4 = ohk[:RADIX_ROWS], ov[:RADIX_ROWS]
        plain = jax.jit(lambda k, v: radix_partition(k, v, RADIX_BITS))
        a = plain(k4, v4)
        b = _radix_by_pid(k4, v4)
        same = bool(jnp.all(a[2] == b[2])) and int(a[3]) == int(b[3]) == 0
        emit("radix_pass_4M_f64", **timed(plain, k4, v4), counts_agree=same)
        emit("radix_pass_by_pid_4M_f64", **timed(_radix_by_pid, k4, v4))
        emit("pair_sort_4M", **timed(jax.jit(_sort1), k4, v4))
    if want("stages") or want("triton"):
        del bhk, bv, ohk, ov
        from hash_join_codes_knl_tpu.engine.config import plan_join
        from hash_join_codes_knl_tpu.engine.phj import (
            _merge_build,
            _merge_sort_probe,
            _staged_fns,
            merge_cap,
            phj_join_merge,
        )
        from hash_join_codes_knl_tpu.relgen.generate import generate
        from hash_join_codes_knl_tpu.utils.hashing import (
            hashed_key,
            mod_inverse_u32,
        )

        inner, outer, _ = generate(42, NI, NO, mode="uniform")
        rel = tuple(jax.device_put(a) for a in
                     (inner.keys, inner.vals, outer.keys, outer.vals))
        del inner, outer
        plan = plan_join(NI, NO)
        build, sort_probe, probe = _staged_fns(plan)
        cap = merge_cap(plan, NO)
        runs, viol = build(rel[0], rel[1])
        ohk_s, ov_s = sort_probe(rel[2], rel[3], cap)
        emit("stage_build", **timed(build, rel[0], rel[1]))
        emit("stage_probe_sort", **timed(sort_probe, rel[2], rel[3], cap))
        emit("stage_probe", **timed(probe, runs, viol, ohk_s, ov_s))
        emit("join_fused", **timed(phj_join_merge, *rel, plan))
    if want("triton"):
        inv = jnp.uint32(mod_inverse_u32(plan.factor))

        @jax.jit
        def plain_join(ik, iv, ok, ov):
            runs, _ = _merge_build(ik, iv, plan)
            ohk, ovs = _merge_sort_probe(hashed_key(ok, plan.factor), ov,
                                         cap, 1)
            mv, mc = mp._probe_plain(ohk, *runs)
            return ohk * inv, ovs, mv, mc

        def kernel_join(*rel):
            return phj_join_merge(*rel, plan)

        ref = jax.block_until_ready(plain_join(*rel))
        got = jax.block_until_ready(kernel_join(*rel))
        same = all(bool(jnp.array_equal(a, b)) for a, b in zip(
            ref, (got.probe_keys, got.probe_vals, got.match_vals,
                  got.match_cnts)))
        emit("triton_probe_agrees", agrees=same)
        for name, fn in (("join_plain", plain_join),
                         ("join_triton", kernel_join),
                         ("join_triton", kernel_join),
                         ("join_plain", plain_join)):
            emit(name, **timed(fn, *rel))
        q = ohk_s.reshape(-1)
        emit("stage_probe_plain", **timed(jax.jit(mp._probe_plain), q, *runs))
        for block in (256, 512, 1024, 2048):
            for warps in (4, 8):
                emit(f"stage_probe_triton_b{block}_w{warps}",
                     **timed(jax.jit(functools.partial(
                         mp._probe_triton, block=block, warps=warps)),
                         q, *runs))
        unsorted = hashed_key(rel[2], plan.factor)
        emit("probe_triton_unsorted",
             **timed(jax.jit(mp._probe_triton), unsorted, *runs))
        emit("probe_plain_unsorted",
             **timed(jax.jit(mp._probe_plain), unsorted, *runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())

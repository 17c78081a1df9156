"""Hash aggregate: group-by-key reduction over relations / join output.

The BASELINE operator set requires a hash aggregate on join output
(BASELINE.json north star).  Design: no hash table at all --
sort-group-reduce, with NO scatter and NO gather anywhere (whether a
scatter-add group-by is faster on the GPU is an open ROADMAP item):

1. one fused sort groups equal keys -- sorted on `keys - 1`, a u32
   bijection that preserves nonzero-key order and wraps the null key 0
   to the TOP, so nulls land last with no separate flag column (a full
   1 GB sort column saved at 256M rows),
2. an inclusive cumsum turns per-run sums into differences of the
   cumsum at run boundaries; each run-START row locally computes the
   "prefix before me" (csum[i] - v[i]) -- no boundary lookups needed.
   Valid rows form a PREFIX after the sort, so a run start's
   prefix-count is simply its row index (no second cumsum),
3. a second stable sort compacts the run-start rows to the front (the
   standard sort-based compaction, as ops/filter.py), and
4. group totals fall out as neighbor differences of the compacted
   prefix columns: sum_j = prefix_{j+1} - prefix_j (the last group
   closes against the grand total).

That scheme is implemented ONCE (`_reduce_runs`, batched over rows
with any number of value columns) and serves three surfaces: the
single-level `hash_aggregate`, the per-chunk partial pass of
`hash_aggregate_chunked`, and its partial re-aggregation level.

Aggregates are exact u32 wraparound sums / counts (the engine's value
domain), packed to the front like every compacted output.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .partition import PAD_KEY


def _reduce_runs(k_s, vcols):
    """Per-row run reduction of batched-sorted columns.

    k_s: (C, m) keys, each row independently sorted with null-key
    (PAD_KEY) rows LAST (the keys-1 sort trick); vcols: tuple of (C, m)
    u32 value columns in the same order.  Returns (gk, sums, cnts, g):
    each row's run-start keys compacted to its front (PAD_KEY tails),
    the per-run u32 wraparound sum of every value column, the run
    lengths, and g = groups per row.  C == 1 uses 1-D sorts internally
    (a (1, n) dimension=1 sort would take XLA's batched sort path, the
    slower one: PERF.md)."""
    C, m = k_s.shape
    valid = k_s != PAD_KEY
    newrun = jnp.concatenate(
        [jnp.ones((C, 1), bool), k_s[:, 1:] != k_s[:, :-1]], axis=1
    )
    newrun &= valid
    pres = []
    tots = []
    for v in vcols:
        v_live = jnp.where(valid, v, jnp.uint32(0))
        csum = jnp.cumsum(v_live, axis=1, dtype=jnp.uint32)
        pres.append(csum - v_live)  # prefix BEFORE each row's run start
        tots.append(csum[:, m - 1 : m])
    # run-length prefix: valid rows are a per-row prefix after the sort,
    # so the count of rows before a run start is its column index
    pres.append(jnp.broadcast_to(
        jnp.arange(m, dtype=jnp.uint32)[None, :], (C, m)
    ))
    tots.append(jnp.sum(valid.astype(jnp.uint32), axis=1, keepdims=True))
    # compact run starts to the front, preserving key order (stable sort
    # on the start flag); the prefix columns ride along
    flag = jnp.where(newrun, jnp.uint32(0), jnp.uint32(1))
    ops = (flag, k_s, *pres)
    if C == 1:
        sorted_ops = jax.lax.sort(
            tuple(o.reshape(-1) for o in ops), num_keys=1, is_stable=True
        )
        sorted_ops = tuple(o.reshape(1, m) for o in sorted_ops)
    else:
        sorted_ops = jax.lax.sort(ops, dimension=1, num_keys=1,
                                  is_stable=True)
    gk = sorted_ops[1]
    ps = sorted_ops[2:]
    g = jnp.sum(newrun.astype(jnp.uint32), axis=1)  # (C,) groups per row
    j = jnp.broadcast_to(jnp.arange(m, dtype=jnp.uint32)[None, :], (C, m))
    live = j < g[:, None]
    last = j + 1 == g[:, None]
    outs = []
    for p, tot in zip(ps, tots):
        nxt = jnp.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        red = jnp.where(last, tot - p, nxt - p)
        outs.append(jnp.where(live, red, jnp.uint32(0)))
    gk = jnp.where(live, gk, jnp.uint32(PAD_KEY))
    return gk, tuple(outs[:-1]), outs[-1], g


def _null_last_sort(keys, vcols, dimension=None):
    """Sort (keys, *vcols) on keys-1: an order-preserving u32 bijection
    for nonzero keys that wraps the null key 0 to 0xFFFFFFFF, so null
    rows sort LAST with no extra flag column."""
    ops = (keys - jnp.uint32(1), *vcols)
    if dimension is None:
        out = jax.lax.sort(ops, num_keys=1)
    else:
        out = jax.lax.sort(ops, dimension=dimension, num_keys=1)
    return (out[0] + jnp.uint32(1), *out[1:])


def hash_aggregate(keys: jnp.ndarray, vals: jnp.ndarray):
    """Group by key; returns (n_groups, group_keys, sums, counts), with the
    groups packed to the front and tails padded with PAD_KEY/0.

    Rows with key == PAD_KEY (null/padding) are ignored, which lets the
    aligned join output feed this directly without materialization.
    """
    n = keys.shape[0]
    if n == 0:
        # static-shape early exit: _reduce_runs' run-boundary
        # concatenate builds a (C, 1) flag against a (C, 0) mask
        # (trace-time error) on empty input
        z = jnp.zeros(0, jnp.uint32)
        return jnp.uint32(0), z, z, jnp.zeros(0, jnp.int32)
    k_s, v_s = _null_last_sort(keys, (vals,))
    gk, (sums,), counts, g = _reduce_runs(
        k_s.reshape(1, n), (v_s.reshape(1, n),)
    )
    return (g[0], gk.reshape(-1), sums.reshape(-1),
            counts.reshape(-1).astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("chunks", "partial_cap"))
def hash_aggregate_chunked(keys, vals, chunks: int = 64,
                           partial_cap: int = 1 << 22):
    """Two-level sort-group-reduce: per-chunk batched sorts + partial
    aggregation, then one small aggregate over the packed partials.

    Level 1 sorts the input as `chunks` INDEPENDENT rows (the same
    batched-2-D sort as the join's chunk-sorted probe) and reduces each
    chunk's runs to
    (key, partial sum, partial count) triples packed to the chunk's
    front.  Level 2 re-aggregates the at-most-partial_cap partials:
    sums add, counts add (a 2-value-column run reduction; the
    compaction sort that dominates the single-level cost now runs at
    partial size, not input size).  Wins when distinct groups << rows;
    at groups ~ rows the partials don't shrink and `hash_aggregate` is
    the right call.

    partial_cap is a STATIC capacity (per chunk: partial_cap/chunks
    slots).  A chunk with more groups than its slot budget OVERFLOWS:
    the count of dropped partials is returned as a VALUE (engine
    convention) and the results must be discarded in favor of
    `hash_aggregate` -- `hash_aggregate_auto` does exactly that.

    Returns (n_groups, group_keys, sums, counts, overflow) with the
    group arrays sized chunks * (partial_cap // chunks) (packed to the
    front, PAD_KEY/0 tails)."""
    n = keys.shape[0]
    if n == 0:
        z = jnp.zeros(0, jnp.uint32)
        return (jnp.uint32(0), z, z, jnp.zeros(0, jnp.int32),
                jnp.zeros((), jnp.int32))
    cap_c = max(1, partial_cap // chunks)
    m = -(-n // chunks)
    pad = chunks * m - n
    k_p = jnp.concatenate([keys, jnp.zeros(pad, jnp.uint32)])
    v_p = jnp.concatenate([vals, jnp.zeros(pad, jnp.uint32)])
    k_s, v_s = _null_last_sort(
        k_p.reshape(chunks, m), (v_p.reshape(chunks, m),), dimension=1
    )
    gk, (ps,), pc, g = _reduce_runs(k_s, (v_s,))
    overflow = jnp.sum(jnp.maximum(g.astype(jnp.int32) - cap_c, 0))
    # static per-chunk slice -- no gather; overflowing chunks lose
    # their tail groups, which is exactly what `overflow` counts
    gk_c = gk[:, :cap_c].reshape(-1)
    ps_c = ps[:, :cap_c].reshape(-1)
    pc_c = pc[:, :cap_c].reshape(-1)
    # level 2: aggregate the partials -- sums AND counts both add, so
    # the run reduction carries two value columns, at partial size
    N2 = gk_c.shape[0]
    k2, s2, c2 = _null_last_sort(gk_c, (ps_c, pc_c))
    gk2, (sums, counts), _, g2 = _reduce_runs(
        k2.reshape(1, N2), (s2.reshape(1, N2), c2.reshape(1, N2))
    )
    return (g2[0], gk2.reshape(-1), sums.reshape(-1),
            counts.reshape(-1).astype(jnp.int32), overflow)


def hash_aggregate_auto(keys, vals, chunks: int = 64,
                        partial_cap: int = 1 << 22):
    """Two-level aggregate with a MEASURED re-plan (engine convention:
    overflow is a value, and the next plan is sized from it, not from
    blind escalation).  When a chunk overflows its partial budget, the
    dropped-partial count bounds the worst chunk's true group count:
    dropped = sum_c max(g_c - cap_c, 0) >= max_c(g_c) - cap_c, so ONE
    retry at cap_c + dropped slots per chunk is guaranteed clean.  Only
    when that re-planned partial size reaches the input size (groups ~
    rows, where two-level cannot win -- its level-2 sort would be at
    least the input sort) does it fall back to the single-level
    `hash_aggregate`.  Exact for any input, same return contract as
    hash_aggregate."""
    keys, vals = jnp.asarray(keys), jnp.asarray(vals)
    n = keys.shape[0]
    n_groups, gk, sums, counts, ovf = hash_aggregate_chunked(
        keys, vals, chunks=chunks, partial_cap=partial_cap,
    )
    dropped = int(ovf)
    if dropped != 0:
        cap_c = max(1, partial_cap // chunks)
        new_cap = chunks * (cap_c + dropped)
        if new_cap >= n:
            return hash_aggregate(keys, vals)
        n_groups, gk, sums, counts, ovf = hash_aggregate_chunked(
            keys, vals, chunks=chunks, partial_cap=new_cap,
        )
        assert int(ovf) == 0, "re-planned partial budget cannot overflow"
    return n_groups, gk, sums, counts


@functools.partial(jax.jit, static_argnames=("cap", "budget"))
def _expand_block_partials(build_keys, build_vals, pk_b, pv_b,
                           cap: int, budget: int):
    """One streamed M:N block, entirely on device: expand the block's
    probe rows against the build relation (ops/expand.py), aggregate
    the expanded (probe key -> build val) rows in place, and return the
    partials sliced to the static `budget`.  ng is returned so the
    caller can detect budget overflow and re-plan from the measured
    group count."""
    from .expand import expand_join

    total, out_k, _out_v, out_t = expand_join(
        build_keys, build_vals, pk_b, pv_b, cap
    )
    ng, gk, sums, counts = hash_aggregate(out_k, out_t)
    return (total, ng, gk[:budget], sums[:budget],
            counts[:budget].astype(jnp.uint32))


def aggregate_join_result_expanded(res, inner_keys, inner_vals,
                                   block_rows: int = 1 << 22,
                                   partial_budget: int = 1 << 20):
    """Device-side M:N aggregate: group the EXPANDED join output by
    probe key, summing matched build values -- without ever
    round-tripping the expansion through host memory.

    The aligned JoinResult carries exact per-probe match counts even
    for duplicate-key builds; matched probe rows are split into blocks
    whose expansions fit `block_rows` (greedy_blocks, the
    materialize_expanded planner), each block is expanded AND
    partially aggregated in one jitted device program
    (_expand_block_partials -- the expansion never leaves HBM), and
    the per-block partials are reduced with the chunked aggregate's
    2-value-column run reduction (sums add, counts add).

    partial_budget caps each block's partial slots (static shape; one
    compiled program serves every block).  A block with more groups
    than the budget is detected from its returned ng and ALL blocks
    re-run once at the measured max group count (exact by
    construction: a block of `cap` rows has at most `cap` groups) --
    the engine's measured re-plan convention, never silent truncation.

    Returns (n_groups, group_keys, sums, counts) exactly like
    aggregate_join_result; match_cnts <= 1 inputs produce identical
    results (differentially tested), so this is the general form and
    the aligned one the fast path.
    """
    import numpy as np

    from .expand import greedy_blocks

    mc = np.asarray(res.match_cnts).reshape(-1)
    total = int(mc.astype(np.int64).sum())
    if total == 0:
        z = jnp.zeros(0, jnp.uint32)
        return jnp.uint32(0), z, z, jnp.zeros(0, jnp.int32)
    m = mc > 0
    pk_np = np.asarray(res.probe_keys).reshape(-1)[m]
    pv_np = np.asarray(res.probe_vals).reshape(-1)[m]
    ik = jnp.asarray(inner_keys)
    iv = jnp.asarray(inner_vals)
    counts = mc[m].astype(np.int64)
    block_rows = max(block_rows, int(counts.max()))
    cap = -(-block_rows // 128) * 128
    budget = min(cap, -(-partial_budget // 128) * 128)

    def run_blocks(budget: int):
        parts, max_ng = [], 0
        for start, stop, blk_total in greedy_blocks(counts, block_rows):
            n_rows = stop - start
            pk_b = np.zeros(cap, np.uint32)
            pv_b = np.zeros(cap, np.uint32)
            pk_b[:n_rows] = pk_np[start:stop]
            pv_b[:n_rows] = pv_np[start:stop]
            got, ng, gk_b, s_b, c_b = _expand_block_partials(
                ik, iv, jnp.asarray(pk_b), jnp.asarray(pv_b), cap, budget
            )
            assert int(got) == blk_total, (int(got), blk_total)
            max_ng = max(max_ng, int(ng))
            parts.append((gk_b, s_b, c_b))
        return parts, max_ng

    parts, max_ng = run_blocks(budget)
    if max_ng > budget:
        # measured re-plan: re-run at the observed worst block's group
        # count (<= cap always, so the second pass cannot overflow)
        budget = min(cap, -(-max_ng // 128) * 128)
        parts, max_ng = run_blocks(budget)
        assert max_ng <= budget
    gk_all = jnp.concatenate([p[0] for p in parts])
    s_all = jnp.concatenate([p[1] for p in parts])
    c_all = jnp.concatenate([p[2] for p in parts])
    N2 = gk_all.shape[0]
    k2, s2, c2 = _null_last_sort(gk_all, (s_all, c_all))
    gk2, (sums, cnts), _, g2 = _reduce_runs(
        k2.reshape(1, N2), (s2.reshape(1, N2), c2.reshape(1, N2))
    )
    return (g2[0], gk2.reshape(-1), sums.reshape(-1),
            cnts.reshape(-1).astype(jnp.int32))


def aggregate_join_result(res):
    """Hash aggregate over a JoinResult (BASELINE config 5: hash aggregate
    on join output): group matched rows by probe key, summing the matched
    build values.  Unmatched/padded slots are nulled out and ignored.

    In the distributed CPRA pipeline this runs per chip with NO cross-chip
    reduction: the owner exchange routes equal keys to one chip, so local
    group keys are globally disjoint (parallel/cpra.py).

    Requires match counts <= 1 (the aligned output); M:N rows go through
    ops/expand.py first and aggregate the expanded columns.  Like
    materialize(), this REFUSES duplicate-key builds instead of silently
    under-counting them (host-side check; res leaves must be concrete).
    """
    import numpy as np

    if (np.asarray(res.match_cnts) > 1).any():
        raise ValueError(
            "multi-match rows present; expand via ops/expand.py "
            "(materialize_expanded) and aggregate the expanded columns"
        )
    res = res.flat()  # hash_aggregate takes the 1-D padded layout
    matched = res.match_cnts == 1
    keys = jnp.where(matched, res.probe_keys, jnp.uint32(PAD_KEY))
    return hash_aggregate(keys, res.match_vals)

"""PHJ: radix-partitioned hash join, single device.

The reference's intended PHJ pipeline (phj.cpp:1646-1949, with the
commented-out build/probe phase at phj.cpp:1869-1924 restored): partition
both relations by the scrambled key, build per partition, probe per
partition.  No atomics, no barriers: phases are jit-compiled dataflow and
all offsets come from prefix sums.

Two engines, chosen by `JoinPlan.probe_impl`:

- "merge" (the default): partitioning is a full sort by the scrambled key,
  so each build key's tuples form one run and every probe key is matched
  by one binary search in the run-compacted build side
  (ops/merge_probe.py).
- "table": the padded layout of ops/partition.py or the radix pass of
  ops/radix_partition.py, probed tile by tile against a dense per-partition
  table (ops/probe.py).

Output contract (`JoinResult`): aligned to the padded probe layout, where
slot i carries (probe key, probe val, matched build val, match count).  For
unique build keys (the benchmark workloads: inner_tuples == inner_distinct,
write.cpp:1689) match count is 0/1 and the aligned form is the full join
result; `materialize` compacts it to contiguous rows (close_gaps analog,
npj.cpp:475-514).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.merge_probe import build_runs, merge_probe
from ..ops.partition import (
    PROBE_TILE_GROUP,
    build_dense_table_jnp,
    build_dense_table_sort_jnp,
    partition_padded_jnp,
    partition_padded_sort_jnp,
    pids_from_hk,
    tile_pids,
)
from ..ops.probe import probe_tiles_jnp
from ..utils.hashing import hashed_key, mod_inverse_u32
from .config import JoinPlan, plan_join


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class JoinResult:
    """Aligned join output.  The four padded columns share one shape:
    flat (cap,) or, from a chunk-sorted probe side (plan.probe_chunks >
    1), chunk-row 2-D (C, cap/C) -- whose row-major flattening IS the
    (cap,) padded layout (slot order identical).  Host consumers flatten
    with np.asarray(col).reshape(-1); device consumers that need 1-D
    call .flat()."""

    probe_keys: jnp.ndarray  # (cap,) or (C, cap/C) padded probe layout
    probe_vals: jnp.ndarray  # same shape
    match_vals: jnp.ndarray  # same shape; build val (max over matches)
    match_cnts: jnp.ndarray  # same shape; number of build matches
    build_counts: jnp.ndarray  # (P,) build partition occupancy

    def tree_flatten(self):
        return (
            (self.probe_keys, self.probe_vals, self.match_vals,
             self.match_cnts, self.build_counts),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def flat(self) -> "JoinResult":
        """This result with 1-D (cap,) padded columns (a no-op for flat
        results).  Distributed steps call this before returning through
        shard_map out_specs, which shard leaf dim 0 and so expect the
        flat layout."""
        if self.probe_keys.ndim == 1:
            return self
        r = lambda x: x.reshape(-1)
        return JoinResult(
            r(self.probe_keys), r(self.probe_vals), r(self.match_vals),
            r(self.match_cnts), self.build_counts,
        )

    @property
    def join_tuples(self) -> jnp.ndarray:
        # u32 wraparound sum; exact below 2^32 output rows (per-shard counts
        # are combined hierarchically at larger scale)
        return jnp.sum(self.match_cnts.astype(jnp.uint32))


PROBE_IMPLS = ("merge", "table")


def phj_join(
    inner_keys: jnp.ndarray,
    inner_vals: jnp.ndarray,
    outer_keys: jnp.ndarray,
    outer_vals: jnp.ndarray,
    plan: JoinPlan,
) -> JoinResult:
    """Dispatch on the plan's probe mode: "merge" runs the sorted-search
    probe (no table, no padded layout); "table" the padded-partition
    path."""
    if plan.probe_impl == "merge":
        return phj_join_merge(inner_keys, inner_vals, outer_keys,
                              outer_vals, plan)
    if plan.probe_impl == "table":
        return _phj_join_padded(inner_keys, inner_vals, outer_keys,
                                outer_vals, plan)
    raise ValueError(
        f"probe_impl must be one of {PROBE_IMPLS}, got {plan.probe_impl!r}"
    )


def merge_cap(plan: JoinPlan, no: int) -> int:
    """Padded probe capacity of the merge pipeline: a multiple of
    tile * probe_chunks, so chunk rows have equal length."""
    quantum = plan.tile * max(1, plan.probe_chunks)
    return -(-no // quantum) * quantum


def _pad_pair(hk, vals, pad_to):
    """Zero-pad both columns to pad_to (the null-key pad convention)."""
    hk_p = jnp.concatenate([hk, jnp.zeros(pad_to - hk.shape[0], jnp.uint32)])
    v_p = jnp.concatenate(
        [vals, jnp.zeros(pad_to - vals.shape[0], jnp.uint32)]
    )
    return hk_p, v_p


def _merge_sort_side(hk, vals, pad_to):
    """Hash-order both columns with one key-value sort; null-key pads
    sort to the front and are masked everywhere downstream."""
    return jax.lax.sort(_pad_pair(hk, vals, pad_to), num_keys=1)


def _merge_sort_probe(hk, vals, pad_to, chunks: int):
    """Probe-side ordering: chunks <= 1 is the global 1-D sort;
    otherwise one batched sort over (chunks, pad_to/chunks) rows, each
    chunk independently hash-ordered, returned in that 2-D form."""
    if chunks <= 1:
        return _merge_sort_side(hk, vals, pad_to)
    hk_p, v_p = _pad_pair(hk, vals, pad_to)
    return jax.lax.sort((hk_p.reshape(chunks, -1), v_p.reshape(chunks, -1)),
                        dimension=1, num_keys=1)


def _merge_build(inner_keys, inner_vals, plan: JoinPlan):
    """Build side of the merge pipeline: (runs, violations).

    runs is the (run_hk, run_cnt, run_val) triple merge_probe searches.
    With plan.unique_build the sorted build side is used as it stands (one
    run per tuple); violations then counts adjacent equal build keys, a
    wrong declaration that the drivers answer with downgrade_plan_opts.
    Otherwise the runs are compacted (exact for duplicate keys) and
    violations is 0."""
    ni = inner_keys.shape[0]
    bhk, bval = _merge_sort_side(hashed_key(inner_keys, plan.factor),
                                 inner_vals, max(ni, 1))
    if plan.unique_build:
        viol = jnp.sum(((bhk[1:] == bhk[:-1]) & (bhk[1:] != 0))
                       .astype(jnp.int32))
        return (bhk, jnp.ones(bhk.shape, jnp.int32), bval), viol
    return build_runs(bhk, bval), jnp.zeros((), jnp.int32)


def _merge_probe(runs, viol, ohk_s, ov_s, plan: JoinPlan) -> JoinResult:
    mv, mc = merge_probe(ohk_s, *runs)
    inv = jnp.uint32(mod_inverse_u32(plan.factor))
    # build_counts in merge mode: [0, 0, plan-optimization violation
    # count].  The first two entries are kept at zero so every consumer
    # reads the same three-entry layout; a nonzero third entry means the
    # unique_build declaration was wrong and the caller re-runs with
    # downgrade_plan_opts.
    zero = jnp.zeros((), jnp.int32)
    stats = jnp.stack([zero, zero, viol.astype(jnp.int32)])
    return JoinResult(ohk_s * inv, ov_s, mv, mc, stats)


@functools.partial(jax.jit, static_argnames=("plan",))
def phj_join_merge(
    inner_keys: jnp.ndarray,
    inner_vals: jnp.ndarray,
    outer_keys: jnp.ndarray,
    outer_vals: jnp.ndarray,
    plan: JoinPlan,
) -> JoinResult:
    """PHJ, merge mode: partition == sort, probe == sorted search.

    Both relations are ordered by the scrambled key; each probe key's
    matches are one run of the build side, found by binary search
    (ops/merge_probe.py) -- no dense table, no padded scatter.
    build_counts carries [0, 0, unique_build violation count].
    """
    runs, viol = _merge_build(inner_keys, inner_vals, plan)
    ohk_s, ov_s = _merge_sort_probe(
        hashed_key(outer_keys, plan.factor), outer_vals,
        merge_cap(plan, outer_keys.shape[0]), max(1, plan.probe_chunks),
    )
    return _merge_probe(runs, viol, ohk_s, ov_s, plan)


@functools.lru_cache(maxsize=32)
def _staged_fns(plan: JoinPlan):
    """Stage jits cached per plan so repeated staged runs don't
    recompile (fresh jit objects would).  Returns (build, sort_probe,
    probe): build(ik, iv) -> (runs, violations); sort_probe(ok, ov, cap)
    -> hash-ordered probe columns; probe(runs, violations, ohk_s, ov_s)
    -> JoinResult."""
    chunks = max(1, plan.probe_chunks)
    build = jax.jit(lambda k, v: _merge_build(k, v, plan))
    sort_probe = jax.jit(
        lambda k, v, cap: _merge_sort_probe(hashed_key(k, plan.factor), v,
                                            cap, chunks),
        static_argnums=(2,),
    )
    probe = jax.jit(lambda runs, viol, o, v: _merge_probe(runs, viol, o, v,
                                                          plan))
    return build, sort_probe, probe


def phj_join_merge_staged(inner_keys, inner_vals, outer_keys, outer_vals,
                          plan: JoinPlan, timer) -> JoinResult:
    """The merge pipeline as three separately-jitted, separately-timed
    stages (partition_build / partition_probe / probe) -- the TIMELOG
    analog (phj.cpp:1712-1927): phase boundaries land in timer.timeline,
    per-phase seconds in timer.phases.  Slightly slower than the fused
    `phj_join_merge` (stage boundaries materialize to device memory)."""
    build, sort_probe, probe = _staged_fns(plan)
    runs, viol = timer.run("partition_build", build, inner_keys, inner_vals)
    ohk_s, ov_s = timer.run("partition_probe", sort_probe, outer_keys,
                            outer_vals, merge_cap(plan, len(outer_keys)))
    return timer.run("probe", probe, runs, viol, ohk_s, ov_s)


@functools.partial(jax.jit, static_argnames=("plan",))
def _phj_join_padded(
    inner_keys: jnp.ndarray,
    inner_vals: jnp.ndarray,
    outer_keys: jnp.ndarray,
    outer_vals: jnp.ndarray,
    plan: JoinPlan,
) -> JoinResult:
    P = plan.num_partitions
    if plan.partition_impl == "radix":
        return _phj_join_padded_radix(inner_keys, inner_vals, outer_keys,
                                      outer_vals, plan)
    # PAD_KEY (0) is the reserved null key: tuples carrying it are padding
    # from upstream stages (exchange buckets, padded layouts) and are dropped
    # on both sides by routing them to the out-of-range partition.
    # build side: partition + dense pack (K1/K3 analog)
    build_table = (
        build_dense_table_sort_jnp
        if plan.partition_impl == "sort"
        else build_dense_table_jnp
    )
    partition = (
        partition_padded_sort_jnp
        if plan.partition_impl == "sort"
        else partition_padded_jnp
    )
    # The engine runs on SCRAMBLED keys: hk = key * factor is a bijection on
    # u32 (odd factor), equality-preserving and pid-extractable by shift, so
    # sorts carry one fewer payload column and keys are recovered at the end
    # with one multiply by the modular inverse.  hk == 0 iff key == 0, so the
    # null-key convention carries over unchanged.
    ihk = hashed_key(inner_keys, plan.factor)
    ohk = hashed_key(outer_keys, plan.factor)
    ipid = pids_from_hk(ihk, plan.p_bits, plan.skip_bits, null_pid=P)
    tk, tv, bcounts = build_table(ihk, inner_vals, ipid, P, plan.slots)
    # probe side: partition into the padded layout (K6/K7/K9 analog)
    opid = pids_from_hk(ohk, plan.p_bits, plan.skip_bits, null_pid=P)
    pk, pv, offsets, _ = partition(ohk, outer_vals, opid, P, plan.tile)
    n_tiles = pk.shape[0] // plan.tile
    tpid = tile_pids(offsets, n_tiles, plan.tile)
    # probe (K2/K4 analog)
    mv, mc = probe_tiles_jnp(
        pk, tk, tv, bcounts, tpid, plan.tile, group=PROBE_TILE_GROUP
    )
    # unscramble probe keys for the output contract (one elementwise pass)
    inv = jnp.uint32(mod_inverse_u32(plan.factor))
    return JoinResult(pk * inv, pv, mv, mc, bcounts)


def _phj_join_padded_radix(inner_keys, inner_vals, outer_keys, outer_vals,
                           plan: JoinPlan):
    """Padded PHJ whose build table comes from the MULTI-PASS radix
    partitioner: the translation of the reference's local pass loop
    (phj.cpp:1791-1863), consuming `plan.pass_bits` pass by pass.

    The build regions ARE the dense table (zero-padded, every probe
    masks null keys), at least plan.slots wide; the probe side takes the
    exact padded layout with a 128-slot tile, so skewed probe keys can
    never overflow.

    build_counts carries P+1 entries: per-partition counts plus the
    summed pass overflow count as the LAST entry (overflows are values).
    """
    from ..ops.radix_partition import multipass_partition

    P = plan.num_partitions
    if sum(plan.pass_bits) != plan.p_bits:
        raise ValueError(
            "radix mode consumes pass_bits; their sum must equal p_bits "
            f"(got {plan.pass_bits} for p_bits={plan.p_bits})"
        )
    ihk = hashed_key(inner_keys, plan.factor)
    ohk = hashed_key(outer_keys, plan.factor)
    tk, tv, bcounts, bovf = multipass_partition(
        ihk, inner_vals, plan.pass_bits, plan.skip_bits, min_cap=plan.slots
    )
    slots = tk.shape[0] // P
    opid = pids_from_hk(ohk, plan.p_bits, plan.skip_bits, null_pid=P)
    pk, pv, offsets, _ = partition_padded_sort_jnp(ohk, outer_vals, opid,
                                                   P, 128)
    n_tiles = pk.shape[0] // 128
    tpid = tile_pids(offsets, n_tiles, 128)
    mv, mc = probe_tiles_jnp(
        pk, tk.reshape(P, slots), tv.reshape(P, slots),
        jnp.full(P, slots, jnp.int32), tpid, 128, group=PROBE_TILE_GROUP,
    )
    inv = jnp.uint32(mod_inverse_u32(plan.factor))
    counts_plus = jnp.concatenate(
        [bcounts.astype(jnp.int32), bovf[None].astype(jnp.int32)]
    )
    return JoinResult(pk * inv, pv, mv, mc, counts_plus)


def downgrade_plan_opts(plan: JoinPlan) -> JoinPlan:
    """Re-plan response to a counted plan-optimization violation
    (build_counts[2] in merge mode): drop the unique_build declaration,
    which duplicate build keys proved wrong.  Geometry is untouched, so
    spill fingerprints and chunk layouts stay valid.  Shared by every
    merge-mode retry loop."""
    return dataclasses.replace(plan, unique_build=False)


def join(
    inner_keys, inner_vals, outer_keys, outer_vals,
    plan: JoinPlan | None = None,
) -> tuple[JoinResult, JoinPlan]:
    """Join through the plan's engine and check its overflow values.

    Merge mode: a counted unique_build violation (build_counts[2])
    re-runs once with the declaration dropped (downgrade_plan_opts).
    Table mode: a table-slot or radix-pass overflow raises -- dropped
    tuples are corruption, not a result (callers wanting the raw
    overflow VALUE use phj_join directly).
    """
    if plan is None:
        plan = plan_join(len(inner_keys), len(outer_keys))
    args = (
        jnp.asarray(inner_keys),
        jnp.asarray(inner_vals),
        jnp.asarray(outer_keys),
        jnp.asarray(outer_vals),
    )
    res = phj_join(*args, plan)
    if plan.probe_impl == "merge":
        if int(res.build_counts[2]) != 0:
            res = None  # free the failed attempt's buffers first
            plan = downgrade_plan_opts(plan)
            res = phj_join(*args, plan)
        return res, plan
    bc = np.asarray(res.build_counts)
    over = (int(bc[-1]) != 0 if plan.partition_impl == "radix"
            else bool((bc > plan.slots).any()))
    if over:
        raise RuntimeError(
            "local join overflow on the padded path (table slots or "
            "radix pass capacity exceeded): raise plan.slots or the "
            "pass fanout"
        )
    return res, plan


def materialize(res: JoinResult) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compact matched rows to (keys, vals, tabs) host arrays.

    Requires match counts <= 1 (unique build keys); for duplicate-key
    builds use materialize_expanded.  Host-side compaction: the aligned
    device result is the deliverable, this is the close_gaps-equivalent
    final packing.
    """
    mc = np.asarray(res.match_cnts)
    if mc.max(initial=0) > 1:
        raise ValueError(
            "multi-match rows present; use materialize_expanded"
        )
    m = mc == 1
    return (
        np.asarray(res.probe_keys)[m],
        np.asarray(res.probe_vals)[m],
        np.asarray(res.match_vals)[m],
    )


def materialize_expanded(res: JoinResult, inner_keys, inner_vals,
                         block_rows: int = 0):
    """Full M:N materialization: every (probe row, matching build row)
    pair, for builds with duplicate keys.

    The aligned result carries per-probe match COUNTS (exact even for
    M:N); the cross-product rows are produced by the expansion op
    (ops/expand.py) over the matched probe rows vs the build relation.
    Returns (keys, vals, tabs) host arrays of exactly sum(match_cnts)
    rows.

    block_rows > 0 streams the expansion through fixed-size device
    blocks instead of one total-sized buffer: matched probe rows are
    grouped so each block's output fits `block_rows` (auto-raised to the
    largest single-row multiplicity), every block reuses ONE compiled
    expansion (fixed shapes), and outputs concatenate host-side -- the
    out-of-core form for expansions larger than device memory.
    """
    from ..ops.expand import expand_join

    mc = np.asarray(res.match_cnts).reshape(-1)
    total = int(mc.astype(np.int64).sum())
    if total == 0:
        e = np.zeros(0, np.uint32)
        return e, e.copy(), e.copy()
    m = mc > 0
    pk_np = np.asarray(res.probe_keys).reshape(-1)[m]
    pv_np = np.asarray(res.probe_vals).reshape(-1)[m]
    ik = jnp.asarray(inner_keys)
    iv = jnp.asarray(inner_vals)
    if not block_rows or total <= block_rows:
        cap = -(-total // 128) * 128
        got, out_k, out_v, out_t = expand_join(
            ik, iv, jnp.asarray(pk_np), jnp.asarray(pv_np), cap
        )
        assert int(got) == total, (int(got), total)
        return (
            np.asarray(out_k)[:total],
            np.asarray(out_v)[:total],
            np.asarray(out_t)[:total],
        )
    counts = mc[m].astype(np.int64)
    block_rows = max(block_rows, int(counts.max()))
    cap = -(-block_rows // 128) * 128
    # greedy block split (shared with the streamed device-side M:N
    # aggregate): consecutive matched rows until the block's output
    # would exceed block_rows
    from ..ops.expand import greedy_blocks

    outs_k, outs_v, outs_t = [], [], []
    for start, stop, blk_total in greedy_blocks(counts, block_rows):
        n_rows = stop - start
        # pad the probe block to the block row capacity: one compiled
        # expansion serves every block
        pk_b = np.zeros(cap, np.uint32)
        pv_b = np.zeros(cap, np.uint32)
        pk_b[:n_rows] = pk_np[start:stop]
        pv_b[:n_rows] = pv_np[start:stop]
        got, out_k, out_v, out_t = expand_join(
            ik, iv, jnp.asarray(pk_b), jnp.asarray(pv_b), cap
        )
        assert int(got) == blk_total, (int(got), blk_total)
        outs_k.append(np.asarray(out_k)[:blk_total])
        outs_v.append(np.asarray(out_v)[:blk_total])
        outs_t.append(np.asarray(out_t)[:blk_total])
    return (
        np.concatenate(outs_k),
        np.concatenate(outs_v),
        np.concatenate(outs_t),
    )

"""Radix/hash partitioning operators (device side).

The reference's histogram -> interleave -> scatter pipeline (K6/K7/K9,
phj.cpp:693-1231): partition ids are high-bit groups of one
multiplicatively scrambled key, partitions are laid out contiguously with
per-partition regions padded to a tile quantum, and all "atomic cursor"
machinery (npj.cpp:244) is replaced by exact prefix-sum offsets, which make
the layout fully deterministic.

Two forms per operator: argsort-based (`partition_padded_jnp`,
`build_dense_table_jnp`, the reference's `-D_NO_VECTOR` analog, K5) and
one fused sort (`*_sort_jnp`).  The bounded-fanout radix pass with
equal-capacity regions is ops/radix_partition.py.

Layout produced for the probe side ("padded partition layout"):
  out[offsets[p] : offsets[p] + counts[p]]    = tuples of partition p
  out[offsets[p] + counts[p] : offsets[p+1]]  = padding (key = PAD_KEY)
with every region a multiple of `quantum` so probe tiles never straddle a
partition boundary.  offsets has P+1 entries; out capacity is the static
bound N + P*quantum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.hashing import hashed_key

PAD_KEY = jnp.uint32(0)  # generator never emits key 0 (write.cpp:1448-1451)


def pids_from_hk(
    hk: jnp.ndarray, p_bits: int, skip_bits: int = 0,
    null_pid: int | None = None,
) -> jnp.ndarray:
    """Partition id from PRE-SCRAMBLED keys: p_bits starting skip_bits
    below the top.  skip_bits > 0 is used by distributed stages whose
    owner routing already consumed the top bits (parallel/cpra.py).
    null_pid (usually P, one past the real range) routes the reserved
    null key hk == 0 out of partition 0 -- pass it whenever pads can be
    present (key 0 is the null key everywhere, CLAUDE.md)."""
    pid = ((hk << jnp.uint32(skip_bits)) >> (32 - p_bits)).astype(jnp.int32)
    if null_pid is not None:
        pid = jnp.where(hk != 0, pid, null_pid)
    return pid


def compute_pids(
    keys: jnp.ndarray, factor: int, p_bits: int, skip_bits: int = 0,
    null_pid: int | None = None,
) -> jnp.ndarray:
    """pids_from_hk over raw keys (scrambles with `factor` first)."""
    return pids_from_hk(hashed_key(keys, factor), p_bits, skip_bits,
                        null_pid)


PROBE_TILE_GROUP = 8  # probe scan batches this many tiles per step


def padded_capacity(n: int, num_partitions: int, quantum: int) -> int:
    cap = -(-n // quantum) * quantum + num_partitions * quantum
    align = PROBE_TILE_GROUP * quantum
    return -(-cap // align) * align


def partition_padded_jnp(
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    pids: jnp.ndarray,
    num_partitions: int,
    quantum: int,
):
    """Stable partition into the padded layout.

    Returns (out_keys, out_vals, offsets[P+1], counts[P]).
    """
    n = keys.shape[0]
    cap = padded_capacity(n, num_partitions, quantum)
    valid = (pids >= 0) & (pids < num_partitions)  # out-of-range pid == drop
    cpid = jnp.clip(pids, 0, num_partitions - 1)
    counts = jnp.bincount(
        jnp.where(valid, cpid, num_partitions), length=num_partitions
    ).astype(jnp.int32)
    padded = ((counts + quantum - 1) // quantum) * quantum
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(padded, dtype=jnp.int32)]
    )
    order = jnp.argsort(jnp.where(valid, cpid, num_partitions), stable=True)
    k_s = keys[order]
    v_s = vals[order]
    p_s = cpid[order]
    starts = jnp.cumsum(counts, dtype=jnp.int32) - counts  # exclusive scan
    rank = jnp.arange(n, dtype=jnp.int32) - starts[p_s]
    dest = jnp.where(valid[order], offsets[p_s] + rank, cap)
    out_k = jnp.full(cap, PAD_KEY, jnp.uint32).at[dest].set(k_s, mode="drop")
    out_v = jnp.zeros(cap, jnp.uint32).at[dest].set(v_s, mode="drop")
    return out_k, out_v, offsets, counts


def build_dense_table_jnp(
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    pids: jnp.ndarray,
    num_partitions: int,
    slots: int,
):
    """Build-side analog of K1/K3: a dense (P, slots) table, partition p's
    tuples packed into row p.  Overflowing tuples (count > slots) are dropped
    and reported via counts so the caller can re-plan (recursive split).

    Returns (table_keys (P,S), table_vals (P,S), counts (P,)).
    """
    n = keys.shape[0]
    valid = (pids >= 0) & (pids < num_partitions)  # out-of-range pid == drop
    cpid = jnp.clip(pids, 0, num_partitions - 1)
    counts = jnp.bincount(
        jnp.where(valid, cpid, num_partitions), length=num_partitions
    ).astype(jnp.int32)
    order = jnp.argsort(jnp.where(valid, cpid, num_partitions), stable=True)
    k_s = keys[order]
    v_s = vals[order]
    p_s = cpid[order]
    starts = jnp.cumsum(counts, dtype=jnp.int32) - counts
    rank = jnp.arange(n, dtype=jnp.int32) - starts[p_s]
    dest = p_s * slots + rank
    dest = jnp.where(
        (rank < slots) & valid[order], dest, num_partitions * slots
    )  # drop
    tk = (
        jnp.full(num_partitions * slots, PAD_KEY, jnp.uint32)
        .at[dest]
        .set(k_s, mode="drop")
        .reshape(num_partitions, slots)
    )
    tv = (
        jnp.zeros(num_partitions * slots, jnp.uint32)
        .at[dest]
        .set(v_s, mode="drop")
        .reshape(num_partitions, slots)
    )
    return tk, tv, counts


def _sorted_rank_and_starts(pid_s: jnp.ndarray):
    """Per-element within-run rank for a pid-sorted stream, gather-free:
    run starts by neighbor compare, positions by cummax."""
    n = pid_s.shape[0]
    j = jnp.arange(n, dtype=jnp.int32)
    newrun = jnp.concatenate(
        [jnp.ones(1, bool), pid_s[1:] != pid_s[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(newrun, j, 0))
    return j, newrun, run_start, j - run_start


def partition_padded_sort_jnp(
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    pids: jnp.ndarray,
    num_partitions: int,
    quantum: int,
):
    """partition_padded via ONE fused multi-operand sort.

    Payloads ride the sort (lax.sort carries operands with the key), and
    rank/gap-shift are computed from the sorted pid stream with pure vector
    ops (run-start cummax, boundary-gap cumsum) -- no 10^8-element gathers.
    The only remaining scatter is the final placement with monotone unique
    destinations.  Semantics identical to partition_padded_jnp (tested).
    """
    n = keys.shape[0]
    P = num_partitions
    cap = padded_capacity(n, P, quantum)
    valid = (pids >= 0) & (pids < P)
    spid = jnp.where(valid, jnp.clip(pids, 0, P - 1), P).astype(jnp.int32)
    pid_s, k_s, v_s = jax.lax.sort((spid, keys, vals), num_keys=1,
                                   is_stable=True)
    j, newrun, run_start, rank = _sorted_rank_and_starts(pid_s)
    # gap inserted when the PREVIOUS run closes: pad its length to quantum
    rs_prev = jnp.concatenate([jnp.zeros(1, jnp.int32), run_start[:-1]])
    prev_len = j - rs_prev
    boundary_gap = jnp.where(
        newrun & (j > 0), (-prev_len) % quantum, 0
    ).astype(jnp.int32)
    dest = j + jnp.cumsum(boundary_gap, dtype=jnp.int32)
    dest = jnp.where(pid_s < P, dest, cap)  # invalid pids sort last: drop
    out_k = jnp.full(cap, PAD_KEY, jnp.uint32).at[dest].set(k_s, mode="drop")
    out_v = jnp.zeros(cap, jnp.uint32).at[dest].set(v_s, mode="drop")
    bounds = jnp.searchsorted(
        pid_s, jnp.arange(P + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    counts = bounds[1:] - bounds[:-1]
    padded = ((counts + quantum - 1) // quantum) * quantum
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(padded, dtype=jnp.int32)]
    )
    return out_k, out_v, offsets, counts


def build_dense_table_sort_jnp(
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    pids: jnp.ndarray,
    num_partitions: int,
    slots: int,
):
    """build_dense_table via one fused sort + gather-free ranks."""
    P = num_partitions
    valid = (pids >= 0) & (pids < P)
    spid = jnp.where(valid, jnp.clip(pids, 0, P - 1), P).astype(jnp.int32)
    pid_s, k_s, v_s = jax.lax.sort((spid, keys, vals), num_keys=1,
                                   is_stable=True)
    _, _, _, rank = _sorted_rank_and_starts(pid_s)
    dest = jnp.where(
        (pid_s < P) & (rank < slots), pid_s * slots + rank, P * slots
    )
    tk = (
        jnp.full(P * slots, PAD_KEY, jnp.uint32)
        .at[dest]
        .set(k_s, mode="drop")
        .reshape(P, slots)
    )
    tv = (
        jnp.zeros(P * slots, jnp.uint32)
        .at[dest]
        .set(v_s, mode="drop")
        .reshape(P, slots)
    )
    bounds = jnp.searchsorted(
        pid_s, jnp.arange(P + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    counts = bounds[1:] - bounds[:-1]
    return tk, tv, counts


def tile_pids(offsets: jnp.ndarray, n_tiles: int, tile: int) -> jnp.ndarray:
    """Partition id owning each probe tile (regions are quantum-aligned, so
    ownership is unique).  Trailing unused tiles map to the last partition,
    whose padding keys make them no-ops."""
    starts = jnp.arange(n_tiles, dtype=jnp.int32) * tile
    pid = jnp.searchsorted(offsets, starts, side="right") - 1
    return jnp.clip(pid, 0, offsets.shape[0] - 2).astype(jnp.int32)

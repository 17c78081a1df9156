"""Join plans: the runtime knob set (SURVEY.md section 5 config row).

The reference's compile-time -D flags and hardcoded constants (load factors,
NUM_PARTITIONS=4096, buffer/block sizes; npj.cpp:944-947, phj.cpp:1976-1979,
cpra2.cpp:2023-2034) become one frozen dataclass chosen at trace time.  The
pass/fanout policy mirrors phj.cpp:1791-1808 (enough passes that the last
level is cache resident).
"""

from __future__ import annotations

import dataclasses


DEFAULT_FACTOR = 0x9E3779B1  # odd golden-ratio factor; any odd u32 works


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    p_bits: int  # total partition bits; fanout P = 2^p_bits
    slots: int  # build-table slots per partition (one table row)
    tile: int  # probe tile = probe-side pad quantum
    factor: int = DEFAULT_FACTOR
    # per-pass radix bits; consumed by partition_impl="radix" (the multi-
    # pass radix partitioner, phj.cpp:1791-1863 analog); must sum to
    # p_bits.  The "sort" modes ignore it (one fused sort IS all passes).
    pass_bits: tuple = ()
    skip_bits: int = 0  # hash bits already consumed by upstream routing
    # table mode's partitioner: "sort" (fused lax.sort) | "argsort"
    # (oracle) | "radix" (multi-pass histogram+scatter driven by pass_bits)
    partition_impl: str = "sort"
    # "merge" (sorted-search probe, flagship) | "table" (padded-partition
    # table probe)
    probe_impl: str = "merge"
    # declare the build keys unique (the reference's -D_UNIQUE mode,
    # npj.cpp:954-956): merge mode then searches the sorted build side as
    # it stands instead of compacting equal-key runs.  VALIDATED at
    # runtime: adjacent equal build keys are counted into
    # build_counts[2] and join() downgrades the flag, so a wrong
    # declaration can never return silently wrong results.
    unique_build: bool = False
    # merge mode: sort the probe side as this many INDEPENDENT chunks
    # (one batched 2-D sort) instead of one global 1-D sort.  0/1 = one
    # global sort, which plan_join always picks (PERF.md).
    probe_chunks: int = 0

    @property
    def num_partitions(self) -> int:
        return 1 << self.p_bits


def reference_pass_plan(local_tuples: int,
                        hash_table_limit: int = 6400) -> tuple:
    """The reference's exact multi-pass policy (phj.cpp:1791-1808):
    partitions = local_tuples / hash_table_limit; passes by thresholds
    {10, 400, 20000, 1e6}; per-pass fanout = partitions^(1/passes) with
    the LAST pass absorbing the integer-rounding remainder.  Returned as
    a tuple of per-pass fanouts (empty when partitions <= 10 -- the
    reference then relies on the shared inter-thread pass).

    Kept for parity/planning comparisons; the engine's own plans derive
    pass bits from the partition occupancy instead (plan_join)."""
    partitions = local_tuples // hash_table_limit
    if partitions > 1_000_000:
        passes = 4
    elif partitions > 20_000:
        passes = 3
    elif partitions > 400:
        passes = 2
    elif partitions > 10:
        passes = 1
    else:
        return ()
    fanout = [int(partitions ** (1.0 / passes))] * passes
    product = 1
    for f in fanout[:-1]:
        product *= f
    fanout[-1] = partitions // product
    return tuple(fanout)


def plan_join(inner_n: int, outer_n: int, tile: int | None = None,
              probe_chunks: int = 0) -> JoinPlan:
    """Pick a plan: build rows ~half full at the chosen fanout, probe
    partitions a small multiple of the tile so padding waste stays low.
    The merge engine sorts the probe side globally: on the H100 the 1-D
    key-value sort of 256M rows beat the batched 64-chunk sort by 3.4x
    (PERF.md), so nothing chunks unless a caller asks.
    """
    if tile is None:
        tile = 2048
    p_bits = 1
    # target mean build-partition occupancy <= 128 and mean probe partition
    # >= 2 tiles (bounds padding waste at ~25% worst case)
    while (inner_n >> p_bits) > 128 and (outer_n >> p_bits) >= 2 * tile:
        p_bits += 1
    mean_build = max(1, inner_n >> p_bits)
    slots = 1
    while slots < mean_build * 3 or slots < 64:
        slots *= 2
    # split total bits into passes of at most 8 bits
    remaining, passes = p_bits, []
    while remaining > 0:
        b = min(8, remaining)
        passes.append(b)
        remaining -= b
    return JoinPlan(p_bits=p_bits, slots=slots, tile=tile,
                    pass_bits=tuple(passes), probe_chunks=probe_chunks)

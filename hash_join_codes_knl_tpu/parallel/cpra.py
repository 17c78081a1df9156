"""CPRA: partition-aware join with cross-worker re-aggregation, multi-chip.

The reference CPRA pipeline (cpra2.cpp:1697-1986): the reference's threads
each radix-partition their local slice, then re-aggregate partition
fragments across threads by memcpy into contiguous repositories
(cpra2.cpp:1883-1906) before partition-parallel build/probe.  On a device
mesh, "thread" becomes "device", and the memcpy re-aggregation becomes a
single `all_to_all`: each device packs its tuples into per-owner
buckets (owner = top log2(C) bits of the hashed key), the collective delivers
every chip its owned fragments, and the local PHJ engine joins them.
Barriers are implicit in SPMD program order; the atomic fragment cursors
become prefix-sum packing (ops/partition.py).

The pack uses fixed-size per-owner buckets (collectives need static shapes);
bucket capacity is a planning knob -- `exchange_cap` tuples per (src, dst)
pair -- and overflow is detected and reported rather than silently dropped.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.config import JoinPlan, plan_join
from ..engine.phj import JoinResult, phj_join
from ..ops.partition import build_dense_table_sort_jnp
from ..utils.hashing import hash_ratio, hashed_key


def pack_by_owner(keys, vals, owner, n_owners: int, cap: int):
    """Pack tuples into (n_owners, cap) padded buckets; returns
    (bucket_keys, bucket_vals, counts).  counts may exceed cap: that is the
    overflow signal (tuples beyond cap are dropped from the buckets).

    This is exactly the dense-table pack with slots=cap (one fused sort +
    gather-free ranks, ops/partition.py)."""
    bk, bv, counts = build_dense_table_sort_jnp(keys, vals, owner, n_owners,
                                                cap)
    return bk, bv, counts


def _check_tier_plan(use_tiers: bool, plan: JoinPlan) -> None:
    """Tier routing requires a merge-mode local plan: the tier level is
    a RANGE hash of the factor-1 scramble (hash_ratio: mulhi32(hk, 100)
    vs cut), so each chip receives keys whose factor-1 hk is confined
    to its tier's slice of the u32 line -- a padded local join
    partitioning on the TOP factor-1 bits would be skewed into
    guaranteed slot overflow.  The merge engine sorts the full range
    and is insensitive to that compression; refuse loudly."""
    if use_tiers and plan.probe_impl != "merge":
        raise ValueError(
            "tier_ratio requires a merge-mode local plan: tier routing "
            "compresses each chip's factor-1 hash range, skewing padded "
            "top-bits partitioning -- use probe_impl='merge'"
        )


def pack_by_owner_radix(keys, vals, factor: int, c_bits: int,
                        cap: int = 0):
    """Owner pack through ONE radix pass (ops/radix_partition.py).

    Owner device = top c_bits of hk = key*factor, exactly the pass's own
    partition function, so the pass IS the pack.  Buckets come back
    zero-padded (every consumer masks null keys), carrying hk -- the
    caller multiplies by the modular inverse after the exchange to
    restore raw keys.  `cap` is the per-owner bucket capacity in tuples
    (the exchange-planning knob, rounded up to the pass's 128-row
    quantum; 0 = the pass's own estimate), so cap-based memory planning
    applies to this pack exactly as to the sort pack -- overflow beyond
    it is the returned signal, never silent.  Returns
    (bucket_hk (C*capr,), bucket_vals, counts (C,), overflow)."""
    from ..ops.radix_partition import radix_partition

    hk = hashed_key(keys, factor)
    return radix_partition(hk, vals, c_bits, cap=cap)


def _engine_overflow(res, local_plan):
    """The local join engine's own overflow signal as a COUNT (0 = clean).

    merge mode: the unique_build violation count (build_counts[2]),
    fixed by downgrade_plan_opts;
    padded radix mode: the multipass pass-overflow count appended as the
    LAST build_counts entry -- the per-partition counts there are
    measured against the pass's own region capacity, NOT plan.slots;
    padded sort mode: number of partitions past `slots` (dropped tuples).
    """
    if local_plan.probe_impl == "merge":
        return res.build_counts[2]
    if local_plan.partition_impl == "radix":
        return res.build_counts[-1]
    return jnp.sum((res.build_counts > local_plan.slots).astype(jnp.int32))


def _owner_bits(n_chips: int) -> int:
    bits = (n_chips - 1).bit_length()
    if 1 << bits != n_chips:
        raise ValueError(f"chip count must be a power of two, got {n_chips}")
    return bits


def _make_owner_of(plan: JoinPlan, n_chips: int, c_bits: int,
                   tier_ratio: float | None = None):
    """Owner-chip routing: top c_bits of the scrambled key, or the
    two-level tier hash when tier_ratio is set (simd_hash_ratio analog).
    Null keys route to the out-of-range owner (dropped by the pack)."""
    use_tiers = tier_ratio is not None and n_chips >= 2

    def owner_of(keys):
        if use_tiers:
            own = hash_ratio(
                keys, plan.factor, n_chips, tier_ratio
            ).astype(jnp.int32)
        elif c_bits == 0:
            own = jnp.zeros(keys.shape, jnp.int32)
        else:
            own = (
                hashed_key(keys, plan.factor) >> (32 - c_bits)
            ).astype(jnp.int32)
        return jnp.where(keys != 0, own, n_chips)

    return owner_of


def make_cpra_step(
    mesh: Mesh,
    plan: JoinPlan,
    inner_cap: int,
    outer_cap: int,
    axis: str = "x",
    skew: bool = False,
    heavy_k_max: int = 8,
    heavy_sample: int = 65536,
    heavy_frac: float = 1 / 256,
    heavy_build_cap: int = 256,
    tier_ratio: float | None = None,
    pack_impl: str = "sort",
):
    """Build the jitted distributed join step for `mesh`.

    inner_cap/outer_cap: per-(src,dst) exchange bucket capacities in tuples.
    tier_ratio: when set (and the mesh has >= 2 chips), tuples are routed
    with the reference's two-level tier hash (simd_hash_ratio,
    phj.cpp:101-116): a 100-bin hash splits traffic between the two mesh
    halves at cut=(1-ratio)*100 -- the DDR/MCDRAM placement knob
    re-expressed as a device-group placement policy (SURVEY.md K13 row) --
    then a second hash picks the chip within the half.
    pack_impl: "sort" (fused-sort pack into inner_cap/outer_cap buckets)
    or "radix" (ONE radix pass as the pack, ops/radix_partition.py;
    inner_cap/outer_cap bound its buckets too, rounded to the pass's
    128-row quantum; zero-padded buckets carry hk and keys are
    restored after the exchange).  Tier routing requires "sort" (the
    tier hash is not a top-bits partition).
    Returns fn(ik, iv, ok, ov) -> (JoinResult, heavy, diag): inputs
    sharded along `axis`, result leaves chip-local (the aligned join output
    never needs to be gathered).  diag is a replicated (3,) int32 vector
    [exchange-cap overflow count, engine overflow count (unique_build
    violations or table overflow, _engine_overflow), heavy-build-cap
    overflow count] -- the overflow sources are reported separately
    because their fixes differ (more exchange slack vs a plan downgrade
    vs a larger heavy_build_cap).  With skew=True, `heavy` is the local-heavy
    row set (probe_vals, match_vals, match_cnts aligned to the local probe
    shard + its keys) produced by heavy-hitter replication (parallel/skew.py);
    otherwise it is None.
    """
    from . import skew as skew_ops

    n_chips = mesh.shape[axis]
    c_bits = _owner_bits(n_chips)
    if pack_impl not in ("sort", "radix"):
        # an unrecognized string must not silently run the sort pack
        raise ValueError(
            f"pack_impl must be 'sort' or 'radix', got {pack_impl!r}"
        )
    use_tiers = tier_ratio is not None and n_chips >= 2
    if pack_impl == "radix" and use_tiers:
        # the radix pass routes by top hash bits; the tier hash is a
        # two-level 100-bin split that no bit prefix expresses.  Refuse
        # loudly instead of silently falling back to the sort pack.
        raise ValueError(
            "pack_impl='radix' is incompatible with tier_ratio: the "
            "tier hash is not a top-bits partition -- use the sort pack "
            "for tiered placement"
        )
    _check_tier_plan(use_tiers, plan)
    # local partitioning consumes the hash bits BELOW the owner bits --
    # within one owner, the top c_bits are constant and carry no
    # information.  With tiers, owner routing is hash_ratio (tier range
    # cut + an independent factor2 within the half) rather than a bit
    # prefix, so no factor-1 bits are consumable as skip_bits; the local
    # plan must be merge mode (guard above), which never reads them.
    skip = plan.skip_bits if use_tiers else plan.skip_bits + c_bits
    local_plan = dataclasses.replace(plan, skip_bits=skip)

    def local_step(ik, iv, ok, ov):
        heavy = None
        overflow = jnp.zeros((), bool)
        heavy_ovf = jnp.zeros((), bool)
        if skew:
            nom = skew_ops.nominate_heavy(
                ok, heavy_sample, heavy_k_max, heavy_frac
            )
            heavy_keys = jax.lax.all_gather(nom, axis, tiled=True)
            i_heavy = skew_ops.is_member(ik, heavy_keys)
            o_heavy = skew_ops.is_member(ok, heavy_keys)
            hbk, hbv, hb_cnt = skew_ops.extract_rows(
                ik, iv, i_heavy, heavy_build_cap
            )
            rep_k = jax.lax.all_gather(hbk, axis, tiled=True)
            rep_v = jax.lax.all_gather(hbv, axis, tiled=True)
            h_mval, h_mcnt = skew_ops.probe_small_table(ok, rep_k, rep_v)
            # heavy probes never get a local match unless flagged heavy
            h_mcnt = jnp.where(o_heavy, h_mcnt, 0)
            h_mval = jnp.where(o_heavy, h_mval, jnp.uint32(0))
            heavy = (ok, ov, h_mval, h_mcnt)
            # its OWN diag entry: more exchange slack cannot fix a
            # truncated heavy-build extraction -- only a larger cap can
            heavy_ovf |= hb_cnt > heavy_build_cap
            ik = jnp.where(i_heavy, jnp.uint32(0), ik)
            ok = jnp.where(o_heavy, jnp.uint32(0), ok)
        # the re-aggregation memcpy (cpra2.cpp:1896-1904) as one collective
        a2a = functools.partial(
            jax.lax.all_to_all, axis_name=axis, split_axis=0, concat_axis=0,
            tiled=True,
        )
        if pack_impl == "radix" and not use_tiers and c_bits > 0:
            # one radix pass as the pack; buckets carry hk, zero-padded
            # at the pass's own capacity -- raw keys restored after the
            # exchange by the modular inverse
            bik, biv, icnt, iovf = pack_by_owner_radix(
                ik, iv, plan.factor, c_bits, cap=inner_cap)
            bok, bov, ocnt, oovf = pack_by_owner_radix(
                ok, ov, plan.factor, c_bits, cap=outer_cap)
            # two overflow layers: the pass's own capacity (tuples
            # dropped -- must retry) and the PLANNED caps (counts
            # exceeded the exchange budget; same signal as the sort
            # pack so cap-based planning stays honest across packs)
            overflow |= (iovf != 0) | (oovf != 0)
            overflow |= jnp.any(icnt > inner_cap) | jnp.any(ocnt > outer_cap)
            from ..utils.hashing import mod_inverse_u32

            inv = jnp.uint32(mod_inverse_u32(plan.factor))
            rik = a2a(bik.reshape(-1)) * inv
            riv = a2a(biv.reshape(-1))
            rok = a2a(bok.reshape(-1)) * inv
            rov = a2a(bov.reshape(-1))
        else:
            owner_of = _make_owner_of(plan, n_chips, c_bits, tier_ratio)
            i_owner = owner_of(ik)
            o_owner = owner_of(ok)
            bik, biv, icnt = pack_by_owner(ik, iv, i_owner, n_chips,
                                           inner_cap)
            bok, bov, ocnt = pack_by_owner(ok, ov, o_owner, n_chips,
                                           outer_cap)
            overflow |= jnp.any(icnt > inner_cap) | jnp.any(ocnt > outer_cap)
            rik, riv = a2a(bik.reshape(-1)), a2a(biv.reshape(-1))
            rok, rov = a2a(bok.reshape(-1)), a2a(bov.reshape(-1))
        # .flat(): out_specs shard leaf dim 0 of the flat padded layout
        res = phj_join(rik, riv, rok, rov, local_plan).flat()
        # diag = [exchange-cap overflow count, engine overflow count,
        # heavy-build-cap overflow count]: the overflow sources stay
        # SEPARATE so the caller can re-plan each correctly (exchange ->
        # more slack; engine -> downgrade_plan_opts or raise; heavy -> a
        # larger heavy_build_cap)
        diag = jnp.stack([
            jax.lax.psum(overflow.astype(jnp.int32), axis),
            jax.lax.psum(
                _engine_overflow(res, local_plan).astype(jnp.int32), axis
            ),
            jax.lax.psum(heavy_ovf.astype(jnp.int32), axis),
        ])
        return res, heavy, diag

    spec = P(axis)
    heavy_spec = (spec, spec, spec, spec) if skew else None
    shard_fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(
            JoinResult(spec, spec, spec, spec, spec),
            heavy_spec,
            P(),
        ),
        check_vma=False,
    )
    return jax.jit(shard_fn)


def make_cpra_steps_staged(
    mesh: Mesh,
    plan: JoinPlan,
    inner_cap: int,
    outer_cap: int,
    axis: str = "x",
    tier_ratio: float | None = None,
):
    """The CPRA pipeline as TWO separately-jitted stages for phase
    metering: `exchange` (owner pack + all_to_all -- the re-aggregation
    copy the reference times separately, cpra2.cpp:1895-1905, printed
    1983-1984) and `local_join` (the per-chip PHJ).  Same semantics as
    make_cpra_step without skew; used by `cli cpra --timelog`.

    Returns (exchange_fn, join_fn):
      exchange_fn(ik, iv, ok, ov) -> (rik, riv, rok, rov, overflow)
      join_fn(rik, riv, rok, rov) -> (JoinResult, overflow)
    """
    n_chips = mesh.shape[axis]
    c_bits = _owner_bits(n_chips)
    use_tiers = tier_ratio is not None and n_chips >= 2
    _check_tier_plan(use_tiers, plan)
    skip = plan.skip_bits if use_tiers else plan.skip_bits + c_bits
    local_plan = dataclasses.replace(plan, skip_bits=skip)

    def exchange(ik, iv, ok, ov):
        owner_of = _make_owner_of(plan, n_chips, c_bits, tier_ratio)
        bik, biv, icnt = pack_by_owner(ik, iv, owner_of(ik), n_chips,
                                       inner_cap)
        bok, bov, ocnt = pack_by_owner(ok, ov, owner_of(ok), n_chips,
                                       outer_cap)
        overflow = jnp.any(icnt > inner_cap) | jnp.any(ocnt > outer_cap)
        a2a = functools.partial(
            jax.lax.all_to_all, axis_name=axis, split_axis=0,
            concat_axis=0, tiled=True,
        )
        overflow = jax.lax.psum(overflow.astype(jnp.int32), axis) > 0
        return (a2a(bik.reshape(-1)), a2a(biv.reshape(-1)),
                a2a(bok.reshape(-1)), a2a(bov.reshape(-1)), overflow)

    def local_join(rik, riv, rok, rov):
        # .flat(): out_specs shard leaf dim 0 of the flat padded layout
        res = phj_join(rik, riv, rok, rov, local_plan).flat()
        overflow = _engine_overflow(res, local_plan) > 0
        overflow = jax.lax.psum(overflow.astype(jnp.int32), axis) > 0
        return res, overflow

    spec = P(axis)
    exchange_fn = jax.jit(
        jax.shard_map(
            exchange, mesh=mesh, in_specs=(spec,) * 4,
            out_specs=(spec, spec, spec, spec, P()), check_vma=False,
        )
    )
    join_fn = jax.jit(
        jax.shard_map(
            local_join, mesh=mesh, in_specs=(spec,) * 4,
            out_specs=(JoinResult(spec, spec, spec, spec, spec), P()),
            check_vma=False,
        )
    )
    return exchange_fn, join_fn


def make_cpra_step_pipelined(
    mesh: Mesh,
    plan: JoinPlan,
    inner_cap: int,
    outer_cap: int,
    chunks: int,
    axis: str = "x",
):
    """Chunked exchange/compute pipeline (BASELINE config 5: exchange
    overlapped with build/probe).

    The build side is exchanged and hash-ordered ONCE; the probe side is
    split into `chunks` static chunks, each packed + all_to_all'd +
    joined against the shared build order.  The chunk loop is UNROLLED in
    one jit so chunk k+1's exchange has no data dependence on chunk k's
    probe -- XLA's async-collective scheduler is free to run them
    concurrently (a lax.scan would serialize them).  Per-chunk results
    concatenate to the same padded layout as the unchunked step.

    Returns fn(ik, iv, ok, ov) -> (JoinResult, overflow flag).
    """
    from ..engine.phj import (
        _merge_build,
        _merge_probe,
        _merge_sort_side,
        downgrade_plan_opts,
        merge_cap,
    )
    from ..utils.hashing import hashed_key as hk_of

    n_chips = mesh.shape[axis]
    c_bits = _owner_bits(n_chips)
    # probe_chunks=1: each pipeline chunk's probe side is globally
    # hash-ordered below.  unique_build is dropped up front: this step
    # has no retry loop, so a counted violation would dead-end as an
    # unfixable overflow flag
    local_plan = downgrade_plan_opts(dataclasses.replace(
        plan, skip_bits=plan.skip_bits + c_bits, probe_chunks=1
    ))
    chunk_cap = -(-outer_cap // chunks)

    def local_step(ik, iv, ok, ov):
        owner_of = _make_owner_of(plan, n_chips, c_bits)
        a2a = functools.partial(
            jax.lax.all_to_all, axis_name=axis, split_axis=0, concat_axis=0,
            tiled=True,
        )
        # build side: exchange + hash-order once
        bik, biv, icnt = pack_by_owner(ik, iv, owner_of(ik), n_chips,
                                       inner_cap)
        overflow = jnp.any(icnt > inner_cap)
        rik, riv = a2a(bik.reshape(-1)), a2a(biv.reshape(-1))
        runs, viol = _merge_build(rik, riv, local_plan)
        cap = merge_cap(local_plan, n_chips * chunk_cap)
        # probe side: all exchanges are emitted before any probe consumes
        # them, leaving the scheduler free to overlap
        o_ch = ok.reshape(chunks, -1)
        v_ch = ov.reshape(chunks, -1)
        exchanged = []
        for c in range(chunks):
            bok, bov, ocnt = pack_by_owner(
                o_ch[c], v_ch[c], owner_of(o_ch[c]), n_chips, chunk_cap
            )
            overflow |= jnp.any(ocnt > chunk_cap)
            exchanged.append((a2a(bok.reshape(-1)), a2a(bov.reshape(-1))))
        parts = []
        for rok, rov in exchanged:
            ohk_s, ov_s = _merge_sort_side(
                hk_of(rok, local_plan.factor), rov, cap
            )
            parts.append(_merge_probe(runs, viol, ohk_s, ov_s, local_plan))
        res = JoinResult(
            *(jnp.concatenate([getattr(p, f) for p in parts])
              for f in ("probe_keys", "probe_vals", "match_vals",
                        "match_cnts", "build_counts"))
        )
        overflow = jax.lax.psum(overflow.astype(jnp.int32), axis) > 0
        return res, overflow

    spec = P(axis)
    return jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=(JoinResult(spec, spec, spec, spec, spec), P()),
            check_vma=False,
        )
    )


def make_cpra_step_2level(
    mesh: Mesh,
    plan: JoinPlan,
    inner_cap: int,
    outer_cap: int,
    host_axis: str = "h",
    chip_axis: str = "c",
):
    """Two-level exchange for multi-host meshes: hash bits route first to a
    HOST (one all_to_all over the host axis -- the cross-host hop, paid once),
    then to a CHIP within the host (one all_to_all over the chip axis --
    the within-host hop).  This is the reference's two-level placement
    (simd_hash_ratio routes tier-then-partition, phj.cpp:101-116)
    re-expressed as the per-host/per-chip partition map of SURVEY.md
    section 2.5; a flat exchange over H*C workers would instead push
    every misrouted tuple across hosts twice.

    inner_cap/outer_cap: per-(src,dst) bucket capacities used at BOTH
    levels.  Returns fn(ik, iv, ok, ov) sharded over (host, chip) ->
    (JoinResult, overflow flag).
    """
    H = mesh.shape[host_axis]
    C = mesh.shape[chip_axis]
    h_bits = _owner_bits(H)
    c_bits = _owner_bits(C)
    local_plan = dataclasses.replace(
        plan, skip_bits=plan.skip_bits + h_bits + c_bits
    )

    def local_step(ik, iv, ok, ov):
        overflow = jnp.zeros((), bool)

        def exchange(keys, vals, axis, n, bits, shift, cap):
            nonlocal overflow
            if bits == 0:
                return keys, vals
            own = (
                (hashed_key(keys, plan.factor) << jnp.uint32(shift))
                >> (32 - bits)
            ).astype(jnp.int32)
            own = jnp.where(keys != 0, own, n)
            bk, bv, cnt = pack_by_owner(keys, vals, own, n, cap)
            overflow |= jnp.any(cnt > cap)
            a2a = functools.partial(
                jax.lax.all_to_all, axis_name=axis, split_axis=0,
                concat_axis=0, tiled=True,
            )
            return a2a(bk.reshape(-1)), a2a(bv.reshape(-1))

        # level 1: route by the top h_bits across hosts
        ik, iv = exchange(ik, iv, host_axis, H, h_bits, 0, inner_cap)
        ok, ov = exchange(ok, ov, host_axis, H, h_bits, 0, outer_cap)
        # level 2: route by the next c_bits within the host
        ik, iv = exchange(ik, iv, chip_axis, C, c_bits, h_bits, inner_cap)
        ok, ov = exchange(ok, ov, chip_axis, C, c_bits, h_bits, outer_cap)
        # .flat(): out_specs shard leaf dim 0 of the flat padded layout
        res = phj_join(ik, iv, ok, ov, local_plan).flat()
        # engine overflow (unique_build violations / radix pass count /
        # table slots)
        # must surface here exactly as in make_cpra_step -- overflows are
        # values, never silent
        overflow |= _engine_overflow(res, local_plan) > 0
        overflow = (
            jax.lax.psum(
                jax.lax.psum(overflow.astype(jnp.int32), chip_axis),
                host_axis,
            )
            > 0
        )
        return res, overflow

    spec = P((host_axis, chip_axis))
    return jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=(JoinResult(spec, spec, spec, spec, spec), P()),
            check_vma=False,
        )
    )


def cpra_join(
    inner_keys,
    inner_vals,
    outer_keys,
    outer_vals,
    mesh: Mesh,
    plan: JoinPlan | None = None,
    slack: float = 2.0,
    axis: str = "x",
    skew: bool = False,
    tier_ratio: float | None = None,
    retries: int = 2,
    liveness_timeout_s: float | None = 30.0,
    **skew_kw,
):
    """Convenience front end: shard host arrays, run the distributed step.

    slack: exchange capacity multiplier over the uniform expectation.
    skew=True enables heavy-hitter replication (parallel/skew.py) and makes
    the return value (light JoinResult, heavy row set, plan); otherwise
    (JoinResult, plan).

    Overflow (e.g. under unannounced skew) triggers up to `retries`
    re-plans, with the overflow sources handled separately from the
    step's diag vector: exchange-cap overflow doubles the slack, a
    unique_build violation drops the flag (as the single-device
    `engine.phj.join` does), heavy-build overflow raises the cap.
    Persistent overflow raises with a pointer to skew handling."""
    n_chips = mesh.shape[axis]
    ni, no = len(inner_keys), len(outer_keys)
    if plan is None:
        plan = plan_join(ni // n_chips, no // n_chips)
    if n_chips == 1 and not skew:
        # degenerate mesh: the owner exchange is the identity -- skip the
        # bucket pack entirely (its static caps would 3x the memory).
        # The single-device driver downgrades a wrong unique_build and
        # raises on padded/radix overflow (engine.phj.join) -- never
        # returns a silently truncated result.
        from ..engine.phj import join as single_chip_join

        return single_chip_join(
            inner_keys, inner_vals, outer_keys, outer_vals, plan,
        )
    # stage boundary: fail fast with a diagnosis instead of hanging in
    # the exchange collective if a mesh participant is gone
    from .distributed import require_live_mesh

    require_live_mesh(mesh, liveness_timeout_s, axis, stage="cpra_exchange")
    # with tier routing the heavier half receives max(r, 1-r) of the
    # traffic spread over n/2 chips -- 2*max(r, 1-r) times uniform
    bias = 1.0
    if tier_ratio is not None and n_chips >= 2:
        bias = 2.0 * max(tier_ratio, 1.0 - tier_ratio)
    from .distributed import shard_null_padded

    sh = NamedSharding(mesh, P(axis))
    dev = lambda x: shard_null_padded(x, n_chips, sh)
    args = (dev(inner_keys), dev(inner_vals), dev(outer_keys),
            dev(outer_vals))
    for attempt in range(retries + 1):
        inner_cap = max(64, int(ni / (n_chips * n_chips) * slack * bias))
        outer_cap = max(
            plan.tile, int(no / (n_chips * n_chips) * slack * bias)
        )
        step = make_cpra_step(mesh, plan, inner_cap, outer_cap, axis,
                              skew=skew, tier_ratio=tier_ratio, **skew_kw)
        res, heavy, diag = step(*args)
        exch_ovf, eng_ovf, heavy_ovf = (int(d) for d in diag)
        if exch_ovf == 0 and eng_ovf == 0 and heavy_ovf == 0:
            if skew:
                return res, heavy, plan
            return res, plan
        # free the failed attempt's buffers before retrying -- heavy
        # holds four probe-shard-sized device arrays and would otherwise
        # stay live across the retry's fresh allocations
        res = None
        heavy = None
        if exch_ovf:
            slack *= 2.0
        if heavy_ovf:
            # a truncated heavy-build extraction: only a larger cap
            # fixes it (slack knobs cannot)
            skew_kw = dict(
                skew_kw,
                heavy_build_cap=4 * skew_kw.get("heavy_build_cap", 256),
            )
        if eng_ovf:
            if plan.probe_impl != "merge":
                raise RuntimeError(
                    "local join overflow on the padded path (table slots "
                    "or radix pass capacity exceeded): raise plan.slots "
                    "or the pass fanout"
                )
            # duplicate build keys under unique_build: drop the flag
            from ..engine.phj import downgrade_plan_opts

            plan = downgrade_plan_opts(plan)
    # diagnose by the signal that actually persisted on the LAST attempt
    # (the separated diag exists exactly so these aren't conflated)
    if heavy_ovf:
        raise RuntimeError(
            "heavy-build extraction overflow persists after re-planning: "
            "pass a larger heavy_build_cap (more replicated build rows "
            "share heavy keys than the cap admits)"
        )
    if exch_ovf:
        raise RuntimeError(
            "exchange bucket overflow persists after re-planning: "
            "enable skew=True (heavy-hitter replication) for this "
            "workload"
        )
    raise RuntimeError("unique_build violation persists: retries=0")

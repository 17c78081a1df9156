"""Distributed Grace join: BOTH relations larger than the MESH's memory.

The single-device Grace driver (engine/grace.py) already removes both
device-memory size limits on one device; this module scales it across a device
mesh -- the composition BASELINE config 5 (1B x 4B rows) asks for:
the reference's fixed 4096-way decomposition + cross-thread memcpy
re-aggregation (cpra2.cpp:1757-1906) re-expressed with the thread axis
replaced by BOTH the chunk-stream axis (out-of-core) and the mesh axis
(scale-out).  Two phases, both SPMD over the mesh:

1. **Distributed partition pass.**  Each superchunk of (n_dev x
   chunk_rows) host rows shards over the mesh; every device runs ONE
   radix pass (ops/radix_partition.py) at fanout F = 2^f_bits.  Because
   the pass emits partition-contiguous regions ordered by the top hash
   bits, and the owner device of partition p is its top log2(n_dev) bits,
   a single tiled `all_to_all` over the flattened regions IS the owner
   exchange --
   device d receives exactly partitions [d*F/n, (d+1)*F/n) from every
   peer, no re-pack needed (the memcpy re-aggregation of
   cpra2.cpp:1896-1904 as one collective).  The received
   fragments then append to partition files (engine/spill.py raw-u32
   format), keyed by owner device so the layout is what a pod's
   host-local spill would hold.

SCOPE (r5: multi-process capable).  Under jax.distributed
(process_count > 1) the host side runs PER HOST: each host extracts
only its own devices' received fragments (addressable_shards), spills
them under spill_dir/host<i> with a host-local sidecar and phase-2
journal, and loads only its own partitions back (the owner exchange
already routed partition p's rows to p's owner device, so each host's
files hold exactly the partitions its devices own -- the pod layout).
Global facts (per-partition counts for the budget caps, resume
decisions, journal maps, final join totals) are reconciled with u32-
lane process_allgather sums (_allsum_u64; x64 is off).  Input
relations are passed REPLICATED: every process provides the same host
arrays/memmaps (each host reads the same relation files -- the
write.cpp data-plane contract); per-host input slicing is an
orthogonal upgrade.  Two single-controller conveniences are
deliberately absent under multi-process, both because they re-run
mesh collectives outside the common SPMD path (a one-host recompute
would deadlock the others): corrupt-spill recovery raises instead of
recomputing, and a side resumes its phase-1 spill only when EVERY
host can (else all hosts recompute together).  on_partition fires for
the HOST-OWNED partitions on each process -- the natural pod
semantics for materializing consumers.  Verified end to end on a
2-process x 4-device CPU mesh (tests/test_grace_dist_mp.py).

2. **Partition-parallel joins.**  Round r joins partition d*F/n + r on
   device d: per-partition columns load from the owner's files, pad to
   ONE shared (build, probe) cap, and a single compiled shard_map'd
   merge join serves all F/n rounds (per-partition shapes would
   recompile per round).

Phase-1 spills use the SAME sidecar fingerprint and file layout as
engine/grace.py -- the partition files' content (as a multiset) depends
only on the input rows and the (factor, f_bits) routing, not on the
chunk size or the mesh shape -- so a single-chip Grace spill resumes a
distributed run and vice versa, and a corrupt reused file recomputes
that side's pass once rather than joining garbage.

Reference behavior being reproduced: phj.cpp:1791-1808 (multi-pass
partitioning makes working sets independent of relation size),
cpra2.cpp:1883-1971 (partition-parallel build/probe over re-aggregated
fragments).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.config import JoinPlan, plan_join
from ..engine.grace import (
    GraceResult,
    PartitionMeta,
    _append_fragments,
    _budget_caps_local,
    _init_partition_files,
    _journal_append,
    _make_loader,
    _phase1,
    _phase2_journal,
    _side_fingerprint,
    _u64sum,
    _write_side_sidecar,
)
from ..engine.phj import JoinResult, phj_join
from ..ops.radix_partition import radix_partition
from ..utils.hashing import hashed_key, mod_inverse_u32
from .cpra import _engine_overflow, _owner_bits
from .distributed import require_live_mesh


def _host_spill_dir(spill_dir: str) -> str:
    """Per-host spill root: single-controller runs use spill_dir itself
    (interchangeable with engine/grace.py spills); multi-process runs
    isolate each host under host<i> -- on a real pod these are
    different filesystems anyway, and on a shared-FS test box the
    subdirectories keep hosts from clobbering each other's files."""
    if jax.process_count() == 1:
        return spill_dir
    d = os.path.join(spill_dir, f"host{jax.process_index()}")
    os.makedirs(d, exist_ok=True)
    return d


def _put_global(host_arr: np.ndarray, mesh: Mesh, axis: str):
    """Shard a (replicated) host array over the mesh axis.  Works in
    both controller models: plain device_put single-process; explicit
    per-host shard construction when the mesh spans processes."""
    sh = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(host_arr), sh)
    return jax.make_array_from_callback(
        host_arr.shape, sh, lambda idx: host_arr[idx]
    )


def _allsum_u64(vals) -> np.ndarray:
    """Element-wise across-process sum (mod 2^64) of a same-shape
    per-process array -- counts, checksums, and join totals whose
    per-partition contributions are host-disjoint.  Rides
    process_allgather as two u32 lanes (jax x64 is off, so u64/i64
    arrays cannot ride collectives directly)."""
    a = np.asarray(vals, np.uint64).reshape(-1)
    if jax.process_count() == 1:
        return a
    from jax.experimental import multihost_utils

    lo = (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (a >> np.uint64(32)).astype(np.uint32)
    glo = np.asarray(multihost_utils.process_allgather(lo)).astype(
        np.uint64
    ).sum(axis=0, dtype=np.uint64)
    ghi = np.asarray(multihost_utils.process_allgather(hi)).astype(
        np.uint64
    ).sum(axis=0, dtype=np.uint64)
    return glo + (ghi << np.uint64(32))


def _local_positions(mesh: Mesh, axis: str) -> list[int]:
    """Mesh-axis positions whose device this process owns."""
    devs = list(mesh.devices.reshape(-1))
    me = jax.process_index()
    return [i for i, dv in enumerate(devs) if dv.process_index == me]


def _owned_shard_blocks(arr, block: int) -> dict[int, np.ndarray]:
    """{mesh position: host copy of that device's block} for a
    P(axis)-sharded output whose per-device block length is `block`."""
    out = {}
    for s in arr.addressable_shards:
        start = s.index[0].start or 0
        out[start // block] = np.asarray(s.data)
    return out


def _agree(flag: bool) -> bool:
    """True iff every process passes True (u32-lane allgather)."""
    if jax.process_count() == 1:
        return flag
    return int(_allsum_u64(np.array([1 if flag else 0]))[0]) == (
        jax.process_count()
    )


@functools.lru_cache(maxsize=64)
def _make_partition_step(mesh: Mesh, axis: str, factor: int, f_bits: int,
                         cap: int):
    """One superchunk's distributed partition pass: per-device radix
    pass + the owner all_to_all.  Returns fn(keys, vals) -> (hk regions,
    val regions, counts, overflow), all but overflow sharded over
    `axis`; received layout per device is (n_src, F/n_dev, capr).
    lru-cached: a fresh jit(shard_map(closure)) per call would key the
    jit cache on a new function identity and recompile the identical
    program for the probe side that the build side just compiled."""
    n_dev = mesh.shape[axis]

    def step(keys, vals):
        hk = hashed_key(keys, factor)
        bk, bv, cnts, ovf = radix_partition(hk, vals, f_bits, cap=cap)
        # regions are partition-contiguous by the top f_bits; owner(p) =
        # top log2(n_dev) bits of p, so the tiled split IS the owner pack
        a2a = functools.partial(
            jax.lax.all_to_all, axis_name=axis, split_axis=0,
            concat_axis=0, tiled=True,
        )
        rk, rv, rc = a2a(bk), a2a(bv), a2a(cnts)
        # the largest partition count any device saw: the cap a retry
        # needs (counts are exact even when a region overflows)
        need = jax.lax.pmax(jnp.max(cnts), axis)
        ovf = jax.lax.psum((ovf != 0).astype(jnp.int32), axis)
        return rk, rv, rc, ovf, need

    spec = P(axis)
    return jax.jit(
        jax.shard_map(
            step, mesh=mesh, in_specs=(spec, spec),
            out_specs=(spec, spec, spec, P(), P()), check_vma=False,
        )
    )


def _partition_side_dist(
    keys, vals, factor: int, f_bits: int, chunk_rows: int, d: str,
    side: str, mesh: Mesh, axis: str, fp: dict | None = None,
):
    """Stream one relation through the MESH's distributed radix pass;
    append each owner device's received fragments to the per-partition
    files `{side}_{p}_{hk,val}.bin`.  Same sidecar contract as
    engine.grace._partition_side (the two spill formats are
    interchangeable); `fp` is the caller's precomputed fingerprint.
    chunk_rows is rows PER DEVICE per superchunk.

    Multi-process: `d` is this host's spill dir and every count/
    checksum accumulated here is HOST-LOCAL (this host's devices'
    partitions only; zeros elsewhere) -- the sidecar then validates
    exactly the files this host holds, and the caller reconciles
    global counts with _allsum_u64 (partition ownership is disjoint)."""
    n_dev = mesh.shape[axis]
    F = 1 << f_bits
    Fl = F // n_dev
    n = len(keys)
    counts = np.zeros(F, np.int64)
    hk_csums = [0] * F
    val_csums = [0] * F
    multi = jax.process_count() > 1
    local_pos = _local_positions(mesh, axis)
    owned = {dst * Fl + j for dst in local_pos for j in range(Fl)}
    if fp is None:
        fp = _side_fingerprint(keys, vals, factor, f_bits)
    _init_partition_files(d, side, F)
    super_rows = n_dev * chunk_rows
    pos = 0
    while pos < n:
        ck = np.zeros(super_rows, np.uint32)
        cv = np.zeros(super_rows, np.uint32)
        take = min(super_rows, n - pos)
        ck[:take] = np.asarray(keys[pos : pos + take])
        cv[:take] = np.asarray(vals[pos : pos + take])
        pos += take
        # null-key pads in the tail superchunk are dropped by the pass
        dk = _put_global(ck, mesh, axis)
        dv = _put_global(cv, mesh, axis)
        step = _make_partition_step(mesh, axis, factor, f_bits, 0)
        rk, rv, rc, ovf, need = step(dk, dv)
        if int(ovf):
            # skew: size the regions from the exact counts and rerun
            step = _make_partition_step(mesh, axis, factor, f_bits,
                                        int(need))
            rk, rv, rc, ovf, need = step(dk, dv)
        capr = rk.shape[0] // (n_dev * F)
        block = n_dev * Fl * capr  # one dst device's received rows
        if multi:
            k_blocks = _owned_shard_blocks(rk, block)
            v_blocks = _owned_shard_blocks(rv, block)
            c_blocks = _owned_shard_blocks(rc, n_dev * Fl)
        else:
            rk_h = np.asarray(rk)
            k_blocks = {dst: rk_h[dst * block : (dst + 1) * block]
                        for dst in range(n_dev)}
            rv_h = np.asarray(rv)
            v_blocks = {dst: rv_h[dst * block : (dst + 1) * block]
                        for dst in range(n_dev)}
            rc_h = np.asarray(rc)
            c_blocks = {
                dst: rc_h[dst * n_dev * Fl : (dst + 1) * n_dev * Fl]
                for dst in range(n_dev)
            }
        frags = [(np.zeros(0, np.uint32),) * 2 for _ in range(F)]
        for dst, kb in k_blocks.items():
            # (src, local partition, region) within this dst's block
            kb = kb.reshape(n_dev, Fl, capr)
            vb = v_blocks[dst].reshape(n_dev, Fl, capr)
            cb = c_blocks[dst].reshape(n_dev, Fl)
            for j in range(Fl):
                live = kb[:, j] != 0
                assert int(live.sum()) == int(cb[:, j].sum())
                frags[dst * Fl + j] = (kb[:, j][live], vb[:, j][live])
        _append_fragments(d, side, frags, counts, hk_csums, val_csums)
    _write_side_sidecar(d, side, fp, counts, hk_csums, val_csums)
    return counts, hk_csums, val_csums


@functools.lru_cache(maxsize=64)
def _make_join_step(mesh: Mesh, axis: str, local_plan: JoinPlan):
    """Phase-2 round: every device joins its round's partition pair.
    Returns (result, psum'd engine overflow count).  lru-cached for the
    same recompile reason as _make_partition_step."""

    def step(bk, bv, pk, pv):
        # .flat(): out_specs shard leaf dim 0 of the flat padded layout
        res = phj_join(bk, bv, pk, pv, local_plan).flat()
        ovf = jax.lax.psum(
            _engine_overflow(res, local_plan).astype(jnp.int32), axis)
        return res, ovf

    spec = P(axis)
    return jax.jit(
        jax.shard_map(
            step, mesh=mesh, in_specs=(spec,) * 4,
            out_specs=(JoinResult(spec, spec, spec, spec, spec), P()),
            check_vma=False,
        )
    )


def grace_join_dist(
    inner_keys,
    inner_vals,
    outer_keys,
    outer_vals,
    mesh: Mesh,
    f_bits: int = 6,
    chunk_rows: int = 16_000_000,
    spill_dir: str | None = None,
    plan: JoinPlan | None = None,
    partition_budget_rows: int = 220_000_000,
    on_partition=None,
    axis: str = "x",
    liveness_timeout_s: float | None = 30.0,
) -> GraceResult:
    """Join two host-resident relations over a device mesh; neither
    relation needs to fit the mesh's combined device memory.  All four inputs are
    numpy arrays or np.memmap; chunk_rows is rows per device per
    phase-1 superchunk.

    on_partition(meta, res_slices, raw_probe_keys) is called per
    partition with that partition's aligned join-output columns
    (probe keys already unscrambled); without it only counts are
    accumulated.  Requires f_bits >= log2(n_devices) (every device owns
    at least one partition).

    Multi-process (jax.distributed): every process passes the SAME
    host relations (replicated inputs); spills/journals live under
    spill_dir/host<i> per host; on_partition fires on the OWNER host
    of each partition; counts and totals in the returned GraceResult
    are global and identical on every process (module docstring,
    SCOPE)."""
    if spill_dir is None:
        raise ValueError("grace_join_dist needs spill_dir")
    if chunk_rows <= 0:
        raise ValueError("chunk_rows must be positive")
    multi = jax.process_count() > 1
    os.makedirs(spill_dir, exist_ok=True)
    spill = _host_spill_dir(spill_dir)
    n_dev = mesh.shape[axis]
    dev_bits = _owner_bits(n_dev)
    if f_bits < dev_bits:
        raise ValueError(
            f"f_bits={f_bits} < log2(n_devices)={dev_bits}: every device "
            "must own at least one partition"
        )
    F = 1 << f_bits
    Fl = F // n_dev
    local_pos = _local_positions(mesh, axis)
    if plan is None:
        plan = plan_join(
            max(1, len(inner_keys) >> f_bits),
            max(1, len(outer_keys) >> f_bits),
        )
    # stage boundary: fail fast instead of hanging in the exchange
    require_live_mesh(mesh, liveness_timeout_s, axis,
                      stage="grace_dist_partition")
    sides = {"build": (inner_keys, inner_vals),
             "probe": (outer_keys, outer_vals)}
    if multi:
        # resume agreement: _partition_side_dist runs MESH collectives,
        # so either every host resumes a side or every host recomputes
        # it together -- a lone recomputing host would deadlock the
        # rest.  A host that could resume but was outvoted drops its
        # sidecar so _phase1 recomputes on all hosts in lockstep.
        from ..engine.grace import _side_sidecar, _try_resume_side

        for side, (k, v) in sides.items():
            fp = _side_fingerprint(k, v, plan.factor, f_bits)
            can = _try_resume_side(spill, side, fp) is not None
            if not _agree(can) and can:
                os.remove(_side_sidecar(spill, side))
    side_state, reused, side_fps, compute_side = _phase1(
        sides, spill, plan.factor, f_bits,
        lambda k, v, side, fp: _partition_side_dist(
            k, v, plan.factor, f_bits, chunk_rows, spill, side,
            mesh, axis, fp),
    )
    # per-host counts are partition-disjoint (the owner exchange routed
    # each partition to exactly one host); the global view is their sum
    b_counts = _allsum_u64(side_state["build"][0]).astype(np.int64)
    p_counts = _allsum_u64(side_state["probe"][0]).astype(np.int64)
    nb_cap, np_cap, local = _budget_caps_local(
        b_counts, p_counts, partition_budget_rows, f_bits, plan)
    inv = np.uint64(mod_inverse_u32(plan.factor))
    if multi:
        # corrupt-spill recovery re-runs the side's mesh collectives,
        # which only this host would enter -- deadlock; fail loudly and
        # let the whole job re-run phase 1 together
        def compute_side(side):  # noqa: F811 -- deliberate override
            raise RuntimeError(
                f"host {jax.process_index()}: spilled {side} files are "
                "corrupt; multi-process runs cannot recompute one "
                "host's phase 1 alone -- delete this host's spill dir "
                "and re-run the job"
            )

    load_side = _make_loader(spill, side_state, reused, compute_side)

    metas = [PartitionMeta(p, int(b_counts[p]), int(p_counts[p]), 0)
             for p in range(F)]
    # per-partition join counts, accumulated HOST-LOCALLY as two u32
    # lanes (x64 off; partition ownership is disjoint across hosts) and
    # summed across processes at the end
    jt_local = np.zeros(F, np.uint64)
    sh = NamedSharding(mesh, P(axis))
    require_live_mesh(mesh, liveness_timeout_s, axis,
                      stage="grace_dist_join")

    def round_parts(r):
        return [d * Fl + r for d in range(n_dev)]

    def load_pair_cols(p):
        # a pair empty on either side contributes only null pads
        nb = int(b_counts[p]) if int(p_counts[p]) else 0
        npr = int(p_counts[p]) if int(b_counts[p]) else 0
        bkc, bvc = load_side("build", p, nb, nb_cap)
        pkc, pvc = load_side("probe", p, npr, np_cap)
        return bkc, bvc, pkc, pvc

    def build_args(r):
        if not multi:
            cols = [[], [], [], []]
            for p in round_parts(r):
                for c, a in zip(cols, load_pair_cols(p)):
                    c.append(a)
            return tuple(
                jax.device_put(jnp.asarray(np.concatenate(c)), sh)
                for c in cols
            )
        # multi-process: each host materializes only its own devices'
        # blocks (its own partitions' files); the callback caches the
        # pair load so the four column arrays share one read
        cache = {}

        def cb(col, cap, idx):
            dst = (idx[0].start or 0) // cap
            p = dst * Fl + r
            if p not in cache:
                cache[p] = load_pair_cols(p)
            return cache[p][col]

        return tuple(
            jax.make_array_from_callback(
                (n_dev * cap,), sh, functools.partial(cb, col, cap)
            )
            for col, cap in ((0, nb_cap), (1, nb_cap),
                             (2, np_cap), (3, np_cap))
        )

    # phase-2 resume (journal shared with the single-chip driver): a
    # round is skipped when EVERY worked pair in it is already recorded
    # for these inputs/routing; partially-journaled rounds re-join whole
    # (the batched step computes all n_dev pairs at once anyway).
    # Multi-process: journals are per host; the done map is merged
    # across hosts (ownership-disjoint) so every host skips the same
    # rounds -- disagreement would desynchronize the collectives.
    done_local = _phase2_journal(spill, side_fps, on_partition)
    if multi:
        present = np.zeros(F, np.uint64)
        jts = np.zeros(F, np.uint64)
        for p, jt in done_local.items():
            present[p] = 1
            jts[p] = jt
        present = _allsum_u64(present)
        jts = _allsum_u64(jts)
        done = {p: int(jts[p]) for p in range(F) if int(present[p])}
    else:
        done = done_local
    resumed = 0

    def worked(p):
        return int(b_counts[p]) and int(p_counts[p])

    live_rounds = []
    for r in range(Fl):
        parts = [p for p in round_parts(r) if worked(p)]
        if not parts:
            continue
        if all(p in done for p in parts):
            for p in parts:
                # under multi-process only the OWNER host carries the
                # resumed count into the final cross-host sum
                jt_local[p] = done[p] if (
                    not multi or p in done_local
                ) else 0
                metas[p].join_tuples = done[p]
                resumed += 1
        else:
            live_rounds.append(r)
    pending = None
    for idx, r in enumerate(live_rounds):
        parts = round_parts(r)
        args = pending if pending is not None else build_args(r)
        res, ovf = _make_join_step(mesh, axis, local)(*args)
        # double buffering: the next round's disk reads + H2D go out
        # while this round's join is still in flight on the mesh (the
        # overflow read below is what forces completion)
        pending = (build_args(live_rounds[idx + 1])
                   if idx + 1 < len(live_rounds) else None)
        # ovf is out_specs P() == fully replicated: every process holds
        # an addressable copy, so int() works in both controller models
        if int(ovf):
            raise RuntimeError(
                f"round {r}: the local join reported {int(ovf)} "
                "overflowed partitions"
            )
        cap_out = res.match_cnts.shape[0] // n_dev
        if multi:
            mc_blocks = _owned_shard_blocks(res.match_cnts, cap_out)
            my_pos = local_pos
        else:
            mc_h = np.asarray(res.match_cnts)
            mc_blocks = {d: mc_h[d * cap_out : (d + 1) * cap_out]
                         for d in range(n_dev)}
            my_pos = range(n_dev)
        pk_blocks = pv_blocks = mv_blocks = None
        for dpos in my_pos:
            p = parts[dpos]
            mc_d = mc_blocks[dpos]
            jt = int(np.sum(mc_d.astype(np.int64)))
            metas[p].join_tuples = jt
            jt_local[p] = jt
            if worked(p):
                _journal_append(spill, p, jt)
            if on_partition and metas[p].build_rows and metas[p].probe_rows:
                if pk_blocks is None:
                    if multi:
                        pk_blocks = _owned_shard_blocks(
                            res.probe_keys, cap_out)
                        pv_blocks = _owned_shard_blocks(
                            res.probe_vals, cap_out)
                        mv_blocks = _owned_shard_blocks(
                            res.match_vals, cap_out)
                    else:
                        def _split(a):
                            h = np.asarray(a)
                            return {d: h[d * cap_out : (d + 1) * cap_out]
                                    for d in range(n_dev)}

                        pk_blocks = _split(res.probe_keys)
                        pv_blocks = _split(res.probe_vals)
                        mv_blocks = _split(res.match_vals)
                pk = pk_blocks[dpos]
                raw_pk = (
                    pk.astype(np.uint64) * inv % (1 << 32)
                ).astype(np.uint32)
                # build_counts carries the single-device 3-entry merge
                # layout (NOT the raw mesh-concatenated per-device
                # build_counts); the round's overflow check above passed
                res_slice = JoinResult(
                    pk, pv_blocks[dpos], mv_blocks[dpos], mc_d,
                    np.zeros(3, np.int32),
                )
                on_partition(metas[p], res_slice, raw_pk)
    jt_global = _allsum_u64(jt_local)
    total = 0
    for p in range(F):
        metas[p].join_tuples = int(jt_global[p])
        total += int(jt_global[p])
    return GraceResult(total, metas, f_bits, reused_sides=dict(reused),
                       resumed_partitions=resumed)

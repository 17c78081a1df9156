"""Grace join: BOTH relations larger than device memory, on one device.

The streaming driver (engine/stream.py) removes the probe-side size
limit but still requires the build side to fit the device (it is sorted
once and stays resident).  This module removes that limit too -- the
reference's reason-to-exist: multi-pass
partitioning makes working sets independent of relation size
(phj.cpp:1791-1808; CPRA's fixed 4096-way decomposition,
cpra2.cpp:1883-1971).  Two phases:

1. **Partition (out-of-core radix pass)**: each relation streams through
   the device in host-sized chunks; one radix pass
   (ops/radix_partition.py) splits
   every chunk by the top `f_bits` of the scrambled key, and the
   compacted per-partition fragments append to host-side partition
   files (engine/spill.py raw-u32 format).  This is exactly the
   reference's partition phase with the thread axis replaced by the
   chunk-stream axis and the memcpy re-aggregation replaced by
   host-file append.

2. **Per-partition join**: each partition pair now fits the device by
   construction (ni/F, no/F up to skew); the standard merge engine
   joins them (keys are already scrambled, so the local plan uses
   factor=1 -- hashed_key is then the identity and the null-key
   convention carries over, hk == 0 iff key == 0).

Overflows remain values: a chunk whose pass overflows its region
capacity retries once with the largest measured partition count as its
cap (the pass's counts are exact); a partition that would not fit the
per-partition budget raises with the f_bits to use instead (recursive
splitting is one more pass of the same machinery).

Phase-1 spills are resumable (engine/stream.py semantics): each side
writes a sidecar with the input fingerprint (rows, key + value
checksums, scramble factor, f_bits) plus per-partition counts and
column checksums.  A rerun over the same inputs and routing reuses the
partition files instead of re-streaming the relation; every partition
read in phase 2 re-verifies its column checksums, and a corrupt file
recomputes that side's pass once rather than joining garbage.  Phase 2
double-buffers: the next partition pair's host read + H2D transfer is
issued before the current pair's join is consumed, so the link overlaps
the per-partition compute exactly as the chunk stream does.

Phase 2 is ALSO resumable: completed partitions append to a progress
journal (join_progress.jsonl -- header = both sides' fingerprints, one
record per joined partition), so a crash during the join phase redoes
only the unjournaled tail on rerun.  Resume is counts-only: attaching
an on_partition row consumer disables journal consumption (every
partition re-joins so the callback sees all rows) while still writing
records for later counts-only reruns.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.radix_partition import radix_partition
from ..utils.hashing import hashed_key, mod_inverse_u32
from .config import JoinPlan, plan_join
from .phj import phj_join
from .spill import _read_u32, _write_u32


@dataclasses.dataclass
class PartitionMeta:
    index: int
    build_rows: int
    probe_rows: int
    join_tuples: int


@dataclasses.dataclass
class GraceResult:
    join_tuples: int
    partitions: list  # PartitionMeta per partition
    f_bits: int
    # which sides resumed their phase-1 partition files from a prior
    # run's spill (checksum-verified) instead of re-streaming
    reused_sides: dict = dataclasses.field(default_factory=dict)
    # partitions whose phase-2 join was resumed from the progress
    # journal (counts-only; 0 whenever a row consumer is attached)
    resumed_partitions: int = 0


class SpillCorrupt(ValueError):
    """A partition file failed its sidecar checksum at load time."""


def _append_u32(path: str, arr: np.ndarray) -> None:
    with open(path, "ab") as f:
        np.ascontiguousarray(arr, dtype="<u4").tofile(f)


from ..utils.host import u64sum as _u64sum  # shared checksum


def _side_sidecar(d: str, side: str) -> str:
    return os.path.join(d, f"{side}_partition.json")


def _side_fingerprint(keys, vals, factor: int, f_bits: int) -> dict:
    """What determines the partition files' CONTENT (as a multiset):
    the input rows themselves (BOTH columns -- same keys with new
    payloads must not resume stale value files) and the scramble/fanout
    routing.  The streaming chunk size only permutes row order within a
    partition file, which neither the join nor the checksums depend on."""
    return {"rows": int(len(keys)), "input_checksum": _u64sum(keys),
            "val_checksum": _u64sum(vals),
            "factor": int(factor), "f_bits": int(f_bits)}


def _try_resume_side(d: str, side: str, fp: dict):
    """Returns (counts, hk_csums, val_csums) if `side`'s phase-1 spill
    matches this input/routing fingerprint and every partition file has
    the recorded length; else None.  Column checksums are re-verified
    lazily at phase-2 load (`load_column`), so a stale or
    corrupt file is caught before any row is joined."""
    try:
        with open(_side_sidecar(d, side)) as f:
            meta = json.load(f)
        if {k: meta.get(k) for k in fp} != fp:
            return None
        counts = np.asarray(meta["counts"], np.int64)
        for p in range(1 << fp["f_bits"]):
            want = int(counts[p]) * 4
            for col in ("hk", "val"):
                path = os.path.join(d, f"{side}_{p}_{col}.bin")
                if os.path.getsize(path) != want:
                    return None
        return (counts, [int(c) for c in meta["hk_checksums"]],
                [int(c) for c in meta["val_checksums"]])
    except (OSError, ValueError, KeyError):
        return None


def _journal_path(d: str) -> str:
    return os.path.join(d, "join_progress.jsonl")


def _load_journal(d: str, fp: dict):
    """Phase-2 progress journal: header line = the run fingerprint
    (both sides' input/routing fingerprints), then one record per
    completed partition.  Returns {partition: join_tuples} when the
    header matches this run, else None (start a fresh journal).  A
    torn tail line from a crash is ignored -- that partition simply
    re-joins."""
    try:
        with open(_journal_path(d)) as f:
            lines = f.read().splitlines()
        if not lines or json.loads(lines[0]) != fp:
            return None
        done = {}
        for ln in lines[1:]:
            try:
                rec = json.loads(ln)
                done[int(rec["p"])] = int(rec["join_tuples"])
            except (ValueError, KeyError):
                continue
        return done
    except (OSError, ValueError):
        return None


def _start_journal(d: str, fp: dict) -> None:
    with open(_journal_path(d), "w") as f:
        f.write(json.dumps(fp) + "\n")


def _journal_append(d: str, p: int, jt: int) -> None:
    with open(_journal_path(d), "a") as f:
        f.write(json.dumps({"p": int(p), "join_tuples": int(jt)}) + "\n")


def _phase2_journal(d: str, side_fps: dict, on_partition):
    """Open (or resume) the phase-2 journal for this run.  `side_fps`
    holds the per-side input fingerprints the caller already computed
    for phase-1 resume (recomputing them here would re-read both
    relations -- ~40 GB of memmap traffic at headline scale).  Returns
    the completed {partition: join_tuples} map -- forced empty when a
    row consumer is attached, because resuming would skip its
    on_partition callbacks; the journal is still WRITTEN in that case
    so a later counts-only rerun can resume from it."""
    fp = dict(side_fps)
    done = _load_journal(d, fp)
    if done is None:
        _start_journal(d, fp)
        done = {}
    return {} if on_partition else done


def _init_partition_files(d: str, side: str, F: int) -> None:
    """Truncate every partition file and drop any half-written sidecar
    from a crashed run (it must not resume)."""
    try:
        os.remove(_side_sidecar(d, side))
    except OSError:
        pass
    for p in range(F):
        for col in ("hk", "val"):
            open(os.path.join(d, f"{side}_{p}_{col}.bin"), "wb").close()


def _write_side_sidecar(d, side, fp, counts, hk_csums, val_csums) -> None:
    with open(_side_sidecar(d, side), "w") as f:
        json.dump({**fp, "counts": counts.tolist(),
                   "hk_checksums": hk_csums,
                   "val_checksums": val_csums}, f)


def _phase1(sides, spill_dir, factor, f_bits, partition_side):
    """Resume-or-compute both sides' phase-1 spills (shared by the
    single-chip and mesh drivers).  partition_side(keys, vals, side, fp)
    runs one side's pass.  Returns (side_state, reused, side_fps,
    compute_side); compute_side is reusable for corrupt-spill recovery."""
    side_state, reused, side_fps = {}, {}, {}

    def compute_side(side):
        k, v = sides[side]
        side_state[side] = partition_side(k, v, side, side_fps[side])
        reused[side] = False

    for side, (k, v) in sides.items():
        fp = side_fps[side] = _side_fingerprint(k, v, factor, f_bits)
        hit = _try_resume_side(spill_dir, side, fp)
        if hit is not None:
            side_state[side] = hit
            reused[side] = True
        else:
            compute_side(side)
    return side_state, reused, side_fps, compute_side


def _budget_caps_local(b_counts, p_counts, budget: int, f_bits: int,
                       plan: JoinPlan):
    """Enforce the per-partition budget, then derive the ONE static
    (build, probe) cap pair all partitions pad to (per-partition shapes
    would recompile F times)
    and the per-partition local plan: keys arrive pre-scrambled, so
    factor=1 makes hashed_key the identity and the local engine skips
    the f_bits the routing consumed."""
    if int(b_counts.max(initial=0)) > budget or int(
        p_counts.max(initial=0)
    ) > budget:
        raise RuntimeError(
            f"a partition exceeds the per-partition budget "
            f"({int(max(b_counts.max(), p_counts.max()))} rows > "
            f"{budget}): re-run with f_bits={f_bits + 2} "
            "(one more level of the same pass handles any skew)"
        )
    nb_cap = -(-max(int(b_counts.max(initial=0)), 128) // 128) * 128
    np_cap = -(-max(int(p_counts.max(initial=0)), 128) // 128) * 128
    local = dataclasses.replace(
        plan_join(nb_cap, np_cap), factor=1,
        skip_bits=plan.skip_bits + f_bits,
    )
    return nb_cap, np_cap, local


def _make_loader(spill_dir, side_state, reused, compute_side):
    """load_side(side, p, n_rows, cap) -> zero-padded, checksum-verified
    (hk, val) numpy columns.  A REUSED file that fails its checksum
    recomputes that side's pass ONCE -- same inputs and routing, so the
    counts (and thus every cap) are reproduced exactly."""

    def load_column(side, p, n, cap, col):
        path = os.path.join(spill_dir, f"{side}_{p}_{col}.bin")
        a = _read_u32(path, n)
        csums = side_state[side][1 if col == "hk" else 2]
        if _u64sum(a) != csums[p]:
            raise SpillCorrupt(f"{path}: checksum mismatch")
        return np.concatenate([a, np.zeros(cap - n, np.uint32)])

    def load_side(side, p, n, cap):
        if n == 0:
            z = np.zeros(cap, np.uint32)
            return z, z
        for attempt in (0, 1):
            try:
                return (load_column(side, p, n, cap, "hk"),
                        load_column(side, p, n, cap, "val"))
            except SpillCorrupt:
                if attempt or not reused[side]:
                    raise
                old_counts = side_state[side][0]
                compute_side(side)
                assert np.array_equal(side_state[side][0], old_counts)

    return load_side


def _append_fragments(d: str, side: str, frags, counts, hk_csums,
                      val_csums) -> None:
    """Append per-partition fragments to the side's partition files,
    accumulating counts and both column checksums (shared by the
    single-device and distributed passes)."""
    for p, (frag_k, frag_v) in enumerate(frags):
        if not len(frag_k):
            continue
        _append_u32(os.path.join(d, f"{side}_{p}_hk.bin"), frag_k)
        _append_u32(os.path.join(d, f"{side}_{p}_val.bin"), frag_v)
        counts[p] += len(frag_k)
        hk_csums[p] = (hk_csums[p] + _u64sum(frag_k)) % (1 << 64)
        val_csums[p] = (val_csums[p] + _u64sum(frag_v)) % (1 << 64)


def _exact_join_tuples(res) -> int:
    """Exact output count WITHOUT a cap-sized D2H transfer: the engine's
    u32 wraparound sum (JoinResult.join_tuples) plus a float32 device
    total recover the high bits -- the float sum's error (~eps * log2(n)
    * total) stays orders of magnitude below 2^31, so rounding the
    difference to the nearest 2^32 multiple is exact.  Overflow-as-value
    discipline: a partition with > 2^32 output rows must not record a
    silently wrapped count."""
    s32 = int(res.join_tuples)
    sf = float(jnp.sum(res.match_cnts.astype(jnp.float32)))
    return s32 + (int(round((sf - s32) / 2.0**32)) << 32)


def _partition_side(
    keys, vals, factor: int, f_bits: int, chunk_rows: int, d: str,
    side: str, fp: dict | None = None,
):
    """Stream one relation through the device's radix pass; append the
    compacted fragments to per-partition files `{side}_{p}_{hk,val}.bin`.
    Returns (per-partition row counts, hk checksums, val checksums).
    The pass emits zero-padded regions; compaction is a host-side
    nonzero mask, the analog of the reference's exact fragment counts.
    A sidecar records the input fingerprint + per-partition
    counts/checksums for reuse; `fp` is the caller's precomputed
    fingerprint (recomputing it here would re-read the whole relation)."""
    F = 1 << f_bits
    n = len(keys)
    counts = np.zeros(F, np.int64)
    hk_csums = [0] * F
    val_csums = [0] * F
    if fp is None:
        fp = _side_fingerprint(keys, vals, factor, f_bits)
    _init_partition_files(d, side, F)
    # ONE static chunk shape: the tail chunk zero-pads to the full
    # chunk size (null-key pads are dropped by the pass) instead of
    # retracing the shape-specialized radix pass for a new tail shape
    eff = min(chunk_rows, n)
    pos = 0
    while pos < n:
        take = min(eff, n - pos)
        ck = np.zeros(eff, np.uint32)
        cv = np.zeros(eff, np.uint32)
        ck[:take] = np.asarray(keys[pos : pos + take])
        cv[:take] = np.asarray(vals[pos : pos + take])
        pos += take
        hk = hashed_key(jnp.asarray(ck), factor)
        bk, bv, cnts, ovf = radix_partition(hk, jnp.asarray(cv), f_bits)
        if int(ovf):
            # skew: size the regions from the exact counts and rerun
            bk, bv, cnts, ovf = radix_partition(
                hk, jnp.asarray(cv), f_bits, cap=int(jnp.max(cnts)))
        bk = np.asarray(bk).reshape(F, -1)
        bv = np.asarray(bv).reshape(F, -1)
        cnts = np.asarray(cnts)
        frags = []
        for p in range(F):
            live = bk[p] != 0
            assert int(live.sum()) == int(cnts[p])
            frags.append((bk[p][live], bv[p][live]))
        _append_fragments(d, side, frags, counts, hk_csums, val_csums)
    _write_side_sidecar(d, side, fp, counts, hk_csums, val_csums)
    return counts, hk_csums, val_csums


def grace_join(
    inner_keys,
    inner_vals,
    outer_keys,
    outer_vals,
    f_bits: int = 6,
    chunk_rows: int = 32_000_000,
    spill_dir: str | None = None,
    plan: JoinPlan | None = None,
    partition_budget_rows: int = 220_000_000,
    on_partition=None,
) -> GraceResult:
    """Join two host-resident relations, neither of which needs to fit
    device memory.  All four inputs are numpy arrays or np.memmap.

    on_partition(meta, res, raw_probe_keys) is called per partition with
    the partition's aligned JoinResult (probe keys already unscrambled)
    -- the hook for materializing consumers; without it only counts are
    accumulated.  spill_dir holds the partition files (a temp dir is
    required -- pass one explicitly so reruns can reuse the space).
    """
    if spill_dir is None:
        raise ValueError("grace_join needs spill_dir for partition files")
    if chunk_rows <= 0:
        raise ValueError("chunk_rows must be positive")
    os.makedirs(spill_dir, exist_ok=True)
    if plan is None:
        # per-partition planning happens per pair below; this fixes the
        # scramble factor the partition pass routes on
        plan = plan_join(
            max(1, len(inner_keys) >> f_bits),
            max(1, len(outer_keys) >> f_bits),
        )
    F = 1 << f_bits
    sides = {"build": (inner_keys, inner_vals),
             "probe": (outer_keys, outer_vals)}
    side_state, reused, side_fps, compute_side = _phase1(
        sides, spill_dir, plan.factor, f_bits,
        lambda k, v, side, fp: _partition_side(
            k, v, plan.factor, f_bits, chunk_rows, spill_dir, side, fp),
    )
    b_counts = side_state["build"][0]
    p_counts = side_state["probe"][0]
    nb_cap, np_cap, local = _budget_caps_local(
        b_counts, p_counts, partition_budget_rows, f_bits, plan)
    inv = np.uint64(mod_inverse_u32(plan.factor))
    total = 0
    load_side = _make_loader(spill_dir, side_state, reused, compute_side)

    def load_pair(p):
        bk, bv = load_side("build", p, int(b_counts[p]), nb_cap)
        pk, pv = load_side("probe", p, int(p_counts[p]), np_cap)
        # read + verify first, then issue the (async) H2D transfers
        return tuple(jax.device_put(a) for a in (bk, bv, pk, pv))

    live = [p for p in range(F) if int(b_counts[p]) and int(p_counts[p])]
    metas = [PartitionMeta(p, int(b_counts[p]), int(p_counts[p]), 0)
             for p in range(F)]
    # phase-2 resume: partitions already joined by a prior run over the
    # same inputs/routing (per the journal) contribute their recorded
    # counts and are skipped -- a crash mid-join redoes only the tail
    done = _phase2_journal(spill_dir, side_fps, on_partition)
    resumed = 0
    for p in [q for q in live if q in done]:
        metas[p].join_tuples = done[p]
        total += done[p]
        resumed += 1
    live = [p for p in live if p not in done]
    loaded: dict = {}
    for idx, p in enumerate(live):
        meta = metas[p]
        bk, bv, pk, pv = loaded.pop(p, None) or load_pair(p)
        # async dispatch; the local plan never declares unique_build, so
        # its result needs no violation check
        res = phj_join(bk, bv, pk, pv, local)
        # double buffering: issue the next pair's disk read + H2D only
        # AFTER the join dispatch above -- the read is blocking host
        # work, so issued first it would serialize with the device
        # instead of overlapping it
        if idx + 1 < len(live):
            loaded[live[idx + 1]] = load_pair(live[idx + 1])
        jt = _exact_join_tuples(res)
        meta.join_tuples = jt
        total += jt
        _journal_append(spill_dir, p, jt)
        if on_partition:
            # consumers index the flat padded layout
            res = res.flat()
            raw_pk = (
                np.asarray(res.probe_keys).astype(np.uint64) * inv
                % (1 << 32)
            ).astype(np.uint32)
            on_partition(meta, res, raw_pk)
    return GraceResult(total, metas, f_bits, reused_sides=dict(reused),
                       resumed_partitions=resumed)

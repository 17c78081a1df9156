"""Out-of-core streaming join: probe relations larger than device memory.

The host-DRAM tier is the analog of the reference's DDR half of the
two-tier layout (hma_malloc DDR-vs-MCDRAM, phj.cpp:241-268; ratio split
phj.cpp:101-116): the build side is sorted ONCE and stays device-resident,
while the probe side lives in host RAM (numpy array or np.memmap -- it
never needs to fit the device) and streams through it in fixed-size
chunks.  Each chunk runs the same merge pipeline as single-shot PHJ
(hash-order sort -> sorted-search probe) against the resident build
runs; chunk k+1's host->device transfer is issued before chunk k's
result is consumed, so the copy overlaps compute (double buffering).

Checkpoint/resume (engine/spill.py): each completed chunk spills its
result columns (match_vals, match_cnts -- the probe columns in chunk-
sorted order are deterministic replays of the input chunk, so they are
not duplicated on disk) plus a sidecar with the chunk input checksum,
join count, and the PLAN FINGERPRINT (factor, probe_chunks, cap) that
determines the spilled row order -- a re-run under a different plan
recomputes instead of resuming misaligned columns.  A restarted run
re-verifies the sidecar/columns and skips completed chunks (the
on_chunk hook receives a SpilledChunk carrying the verified columns;
`replay_probe_columns` reconstructs the matching probe columns on
demand); corrupted or missing spill recomputes that chunk.  Every chunk
is a pure function of (build order, chunk rows), so rerun-from-last-
chunk is always sound.

This is the single-device path to BASELINE config-5 scale (1B-row probe
sides): device memory holds only the build runs + two in-flight chunks.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np


from .config import JoinPlan, plan_join
from .phj import _staged_fns, downgrade_plan_opts, merge_cap
from .spill import _read_u32, _write_u32


@dataclasses.dataclass
class ChunkMeta:
    index: int
    rows: int
    join_tuples: int
    resumed: bool


@dataclasses.dataclass
class SpilledChunk:
    """Checksum-verified result columns of a chunk resumed from spill,
    handed to on_chunk in place of the live JoinResult.  The aligned
    probe columns are deterministic replays of the input chunk: use
    `replay_probe_columns(chunk_keys, chunk_vals, plan, cap)` to
    reconstruct them, giving consumers the full aligned result without
    re-running the probe."""

    match_vals: np.ndarray  # (cap,) u32, chunk-sorted order
    match_cnts: np.ndarray  # (cap,) int32


@dataclasses.dataclass
class StreamResult:
    join_tuples: int
    chunks: list  # ChunkMeta per chunk
    plan: JoinPlan

    @property
    def resumed_chunks(self) -> int:
        return sum(c.resumed for c in self.chunks)


from ..utils.host import u64sum as _chunk_checksum  # shared checksum


def _sidecar_path(d: str, k: int) -> str:
    return os.path.join(d, f"chunk_{k:06d}.json")


def _spill_chunk(d: str, k: int, mval, mcnt, meta: dict) -> None:
    # flatten: the on-disk format is the 1-D padded layout (chunk-row
    # 2-D engine results flatten to it row-major, matching the replay)
    mval = np.asarray(mval, dtype=np.uint32).reshape(-1)
    mcnt = np.asarray(mcnt, dtype=np.int32).astype(np.uint32).reshape(-1)
    _write_u32(os.path.join(d, f"chunk_{k:06d}_mval.bin"), mval)
    _write_u32(os.path.join(d, f"chunk_{k:06d}_mcnt.bin"), mcnt)
    meta = dict(meta, mval_checksum=_chunk_checksum(mval),
                mcnt_checksum=_chunk_checksum(mcnt))
    with open(_sidecar_path(d, k), "w") as f:
        json.dump(meta, f)


def _plan_fingerprint(plan: JoinPlan, cap: int) -> dict:
    """The plan fields that determine the spilled columns' ROW ORDER:
    the chunk-sorted layout depends on the scramble factor, the probe
    chunk count, and the padded capacity."""
    return {"factor": plan.factor,
            "probe_chunks": max(1, plan.probe_chunks), "cap": cap}


def _build_fingerprint(inner_keys, inner_vals) -> dict:
    """Identity of the BUILD side a chunk's results were computed
    against.  Without it a resume with a changed build relation (same
    probe, same spill_dir) would silently return the OLD build's
    matches (engine/grace.py fingerprints both sides; so must this)."""
    return {
        "build_rows": int(len(inner_keys)),
        "build_keys_checksum": _chunk_checksum(np.asarray(inner_keys)),
        "build_vals_checksum": _chunk_checksum(np.asarray(inner_vals)),
    }


def _try_resume_chunk(d: str, k: int, input_checksum: int, rows: int,
                      cap: int, plan: JoinPlan, build_fp: dict):
    """Returns (sidecar meta, SpilledChunk) if chunk k's spill is
    present, matches this input, this BUILD side, AND this plan's
    row-order fingerprint, and passes the column checksums; else None.
    A fingerprint mismatch (e.g. a re-run with a different factor,
    probe_chunks, or build relation) recomputes: the spilled columns
    came from the OLD configuration and would be silently wrong."""
    try:
        with open(_sidecar_path(d, k)) as f:
            meta = json.load(f)
        if meta["input_checksum"] != input_checksum or meta["rows"] != rows:
            return None
        fp = dict(_plan_fingerprint(plan, cap), **build_fp)
        if {key: meta.get(key) for key in fp} != fp:
            return None
        mval = _read_u32(os.path.join(d, f"chunk_{k:06d}_mval.bin"), cap)
        mcnt = _read_u32(os.path.join(d, f"chunk_{k:06d}_mcnt.bin"), cap)
        if (_chunk_checksum(mval) != meta["mval_checksum"]
                or _chunk_checksum(mcnt) != meta["mcnt_checksum"]):
            return None
        return meta, SpilledChunk(mval, mcnt.astype(np.int32))
    except (OSError, ValueError, KeyError):
        return None


def replay_probe_columns(chunk_keys, chunk_vals, plan: JoinPlan, cap: int):
    """Reconstruct the aligned probe columns (probe_keys, probe_vals) of
    a chunk -- the deterministic chunk-sorted replay that the spill
    intentionally does not duplicate on disk.  Combined with a
    SpilledChunk's match columns this is the chunk's full JoinResult."""
    from ..utils.hashing import hashed_key, mod_inverse_u32

    ck = np.zeros(cap, np.uint32)
    cv = np.zeros(cap, np.uint32)
    ck[: len(chunk_keys)] = chunk_keys
    cv[: len(chunk_vals)] = chunk_vals
    chunks = max(1, plan.probe_chunks)
    hk_s, v_s = jax.lax.sort(
        (hashed_key(jnp.asarray(ck), plan.factor).reshape(chunks, -1),
         jnp.asarray(cv).reshape(chunks, -1)),
        dimension=1, num_keys=1,
    )
    hk = np.asarray(hk_s).reshape(-1)
    inv = np.uint32(mod_inverse_u32(plan.factor))
    pk = (hk.astype(np.uint64) * inv % (1 << 32)).astype(np.uint32)
    return pk, np.asarray(v_s).reshape(-1)


def stream_join(
    inner_keys,
    inner_vals,
    outer_keys: np.ndarray,
    outer_vals: np.ndarray,
    chunk_rows: int,
    plan: JoinPlan | None = None,
    spill_dir: str | None = None,
    on_chunk=None,
) -> StreamResult:
    """Join a device-resident build side against a host-resident probe
    side.

    outer_keys/outer_vals: host numpy arrays or np.memmap -- only
    `chunk_rows` of each are ever device-resident (plus the in-flight
    next chunk).  spill_dir enables checkpoint/resume.  on_chunk, if
    given, is called with (ChunkMeta, payload) per chunk: a live
    JoinResult for computed chunks, a SpilledChunk (the verified match
    columns; probe columns via replay_probe_columns) for resumed ones --
    so consumers that materialize rows can complete a resumed run
    without recomputing any probe.  Prefetch skips over resumed chunks:
    the next chunk that will actually COMPUTE is the one in flight.
    """
    ni = len(inner_keys)
    no = len(outer_keys)
    if plan is None:
        plan = plan_join(ni, min(no, chunk_rows))
    cap = merge_cap(plan, chunk_rows)
    build_fp = (_build_fingerprint(inner_keys, inner_vals)
                if spill_dir else {})
    if spill_dir:
        os.makedirs(spill_dir, exist_ok=True)

    ik_d, iv_d = jnp.asarray(inner_keys), jnp.asarray(inner_vals)
    build, sort_probe, probe = _staged_fns(plan)
    runs, viol = build(ik_d, iv_d)
    if int(viol):
        # duplicate build keys under a unique_build declaration: drop the
        # declaration before any chunk runs (the chunk geometry, and so
        # the spill fingerprint, is unchanged)
        plan = downgrade_plan_opts(plan)
        build, sort_probe, probe = _staged_fns(plan)
        runs, viol = build(ik_d, iv_d)

    n_chunks = -(-no // chunk_rows)

    # one-entry host cache: get_status (spill mode) reads a chunk to
    # checksum it, and to_device for the SAME chunk follows immediately
    # -- without the handoff every computed chunk's key/val columns
    # would page in from the memmap twice
    host_cache: dict = {}

    def host_chunk(k):
        if k in host_cache:
            return host_cache.pop(k)
        sl = slice(k * chunk_rows, min((k + 1) * chunk_rows, no))
        return np.asarray(outer_keys[sl]), np.asarray(outer_vals[sl])

    def to_device(k):
        ck, cv = host_chunk(k)
        if len(ck) < chunk_rows:  # short tail: pad with null keys
            pad = chunk_rows - len(ck)
            ck = np.concatenate([ck, np.zeros(pad, np.uint32)])
            cv = np.concatenate([cv, np.zeros(pad, np.uint32)])
        # async H2D: returns immediately, the copy overlaps compute
        return jax.device_put(ck), jax.device_put(cv)

    # resolve each chunk's resume status host-side (cheap sidecar reads)
    # BEFORE issuing prefetches, so the in-flight H2D transfer is always
    # for the next chunk that will actually compute -- resumed chunks in
    # the middle of a run no longer force a synchronous refetch
    status: dict = {}  # k -> (rows, csum, resume_or_None)

    def get_status(k):
        if k not in status:
            if spill_dir:
                ck_host, cv_host = host_chunk(k)
                host_cache.clear()
                host_cache[k] = (ck_host, cv_host)
                rows = len(ck_host)
                csum = _chunk_checksum(ck_host)
                resume = _try_resume_chunk(spill_dir, k, csum, rows, cap,
                                           plan, build_fp)
            else:
                # no spill -> no checksum consumer: derive the row count
                # arithmetically instead of paging in the whole chunk
                rows = min(chunk_rows, no - k * chunk_rows)
                csum = None
                resume = None
            status[k] = (rows, csum, resume)
        return status[k]

    def next_compute(k):
        """First chunk index >= k that needs computing (n_chunks if none)."""
        while k < n_chunks and get_status(k)[2] is not None:
            k += 1
        return k

    chunks: list[ChunkMeta] = []
    total = 0
    pending = (-1, None)  # (chunk index, (dev_keys, dev_vals)) in flight
    for k in range(n_chunks):
        rows, csum, resume = get_status(k)
        if resume is not None:
            meta, spilled = resume
            cm = ChunkMeta(k, rows, meta["join_tuples"], True)
            chunks.append(cm)
            total += cm.join_tuples
            if on_chunk:
                on_chunk(cm, spilled)
            continue
        dk, dv = pending[1] if pending[0] == k else to_device(k)
        nk = next_compute(k + 1)
        pending = (nk, to_device(nk)) if nk < n_chunks else (-1, None)
        ohk_s, ov_s = sort_probe(dk, dv, cap)
        res = probe(runs, viol, ohk_s, ov_s)
        jt = int(res.join_tuples)
        cm = ChunkMeta(k, rows, jt, False)
        if spill_dir:
            _spill_chunk(
                spill_dir, k, res.match_vals, res.match_cnts,
                {"index": k, "rows": rows, "input_checksum": csum,
                 "join_tuples": jt,
                 **_plan_fingerprint(plan, cap), **build_fp},
            )
        chunks.append(cm)
        total += jt
        if on_chunk:
            on_chunk(cm, res)
    return StreamResult(total, chunks, plan)

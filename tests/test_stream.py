"""Out-of-core streaming join (engine/stream.py) vs the oracle, plus
spill/resume and corruption-recovery behavior."""

import numpy as np
import pytest

from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.engine.stream import stream_join


@pytest.fixture()
def workload():
    rng = np.random.default_rng(23)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    iv = rng.integers(0, 2**32, 2048, dtype=np.uint32)
    # probe: hits + misses, length NOT a multiple of the chunk size
    hits = ik[rng.integers(0, 2048, 9000)]
    miss = rng.integers(1, 2**32, 1500, dtype=np.uint32)
    ok = np.concatenate([hits, miss]).astype(np.uint32)
    rng.shuffle(ok)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    return ik, iv, ok, ov


def test_stream_join_matches_oracle(workload):
    ik, iv, ok, ov = workload
    rows = []

    def collect(cm, res):
        assert res is not None
        mc = np.asarray(res.match_cnts)
        m = mc == 1
        rows.append(
            (np.asarray(res.probe_keys)[m], np.asarray(res.probe_vals)[m],
             np.asarray(res.match_vals)[m])
        )

    sres = stream_join(ik, iv, ok, ov, chunk_rows=4096, on_chunk=collect)
    want = join_oracle(ik, iv, ok, ov)
    assert sres.join_tuples == len(want[0])
    assert len(sres.chunks) == 3  # 10500 rows / 4096
    got = multiset_digest(*(np.concatenate(cols) for cols in zip(*rows)))
    assert got == multiset_digest(*want)


def test_stream_join_spill_resume(tmp_path, workload):
    ik, iv, ok, ov = workload
    d = str(tmp_path / "spill")
    first = stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=d)
    assert first.resumed_chunks == 0
    second = stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=d)
    assert second.resumed_chunks == len(second.chunks) == 3
    assert second.join_tuples == first.join_tuples


def test_stream_resumed_chunks_can_materialize(tmp_path, workload):
    """A fully-resumed run must still let consumers materialize rows:
    on_chunk receives the verified SpilledChunk columns and
    replay_probe_columns reconstructs the aligned probe columns --
    digest must equal the fresh run's."""
    from hash_join_codes_knl_tpu.engine.stream import (
        SpilledChunk,
        replay_probe_columns,
    )

    ik, iv, ok, ov = workload
    d = str(tmp_path / "spill")
    stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=d)
    rows = []

    def collect(cm, payload):
        assert isinstance(payload, SpilledChunk), "resume must hand columns"
        k = cm.index
        sl = slice(k * 4096, min((k + 1) * 4096, len(ok)))
        pk, pv = replay_probe_columns(ok[sl], ov[sl], second_plan,
                                      len(payload.match_vals))
        m = payload.match_cnts == 1
        rows.append((pk[m], pv[m], payload.match_vals[m]))

    # plan must match the spilled fingerprint: reuse the first run's
    first = stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=d)
    second_plan = first.plan
    second = stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=d,
                         plan=second_plan, on_chunk=collect)
    assert second.resumed_chunks == 3
    got = multiset_digest(*(np.concatenate(cols) for cols in zip(*rows)))
    want = join_oracle(ik, iv, ok, ov)
    assert second.join_tuples == len(want[0])
    assert got == multiset_digest(*want)


def test_stream_plan_fingerprint_mismatch_recomputes(tmp_path, workload):
    """Spill written under one plan must NOT resume under a plan with a
    different row-order fingerprint (factor): the columns' chunk-sorted
    order would misalign replaying consumers (sidecar fingerprint)."""
    import dataclasses

    from hash_join_codes_knl_tpu.engine.config import plan_join

    ik, iv, ok, ov = workload
    d = str(tmp_path / "spill")
    base = plan_join(len(ik), 4096)
    first = stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=d,
                        plan=base)
    other = dataclasses.replace(base, factor=0x85EBCA77)
    second = stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=d,
                         plan=other)
    assert second.resumed_chunks == 0  # fingerprint mismatch -> recompute
    assert second.join_tuples == first.join_tuples
    # and the rewritten spill resumes cleanly under the new plan
    third = stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=d,
                        plan=other)
    assert third.resumed_chunks == 3


def test_stream_join_corrupted_spill_recomputed(tmp_path, workload):
    ik, iv, ok, ov = workload
    d = tmp_path / "spill"
    first = stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=str(d))
    # flip one byte in chunk 1's result column: resume must reject it and
    # recompute exactly that chunk
    target = d / "chunk_000001_mval.bin"
    blob = bytearray(target.read_bytes())
    blob[13] ^= 0xFF
    target.write_bytes(bytes(blob))
    second = stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=str(d))
    assert [c.resumed for c in second.chunks] == [True, False, True]
    assert second.join_tuples == first.join_tuples


def test_stream_join_input_change_invalidates_chunk(tmp_path, workload):
    ik, iv, ok, ov = workload
    d = str(tmp_path / "spill")
    stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=d)
    ok2 = ok.copy()
    ok2[4100] = ik[7]  # chunk 1's input changes -> checksum mismatch
    second = stream_join(ik, iv, ok2, ov, chunk_rows=4096, spill_dir=d)
    assert [c.resumed for c in second.chunks] == [True, False, True]
    want = join_oracle(ik, iv, ok2, ov)
    assert second.join_tuples == len(want[0])


def test_stream_cli_driver(tmp_path):
    """The driver surface: cli phj --stream-chunk-rows with spill, run
    twice -- the second run must resume every chunk."""
    import json

    from hash_join_codes_knl_tpu.cli import main

    d = str(tmp_path / "spill")
    args = ["phj", "1", "8192", "1024", "--seed", "11",
            "--dir", str(tmp_path),
            "--stream-chunk-rows", "2048", "--spill-dir", d, "--json"]
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(args) == 0
    m1 = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert m1["algorithm"] == "phj-stream"
    assert m1["chunks"] == 4 and m1["resumed_chunks"] == 0
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(args) == 0
    m2 = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert m2["resumed_chunks"] == 4
    assert m2["join_tuples"] == m1["join_tuples"]


def test_stream_resume_rejects_changed_build_side(tmp_path, workload):
    """Same probe, same spill dir, DIFFERENT build relation: the resume
    must recompute every chunk (the spilled matches came from the old
    build side and would be silently wrong), then resume again once the
    new build side has its own spills."""
    ik, iv, ok, ov = workload
    d = str(tmp_path / "spill")
    first = stream_join(ik, iv, ok, ov, chunk_rows=4096, spill_dir=d)
    assert first.resumed_chunks == 0
    iv2 = iv ^ np.uint32(0x5A5A5A5A)
    second = stream_join(ik, iv2, ok, ov, chunk_rows=4096, spill_dir=d)
    assert second.resumed_chunks == 0  # build fingerprint mismatch
    assert second.join_tuples == first.join_tuples
    third = stream_join(ik, iv2, ok, ov, chunk_rows=4096, spill_dir=d)
    assert third.resumed_chunks == len(third.chunks) == 3


def test_stream_plan_opt_violation_downgrades(workload):
    """unique_build declared on a duplicate-key build: the streaming
    driver must see the counted violation (build_counts[2]) before the
    first chunk, downgrade the flag WITHOUT changing geometry (spill
    fingerprints depend on geometry only), and produce exact results
    for every chunk."""
    import dataclasses

    from hash_join_codes_knl_tpu.engine.config import JoinPlan

    ik, iv, ok, ov = workload
    ik2 = np.concatenate([ik, ik[:256]])  # duplicate build keys
    iv2 = np.concatenate([iv, iv[:256] ^ np.uint32(0x5A5A5A5A)])
    plan = JoinPlan(p_bits=4, slots=256, tile=512, unique_build=True)
    sres = stream_join(ik2, iv2, ok, ov, chunk_rows=4096, plan=plan)
    assert not sres.plan.unique_build  # downgraded, not silent
    assert sres.plan == dataclasses.replace(plan, unique_build=False)
    want = join_oracle(ik2, iv2, ok, ov)
    assert sres.join_tuples == len(want[0])

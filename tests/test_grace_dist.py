"""Distributed Grace join (parallel/grace_dist.py): out-of-core BOTH
sides over a device mesh -- distributed radix pass with the owner
all_to_all, partition-parallel joins, spill interchange with the
single-chip driver."""

import numpy as np
import pytest

from hash_join_codes_knl_tpu.engine.grace import grace_join
from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.parallel.distributed import data_mesh
from hash_join_codes_knl_tpu.parallel.grace_dist import grace_join_dist


@pytest.fixture()
def workload():
    rng = np.random.default_rng(71)
    ik = np.unique(rng.integers(1, 2**32, 6000, dtype=np.uint32))[:4096]
    iv = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    hits = ik[rng.integers(0, 4096, 16000)]
    miss = rng.integers(1, 2**32, 3000, dtype=np.uint32)
    ok = np.concatenate([hits, miss]).astype(np.uint32)
    rng.shuffle(ok)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    return ik, iv, ok, ov


def test_grace_dist_matches_oracle(tmp_path, workload):
    """Multi-superchunk distributed pass (4 devices, 16 partitions, 4
    rounds); rows collected through on_partition reproduce the oracle
    multiset exactly and per-partition counts conserve the inputs."""
    ik, iv, ok, ov = workload
    mesh = data_mesh(4)
    rows = []

    def collect(meta, res, raw_pk):
        # on_partition gets the single-device drivers' 3-entry merge
        # layout in build_counts, not the raw mesh-concatenated
        # per-device array
        assert len(np.asarray(res.build_counts)) == 3
        mc = np.asarray(res.match_cnts)
        m = mc == 1
        rows.append((raw_pk[m], np.asarray(res.probe_vals)[m],
                     np.asarray(res.match_vals)[m]))

    gres = grace_join_dist(ik, iv, ok, ov, mesh, f_bits=4,
                           chunk_rows=3000,
                           spill_dir=str(tmp_path / "gd"),
                           on_partition=collect)
    want = join_oracle(ik, iv, ok, ov)
    assert gres.join_tuples == len(want[0])
    assert sum(m.build_rows for m in gres.partitions) == len(ik)
    assert sum(m.probe_rows for m in gres.partitions) == len(ok)
    got = multiset_digest(*(np.concatenate(c) for c in zip(*rows)))
    assert got == multiset_digest(*want)


def test_grace_dist_duplicate_build_keys(tmp_path, workload):
    """M:N cardinality is exact through the distributed partitioned
    path (duplicate build keys expand the output)."""
    ik, iv, ok, ov = workload
    dup_k = np.concatenate([ik, ik[:512]]).astype(np.uint32)
    dup_v = np.concatenate([iv, iv[:512] ^ 1]).astype(np.uint32)
    mesh = data_mesh(2)
    gres = grace_join_dist(dup_k, dup_v, ok, ov, mesh, f_bits=2,
                           chunk_rows=6000,
                           spill_dir=str(tmp_path / "gd2"))
    want = join_oracle(dup_k, dup_v, ok, ov)
    assert gres.join_tuples == len(want[0])


def test_grace_dist_spill_interchange(tmp_path, workload):
    """The distributed and single-chip drivers share the spill
    contract: a single-chip Grace run's phase-1 files resume a
    distributed run (and a distributed rerun reuses its own), because
    partition content depends only on the inputs and the (factor,
    f_bits) routing -- not the chunk size or the mesh shape."""
    ik, iv, ok, ov = workload
    d = str(tmp_path / "gx")
    mesh = data_mesh(4)
    r1 = grace_join(ik, iv, ok, ov, f_bits=4, chunk_rows=8000,
                    spill_dir=d)
    r2 = grace_join_dist(ik, iv, ok, ov, mesh, f_bits=4,
                         chunk_rows=2000, spill_dir=d)
    assert r2.reused_sides == {"build": True, "probe": True}
    assert r2.join_tuples == r1.join_tuples
    # the phase-2 journal is shared across drivers too: the single-chip
    # run already joined every partition, so the distributed rerun
    # resumes them all (counts-only run)
    n_live = sum(1 for m in r1.partitions if m.build_rows and m.probe_rows)
    assert r2.resumed_partitions == n_live
    # distributed rerun reuses its own spill too
    r3 = grace_join_dist(ik, iv, ok, ov, mesh, f_bits=4,
                         chunk_rows=2000, spill_dir=d)
    assert r3.reused_sides == {"build": True, "probe": True}
    assert r3.join_tuples == r1.join_tuples
    # different routing must NOT reuse
    r4 = grace_join_dist(ik, iv, ok, ov, mesh, f_bits=3,
                         chunk_rows=2000, spill_dir=d)
    assert r4.reused_sides == {"build": False, "probe": False}
    assert r4.join_tuples == r1.join_tuples


def test_grace_dist_cli_driver(tmp_path):
    """cli phj <threads> with --grace-bits routes to the distributed
    driver, end to end with cardinality verification."""
    import io
    import json
    from contextlib import redirect_stdout

    from hash_join_codes_knl_tpu.cli import main

    args = ["phj", "4", "8192", "2048", "--seed", "23",
            "--dir", str(tmp_path), "--grace-bits", "2",
            "--stream-chunk-rows", "8192",
            "--spill-dir", str(tmp_path / "spill"), "--json"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(args) == 0
    m = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert m["algorithm"] == "phj-grace"
    assert m["partitions"] == 4
    assert m["join_tuples"] == 8192


def test_grace_dist_guards(tmp_path, workload):
    """f_bits below log2(n_devices) and partition-budget overflow both
    raise with re-plan guidance, never join silently wrong."""
    ik, iv, ok, ov = workload
    mesh = data_mesh(4)
    with pytest.raises(ValueError, match="f_bits"):
        grace_join_dist(ik, iv, ok, ov, mesh, f_bits=1,
                        chunk_rows=4000,
                        spill_dir=str(tmp_path / "gg"))
    with pytest.raises(RuntimeError, match="f_bits"):
        grace_join_dist(ik, iv, ok, ov, mesh, f_bits=2,
                        chunk_rows=4000,
                        spill_dir=str(tmp_path / "gg2"),
                        partition_budget_rows=100)


def test_grace_dist_hot_key_chunk_host_fallback(tmp_path):
    """Distributed twin of the hot-key fallback: a shard dominated by
    one key must not kill the run after cap retries -- the superchunk
    partitions exactly on the host and the spills stay interchangeable
    (found by fuzz seed 9401: one key = 33% of probes)."""
    rng = np.random.default_rng(78)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    iv = rng.integers(0, 2**32, 2048, dtype=np.uint32)
    ok = ik[rng.integers(0, 2048, 16000)].astype(np.uint32)
    ok[:9000] = ik[9]
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    mesh = data_mesh(2)
    gres = grace_join_dist(ik, iv, ok, ov, mesh, f_bits=4,
                           chunk_rows=3000,
                           spill_dir=str(tmp_path / "hotd"))
    want = join_oracle(ik, iv, ok, ov)
    assert gres.join_tuples == len(want[0])

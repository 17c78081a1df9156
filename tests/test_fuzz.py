"""Randomized differential campaign: random workloads x random plans vs
the golden oracle.  Catches corner interactions (pad boundaries, window
edges, partition occupancy extremes) that targeted tests miss.  Seeds
are fixed -- failures are reproducible by case index.
"""

import numpy as np
import pytest

from hash_join_codes_knl_tpu.engine.config import JoinPlan
from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.engine.phj import (
    join,
    materialize,
    materialize_expanded,
)


def _case(seed):
    rng = np.random.default_rng(seed)
    ni = int(rng.integers(1, 5000))
    no = int(rng.integers(1, 20000))
    # build keys: sometimes unique, sometimes with duplicates
    pool = np.unique(rng.integers(1, 2**32, ni + 64, dtype=np.uint32))
    if rng.random() < 0.5:
        ik = pool[:ni]
    else:
        ik = pool[rng.integers(0, max(1, len(pool) // 2), ni)].astype(
            np.uint32
        )
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    # probes: mix of hits and misses, sometimes heavily skewed
    hits = ik[rng.integers(0, len(ik), no)]
    misses = rng.integers(1, 2**32, no, dtype=np.uint32)
    take_hit = rng.random(no) < rng.random()
    ok = np.where(take_hit, hits, misses).astype(np.uint32)
    if rng.random() < 0.3 and len(ik):
        ok[: no // 3] = ik[0]  # heavy hitter
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    # random-but-valid plan geometry (incl. the chunk-sorted probe path)
    tile = int(rng.choice([128, 256, 512, 1024, 2048]))
    p_bits = int(rng.integers(2, 8))
    chunks = int(rng.choice([0, 0, 2, 4, 8]))
    plan = JoinPlan(p_bits=p_bits, slots=4096, tile=tile,
                    pass_bits=(p_bits,), probe_chunks=chunks)
    return ik, iv, ok, ov, plan


@pytest.mark.parametrize("seed", range(101, 121))
def test_fuzz_join_vs_oracle(seed):
    ik, iv, ok, ov, plan = _case(seed)
    res, _ = join(ik, iv, ok, ov, plan)
    want_rows = join_oracle(ik, iv, ok, ov)
    assert int(res.join_tuples) == len(want_rows[0])
    mc = np.asarray(res.match_cnts)
    if mc.max(initial=0) <= 1:
        got = multiset_digest(*materialize(res))
    else:
        got = multiset_digest(*materialize_expanded(res, ik, iv))
    assert got == multiset_digest(*want_rows)


@pytest.mark.parametrize("seed", range(201, 206))
def test_fuzz_radix_padded_vs_oracle(seed):
    """The padded radix pipeline (multipass radix partition + dense
    table probe) on random workloads and random pass splits -- the
    parity-mode path the merge fuzz above never enters."""
    from hash_join_codes_knl_tpu.engine.phj import phj_join

    rng = np.random.default_rng(seed)
    ik, iv, ok, ov, _ = _case(seed)
    p_bits = int(rng.integers(2, 7))
    if rng.random() < 0.5 or p_bits < 4:
        passes = (p_bits,)
    else:
        lo = int(rng.integers(1, p_bits))
        passes = (p_bits - lo, lo)
    slots = 256
    while slots * (1 << p_bits) < 4 * len(ik):  # generous occupancy
        slots *= 2
    plan = JoinPlan(p_bits=p_bits, slots=slots, tile=1024,
                    pass_bits=passes, partition_impl="radix",
                    probe_impl="table")
    res = phj_join(ik, iv, ok, ov, plan)
    assert int(np.asarray(res.build_counts)[-1]) == 0, "pass overflow"
    want_rows = join_oracle(ik, iv, ok, ov)
    assert int(res.join_tuples) == len(want_rows[0])
    mc = np.asarray(res.match_cnts)
    if mc.max(initial=0) <= 1:
        got = multiset_digest(*materialize(res))
    else:
        got = multiset_digest(*materialize_expanded(res, ik, iv))
    assert got == multiset_digest(*want_rows)


@pytest.mark.parametrize("seed", range(501, 509))
def test_fuzz_npj_vs_oracle(seed):
    """NPJ (sorted search of the compact build) across random
    load factors, margins, and unique/duplicate builds."""
    from hash_join_codes_knl_tpu.engine.npj import npj_join, plan_npj

    rng = np.random.default_rng(seed)
    ik, iv, ok, ov, _ = _case(seed)
    plan = plan_npj(len(ik), load=float(rng.choice([0.25, 0.5, 0.9])))
    mv, mc, plan = npj_join(ik, iv, ok, ov, plan)
    want_rows = join_oracle(ik, iv, ok, ov)
    mc = np.asarray(mc)
    assert int(mc.astype(np.int64).sum()) == len(want_rows[0])
    if mc.max(initial=0) <= 1:
        m = mc == 1
        got = multiset_digest(np.asarray(ok)[m], np.asarray(ov)[m],
                              np.asarray(mv)[m])
        assert got == multiset_digest(*want_rows)


@pytest.mark.parametrize("seed", range(601, 606))
def test_fuzz_stream_resume_vs_oracle(seed, tmp_path):
    """Streaming join under random chunk sizes with a mid-run crash
    (a random suffix of the per-chunk spills deleted) and a resumed
    rerun: resumed + live counts and the materialized 1:1 multiset must
    all match the oracle (M:N digest coverage lives in the targeted
    stream tests)."""
    import os

    from hash_join_codes_knl_tpu.engine.stream import (
        SpilledChunk,
        replay_probe_columns,
        stream_join,
    )

    rng = np.random.default_rng(seed)
    ik, iv, ok, ov, _ = _case(seed)
    d = str(tmp_path / "fz_stream")
    chunk_rows = int(rng.integers(300, 6000))
    first = stream_join(ik, iv, ok, ov, chunk_rows=chunk_rows,
                        spill_dir=d)
    want_rows = join_oracle(ik, iv, ok, ov)
    assert first.join_tuples == len(want_rows[0])
    # crash simulation: drop a random suffix of the per-chunk spills
    n_chunks = len(first.chunks)
    keep = int(rng.integers(0, n_chunks))
    for k in range(keep, n_chunks):
        for f in os.listdir(d):
            if f.startswith(f"chunk_{k:06d}"):
                os.remove(os.path.join(d, f))
    rows = []

    def collect(cm, payload):
        k = cm.index
        sl = slice(k * chunk_rows, min((k + 1) * chunk_rows, len(ok)))
        if isinstance(payload, SpilledChunk):
            pk, pv = replay_probe_columns(ok[sl], ov[sl], first.plan,
                                          len(payload.match_vals))
            mval, mcnt = payload.match_vals, payload.match_cnts
        else:
            pk = np.asarray(payload.probe_keys)
            pv = np.asarray(payload.probe_vals)
            mval = np.asarray(payload.match_vals)
            mcnt = np.asarray(payload.match_cnts)
        m = np.asarray(mcnt) == 1
        rows.append((np.asarray(pk)[m], np.asarray(pv)[m],
                     np.asarray(mval)[m]))

    second = stream_join(ik, iv, ok, ov, chunk_rows=chunk_rows,
                         spill_dir=d, plan=first.plan, on_chunk=collect)
    assert second.join_tuples == first.join_tuples
    assert second.resumed_chunks == keep
    got = multiset_digest(*(np.concatenate(c) for c in zip(*rows)))
    # oracle restricted to 1:1 rows (mcnt == 1 <=> build multiplicity 1)
    wk, wv, wm = want_rows
    uk, uc = np.unique(ik, return_counts=True)
    mult = dict(zip(uk.tolist(), uc.tolist()))
    keep_m = np.fromiter((mult.get(int(k), 0) == 1 for k in wk),
                         count=len(wk), dtype=bool)
    assert got == multiset_digest(wk[keep_m], wv[keep_m], wm[keep_m])


@pytest.mark.parametrize("seed", range(301, 306))
def test_fuzz_cpra_vs_oracle(seed):
    import jax

    from hash_join_codes_knl_tpu.parallel.cpra import cpra_join

    rng = np.random.default_rng(seed)
    ik, iv, ok, ov, plan = _case(seed)
    n_chips = int(rng.choice([2, 4, 8]))
    mesh = jax.make_mesh((n_chips,), ("x",))
    # shard-divisible lengths
    ik = ik[: len(ik) // n_chips * n_chips]
    iv = iv[: len(ik)]
    ok = ok[: len(ok) // n_chips * n_chips]
    ov = ov[: len(ok)]
    if len(ik) == 0 or len(ok) == 0:
        pytest.skip("degenerate after shard rounding")
    res, _ = cpra_join(ik, iv, ok, ov, mesh, plan, slack=4.0, retries=3)
    want_rows = join_oracle(ik, iv, ok, ov)
    assert int(np.asarray(res.join_tuples).sum()) == len(want_rows[0])
    mc = np.asarray(res.match_cnts).reshape(-1)
    if mc.max(initial=0) <= 1:
        m = mc == 1
        got = multiset_digest(
            np.asarray(res.probe_keys).reshape(-1)[m],
            np.asarray(res.probe_vals).reshape(-1)[m],
            np.asarray(res.match_vals).reshape(-1)[m],
        )
    else:
        # M:N distributed digest: flatten the sharded result and expand
        # the full cross-product via materialize_expanded (the expansion
        # re-derives matched build rows from the global build relation,
        # so shard placement is irrelevant)
        from hash_join_codes_knl_tpu.engine.phj import JoinResult

        flat = JoinResult(
            *(np.asarray(getattr(res, f)).reshape(-1)
              for f in ("probe_keys", "probe_vals", "match_vals",
                        "match_cnts", "build_counts"))
        )
        got = multiset_digest(*materialize_expanded(flat, ik, iv))
    assert got == multiset_digest(*want_rows)


@pytest.mark.parametrize("seed", range(401, 405))
def test_fuzz_grace_dist_vs_oracle(seed, tmp_path):
    """Distributed Grace join on random workloads, meshes, fanouts and
    superchunk sizes: cardinality always, full multiset digest (M:N via
    the expansion op over the global build relation) always."""
    from hash_join_codes_knl_tpu.engine.phj import JoinResult
    from hash_join_codes_knl_tpu.parallel.distributed import data_mesh
    from hash_join_codes_knl_tpu.parallel.grace_dist import grace_join_dist

    rng = np.random.default_rng(seed)
    ik, iv, ok, ov, _ = _case(seed)
    n_dev = int(rng.choice([2, 4]))
    mesh = data_mesh(n_dev)
    f_bits = int(rng.integers((n_dev - 1).bit_length(), 5))
    chunk_rows = int(rng.integers(500, 4000))
    cols = [[], [], [], []]

    def collect(meta, res, raw_pk):
        for c, a in zip(cols, (raw_pk, res.probe_vals, res.match_vals,
                               res.match_cnts)):
            c.append(np.asarray(a))

    gres = grace_join_dist(ik, iv, ok, ov, mesh, f_bits=f_bits,
                           chunk_rows=chunk_rows,
                           spill_dir=str(tmp_path / "fz"),
                           on_partition=collect)
    want_rows = join_oracle(ik, iv, ok, ov)
    assert gres.join_tuples == len(want_rows[0])
    flat = JoinResult(*(np.concatenate(c) if c else np.zeros(0, np.uint32)
                        for c in cols), np.zeros(2, np.int32))
    got = multiset_digest(*materialize_expanded(flat, ik, iv))
    assert got == multiset_digest(*want_rows)


@pytest.mark.parametrize("seed", range(601, 609))
def test_fuzz_column_join_modes_vs_oracle(seed):
    """Random workloads through every columns-layer mode (inner/left/
    semi/anti), u32 and composite keys, vs a host oracle on the exact
    (outer_idx, inner_idx) pair multiset.  The oracle/checker are the
    SAME helpers test_columns.py uses (one mode-semantics source, no
    drift between the targeted tests and the fuzz draws)."""
    from test_columns import _check_mode

    from hash_join_codes_knl_tpu.engine.columns import (
        join_columns,
        join_columns_multi,
    )

    rng = np.random.default_rng(seed)
    ni = int(rng.integers(1, 3000))
    no = int(rng.integers(1, 8000))
    dup = rng.random() < 0.5
    span = int(rng.integers(ni // 2 + 1, 2**32)) if not dup else ni // 2 + 1
    ik = rng.integers(1, span + 1, ni, dtype=np.uint32)
    hits = ik[rng.integers(0, ni, no)]
    misses = rng.integers(1, 2**32, no, dtype=np.uint32)
    ok = np.where(rng.random(no) < rng.random(), hits, misses).astype(
        np.uint32
    )
    if seed % 2:
        # key 0 is the ENGINE's reserved null but a legal key at this
        # layer (routed through fold+verify): half the draws plant it
        # on both sides so the remap path stays fuzzed
        ik[: max(1, ni // 50)] = 0
        ok[: max(1, no // 50)] = 0
    inner_cols = {"iv": np.arange(ni, dtype=np.int64) + 1}
    outer_cols = {"ov": np.arange(no, dtype=np.int64) + 1}

    def check(out, how):
        _check_mode(out, ik, ok, inner_cols, outer_cols, how)

    for how in ("inner", "left", "semi", "anti"):
        out, _ = join_columns(ik, inner_cols, ok, outer_cols, how=how)
        check(out, how)
    # composite: split each u32 key into two int32 halves (hi 16 / lo 16
    # bits) -- the exact same join relation, via the multi-key path
    ik_hi = (ik >> 16).astype(np.int32)
    ik_lo = (ik & 0xFFFF).astype(np.int32)
    ok_hi = (ok >> 16).astype(np.int32)
    ok_lo = (ok & 0xFFFF).astype(np.int32)
    how = ("inner", "left", "semi", "anti")[seed % 4]
    out, _ = join_columns_multi((ik_hi, ik_lo), inner_cols,
                                (ok_hi, ok_lo), outer_cols, how=how)
    check(out, how)


@pytest.mark.parametrize("seed", range(240, 252))
def test_fuzz_chunked_aggregate_vs_numpy(seed):
    """Random (size, group count, chunks, partial cap, null fraction):
    the two-level aggregate either matches numpy exactly (overflow 0)
    or counts its dropped partials and the auto wrapper's fallback is
    exact."""
    import jax.numpy as jnp

    from hash_join_codes_knl_tpu.ops.aggregate import (
        hash_aggregate,
        hash_aggregate_auto,
        hash_aggregate_chunked,
    )

    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40000))
    g_target = int(rng.integers(1, max(2, n)))
    chunks = int(rng.choice([1, 2, 4, 8, 16]))
    pool = np.unique(rng.integers(1, 2**32, g_target + 64,
                                  dtype=np.uint32))[:g_target]
    keys = pool[rng.integers(0, len(pool), n)].astype(np.uint32)
    if rng.random() < 0.5:
        keys[rng.random(n) < rng.random() * 0.3] = 0  # nulls
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    cap = int(rng.choice([64, 1024, chunks * (-(-n // chunks))]))

    # numpy oracle
    live = keys != 0
    uk = np.unique(keys[live])
    want_sums = {int(k): np.uint32(vals[keys == k].sum()) for k in uk}

    ng, gk, sums, counts, ovf = hash_aggregate_chunked(
        jnp.asarray(keys), jnp.asarray(vals), chunks=chunks,
        partial_cap=cap,
    )
    if int(ovf) == 0:
        g = int(ng)
        assert g == len(uk), (seed, n, chunks, cap)
        gk_np = np.asarray(gk)[:g]
        assert np.array_equal(np.sort(gk_np), uk)
        for j, k in enumerate(gk_np[: min(g, 50)]):
            assert np.asarray(sums)[j] == want_sums[int(k)]
            assert np.asarray(counts)[j] == (keys == k).sum()
    # the auto wrapper is exact either way
    ra = hash_aggregate_auto(keys, vals, chunks=chunks, partial_cap=cap)
    n0, k0, s0, c0 = hash_aggregate(jnp.asarray(keys), jnp.asarray(vals))
    g0 = int(n0)
    assert int(ra[0]) == g0 == len(uk)
    np.testing.assert_array_equal(np.asarray(ra[1])[:g0],
                                  np.asarray(k0)[:g0])
    np.testing.assert_array_equal(np.asarray(ra[2])[:g0],
                                  np.asarray(s0)[:g0])
    np.testing.assert_array_equal(np.asarray(ra[3])[:g0],
                                  np.asarray(c0)[:g0])

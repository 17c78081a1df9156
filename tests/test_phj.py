"""End-to-end PHJ vs the golden oracle on generated workloads."""

import numpy as np
import pytest

from hash_join_codes_knl_tpu.engine.config import JoinPlan, plan_join
from hash_join_codes_knl_tpu.engine.oracle import (
    join_oracle,
    multiset_digest,
)
from hash_join_codes_knl_tpu.engine.phj import join, materialize
from hash_join_codes_knl_tpu.relation import expected_join_tuples
from hash_join_codes_knl_tpu.relgen.generate import generate


def _check_against_oracle(inner, outer):
    res, plan = join(inner.keys, inner.vals, outer.keys, outer.vals)
    if plan.probe_impl == "merge":
        # merge mode: build_counts = [0, 0, unique_build violations]
        assert int(np.asarray(res.build_counts)[2]) == 0, "violation"
    else:
        assert int(np.asarray(res.build_counts).max()) <= plan.slots, \
            "overflow"
    k, v, t = materialize(res)
    want = multiset_digest(*join_oracle(inner.keys, inner.vals,
                                        outer.keys, outer.vals))
    got = multiset_digest(k, v, t)
    assert got == want
    return res, plan


@pytest.mark.parametrize(
    "kw",
    [
        dict(inner_tuples=4096, outer_tuples=4096, mode="ref"),
        dict(inner_tuples=1024, outer_tuples=16384, mode="uniform"),
        dict(inner_tuples=1024, outer_tuples=16384, mode="zipf", zipf=1.0),
        dict(inner_tuples=2048, outer_tuples=16384, mode="uniform", selc=0.5),
        dict(inner_tuples=100, outer_tuples=3000, mode="uniform"),
    ],
)
def test_phj_matches_oracle(kw):
    inner, outer, _ = generate(seed=17, prefer_native=False, **kw)
    _check_against_oracle(inner, outer)


def test_phj_cardinality_formula_ref_mode():
    inner, outer, _ = generate(
        seed=23, inner_tuples=4096, outer_tuples=4096, prefer_native=False
    )
    res, _ = join(inner.keys, inner.vals, outer.keys, outer.vals)
    assert int(res.join_tuples) == expected_join_tuples(4096, 4096)


def test_phj_explicit_small_plan():
    inner, outer, _ = generate(
        seed=29, inner_tuples=512, outer_tuples=8192,
        mode="uniform", prefer_native=False,
    )
    plan = JoinPlan(p_bits=3, slots=128, tile=256, pass_bits=(3,))
    res, _ = join(inner.keys, inner.vals, outer.keys, outer.vals, plan)
    k, v, t = materialize(res)
    want = multiset_digest(*join_oracle(inner.keys, inner.vals,
                                        outer.keys, outer.vals))
    assert multiset_digest(k, v, t) == want


def test_plan_join_sanity():
    plan = plan_join(16_000_000, 256_000_000)
    assert plan.num_partitions >= 1 << 14
    assert plan.slots >= (16_000_000 >> plan.p_bits)
    assert sum(plan.pass_bits) == plan.p_bits
    plan_small = plan_join(100, 1000)
    assert plan_small.p_bits >= 1


def test_phj_merge_mode_matches_oracle():
    import dataclasses

    for kw in (
        dict(inner_tuples=4096, outer_tuples=4096, mode="ref"),
        dict(inner_tuples=1024, outer_tuples=16384, mode="uniform"),
        dict(inner_tuples=2048, outer_tuples=16384, mode="uniform", selc=0.5),
        dict(inner_tuples=1000, outer_tuples=9999, mode="zipf", zipf=1.0),
    ):
        inner, outer, _ = generate(seed=41, prefer_native=False, **kw)
        plan = JoinPlan(p_bits=6, slots=256, tile=256, pass_bits=(6,),
                        probe_impl="merge")
        res, _ = join(inner.keys, inner.vals, outer.keys, outer.vals, plan)
        k, v, t = materialize(res)
        want = multiset_digest(*join_oracle(inner.keys, inner.vals,
                                            outer.keys, outer.vals))
        assert multiset_digest(k, v, t) == want


def test_phj_merge_mode_mn_duplicates_and_expand():
    # duplicate build keys: merge probe must count multiplicity and the
    # expansion op must materialize the full M:N rows
    from hash_join_codes_knl_tpu.ops.expand import expand_join

    rng = np.random.default_rng(6)
    ik = rng.integers(1, 300, 2000, dtype=np.uint32)  # heavy duplication
    iv = rng.integers(0, 2**32, 2000, dtype=np.uint32)
    ok = rng.integers(1, 400, 4096, dtype=np.uint32)
    ov = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    plan = JoinPlan(p_bits=4, slots=256, tile=256, pass_bits=(4,),
                    probe_impl="merge")
    res, _ = join(ik, iv, ok, ov, plan)
    want_rows = join_oracle(ik, iv, ok, ov)
    assert int(res.join_tuples) == len(want_rows[0])
    assert int(np.asarray(res.match_cnts).max()) > 1  # real M:N
    # full materialization through the expansion path
    import jax.numpy as jnp
    total, k, v, t = expand_join(
        jnp.asarray(ik), jnp.asarray(iv), jnp.asarray(ok), jnp.asarray(ov),
        capacity=len(want_rows[0]) + 128,
    )
    assert multiset_digest(
        np.asarray(k)[: int(total)], np.asarray(v)[: int(total)],
        np.asarray(t)[: int(total)],
    ) == multiset_digest(*want_rows)


def test_join_replans_window_on_duplicate_heavy_build():
    """A build side with a single key repeated thousands of times: every
    probe of that key must count the whole run (3001 rows), never a
    short count."""
    rng = np.random.default_rng(53)
    base = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:1024]
    hot = base[0]
    ik = np.concatenate([base, np.full(3000, hot, np.uint32)])
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    ok = base[rng.integers(0, 1024, 8192)].astype(np.uint32)
    ov = rng.integers(0, 2**32, 8192, dtype=np.uint32)
    plan = JoinPlan(p_bits=4, slots=4096, tile=256, pass_bits=(4,))
    res, final_plan = join(ik, iv, ok, ov, plan)
    assert final_plan == plan
    assert int(np.asarray(res.build_counts)[2]) == 0
    # counts: each hot probe matches 3001 build rows
    mc = np.asarray(res.match_cnts)
    want_total = sum(3001 if k == hot else 1 for k in ok.tolist())
    assert int(mc.sum()) == want_total


def test_materialize_expanded_mn_join():
    """Duplicate-key build: full cross-product rows via the expansion
    path must match the oracle multiset."""
    rng = np.random.default_rng(71)
    base = np.unique(rng.integers(1, 2**32, 800, dtype=np.uint32))[:512]
    # each key appears 1-4 times in the build side
    reps = rng.integers(1, 5, 512)
    ik = np.repeat(base, reps).astype(np.uint32)
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    ok = base[rng.integers(0, 512, 4096)].astype(np.uint32)
    ov = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    res, _ = join(ik, iv, ok, ov)
    from hash_join_codes_knl_tpu.engine.phj import materialize_expanded

    k, v, t = materialize_expanded(res, ik, iv)
    want = multiset_digest(*join_oracle(ik, iv, ok, ov))
    assert multiset_digest(k, v, t) == want


@pytest.mark.parametrize("ni,no", [(1, 1), (1, 5000), (3, 17), (130, 2)])
def test_tiny_relations(ni, no):
    """Degenerate sizes must survive the padding geometry."""
    rng = np.random.default_rng(ni * 1000 + no)
    ik = np.unique(rng.integers(1, 2**32, ni + 10, dtype=np.uint32))[:ni]
    iv = ik * np.uint32(7)
    ok = ik[rng.integers(0, ni, no)].astype(np.uint32)
    ov = ok * np.uint32(13)
    res, _ = join(ik, iv, ok, ov)
    assert int(res.join_tuples) == no
    k, v, t = materialize(res)
    want = multiset_digest(*join_oracle(ik, iv, ok, ov))
    assert multiset_digest(k, v, t) == want


def test_no_matches_at_all():
    ik = np.arange(2, 1026, dtype=np.uint32) * 2  # even keys
    iv = ik.copy()
    ok = np.arange(1, 4097, dtype=np.uint32) * 2 + 1  # odd keys
    ov = ok.copy()
    res, _ = join(ik, iv, ok, ov)
    assert int(res.join_tuples) == 0
    k, v, t = materialize(res)
    assert len(k) == 0


def test_padded_radix_mode_consumes_pass_bits():
    """partition_impl='radix' runs the padded join through the multi-pass
    radix partitioner (pass_bits pass by pass, phj.cpp:1791-1863 analog)
    and must match the golden oracle exactly."""
    import numpy as np

    from hash_join_codes_knl_tpu.engine.config import JoinPlan
    from hash_join_codes_knl_tpu.engine.oracle import (
        join_oracle,
        multiset_digest,
    )
    from hash_join_codes_knl_tpu.engine.phj import materialize, phj_join

    rng = np.random.default_rng(29)
    ik = np.unique(rng.integers(1, 2**32, 4000, dtype=np.uint32))[:3000]
    iv = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    ok = np.concatenate(
        [ik[rng.integers(0, 3000, 9000)],
         rng.integers(1, 2**32, 3000, dtype=np.uint32)]
    ).astype(np.uint32)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    for pass_bits in ((6,), (3, 3)):
        plan = JoinPlan(p_bits=6, slots=1024, tile=2048,
                        pass_bits=pass_bits, partition_impl="radix",
                        probe_impl="table")
        import jax.numpy as jnp

        res = phj_join(jnp.asarray(ik), jnp.asarray(iv), jnp.asarray(ok),
                       jnp.asarray(ov), plan)
        assert int(np.asarray(res.build_counts)[-1]) == 0  # pass overflow
        got = multiset_digest(*materialize(res))
        want = multiset_digest(*join_oracle(ik, iv, ok, ov))
        assert got == want


def test_padded_radix_4096way_reference_fanout():
    """The reference CPRA's fixed operating point: NUM_PARTITIONS=4096
    (cpra2.cpp:2023), i.e. 12 radix bits consumed as two 6-bit passes --
    the bounded-fanout regime its pass loop (cpra2.cpp:1757-1827) always
    runs.  Verified at the multipass-partition level (every one of the
    4096 final regions must hold exactly its oracle multiset, pads
    excluded, zero pass overflow); the full join at this fanout runs in
    chip_smoke.py."""
    import jax.numpy as jnp
    import numpy as np

    from hash_join_codes_knl_tpu.ops.radix_partition import (
        multipass_partition,
    )
    from hash_join_codes_knl_tpu.utils.hashing import hashed_key

    rng = np.random.default_rng(41)
    keys = np.unique(rng.integers(1, 2**32, 9000, dtype=np.uint32))[:8192]
    vals = rng.integers(0, 2**32, 8192, dtype=np.uint32)
    hk = np.asarray(hashed_key(jnp.asarray(keys), 0x9E3779B1))
    k, v, counts, ovf = multipass_partition(
        jnp.asarray(hk), jnp.asarray(vals), (6, 6)
    )
    assert int(ovf) == 0
    counts = np.asarray(counts)
    assert counts.shape == (4096,) and counts.sum() == 8192
    k = np.asarray(k)
    v = np.asarray(v)
    cap = len(k) // 4096
    pid = (hk >> np.uint32(20)).astype(np.int64)  # top 12 bits
    # exact per-region counts for ALL 4096 regions
    np.testing.assert_array_equal(counts, np.bincount(pid, minlength=4096))
    # per-region multiset content check, sampled every 64th region
    for p in range(0, 4096, 64):
        reg_k = k[p * cap : (p + 1) * cap]
        reg_v = v[p * cap : (p + 1) * cap]
        live = reg_k != 0
        want = pid == p
        assert live.sum() == counts[p] == want.sum()
        got = sorted(zip(reg_k[live].tolist(), reg_v[live].tolist()))
        exp = sorted(zip(hk[want].tolist(), vals[want].tolist()))
        assert got == exp, f"region {p}"


def test_reference_pass_plan_policy():
    """reference_pass_plan reproduces the reference's pass/fanout policy
    (phj.cpp:1791-1808): partitions = local/6400, passes by thresholds
    {10, 400, 20000, 1e6}, per-pass fanout = partitions^(1/passes) with
    the last pass absorbing the rounding remainder."""
    from hash_join_codes_knl_tpu.engine.config import reference_pass_plan

    # partitions <= 10: the shared inter-thread pass suffices
    assert reference_pass_plan(6400 * 8) == ()
    assert reference_pass_plan(64_000) == ()
    # one pass: 10 < partitions <= 400
    assert reference_pass_plan(6400 * 400) == (400,)
    # two passes: the 16M-local-tuples CPRA shape -> 2500-way as 50 x 50
    assert reference_pass_plan(16_000_000) == (50, 50)
    # three passes: partitions = 2^15, floor(cbrt) = 31, last pass
    # absorbs the remainder: 32768 // (31*31) = 34
    assert reference_pass_plan(6400 * (1 << 15)) == (31, 31, 34)


def test_merge_probe_chunked_sort_matches_oracle():
    """probe_chunks > 1: the probe side is sorted as independent chunks
    (batched 2-D sort); results must be exactly the oracle's."""
    import numpy as np
    import jax.numpy as jnp

    from hash_join_codes_knl_tpu.engine.config import plan_join
    from hash_join_codes_knl_tpu.engine.oracle import (
        join_oracle,
        multiset_digest,
    )
    from hash_join_codes_knl_tpu.engine.phj import materialize, phj_join

    rng = np.random.default_rng(47)
    ik = np.unique(rng.integers(1, 2**32, 5000, dtype=np.uint32))[:4096]
    iv = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    ok = np.concatenate(
        [ik[rng.integers(0, 4096, 30000)],
         rng.integers(1, 2**32, 2768, dtype=np.uint32)]
    ).astype(np.uint32)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    import dataclasses

    plan = dataclasses.replace(plan_join(4096, len(ok), tile=512),
                               probe_chunks=4)
    res = phj_join(jnp.asarray(ik), jnp.asarray(iv), jnp.asarray(ok),
                   jnp.asarray(ov), plan)
    assert res.probe_keys.shape[0] == 4  # the chunk-row 2-D layout
    got = multiset_digest(*materialize(res))
    want = multiset_digest(*join_oracle(ik, iv, ok, ov))
    assert got == want


def test_materialize_expanded_block_streaming():
    """block_rows streams the expansion through fixed-size device blocks;
    results must equal the single-shot expansion and the oracle,
    including a single key whose multiplicity exceeds the block size
    (auto-raise)."""
    rng = np.random.default_rng(91)
    base = np.unique(rng.integers(1, 2**32, 600, dtype=np.uint32))[:256]
    reps = rng.integers(1, 6, 256)
    reps[7] = 700  # one key's multiplicity exceeds block_rows=512
    ik = np.repeat(base, reps).astype(np.uint32)
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    ok = base[rng.integers(0, 256, 2048)].astype(np.uint32)
    ov = rng.integers(0, 2**32, 2048, dtype=np.uint32)
    res, _ = join(ik, iv, ok, ov)
    from hash_join_codes_knl_tpu.engine.phj import materialize_expanded

    single = materialize_expanded(res, ik, iv)
    blocked = materialize_expanded(res, ik, iv, block_rows=512)
    assert multiset_digest(*blocked) == multiset_digest(*single)
    assert multiset_digest(*blocked) == multiset_digest(
        *join_oracle(ik, iv, ok, ov)
    )


def test_join_raises_on_padded_overflow():
    """The join() wrapper must RAISE on padded-table / radix overflow
    (dropped tuples) rather than return a silently truncated result."""
    import pytest

    from hash_join_codes_knl_tpu.engine.config import JoinPlan
    from hash_join_codes_knl_tpu.engine.phj import join as auto_join

    rng = np.random.default_rng(83)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    iv = rng.integers(0, 2**32, 2048, dtype=np.uint32)
    ok = ik[rng.integers(0, 2048, 4096)].astype(np.uint32)
    ov = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    # 4 partitions x 128 slots for 2048 build rows: guaranteed drops
    plan = JoinPlan(p_bits=2, slots=128, tile=128, pass_bits=(2,),
                    probe_impl="table")
    with pytest.raises(RuntimeError, match="slots"):
        auto_join(ik, iv, ok, ov, plan)


def test_unique_build_skips_secondary_sort_and_validates():
    """plan.unique_build (the reference's -D_UNIQUE analog,
    npj.cpp:954-956): exact on genuinely unique build keys, and a
    COUNTED violation + automatic downgrade on duplicate builds --
    never a silently short count or non-maximal match value."""
    import dataclasses

    import jax.numpy as jnp

    from hash_join_codes_knl_tpu.engine.phj import (
        materialize_expanded,
        phj_join,
    )

    rng = np.random.default_rng(61)
    ik = np.unique(rng.integers(1, 2**32, 4000, dtype=np.uint32))[:2048]
    iv = rng.integers(0, 2**32, 2048, dtype=np.uint32)
    ok = ik[rng.integers(0, 2048, 8192)].astype(np.uint32)
    ov = rng.integers(0, 2**32, 8192, dtype=np.uint32)
    plan = JoinPlan(p_bits=4, slots=256, tile=256, pass_bits=(4,),
                    probe_impl="merge", unique_build=True)
    res, plan_out = join(ik, iv, ok, ov, plan)
    assert plan_out.unique_build  # no downgrade on clean input
    assert int(np.asarray(res.build_counts)[2]) == 0
    k, v, t = materialize(res)
    want = multiset_digest(*join_oracle(ik, iv, ok, ov))
    assert multiset_digest(k, v, t) == want

    # duplicate build keys under a (wrong) unique declaration: the
    # engine counts the violation and join() downgrades to the
    # run-compacting build -- exact counts and max-val semantics
    ik2 = np.concatenate([ik, ik[:512]])
    iv2 = rng.integers(0, 2**32, len(ik2), dtype=np.uint32)
    first = phj_join(jnp.asarray(ik2), jnp.asarray(iv2), jnp.asarray(ok),
                     jnp.asarray(ov), plan)
    assert int(np.asarray(first.build_counts)[2]) == 512  # counted
    res2, plan2 = join(ik2, iv2, ok, ov, plan)
    assert not plan2.unique_build  # downgraded
    assert plan2 == dataclasses.replace(plan, unique_build=False)
    assert int(np.asarray(res2.build_counts)[2]) == 0
    k2, v2, t2 = materialize_expanded(res2, ik2, iv2)
    want2 = multiset_digest(*join_oracle(ik2, iv2, ok, ov))
    assert multiset_digest(k2, v2, t2) == want2


def test_unknown_probe_impl_raises():
    import pytest

    plan = JoinPlan(p_bits=2, slots=128, tile=128, probe_impl="pallas")
    with pytest.raises(ValueError, match="probe_impl"):
        join(np.ones(4, np.uint32), np.ones(4, np.uint32),
             np.ones(4, np.uint32), np.ones(4, np.uint32), plan)

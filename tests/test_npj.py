"""NPJ engine vs the golden oracle; table-structure invariants."""

import numpy as np
import jax.numpy as jnp
import pytest

from hash_join_codes_knl_tpu.engine.npj import NpjPlan, npj_build, npj_join, plan_npj
from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.relgen.generate import generate
from hash_join_codes_knl_tpu.utils.hashing import np_range_hash


def test_npj_build_findable_invariant():
    # every key must be reachable from its home bucket scanning forward to
    # the first empty slot
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 2**32, 3000, dtype=np.uint32)
    vals = keys * np.uint32(3)
    plan = plan_npj(len(keys), load=0.75)
    tk, tv, ov, max_disp = npj_build(jnp.asarray(keys), jnp.asarray(vals),
                                     plan)
    assert int(ov) == 0
    tk = np.asarray(tk)
    # displacement bound: every key sits within max_disp of its home bucket
    h_all = np_range_hash(keys, plan.factor, plan.buckets)
    occupied = np.flatnonzero(tk != 0)
    assert int(max_disp) >= 0
    h = np_range_hash(keys, plan.factor, plan.buckets)
    for k, hh in zip(keys[:500], h[:500]):
        s = int(hh)
        while True:
            assert tk[s] != 0, "hit empty before finding key"
            if tk[s] == k:
                break
            s += 1


@pytest.mark.parametrize(
    "kw",
    [
        dict(inner_tuples=4096, outer_tuples=4096, mode="ref"),
        dict(inner_tuples=1024, outer_tuples=8192, mode="uniform"),
        dict(inner_tuples=1024, outer_tuples=8192, mode="zipf", zipf=1.0),
    ],
)
def test_npj_matches_oracle(kw):
    inner, outer, _ = generate(seed=37, prefer_native=False, **kw)
    mv, mc, _ = npj_join(inner.keys, inner.vals, outer.keys, outer.vals)
    mv, mc = np.asarray(mv), np.asarray(mc)
    assert mc.max() <= 1  # unique build keys on these workloads
    m = mc == 1
    got = multiset_digest(outer.keys[m], outer.vals[m], mv[m])
    want = multiset_digest(
        *join_oracle(inner.keys, inner.vals, outer.keys, outer.vals)
    )
    assert got == want


def test_npj_duplicate_build_keys_counted():
    ik = np.array([5, 5, 9], dtype=np.uint32)
    iv = np.array([1, 2, 3], dtype=np.uint32)
    ok = np.array([5, 9, 7], dtype=np.uint32)
    mv, mc, _ = npj_join(ik, iv, ok, ok)
    np.testing.assert_array_equal(np.asarray(mc), [2, 1, 0])
    assert int(np.asarray(mv)[0]) == 2  # max of matched vals


def test_npj_sorted_probe_matches_chain_walk():
    """The sorted probe and the chain-walk oracle must agree exactly,
    including duplicate build keys and missing probes."""
    import dataclasses

    rng = np.random.default_rng(77)
    ik = rng.integers(1, 4000, 3000, dtype=np.uint32)  # many duplicates
    iv = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    ok = np.concatenate(
        [ik[rng.integers(0, 3000, 5000)],
         rng.integers(1, 2**32, 3000, dtype=np.uint32)]
    ).astype(np.uint32)
    mv0, mc0, plan = npj_join(ik, iv, ok, ok)
    assert plan.probe_impl == "sorted"
    chain = dataclasses.replace(plan, probe_impl="chain")
    mv1, mc1, _ = npj_join(ik, iv, ok, ok, chain)
    np.testing.assert_array_equal(np.asarray(mc0), np.asarray(mc1))
    np.testing.assert_array_equal(np.asarray(mv0), np.asarray(mv1))


def test_npj_unique_mode_matches_default():
    """_UNIQUE analog (npj.cpp:954-956): with distinct build keys, early
    lane retirement must not change any result."""
    import dataclasses

    import jax.numpy as jnp

    rng = np.random.default_rng(61)
    ik = np.unique(rng.integers(1, 2**32, 5000, dtype=np.uint32))[:4096]
    iv = ik * np.uint32(3)
    ok = ik[rng.integers(0, 4096, 16384)].astype(np.uint32)
    mv0, mc0, plan = npj_join(ik, iv, ok, ok)
    # unique-mode early retirement only exists on the chain walk
    plan_u = dataclasses.replace(plan, unique=True, probe_impl="chain")
    mv1, mc1, _ = npj_join(ik, iv, ok, ok, plan_u)
    np.testing.assert_array_equal(np.asarray(mv0), np.asarray(mv1))
    np.testing.assert_array_equal(np.asarray(mc0), np.asarray(mc1))


def test_npj_sorted_const_tile_bucket_collision():
    """A probe side of ONE hot key plus a distinct key sharing its home
    bucket: the collider must get its own row, never the hot key's."""
    rng = np.random.default_rng(5)
    ik = np.unique(rng.integers(1, 2**32, 60_000, dtype=np.uint32))[:32768]
    iv = (np.arange(len(ik), dtype=np.uint32) + 1) * np.uint32(7)
    plan = plan_npj(len(ik))
    h0 = np_range_hash(ik, plan.factor, plan.buckets)
    order = np.argsort(h0, kind="stable")
    dup = np.flatnonzero(np.diff(h0[order]) == 0)
    assert len(dup), "need at least one bucket collision in the build"
    a = ik[order[dup[0]]]
    b = ik[order[dup[0] + 1]]
    assert a != b and h0[order[dup[0]]] == h0[order[dup[0] + 1]]
    ok = np.full(2048, a, np.uint32)
    ok[1024] = b
    for order_kw in ("input", "sorted"):
        out = npj_join(ik, iv, ok, ok, order=order_kw)
        if order_kw == "input":
            mv, mc, _ = out
            keys = ok
        else:
            keys, _, mv, mc, _ = out
        keys, mv, mc = (np.asarray(x) for x in (keys, mv, mc))
        va = int(iv[ik == a][0])
        vb = int(iv[ik == b][0])
        assert (mc == 1).all()
        assert (mv[keys == a] == va).all()
        assert (mv[keys == b] == vb).all(), "collider got the hot key's row"


def _clustered_build(plan, rng, n_cluster=4500):
    """Distinct keys whose home buckets crowd into 200 buckets: parking
    pushes them thousands of slots past home (large max_disp)."""
    pool = np.unique(rng.integers(1, 2**32, 400_000, dtype=np.uint32))
    h0 = np_range_hash(pool, plan.factor, plan.buckets)
    mid = pool[(h0 >= 2000) & (h0 < 2200)][:n_cluster]
    rest = pool[(h0 < 1500)][:1000]
    return np.concatenate([mid, rest]).astype(np.uint32)


@pytest.mark.parametrize("order", ["input", "sorted"])
@pytest.mark.parametrize("load", [0.5, 0.9])
@pytest.mark.parametrize("build", ["uniform", "clustered"])
def test_npj_probe_matches_oracle(order, load, build):
    """The sorted probe, in both output orders, at the reference's load
    factor and the default one, on a uniform build and on a clustered
    build whose parking displacement is large -- against the oracle and
    the chain walk."""
    import dataclasses

    rng = np.random.default_rng(int(load * 10) + len(build))
    if build == "uniform":
        ik = np.unique(rng.integers(1, 2**32, 6000, dtype=np.uint32))[:4096]
        plan = plan_npj(len(ik), load=load)
    else:
        plan = NpjPlan(buckets=1 << 13)
        ik = _clustered_build(plan, rng)
        plan = plan_npj(len(ik), load=load)
        plan = dataclasses.replace(plan, buckets=1 << 13)
        _, _, ovf, max_disp = npj_build(jnp.asarray(ik),
                                        jnp.asarray(ik), plan)
        assert int(ovf) == 0 and int(max_disp) > 1000  # the premise
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    ok = np.concatenate([ik[rng.integers(0, len(ik), 6000)],
                         rng.integers(1, 2**32, 2000, dtype=np.uint32)])
    ok = ok.astype(np.uint32)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    want = multiset_digest(*join_oracle(ik, iv, ok, ov))
    if order == "input":
        mv, mc, _ = npj_join(ik, iv, ok, ov, plan)
        mv, mc = np.asarray(mv), np.asarray(mc)
        m = mc == 1
        assert multiset_digest(ok[m], ov[m], mv[m]) == want
        cmv, cmc, _ = npj_join(ik, iv, ok, ov,
                               dataclasses.replace(plan, probe_impl="chain"))
        np.testing.assert_array_equal(mc, np.asarray(cmc))
        np.testing.assert_array_equal(mv, np.asarray(cmv))
    else:
        k, v, mv, mc, _ = npj_join(ik, iv, ok, ov, plan, order="sorted")
        k, v, mv, mc = (np.asarray(x) for x in (k, v, mv, mc))
        m = mc == 1
        assert multiset_digest(k[m], v[m], mv[m]) == want


def test_npj_sorted_order_output_matches_input_order():
    """order='sorted' (one probe-side sort, PHJ-style sorted-aligned
    output) must produce the same row multiset as the default
    input-order contract, including M:N counts and misses."""
    rng = np.random.default_rng(83)
    ik = rng.integers(1, 4000, 3000, dtype=np.uint32)  # duplicates
    iv = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    ok = np.concatenate(
        [ik[rng.integers(0, 3000, 5000)],
         rng.integers(1, 2**32, 2000, dtype=np.uint32)]
    ).astype(np.uint32)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    mv0, mc0, plan0 = npj_join(ik, iv, ok, ov)
    k_s, v_s, mv1, mc1, plan1 = npj_join(ik, iv, ok, ov, order="sorted")
    assert plan1 == plan0
    k_s, v_s = np.asarray(k_s), np.asarray(v_s)
    mv1, mc1 = np.asarray(mv1), np.asarray(mc1)
    live = k_s != 0
    assert live.sum() == len(ok)
    # pads carry zero counts
    assert mc1[~live].sum() == 0
    # row-multiset equality of (key, val, match_val, cnt)
    a = np.lexsort((np.asarray(mc0), np.asarray(mv0), ov, ok))
    b = np.lexsort((mc1[live], mv1[live], v_s[live], k_s[live]))
    np.testing.assert_array_equal(ok[a], k_s[live][b])
    np.testing.assert_array_equal(ov[a], v_s[live][b])
    np.testing.assert_array_equal(np.asarray(mv0)[a], mv1[live][b])
    np.testing.assert_array_equal(np.asarray(mc0)[a], mc1[live][b])
    with pytest.raises(ValueError, match="sorted probe engine only"):
        import dataclasses

        npj_join(ik, iv, ok, ov,
                 dataclasses.replace(plan0, probe_impl="chain"),
                 order="sorted")

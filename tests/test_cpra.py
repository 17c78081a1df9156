"""Distributed CPRA join on an 8-virtual-device CPU mesh vs the oracle."""

import jax
import numpy as np
import pytest

from hash_join_codes_knl_tpu.engine.config import JoinPlan
from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.parallel.cpra import cpra_join, pack_by_owner
from hash_join_codes_knl_tpu.relgen.generate import generate

import jax.numpy as jnp


def _digest_aligned(res):
    mc = np.asarray(res.match_cnts).reshape(-1)
    assert mc.max(initial=0) <= 1
    m = mc == 1
    return multiset_digest(
        np.asarray(res.probe_keys).reshape(-1)[m],
        np.asarray(res.probe_vals).reshape(-1)[m],
        np.asarray(res.match_vals).reshape(-1)[m],
    )


def test_pack_by_owner_roundtrip():
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 2**32, 1000, dtype=np.uint32)
    vals = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    owner = rng.integers(0, 4, 1000).astype(np.int32)
    bk, bv, cnt = pack_by_owner(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(owner), 4, 512
    )
    bk, bv, cnt = np.asarray(bk), np.asarray(bv), np.asarray(cnt)
    assert cnt.sum() == 1000
    for c in range(4):
        np.testing.assert_array_equal(bk[c, : cnt[c]], keys[owner == c])
        np.testing.assert_array_equal(bv[c, : cnt[c]], vals[owner == c])
        assert (bk[c, cnt[c] :] == 0).all()


@pytest.mark.parametrize("n_chips", [2, 8])
@pytest.mark.parametrize(
    "kw",
    [
        dict(inner_tuples=4096, outer_tuples=4096, mode="ref"),
        dict(inner_tuples=2048, outer_tuples=32768, mode="uniform"),
        dict(inner_tuples=2048, outer_tuples=32768, mode="zipf", zipf=0.75),
        dict(inner_tuples=4096, outer_tuples=32768, mode="uniform", selc=0.5),
    ],
)
def test_cpra_matches_oracle(n_chips, kw):
    inner, outer, _ = generate(seed=31, prefer_native=False, **kw)
    mesh = jax.make_mesh((n_chips,), ("x",))
    plan = JoinPlan(p_bits=6, slots=256, tile=256, pass_bits=(6,))
    res, _ = cpra_join(
        inner.keys, inner.vals, outer.keys, outer.vals, mesh, plan, slack=4.0
    )
    want = multiset_digest(
        *join_oracle(inner.keys, inner.vals, outer.keys, outer.vals)
    )
    assert _digest_aligned(res) == want


def test_cpra_overflow_detection():
    # all keys identical -> one owner chip gets everything -> tiny caps blow
    keys = np.full(4096, 12345, dtype=np.uint32)
    vals = keys.copy()
    mesh = jax.make_mesh((8,), ("x",))
    plan = JoinPlan(p_bits=4, slots=64, tile=128, pass_bits=(4,))
    with pytest.raises(RuntimeError, match="overflow"):
        cpra_join(keys, vals, keys, vals, mesh, plan, slack=1.0)


def test_cpra_skew_heavy_hitter_replication():
    # one key carries ~30% of the probe stream: without skew handling the
    # owner chip's bucket overflows at slack 1.5; with replication it works
    rng = np.random.default_rng(11)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    iv = ik * np.uint32(3)
    hot = ik[7]
    picks = ik[rng.integers(0, 2048, 32768)]
    hot_mask = rng.random(32768) < 0.30
    ok = np.where(hot_mask, hot, picks).astype(np.uint32)
    ov = ok * np.uint32(5)
    mesh = jax.make_mesh((8,), ("x",))
    plan = JoinPlan(p_bits=6, slots=128, tile=256, pass_bits=(6,))

    with pytest.raises(RuntimeError, match="overflow"):
        cpra_join(ik, iv, ok, ov, mesh, plan, slack=1.5, retries=0)

    res, heavy, _ = cpra_join(ik, iv, ok, ov, mesh, plan, slack=1.5,
                              skew=True, heavy_frac=1 / 64)
    # union of light + heavy rows must equal the oracle
    lk, lv, lt, lc = (np.asarray(x).reshape(-1) for x in (
        res.probe_keys, res.probe_vals, res.match_vals, res.match_cnts))
    hk, hv, ht, hc = (np.asarray(x).reshape(-1) for x in heavy)
    assert max(lc.max(), hc.max()) <= 1
    keys = np.concatenate([lk[lc == 1], hk[hc == 1]])
    vals = np.concatenate([lv[lc == 1], hv[hc == 1]])
    tabs = np.concatenate([lt[lc == 1], ht[hc == 1]])
    got = multiset_digest(keys, vals, tabs)
    want = multiset_digest(*join_oracle(ik, iv, ok, ov))
    assert got == want
    # the hot key's rows must have come through the heavy path
    assert (hk[hc == 1] == hot).sum() == (ok == hot).sum()


def test_cpra_single_chip_mesh():
    inner, outer, _ = generate(seed=61, inner_tuples=1024,
                               outer_tuples=8192, mode="uniform",
                               prefer_native=False)
    mesh = jax.make_mesh((1,), ("x",))
    plan = JoinPlan(p_bits=5, slots=128, tile=128, pass_bits=(5,))
    res, _ = cpra_join(inner.keys, inner.vals, outer.keys, outer.vals,
                       mesh, plan, slack=4.0)
    want = multiset_digest(
        *join_oracle(inner.keys, inner.vals, outer.keys, outer.vals)
    )
    assert _digest_aligned(res) == want


def test_cpra_single_chip_padded_overflow_raises():
    """The degenerate 1-chip path must surface padded-table overflow
    (dropped tuples) as an error like the mesh loop does, never return
    a silently truncated result."""
    inner, outer, _ = generate(seed=67, inner_tuples=1024,
                               outer_tuples=4096, mode="uniform",
                               prefer_native=False)
    mesh = jax.make_mesh((1,), ("x",))
    # 4 partitions x 128 slots for 1024 build rows (~256/partition):
    # guaranteed drops
    plan = JoinPlan(p_bits=2, slots=128, tile=128, pass_bits=(2,),
                    probe_impl="table")
    with pytest.raises(RuntimeError, match="slots"):
        cpra_join(inner.keys, inner.vals, outer.keys, outer.vals,
                  mesh, plan, slack=4.0)


def test_cpra_rejects_bad_knobs():
    """Unknown pack_impl strings and tier routing with a padded local
    plan must both fail loudly (the silent fallbacks they shadowed:
    running the sort pack for a misspelled 'radix', and a skewed padded
    partition under tier range compression)."""
    from hash_join_codes_knl_tpu.parallel.cpra import make_cpra_step

    mesh = jax.make_mesh((8,), ("x",))
    plan = JoinPlan(p_bits=4, slots=128, tile=128, pass_bits=(4,))
    with pytest.raises(ValueError, match="pack_impl"):
        make_cpra_step(mesh, plan, 128, 128, pack_impl="radx")
    padded = JoinPlan(p_bits=4, slots=128, tile=128, pass_bits=(4,),
                      probe_impl="table")
    with pytest.raises(ValueError, match="merge"):
        make_cpra_step(mesh, padded, 128, 128, tier_ratio=0.5)


def test_cpra_overflow_auto_retry():
    # mild skew: ~25% of probes hit one key -- overflows slack=1.0 caps,
    # fits after the automatic re-plan with doubled slack
    rng = np.random.default_rng(23)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    iv = ik * np.uint32(3)
    hot = ik[7]
    ok = ik[rng.integers(0, 2048, 8192)].astype(np.uint32)
    ok[rng.integers(0, 8192, 2048)] = hot
    ov = ok * np.uint32(5)
    mesh = jax.make_mesh((8,), ("x",))
    plan = JoinPlan(p_bits=4, slots=128, tile=128, pass_bits=(4,))
    res, _ = cpra_join(ik, iv, ok, ov, mesh, plan, slack=1.0, retries=3)
    want = multiset_digest(*join_oracle(ik, iv, ok, ov))
    assert _digest_aligned(res) == want


def test_cpra_window_replan_from_measured_span():
    """Distributed chunked-geometry skew: a build key duplicated 3000x,
    probed from many chunk rows, must count every match of the run on
    the first attempt (no window to re-plan)."""
    rng = np.random.default_rng(97)
    ik = np.unique(rng.integers(1, 2**32, 6000, dtype=np.uint32))[:4096]
    hot = ik[123]
    ik_dup = np.concatenate([ik, np.full(3000, hot, np.uint32)])
    iv = rng.integers(0, 2**32, len(ik_dup), dtype=np.uint32)
    ok = ik[rng.integers(0, 4096, 32768)].astype(np.uint32)
    ok[::64] = hot  # spread hot probes over many chunk rows
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    mesh = jax.make_mesh((2,), ("x",))
    plan = JoinPlan(p_bits=4, slots=1024, tile=256, pass_bits=(4,),
                    probe_chunks=4)
    res, got_plan = cpra_join(ik_dup, iv, ok, ov, mesh, plan, slack=4.0,
                              retries=0)
    want_rows = len(join_oracle(ik_dup, iv, ok, ov)[0])
    assert int(np.asarray(res.join_tuples).sum()) == want_rows
    assert got_plan == plan


def test_cpra_radix_pack_matches_sort_pack():
    """pack_impl='radix' routes the exchange through the radix pass
    (ops/radix_partition.py); results must equal the sort-pack step and
    the oracle."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hash_join_codes_knl_tpu.engine.config import JoinPlan
    from hash_join_codes_knl_tpu.engine.oracle import (
        join_oracle,
        multiset_digest,
    )
    from hash_join_codes_knl_tpu.parallel.cpra import make_cpra_step
    from hash_join_codes_knl_tpu.relgen.generate import generate

    inner, outer, _ = generate(seed=73, inner_tuples=2048,
                               outer_tuples=8192, mode="uniform",
                               prefer_native=False)
    mesh = jax.make_mesh((4,), ("x",))
    plan = JoinPlan(p_bits=4, slots=256, tile=128, pass_bits=(4,))
    sh = NamedSharding(mesh, P("x"))
    dev = lambda x: jax.device_put(np.asarray(x), sh)
    args = (dev(inner.keys), dev(inner.vals), dev(outer.keys),
            dev(outer.vals))
    want = multiset_digest(
        *join_oracle(inner.keys, inner.vals, outer.keys, outer.vals)
    )

    def digest(res):
        mc = np.asarray(res.match_cnts).reshape(-1)
        m = mc == 1
        return multiset_digest(
            np.asarray(res.probe_keys).reshape(-1)[m],
            np.asarray(res.probe_vals).reshape(-1)[m],
            np.asarray(res.match_vals).reshape(-1)[m],
        )

    step_r = make_cpra_step(mesh, plan, inner_cap=2048, outer_cap=8192,
                            pack_impl="radix")
    res_r, _, diag_r = step_r(*args)
    assert int(diag_r[0]) == 0 and int(diag_r[1]) == 0
    assert digest(res_r) == want

    step_s = make_cpra_step(mesh, plan, inner_cap=2048, outer_cap=8192)
    res_s, _, diag_s = step_s(*args)
    assert int(diag_s[0]) == 0 and int(diag_s[1]) == 0
    assert digest(res_s) == want

    # cap-based memory planning applies to the radix pack too: a
    # too-small outer_cap must surface as EXCHANGE overflow (diag[0]),
    # never silently drop tuples behind the pass's own capacity
    step_tight = make_cpra_step(mesh, plan, inner_cap=2048,
                                outer_cap=128, pack_impl="radix")
    _, _, diag_t = step_tight(*args)
    assert int(diag_t[0]) > 0


def test_cpra_join_odd_relation_sizes():
    """Relation lengths that do not divide the mesh must shard via
    null-key padding instead of dying in jax's sharding divisibility
    check (regression: cryptic ValueError on any odd size)."""
    rng = np.random.default_rng(41)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:1255]
    iv = rng.integers(0, 2**32, 1255, dtype=np.uint32)
    ok = ik[rng.integers(0, 1255, 9377)].astype(np.uint32)
    ov = rng.integers(0, 2**32, 9377, dtype=np.uint32)
    mesh = jax.make_mesh((8,), ("x",))
    res, _ = cpra_join(ik, iv, ok, ov, mesh, slack=4.0)
    want = join_oracle(ik, iv, ok, ov)
    assert int(np.asarray(res.join_tuples).sum()) == len(want[0])


def test_engine_overflow_includes_select_overflow():
    """The distributed drivers' overflow accessor reads each engine's own
    channel: the unique_build violation count in merge mode, the pass
    overflow count (last entry) in padded radix mode, and partitions
    past `slots` in padded sort mode."""
    import jax.numpy as jnp

    from hash_join_codes_knl_tpu.engine.phj import JoinResult
    from hash_join_codes_knl_tpu.parallel.cpra import _engine_overflow

    z = jnp.zeros(4, jnp.uint32)
    zc = jnp.zeros(4, jnp.int32)
    merge_plan = JoinPlan(p_bits=4, slots=64, tile=128, probe_impl="merge")
    res = JoinResult(z, z, z, zc, jnp.asarray([0, 0, 3], jnp.int32))
    assert int(_engine_overflow(res, merge_plan)) == 3
    res = JoinResult(z, z, z, zc, jnp.asarray([0, 0, 0], jnp.int32))
    assert int(_engine_overflow(res, merge_plan)) == 0
    radix = JoinPlan(p_bits=2, slots=64, tile=128, pass_bits=(2,),
                     partition_impl="radix", probe_impl="table")
    res = JoinResult(z, z, z, zc, jnp.asarray([900, 1, 1, 1, 5], jnp.int32))
    assert int(_engine_overflow(res, radix)) == 5
    table = JoinPlan(p_bits=2, slots=64, tile=128, probe_impl="table")
    res = JoinResult(z, z, z, zc, jnp.asarray([65, 64, 70, 1], jnp.int32))
    assert int(_engine_overflow(res, table)) == 2

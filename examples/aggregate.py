"""Hash aggregates: group-by over a relation and over join output.

Demonstrates the three aggregate surfaces (ops/aggregate.py):
  1. hash_aggregate            -- single-level sort-group-reduce
  2. hash_aggregate_chunked    -- two-level batched-chunk engine for
                                  low-cardinality groupings (with a
                                  COUNTED partial-capacity overflow)
  3. aggregate_join_result     -- the BASELINE aggregate-on-join-output
                                  operator, straight off the aligned
                                  JoinResult (no materialization)

Runs on whatever jax.devices() offers (GPU or CPU).
python examples/aggregate.py [rows]
"""

import sys

import numpy as np

import hash_join_codes_knl_tpu as hjk


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    rng = np.random.default_rng(11)

    # --- 1. group a raw (key, value) column pair: ~2K distinct groups
    keys = rng.integers(1, 2048, n, dtype=np.uint32)
    vals = rng.integers(0, 1000, n, dtype=np.uint32)
    n_groups, gk, sums, counts = hjk.hash_aggregate(keys, vals)
    g = int(n_groups)
    print(f"single-level: {g} groups over {n} rows")

    # numpy cross-check on a few groups
    for key in np.asarray(gk)[: min(g, 3)]:
        m = keys == key
        want = np.uint32(vals[m].sum())  # u32 wraparound, like the engine
        idx = int(np.flatnonzero(np.asarray(gk)[:g] == key)[0])
        assert np.asarray(sums)[idx] == want
        assert np.asarray(counts)[idx] == m.sum()

    # --- 2. the two-level engine: same result, batched chunk sorts.
    # partial_cap bounds the per-chunk group slots; an overflow is a
    # COUNTED value and hash_aggregate_auto re-plans the budget from it
    # (one guaranteed-clean retry; single-level only at groups ~ rows)
    from hash_join_codes_knl_tpu.ops.aggregate import (
        hash_aggregate_auto,
        hash_aggregate_chunked,
    )

    n2, gk2, sums2, counts2, overflow = hash_aggregate_chunked(
        keys, vals, chunks=16, partial_cap=1 << 16
    )
    assert int(overflow) == 0 and int(n2) == g
    assert np.array_equal(np.asarray(gk2)[:g], np.asarray(gk)[:g])
    assert np.array_equal(np.asarray(sums2)[:g], np.asarray(sums)[:g])
    print(f"two-level:    {int(n2)} groups, overflow={int(overflow)}")

    # a deliberately tiny cap: overflow is counted, auto falls back
    _, _, _, _, ovf = hash_aggregate_chunked(keys, vals, chunks=16,
                                             partial_cap=256)
    ra = hash_aggregate_auto(keys, vals, chunks=16, partial_cap=256)
    assert int(ovf) > 0 and int(ra[0]) == g
    print(f"tiny cap:     overflow={int(ovf)} counted -> measured re-plan")

    # --- 2b. M:N join output aggregated ON DEVICE: the expansion is
    # streamed through expand_join blocks straight into partials --
    # it never materializes in host memory (r5)
    base = np.unique(rng.integers(1, 2**32, 600, dtype=np.uint32))[:256]
    mn_ik = np.repeat(base, rng.integers(1, 5, 256)).astype(np.uint32)
    mn_iv = rng.integers(0, 2**32, len(mn_ik), dtype=np.uint32)
    mn_ok = base[rng.integers(0, 256, 4096)].astype(np.uint32)
    mn_ov = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    mn_res, _ = hjk.join(mn_ik, mn_iv, mn_ok, mn_ov)
    nmn, mk, msums, mcounts = hjk.aggregate_join_result_expanded(
        mn_res, mn_ik, mn_iv, block_rows=2048)
    print(f"M:N streamed: {int(nmn)} groups over "
          f"{int(np.asarray(mcounts).sum())} expanded rows")

    # --- 3. aggregate over JOIN output: sum matched build values per
    # probe key, straight off the aligned result
    inner, outer, _ = hjk.generate(seed=7, inner_tuples=4096,
                                   outer_tuples=n, mode="uniform")
    res, _ = hjk.join(inner.keys, inner.vals, outer.keys, outer.vals)
    ng, jk, jsums, jcounts = hjk.aggregate_join_result(res)
    print(f"join output:  {int(ng)} groups from {int(res.join_tuples)} "
          "matched rows")
    assert int(np.asarray(jcounts).sum()) == int(res.join_tuples)
    print("OK")


if __name__ == "__main__":
    main()

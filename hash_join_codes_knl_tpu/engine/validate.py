"""Oracle-free runtime invariant checks: the BG debug mode analog.

The reference's -DBG build re-checksums partition outputs and re-verifies
partition monotonicity after the scatter (phj.cpp:1034-1041, 1214-1229;
assertions committed commented-out).  This is the runtime equivalent for
the merge engine: given a JoinResult and the ORIGINAL probe relation, it
verifies -- without any oracle join --

  1. key conservation: the multiset of live probe keys in the result
     equals the input key multiset (checked by u64 sum + count; the sort
     may only permute, never invent or drop tuples),
  2. pad hygiene: padding slots (key 0) carry zero match counts/values,
  3. match sanity: counts are non-negative and a match value implies a
     positive count (and vice versa for unique-build workloads),
  4. order monotonicity: the result's probe keys are hash-ordered
     within each sorted chunk (the partition-monotonicity re-check).

Cheap enough to run on every CLI invocation with --check; raises
ValueError with a specific diagnosis on the first violated invariant.
"""

from __future__ import annotations

import numpy as np



def validate_join_result(res, outer_keys, plan) -> dict:
    """Returns a small stats dict on success; raises ValueError on the
    first violated invariant.  Host-side (concrete arrays)."""
    pk = np.asarray(res.probe_keys).reshape(-1)
    pv = np.asarray(res.probe_vals).reshape(-1)
    mv = np.asarray(res.match_vals).reshape(-1)
    mc = np.asarray(res.match_cnts).reshape(-1)
    in_keys = np.asarray(outer_keys).reshape(-1)

    live = pk != 0
    n_live = int(live.sum())
    n_in = int((in_keys != 0).sum())
    if n_live != n_in:
        raise ValueError(
            f"key conservation: {n_live} live result slots != "
            f"{n_in} input tuples"
        )
    got_sum = int(pk.astype(np.uint64).sum(dtype=np.uint64))
    want_sum = int(in_keys.astype(np.uint64).sum(dtype=np.uint64))
    if got_sum != want_sum:
        raise ValueError(
            f"key conservation: result key checksum {got_sum} != "
            f"input checksum {want_sum} (write.cpp:1635-1645 semantics)"
        )

    if mc[~live].any() or mv[~live].any() or pv[~live].any():
        raise ValueError("pad hygiene: padding slots carry matches/values")

    if (mc < 0).any():
        raise ValueError("match sanity: negative match count")
    if ((mc == 0) & (mv != 0)).any():
        raise ValueError("match sanity: match value without a match")

    # partition monotonicity: within each sorted probe chunk the
    # scrambled keys must be non-decreasing (pads are hk 0 and sort
    # first, so they never break monotonicity).  Irregular geometries
    # (result length not divisible by the chunk count -- a truncated or
    # re-laid-out result) cannot infer chunk boundaries; that case is
    # REPORTED in the stats instead of silently skipping the check.
    monotonicity = "n/a"
    if getattr(plan, "probe_impl", "merge") == "merge":
        hk = (pk.astype(np.uint64) * np.uint64(plan.factor)).astype(
            np.uint32
        )
        chunks = max(1, getattr(plan, "probe_chunks", 0))
        if len(hk) == 0 or len(hk) % chunks != 0:
            monotonicity = "skipped: irregular geometry " \
                f"({len(hk)} slots, {chunks} chunks)"
        else:
            h2 = hk.reshape(chunks, -1)
            if (h2[:, 1:] < h2[:, :-1]).any():
                raise ValueError(
                    "monotonicity: probe layout not hash-ordered within "
                    "a sorted chunk"
                )
            monotonicity = "checked"

    return {
        "live_slots": n_live,
        "key_checksum": got_sum,
        "join_tuples": int(mc.astype(np.int64).sum()),
        "monotonicity": monotonicity,
    }

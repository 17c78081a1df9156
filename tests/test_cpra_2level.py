"""Two-level (host x chip) exchange on a 2x4 virtual mesh vs the oracle."""

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from hash_join_codes_knl_tpu.engine.config import JoinPlan
from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.parallel.cpra import make_cpra_step_2level
from hash_join_codes_knl_tpu.relgen.generate import generate


def test_two_level_exchange_matches_oracle():
    H, C = 2, 4
    inner, outer, _ = generate(
        seed=59, inner_tuples=2048, outer_tuples=16384,
        mode="uniform", prefer_native=False,
    )
    mesh = jax.make_mesh((H, C), ("h", "c"))
    plan = JoinPlan(p_bits=4, slots=128, tile=128, pass_bits=(4,))
    step = make_cpra_step_2level(
        mesh, plan, inner_cap=2048, outer_cap=16384 // 2
    )
    sh = NamedSharding(mesh, P(("h", "c")))
    dev = lambda x: jax.device_put(np.asarray(x), sh)
    res, overflow = step(
        dev(inner.keys), dev(inner.vals), dev(outer.keys), dev(outer.vals)
    )
    assert not bool(overflow)
    mc = np.asarray(res.match_cnts).reshape(-1)
    m = mc == 1
    got = multiset_digest(
        np.asarray(res.probe_keys).reshape(-1)[m],
        np.asarray(res.probe_vals).reshape(-1)[m],
        np.asarray(res.match_vals).reshape(-1)[m],
    )
    want = multiset_digest(
        *join_oracle(inner.keys, inner.vals, outer.keys, outer.vals)
    )
    assert got == want
    # ownership: every shard's matched keys must be disjoint from others'
    pk = np.asarray(res.probe_keys).reshape(H * C, -1)
    mc2 = np.asarray(res.match_cnts).reshape(H * C, -1)
    seen = set()
    for s in range(H * C):
        ks = set(pk[s][mc2[s] == 1].tolist())
        assert not (seen & ks)
        seen |= ks


def test_two_level_padded_overflow_detected():
    """A padded-plan 2-level run whose build partitions exceed `slots`
    must raise the overflow flag (overflows are values, never silent) --
    mirrors the occupancy check of make_cpra_step."""
    H, C = 2, 4
    inner, outer, _ = generate(
        seed=61, inner_tuples=2048, outer_tuples=4096,
        mode="uniform", prefer_native=False,
    )
    mesh = jax.make_mesh((H, C), ("h", "c"))
    # slots=1 guarantees occupancy overflow on 2048 build tuples / 4 parts
    plan = JoinPlan(p_bits=2, slots=1, tile=128, pass_bits=(2,),
                    probe_impl="table")
    step = make_cpra_step_2level(mesh, plan, inner_cap=2048, outer_cap=4096)
    sh = NamedSharding(mesh, P(("h", "c")))
    dev = lambda x: jax.device_put(np.asarray(x), sh)
    _, overflow = step(
        dev(inner.keys), dev(inner.vals), dev(outer.keys), dev(outer.vals)
    )
    assert bool(overflow)

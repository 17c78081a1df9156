"""NPJ: no-partition (simple) hash join against one global table.

The reference NPJ (npj.cpp:769-927): one shared open-addressing table built
over the whole build side, probed directly.

Build (K1 analog, npj.cpp:190-212): the reference inserts with CAS + linear
probing.  A linear-probe table's *cluster structure* is insertion-order
independent, so the canonical layout is computed directly: sort tuples by
scrambled key hk (the home bucket is a monotone function of hk, so this
orders them by home bucket too), then resolve collisions with the
vectorized parking rule slot_i = max(h_i, slot_{i-1}+1), which collapses
to slot_i = i + cummax(h_i - i) -- one sort, one cummax, one scatter.  The
table is allocated with a non-wrapping overflow margin instead of modular
wraparound (same join semantics: every key is findable from its home bucket
scanning forward to the first empty).

Probe (K2 analog, npj.cpp:216-364): two engines.

* "sorted" (default): the table's tuples in slot order, with the empty
  slots dropped, are the build side sorted by hk.  Compacting its equal-key
  runs (ops/merge_probe.py build_runs) gives one entry per distinct key,
  and every probe key finds its run with one binary search -- the parked
  table itself is never materialized on this path.  Probes need no
  reordering: order="input" searches them as they come.
* "chain": the literal while_loop chain walk over whole-relation gather
  steps (active-masked; iterations = longest chain) -- the semantic
  oracle and ablation baseline (the -D_NO_VECTOR analog).

Output contract: aligned to the PROBE input order (match_val/match_cnt per
probe tuple), the closest analog of the reference's probe-order output.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..ops.merge_probe import build_runs, merge_probe
from ..ops.partition import PAD_KEY
from ..utils.hashing import hashed_key, mod_inverse_u32, mulhi32, range_hash
from .config import DEFAULT_FACTOR


@dataclasses.dataclass(frozen=True)
class NpjPlan:
    buckets: int  # table size (home-bucket range)
    margin: int = 4096  # non-wrapping overflow slots past the end
    factor: int = DEFAULT_FACTOR
    max_chain: int = 1 << 20  # safety bound on probe chain walk
    # _UNIQUE mode (npj.cpp:954-956,288-290): build keys are known
    # distinct, so a probe lane retires at its first match instead of
    # walking to the end of the cluster
    unique: bool = False
    # probe engines: "sorted" (binary search of the compact sorted build,
    # default) | "chain" (while_loop chain walk, the oracle/ablation path)
    probe_impl: str = "sorted"

    @property
    def table_size(self) -> int:
        """buckets + margin, rounded up to a 128 multiple."""
        return -(-(self.buckets + self.margin) // 128) * 128


def plan_npj(inner_n: int, load: float = 0.5) -> NpjPlan:
    """Reference sizing: hash_buckets = inner/load (npj.cpp:944-947 uses
    load 0.9; default 0.5 here, which keeps chains short for the chain
    walk)."""
    buckets = 1
    while buckets * load < inner_n:
        buckets *= 2
    return NpjPlan(buckets=buckets)


@functools.partial(jax.jit, static_argnames=("plan",))
def npj_build(inner_keys, inner_vals, plan: NpjPlan):
    """Returns (table_keys, table_vals, overflow_count, max_disp).

    max_disp is the largest parking displacement (slot - home bucket) of
    any kept tuple: every key's matches lie in [h0, h0 + max_disp]."""
    n = inner_keys.shape[0]
    size = plan.table_size
    # hk - 1 wraps the null key to the top, so null tuples sort last and
    # park past the table, where they are dropped
    sk, v_s = jax.lax.sort(
        (hashed_key(inner_keys, plan.factor) - jnp.uint32(1), inner_vals),
        num_keys=1,
    )
    hk_s = sk + jnp.uint32(1)
    h_s = jnp.where(hk_s != 0,
                    mulhi32(hk_s, jnp.uint32(plan.buckets)).astype(jnp.int32),
                    size)
    j = jnp.arange(n, dtype=jnp.int32)
    slot = j + jax.lax.cummax(h_s - j)  # parking rule
    slot = jnp.where((h_s < size) & (slot < size), slot, size)  # drop
    k_s = hk_s * jnp.uint32(mod_inverse_u32(plan.factor))
    tk = jnp.full(size, PAD_KEY, jnp.uint32).at[slot].set(k_s, mode="drop")
    tv = jnp.zeros(size, jnp.uint32).at[slot].set(v_s, mode="drop")
    overflow = jnp.sum((slot >= size).astype(jnp.int32)) - jnp.sum(
        (h_s >= size).astype(jnp.int32)
    )
    max_disp = jnp.max(
        jnp.where(slot < size, slot - h_s, 0), initial=0
    ).astype(jnp.int32)
    return tk, tv, overflow, max_disp


@functools.partial(jax.jit, static_argnames=("plan",))
def npj_probe(table_keys, table_vals, probe_keys, plan: NpjPlan):
    """Walk chains until first empty slot; returns (match_vals, match_cnts)."""
    n = probe_keys.shape[0]
    size = table_keys.shape[0]
    h0 = range_hash(probe_keys, plan.factor, plan.buckets).astype(jnp.int32)
    live = probe_keys != PAD_KEY

    def cond(state):
        off, active, _, _ = state
        return jnp.any(active) & (off < plan.max_chain)

    def body(state):
        off, active, mval, mcnt = state
        slot = jnp.minimum(h0 + off, size - 1)
        tk = jnp.where(active, table_keys[slot], PAD_KEY)
        tv = table_vals[slot]
        eq = active & (tk == probe_keys)
        mval = jnp.where(eq, jnp.maximum(mval, tv), mval)
        mcnt = mcnt + eq.astype(jnp.int32)
        active = active & (tk != PAD_KEY) & (h0 + off + 1 < size)
        if plan.unique:
            active = active & jnp.logical_not(eq)  # first match retires
        return off + 1, active, mval, mcnt

    _, _, mval, mcnt = jax.lax.while_loop(
        cond,
        body,
        (
            jnp.int32(0),
            live,
            jnp.zeros(n, jnp.uint32),
            jnp.zeros(n, jnp.int32),
        ),
    )
    return mval, mcnt


@functools.partial(jax.jit, static_argnames=("plan",))
def npj_runs(inner_keys, inner_vals, plan: NpjPlan):
    """The compact sorted build the sorted probe searches: the table's
    tuples in slot order without its empty slots, equal keys compacted
    to (key, count, largest value) runs."""
    if inner_keys.shape[0] == 0:  # one null pad keeps the search defined
        inner_keys = inner_vals = jnp.zeros(1, jnp.uint32)
    bhk, bval = jax.lax.sort(
        (hashed_key(inner_keys, plan.factor), inner_vals), num_keys=1)
    return build_runs(bhk, bval)


@functools.partial(jax.jit, static_argnames=("plan", "order"))
def npj_probe_sorted(runs, probe_keys, plan: NpjPlan, probe_vals=None,
                     order: str = "input"):
    """Binary-search probe of the compact sorted build (`npj_runs`).

    order="input": returns (match_vals, match_cnts) aligned to the probe
    input order -- the probes are searched as they come.

    order="sorted": the probe side is first sorted by hk carrying its
    values, and the result stays in that (home-bucket) order, exactly the
    PHJ merge engine's aligned contract; returns (probe_keys_sorted,
    probe_vals_sorted, match_vals, match_cnts) (requires probe_vals)."""
    phk = hashed_key(probe_keys, plan.factor)
    if order == "input":
        return merge_probe(phk, *runs)
    if probe_vals is None:
        raise ValueError("order='sorted' needs probe_vals")
    phk, pv = jax.lax.sort((phk, probe_vals), num_keys=1)
    mv, mc = merge_probe(phk, *runs)
    return phk * jnp.uint32(mod_inverse_u32(plan.factor)), pv, mv, mc


def npj_join(inner_keys, inner_vals, outer_keys, outer_vals,
             plan: NpjPlan | None = None, order: str = "input"):
    """Full NPJ.

    order="input" (default): returns (match_vals, match_cnts aligned to
    the outer input order, plan).

    order="sorted": returns (probe_keys, probe_vals, match_vals,
    match_cnts, plan) in home-bucket-sorted order -- the PHJ merge
    engine's aligned contract.  Sorted probe engine only."""
    if order not in ("input", "sorted"):
        raise ValueError(f"order must be 'input' or 'sorted', got {order!r}")
    if plan is None:
        plan = plan_npj(len(inner_keys))
    if plan.probe_impl == "chain" and order != "input":
        raise ValueError(
            "order='sorted' applies to the sorted probe engine only "
            "(the chain walk is input-ordered by construction)"
        )
    ik, iv = jnp.asarray(inner_keys), jnp.asarray(inner_vals)
    ok = jnp.asarray(outer_keys)
    if plan.probe_impl == "chain":
        tk, tv, overflow, _ = npj_build(ik, iv, plan)
        if int(overflow) > 0:
            raise RuntimeError(
                f"{int(overflow)} build tuples overflowed the table margin; "
                "increase NpjPlan.margin or lower the load factor"
            )
        mv, mc = npj_probe(tk, tv, ok, plan)
        return mv, mc, plan
    runs = npj_runs(ik, iv, plan)
    if order == "sorted":
        return (*npj_probe_sorted(runs, ok, plan, jnp.asarray(outer_vals),
                                  order="sorted"), plan)
    return (*npj_probe_sorted(runs, ok, plan), plan)

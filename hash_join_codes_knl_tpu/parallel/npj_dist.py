"""Distributed NPJ: the shared-global-table join on a chip mesh.

The reference NPJ (npj.cpp:769-927) has every thread build into ONE shared
open-addressing table through CAS, then every thread probe its outer slice
against it.  The translation of "one table all workers can reach" is a
table REPLICATED per device (SURVEY.md section 2.5, shared-state row):
devices `all_gather` the sharded build side, each builds the identical
global table locally (the build is deterministic and insertion-order
independent, engine/npj.py), and probes only its own outer shard.  No
communication happens during the probe -- exactly the reference's phase
structure (barrier-fenced build phase, then an embarrassingly parallel
probe phase, npj.cpp:861-897).

This is the degenerate baseline by design: build work is duplicated C times
and the table occupies HBM on every chip.  It wins only when the build side
is small; PHJ/CPRA own every other regime, as on KNL.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.npj import (
    NpjPlan,
    npj_build,
    npj_probe,
    npj_probe_sorted,
    npj_runs,
    plan_npj,
)


def make_npj_step(mesh: Mesh, plan: NpjPlan, axis: str = "x"):
    """Jitted distributed NPJ step: (ik, iv, ok, ov) sharded along `axis`
    -> (match_vals, match_cnts aligned to the local outer shard,
    join_tuples scalar, build_overflow scalar).  The build overflow (a
    table-margin overflow of the chain walk's table) is psum'd; the
    sorted probe builds no table and reports 0."""

    def local_step(ik, iv, ok, ov):
        # build phase: replicate the build side (the "shared table"),
        # build the identical table on every chip
        gik = jax.lax.all_gather(ik, axis, tiled=True)
        giv = jax.lax.all_gather(iv, axis, tiled=True)
        # probe phase: local outer shard only, no communication
        if plan.probe_impl == "chain":
            tk, tv, bovf, _ = npj_build(gik, giv, plan)
            mv, mc = npj_probe(tk, tv, ok, plan)
        else:
            mv, mc = npj_probe_sorted(npj_runs(gik, giv, plan), ok, plan)
            bovf = jnp.zeros((), jnp.int32)
        total = jax.lax.psum(jnp.sum(mc.astype(jnp.uint32)), axis)
        bovf = jax.lax.psum(bovf, axis)
        return mv, mc, total, bovf

    spec = P(axis)
    return jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=(spec, spec, P(), P()),
            check_vma=False,
        )
    )


def npj_join_dist(inner_keys, inner_vals, outer_keys, outer_vals,
                  mesh: Mesh, plan: NpjPlan | None = None, axis: str = "x",
                  liveness_timeout_s: float | None = 30.0):
    """Convenience front end; returns (match_vals, match_cnts, join_tuples,
    plan) with match arrays aligned to the outer relation order."""
    from .distributed import require_live_mesh

    require_live_mesh(mesh, liveness_timeout_s, axis, stage="npj_build")
    if plan is None:
        plan = plan_npj(len(inner_keys))
    from .distributed import shard_null_padded

    sh = NamedSharding(mesh, P(axis))
    n_dev = mesh.shape[axis]
    # pads land at the tail of the last shard, so trimming the aligned
    # outputs back to the input length (below) drops exactly them
    dev = lambda x: shard_null_padded(x, n_dev, sh)
    args = (dev(inner_keys), dev(inner_vals), dev(outer_keys),
            dev(outer_vals))
    mv, mc, total, bovf = make_npj_step(mesh, plan, axis)(*args)
    if int(bovf) > 0:
        raise RuntimeError(
            f"NPJ build overflow: {int(bovf)} tuples past the table "
            "margin; increase NpjPlan.margin or lower the load factor"
        )
    n_out = len(outer_keys)
    return (np.asarray(mv)[:n_out], np.asarray(mc)[:n_out], int(total),
            plan)

"""Partitioned probe operator: the padded-table redesign of K2/K4.

The reference probe is a 16-lane gather / compare / compress loop over a
table in memory (npj.cpp:216-364).  Here partitioning has already packed
each build-side partition into one dense table row, and the probe is a
*dense* comparison of each probe tile against its partition's row --
equality matrices, match extraction by select+max (exact in u32), match
counting by reduction.  Probe tiles never straddle partitions (padded
layout, ops/partition.py), so each tile touches exactly one table row.

Output is aligned to the padded probe layout: for probe slot i,
  match_val[i] = build val of the matching tuple (0 if none; for multi-match
                 partitions the maximum val among matches -- callers needing
                 full M:N output use the expansion path in ops/expand.py)
  match_cnt[i] = number of matching build tuples (0 for padding slots)
This replaces the reference's compress-store + atomic output blocks
(npj.cpp:296-317) with a deterministic, compaction-ready form (K10's
close_gaps becomes ops/compact.py over match_cnt).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .partition import PAD_KEY


def probe_tiles_jnp(
    probe_keys: jnp.ndarray,  # (cap,) padded partition layout
    table_keys: jnp.ndarray,  # (P, S)
    table_vals: jnp.ndarray,  # (P, S)
    table_counts: jnp.ndarray,  # (P,)
    tile_pid: jnp.ndarray,  # (n_tiles,)
    tile: int,
    group: int = 8,
):
    """Tile-by-tile probe of the padded layout against the dense table.

    Scans over groups of `group` tiles per step (one scalar scan step per
    tile would dominate runtime at 10^8-tuple scale).  Requires
    n_tiles % group == 0, which padded_capacity's alignment guarantees.
    """
    n_tiles = tile_pid.shape[0]
    assert n_tiles % group == 0, (n_tiles, group)
    slots = table_keys.shape[1]
    col = jnp.arange(slots, dtype=jnp.int32)
    probe2d = probe_keys.reshape(n_tiles, tile)
    pid2d = tile_pid.reshape(n_tiles // group, group)

    def one_group(_, args):
        g, pids = args
        ok = jax.lax.dynamic_slice(
            probe2d, (g * group, 0), (group, tile)
        )  # (G, T)
        tk = jnp.take(table_keys, pids, axis=0)  # (G, S)
        tv = jnp.take(table_vals, pids, axis=0)
        valid = col[None, :] < jnp.take(table_counts, pids)[:, None]  # (G, S)
        eq = (
            (ok[:, :, None] == tk[:, None, :])
            & valid[:, None, :]
            & (ok[:, :, None] != PAD_KEY)
        )  # (G, T, S)
        mval = jnp.max(
            jnp.where(eq, tv[:, None, :], jnp.uint32(0)), axis=2
        )
        mcnt = jnp.sum(eq, axis=2).astype(jnp.int32)
        return _, (mval, mcnt)

    _, (mv, mc) = jax.lax.scan(
        one_group,
        0,
        (jnp.arange(n_tiles // group), pid2d),
    )
    return mv.reshape(n_tiles * tile), mc.reshape(n_tiles * tile)

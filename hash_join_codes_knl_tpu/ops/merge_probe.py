"""Merge-mode probe: every probe key searched in the sorted build side.

After partition-as-sort (engine/phj.py) the build side is ordered by the
scrambled key hk, so all build tuples sharing a key form one run.
`build_runs` compacts the runs to one entry each -- the key, the run
length and the largest value in the run -- and `merge_probe` finds each
probe key's run with one binary search: the match count is the run length
and the match value the run's largest build value (the aligned output
contract).

Two implementations of the search, chosen by the platform the program is
lowered for (lax.platform_dependent):

- on CUDA, `_probe_triton`: a Pallas kernel on the Triton route, one lane
  per probe key, the binary search's bounds kept in registers for all its
  steps -- one pass over the probe column.  On the H100 at 16M x 256M it
  takes 5.4 ms where the plain version takes 26 ms, and the whole join
  16.6 ms instead of 35.7 ms (PERF.md);
- elsewhere, `_probe_plain`: jnp.searchsorted plus gathers, left to XLA.
  It is also the reference the kernel is tested against.

Null-key convention: pads on either side carry hk 0.  Build pads form the
first run and probe pads are masked, so neither ever matches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# jnp.searchsorted lowering of the plain probe's search.  Measured on the
# H100 at 16M build x 256M probe rows against "scan" and "scan_unrolled"
# (PERF.md).
SEARCH_METHOD = "sort"


def build_runs(bhk, bval):
    """(run_hk, run_cnt, run_val) of a sorted build side, each (n,): run
    r's key, length and largest value at index r, then unused entries
    with key 0xFFFFFFFF and count 0 (run_hk stays ascending, and a real
    0xFFFFFFFF run precedes them)."""
    n = bhk.shape[0]
    first = jnp.concatenate([jnp.ones(1, bool), bhk[1:] != bhk[:-1]])
    rid = jnp.cumsum(first.astype(jnp.int32)) - 1
    run_hk = jnp.full(n, 0xFFFFFFFF, jnp.uint32).at[
        jnp.where(first, rid, n)].set(bhk, mode="drop")
    run_cnt = jnp.zeros(n, jnp.int32).at[rid].add(1)
    run_val = jnp.zeros(n, jnp.uint32).at[rid].max(bval)
    return run_hk, run_cnt, run_val


def _probe_plain(q, run_hk, run_cnt, run_val, method: str = SEARCH_METHOD):
    j = jnp.searchsorted(run_hk, q, side="left", method=method)
    j = jnp.minimum(j, run_hk.shape[0] - 1)
    hit = (run_hk[j] == q) & (q != 0)
    cnt = jnp.where(hit, run_cnt[j], 0)
    mv = jnp.where(cnt > 0, run_val[j], jnp.uint32(0))
    return mv, cnt


def _probe_triton(q, run_hk, run_cnt, run_val, block: int = 1024,
                  warps: int = 4):
    """_probe_plain's contract as one Triton kernel: each lane runs the
    lower-bound search for its key over all of run_hk (a fixed
    ceil(log2(m + 1)) steps), then gathers the run's count and value.
    block probe keys per program; every block/warps pair from 256 to 2048
    keys and 4 or 8 warps measured within 10% on the H100 (PERF.md)."""
    n, m = q.shape[0], run_hk.shape[0]
    steps = int(m).bit_length()

    def kernel(q_ref, hk_ref, cnt_ref, val_ref, mv_ref, mc_ref):
        qv = q_ref[...]

        def step(_, bounds):
            lo, hi = bounds
            mid = jnp.minimum((lo + hi) // 2, m - 1)
            right = hk_ref[mid] < qv
            return jnp.where(right, mid + 1, lo), jnp.where(right, hi, mid)

        bounds = (jnp.zeros((block,), jnp.int32),
                  jnp.full((block,), m, jnp.int32))
        lo, _ = jax.lax.fori_loop(0, steps, step, bounds)
        j = jnp.minimum(lo, m - 1)
        hit = (hk_ref[j] == qv) & (qv != 0)
        cnt = jnp.where(hit, cnt_ref[j], 0)
        mc_ref[...] = cnt
        mv_ref[...] = jnp.where(cnt > 0, val_ref[j], jnp.uint32(0))

    # the last program's block runs past n: pad the probe column with null
    # keys to whole blocks and trim the outputs
    pad = -n % block
    qp = jnp.concatenate([q, jnp.zeros(pad, jnp.uint32)]) if pad else q
    blk = pl.BlockSpec((block,), lambda i: (i,))
    mv, mc = pl.pallas_call(
        kernel,
        grid=(qp.shape[0] // block,),
        in_specs=[blk, pl.no_block_spec, pl.no_block_spec, pl.no_block_spec],
        out_specs=[blk, blk],
        out_shape=[jax.ShapeDtypeStruct(qp.shape, jnp.uint32),
                   jax.ShapeDtypeStruct(qp.shape, jnp.int32)],
        compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=1),
        backend="triton",
        name="merge_probe",
    )(qp, run_hk, run_cnt, run_val)
    return mv[:n], mc[:n]


def merge_probe(probe_hk, run_hk, run_cnt, run_val):
    """(match_vals, match_cnts) for every probe slot.

    probe_hk: scrambled probe keys of any shape and order -- the flat
    (cap,) layout or (C, L) chunk rows; outputs mirror it.  run_hk: (n,)
    ascending, n >= 1, with run_cnt/run_val beside it (`build_runs`, or a
    sorted build side of unique keys with counts of one)."""
    q = probe_hk.reshape(-1)
    if q.shape[0] == 0:
        return (jnp.zeros(probe_hk.shape, jnp.uint32),
                jnp.zeros(probe_hk.shape, jnp.int32))
    mv, mc = jax.lax.platform_dependent(
        q, run_hk, run_cnt, run_val, cuda=_probe_triton, default=_probe_plain)
    return mv.reshape(probe_hk.shape), mc.reshape(probe_hk.shape)

"""Golden join semantics: the portable definition of a correct result.

The reference join binaries emit, for every (outer tuple, matching inner
tuple) pair, a three-column row (outer key, outer payload, inner payload) --
probe writes key/val/tab at npj.cpp:296-317 and the scalar tail at
npj.cpp:344-347.  Output ORDER is nondeterministic there (atomically claimed
blocks), so equality of results is defined on the row multiset; this module
provides the numpy oracle, a canonical row ordering, and an O(1)-comparable
multiset digest for at-scale verification (SURVEY.md section 4).
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def join_oracle(
    inner_keys: np.ndarray,
    inner_vals: np.ndarray,
    outer_keys: np.ndarray,
    outer_vals: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All matching rows as (outer_key, outer_val, inner_val) columns."""
    order = np.argsort(inner_keys, kind="stable")
    sk = inner_keys[order]
    sv = inner_vals[order]
    lo = np.searchsorted(sk, outer_keys, "left").astype(np.int64)
    hi = np.searchsorted(sk, outer_keys, "right").astype(np.int64)
    cnt = hi - lo
    total = int(cnt.sum())
    out_o = np.repeat(np.arange(len(outer_keys), dtype=np.int64), cnt)
    group_start = np.repeat(np.cumsum(cnt) - cnt, cnt)
    ipos = np.repeat(lo, cnt) + (np.arange(total, dtype=np.int64) - group_start)
    return outer_keys[out_o], outer_vals[out_o], sv[ipos]


def canonical_order(
    keys: np.ndarray, vals: np.ndarray, tabs: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rows sorted lexicographically by (key, val, tab): the canonical form
    used to compare outputs whose physical order differs."""
    idx = np.lexsort((tabs, vals, keys))
    return keys[idx], vals[idx], tabs[idx]


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: order-independent row hashing needs each row's
    hash to be well mixed before summation."""
    x = x.astype(_U64)
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


def multiset_digest(
    keys: np.ndarray, vals: np.ndarray, tabs: np.ndarray
) -> tuple[int, int, int]:
    """(count, sum-of-row-hashes mod 2^64, xor is replaced by a second
    independent sum) -- equal digests <=> equal row multisets w.h.p.

    Used to verify 10^8+-row outputs without materializing sorted copies.

    The row hash CHAINS the mix per column.  The earlier single-xor of
    shifted columns collided deterministically: u32 columns shifted by
    21/42 overlap (key bits 21-31 alias val bits 0-10) and tab bits
    22-31 fell off the u64 top, so distinct rows like (0,1,7) and
    (2097152,0,7) -- or tabs differing only in high bits -- hashed
    equal, and a column-bit-swapping engine bug would verify clean.
    Chaining makes every input bit pass through a full finalizer before
    the next column is folded in.
    """
    h = _mix64(_mix64(_mix64(keys.astype(_U64)) ^ vals.astype(_U64))
               ^ tabs.astype(_U64))
    s1 = int(np.sum(h, dtype=_U64))
    s2 = int(np.sum(_mix64(h + _U64(0x9E3779B97F4A7C15)), dtype=_U64))
    return len(keys), s1, s2


def add_digests(a, b) -> tuple[int, int, int]:
    """The digest of the union of two row multisets: counts add, the two
    hash sums add mod 2^64."""
    m = (1 << 64) - 1
    return a[0] + b[0], (a[1] + b[1]) & m, (a[2] + b[2]) & m


def _oracle_chunk(task):
    inner_keys, inner_vals, outer_keys, outer_vals = task
    # the digest does not depend on row order: probe rows in key order make
    # join_oracle's searches walk the build side in order
    order = np.argsort(outer_keys, kind="stable")
    return multiset_digest(*join_oracle(inner_keys, inner_vals,
                                        outer_keys[order], outer_vals[order]))


def _digest_chunk(cols):
    return multiset_digest(*cols)


def _sum_digests(digests):
    total = (0, 0, 0)
    for d in digests:
        total = add_digests(total, d)
    return total


def oracle_digest(inner_keys, inner_vals, outer_keys, outer_vals,
                  pool=None, chunk_rows: int = 1 << 24):
    """multiset_digest(*join_oracle(...)), computed over probe chunks of
    chunk_rows rows (the digest is a sum over rows), on `pool` (a
    multiprocessing pool whose workers need numpy only) when given."""
    # one stable sort of the build side here; join_oracle's own stable
    # argsort of an already sorted column is then linear
    order = np.argsort(inner_keys, kind="stable")
    ik, iv = inner_keys[order], inner_vals[order]
    n = len(outer_keys)
    tasks = [(ik, iv, outer_keys[i : i + chunk_rows],
              outer_vals[i : i + chunk_rows]) for i in range(0, n, chunk_rows)]
    run = pool.imap_unordered if pool is not None else map
    return _sum_digests(run(_oracle_chunk, tasks))


def digest_rows(keys, vals, tabs, pool=None, chunk_rows: int = 1 << 24):
    """multiset_digest(keys, vals, tabs) over row chunks, on `pool` when
    given."""
    n = len(keys)
    tasks = [(keys[i : i + chunk_rows], vals[i : i + chunk_rows],
              tabs[i : i + chunk_rows]) for i in range(0, n, chunk_rows)]
    run = pool.imap_unordered if pool is not None else map
    return _sum_digests(run(_digest_chunk, tasks))

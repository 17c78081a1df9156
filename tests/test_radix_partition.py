"""The radix partition pass (ops/radix_partition.py) vs the numpy oracle."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest

from hash_join_codes_knl_tpu.ops.radix_partition import (
    multipass_partition,
    radix_partition,
    radix_partition_oracle,
    region_cap,
)


def _multiset(keys, vals):
    return collections.Counter(zip(keys.tolist(), vals.tolist()))


def _check(hk, vals, bits, skip_bits=0, cap=0):
    out_k, out_v, counts, ovf = radix_partition(
        jnp.asarray(hk), jnp.asarray(vals), bits, skip_bits=skip_bits,
        cap=cap,
    )
    assert int(ovf) == 0, "unexpected overflow"
    out_k, out_v = np.asarray(out_k), np.asarray(out_v)
    counts = np.asarray(counts)
    want = radix_partition_oracle(hk, vals, bits, skip_bits=skip_bits)
    F = 1 << bits
    cap_out = out_k.shape[0] // F
    for p in range(F):
        wk, wv = want[p]
        assert counts[p] == len(wk), f"count mismatch p={p}"
        rk = out_k[p * cap_out : (p + 1) * cap_out]
        rv = out_v[p * cap_out : (p + 1) * cap_out]
        m = rk != 0
        assert m.sum() == len(wk), f"region fill mismatch p={p}"
        assert _multiset(rk[m], rv[m]) == _multiset(wk, wv), f"p={p}"


def test_uniform_keys_8way():
    rng = np.random.default_rng(0)
    hk = rng.integers(1, 2**32, 20000, dtype=np.uint32)
    vals = rng.integers(0, 2**32, 20000, dtype=np.uint32)
    _check(hk, vals, bits=3)


def test_16way_with_nulls():
    rng = np.random.default_rng(1)
    hk = rng.integers(1, 2**32, 30000, dtype=np.uint32)
    hk[rng.integers(0, 30000, 3000)] = 0  # null keys must be dropped
    vals = rng.integers(0, 2**32, 30000, dtype=np.uint32)
    _check(hk, vals, bits=4)


def test_skip_bits_second_pass():
    rng = np.random.default_rng(2)
    # all keys share the top 3 bits (as within one first-pass partition)
    hk = (rng.integers(1, 2**29, 8192, dtype=np.uint32)
          | np.uint32(5 << 29))
    vals = rng.integers(0, 2**32, 8192, dtype=np.uint32)
    _check(hk, vals, bits=4, skip_bits=3)


def test_skewed_keys_detect_overflow():
    # every key identical: one partition takes everything; a tight cap
    # must flag overflow rather than corrupt
    hk = np.full(8192, 0x9E3779B1, dtype=np.uint32)
    vals = np.arange(8192, dtype=np.uint32)
    _, _, counts, ovf = radix_partition(
        jnp.asarray(hk), jnp.asarray(vals), 3, cap=512,
    )
    assert int(ovf) == 8192 - 512  # the dropped tuples, counted
    assert int(np.asarray(counts).sum()) == 8192  # counts stay exact
    # the retry the drivers make: a cap from the exact counts is complete
    _check(hk, vals, bits=3, cap=int(np.asarray(counts).max()))


def test_two_pass_composition():
    # pass 1 on 3 bits, pass 2 on the next 3: final partitions must equal
    # a direct 6-bit oracle partition
    rng = np.random.default_rng(3)
    hk = rng.integers(1, 2**32, 16384, dtype=np.uint32)
    vals = rng.integers(0, 2**32, 16384, dtype=np.uint32)
    k1, v1, c1, ovf1 = radix_partition(jnp.asarray(hk), jnp.asarray(vals), 3)
    assert int(ovf1) == 0
    cap1 = k1.shape[0] // 8
    want6 = radix_partition_oracle(hk, vals, 6)
    for p1 in range(8):
        rk = k1[p1 * cap1 : (p1 + 1) * cap1]
        rv = v1[p1 * cap1 : (p1 + 1) * cap1]
        k2, v2, c2, ovf2 = radix_partition(rk, rv, 3, skip_bits=3)
        assert int(ovf2) == 0
        k2, v2 = np.asarray(k2), np.asarray(v2)
        cap2 = k2.shape[0] // 8
        for p2 in range(8):
            wk, wv = want6[p1 * 8 + p2]
            rk2 = k2[p2 * cap2 : (p2 + 1) * cap2]
            rv2 = v2[p2 * cap2 : (p2 + 1) * cap2]
            m = rk2 != 0
            assert _multiset(rk2[m], rv2[m]) == _multiset(wk, wv)


def test_empty_input_clean_overflow():
    """An empty chunk reports overflow == 0 and empty regions."""
    out_k, out_v, counts, ovf = radix_partition(
        jnp.zeros(0, jnp.uint32), jnp.zeros(0, jnp.uint32), 3,
    )
    assert int(ovf) == 0
    assert int(np.asarray(counts).sum()) == 0
    assert (np.asarray(out_k) == 0).all()
    assert len(out_k) % (8 * 128) == 0


@pytest.mark.parametrize("pass_bits", [(6,), (3, 3), (2, 2, 2)])
def test_multipass_matches_single_pass_oracle(pass_bits):
    """Composed passes (each later pass batched over the previous
    regions) give the oracle's 6-bit partitions in region order."""
    rng = np.random.default_rng(sum(pass_bits) + len(pass_bits))
    hk = rng.integers(1, 2**32, 20000, dtype=np.uint32)
    hk[:500] = 0
    vals = rng.integers(0, 2**32, 20000, dtype=np.uint32)
    k, v, counts, ovf = multipass_partition(jnp.asarray(hk),
                                            jnp.asarray(vals), pass_bits)
    assert int(ovf) == 0
    k, v, counts = np.asarray(k), np.asarray(v), np.asarray(counts)
    cap = len(k) // 64
    for p, (wk, wv) in enumerate(radix_partition_oracle(hk, vals, 6)):
        rk, rv = k[p * cap : (p + 1) * cap], v[p * cap : (p + 1) * cap]
        m = rk != 0
        assert counts[p] == len(wk) == m.sum()
        assert _multiset(rk[m], rv[m]) == _multiset(wk, wv)


@pytest.mark.parametrize("n,F,cap,want", [
    (0, 8, 0, 128), (1 << 20, 64, 0, 17408), (100, 4, 300, 384),
    (1 << 16, 1, 0, 67584),
])
def test_region_cap_rule(n, F, cap, want):
    assert region_cap(n, F, cap) == want
    assert region_cap(n, F, cap) % 128 == 0

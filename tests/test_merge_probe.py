"""The merge-mode probe (ops/merge_probe.py) against the numpy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hash_join_codes_knl_tpu.engine.config import plan_join
from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.engine.phj import (
    _merge_sort_probe,
    _merge_sort_side,
    join,
    materialize,
    materialize_expanded,
)
import hash_join_codes_knl_tpu.ops.merge_probe as mp
from hash_join_codes_knl_tpu.ops.merge_probe import build_runs, merge_probe

MAXK = np.uint32(0xFFFFFFFF)


def _case(name, rng):
    """(build keys, build vals, probe keys) for one named scenario."""
    uniq = np.unique(rng.integers(1, 2**32 - 1, 3000, dtype=np.uint32))
    uniq = rng.permutation(uniq)[:2000]
    if name == "unique":
        ik = uniq
        ok = uniq[rng.integers(0, 2000, 6000)]
    elif name == "duplicates":
        ik = np.repeat(uniq[:500], rng.integers(1, 6, 500))
        ok = uniq[rng.integers(0, 700, 6000)]  # hits and misses
    elif name == "pads":
        # null keys on both sides never match
        ik = np.concatenate([uniq, np.zeros(300, np.uint32)])
        ok = np.concatenate([uniq[rng.integers(0, 2000, 5000)],
                             np.zeros(1000, np.uint32)])
    elif name == "max_key":
        # the key whose scrambled form may sit at the u32 top, plus the
        # raw top key itself on both sides
        ik = np.concatenate([uniq, np.full(3, MAXK)])
        ok = np.concatenate([uniq[rng.integers(0, 2000, 5000)],
                             np.full(50, MAXK)])
    elif name == "empty_probe":
        ik, ok = uniq, np.zeros(0, np.uint32)
    elif name == "all_miss":
        ik = uniq[:1000]
        ok = uniq[1000:][rng.integers(0, 1000, 6000)]
    elif name == "zipf":
        ranks = np.minimum(rng.zipf(1.5, 6000), 2000) - 1
        ik, ok = uniq, uniq[ranks]
    else:
        raise ValueError(name)
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    return ik.astype(np.uint32), iv, ok.astype(np.uint32)


CASES = ["unique", "duplicates", "pads", "max_key", "empty_probe",
         "all_miss", "zipf"]


@pytest.mark.parametrize("chunks", [0, 8, 64], ids=["flat", "C8", "C64"])
@pytest.mark.parametrize("name", CASES)
def test_merge_probe_matches_oracle(name, chunks):
    """Counts and largest match values per probe row, in the flat layout
    and in (C, L) chunk rows, equal the oracle's; outputs mirror the
    probe layout's shape."""
    rng = np.random.default_rng(len(name) * 100 + chunks)
    ik, iv, ok = _case(name, rng)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    bhk, bval = _merge_sort_side(jnp.asarray(ik), jnp.asarray(iv),
                                 max(len(ik), 1))
    cap = max(1, -(-len(ok) // 512)) * 512
    ohk, ovs = _merge_sort_probe(jnp.asarray(ok), jnp.asarray(ov), cap,
                                 chunks)
    mv, mc = merge_probe(ohk, *build_runs(bhk, bval))
    assert mv.shape == mc.shape == ohk.shape
    ohk, ovs = np.asarray(ohk).reshape(-1), np.asarray(ovs).reshape(-1)
    mv, mc = np.asarray(mv).reshape(-1), np.asarray(mc).reshape(-1)
    # the oracle, per probe row: match count and largest build value
    live = ik != 0
    want_c = np.zeros(len(ohk), np.int64)
    want_v = np.zeros(len(ohk), np.uint32)
    for i, q in enumerate(ohk):
        if q:
            hit = live & (ik == q)
            want_c[i] = hit.sum()
            want_v[i] = iv[hit].max(initial=0)
    np.testing.assert_array_equal(mc, want_c)
    np.testing.assert_array_equal(mv, want_v)


@pytest.mark.parametrize("name", CASES)
def test_join_merge_mode_digest(name):
    """The full merge pipeline through join() equals the oracle's rows
    (expanded for duplicate builds)."""
    rng = np.random.default_rng(len(name))
    ik, iv, ok = _case(name, rng)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    if len(ok) == 0:
        ok = ov = np.zeros(1, np.uint32)
    res, _ = join(ik, iv, ok, ov)
    rows = (materialize_expanded(res, ik, iv)
            if int(np.asarray(res.match_cnts).max(initial=0)) > 1
            else materialize(res))
    # key 0 is the engine's null key: the oracle sees only real rows
    bi, po = ik != 0, ok != 0
    assert multiset_digest(*rows) == multiset_digest(
        *join_oracle(ik[bi], iv[bi], ok[po], ov[po]))


@pytest.mark.parametrize("method", ["scan", "scan_unrolled", "sort"])
def test_merge_probe_search_methods_agree(method):
    rng = np.random.default_rng(3)
    ik, iv, ok = _case("duplicates", rng)
    bhk, bval = _merge_sort_side(jnp.asarray(ik), jnp.asarray(iv), len(ik))
    runs = build_runs(bhk, bval)
    q = jnp.asarray(ok)
    mv, mc = mp._probe_plain(q, *runs, method=method)
    mv0, mc0 = merge_probe(q, *runs)
    np.testing.assert_array_equal(np.asarray(mc), np.asarray(mc0))
    np.testing.assert_array_equal(np.asarray(mv), np.asarray(mv0))


def test_build_runs_layout():
    bhk = jnp.asarray(np.array([0, 0, 5, 5, 5, 9, MAXK], np.uint32))
    bval = jnp.asarray(np.array([7, 7, 3, 11, 2, 4, 6], np.uint32))
    hk, cnt, val = (np.asarray(a) for a in build_runs(bhk, bval))
    np.testing.assert_array_equal(hk, [0, 5, 9, MAXK, MAXK, MAXK, MAXK])
    np.testing.assert_array_equal(cnt, [2, 3, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(val, [7, 11, 4, 6, 0, 0, 0])


def test_unused_runs_never_match_the_top_key():
    """Unused run entries carry key 0xFFFFFFFF with count 0: probing that
    key without a real run must find no match."""
    bhk = jnp.asarray(np.array([3, 3, 8], np.uint32))
    bval = jnp.asarray(np.array([1, 2, 3], np.uint32))
    mv, mc = merge_probe(jnp.asarray(np.array([MAXK, 3, 8, 0], np.uint32)),
                         *build_runs(bhk, bval))
    np.testing.assert_array_equal(np.asarray(mc), [0, 2, 1, 0])
    np.testing.assert_array_equal(np.asarray(mv), [0, 2, 3, 0])


def test_plan_join_sorts_probe_globally():
    plan = plan_join(16_000_000, 256_000_000)
    assert plan.probe_chunks == 0 and plan.probe_impl == "merge"


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Runs the Triton kernel in Pallas's interpreter on the CPU."""
    import functools

    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("name", ["unique", "duplicates", "pads", "max_key",
                                  "all_miss", "zipf"])
def test_triton_kernel_matches_plain(name, interpret_pallas):
    """The kernel the GPU runs, interpreted, equals the plain probe --
    including a probe column that is not a whole number of blocks."""
    rng = np.random.default_rng(7 + len(name))
    ik, iv, ok = _case(name, rng)
    ok = np.sort(ok)[:-37]  # sorted like the merge pipeline's probe side
    bhk, bval = _merge_sort_side(jnp.asarray(ik), jnp.asarray(iv), len(ik))
    runs = build_runs(bhk, bval)
    q = jnp.asarray(ok)
    mv, mc = mp._probe_triton(q, *runs, block=256)
    mv0, mc0 = mp._probe_plain(q, *runs)
    assert mv.shape == (len(ok),)
    np.testing.assert_array_equal(np.asarray(mc), np.asarray(mc0))
    np.testing.assert_array_equal(np.asarray(mv), np.asarray(mv0))


def test_cpu_lowering_takes_the_plain_probe():
    """On the CPU merge_probe lowers to the plain search: its HLO holds no
    Triton custom call."""
    runs = build_runs(jnp.arange(1, 9, dtype=jnp.uint32),
                      jnp.arange(8, dtype=jnp.uint32))
    q = jnp.arange(16, dtype=jnp.uint32)
    hlo = jax.jit(merge_probe).lower(q, *runs).as_text()
    assert "triton" not in hlo.lower()
    mv, mc = merge_probe(q, *runs)
    np.testing.assert_array_equal(np.asarray(mc), [0] + [1] * 8 + [0] * 7)


def test_empty_probe_column():
    runs = build_runs(jnp.arange(1, 9, dtype=jnp.uint32),
                      jnp.arange(8, dtype=jnp.uint32))
    mv, mc = merge_probe(jnp.zeros((4, 0), jnp.uint32), *runs)
    assert mv.shape == mc.shape == (4, 0)

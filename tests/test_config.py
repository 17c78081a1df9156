"""Plan policies: reference pass policy parity + auto-plan invariants."""

import pytest

from hash_join_codes_knl_tpu.engine.config import (
    plan_join,
    reference_pass_plan,
)


def test_reference_pass_policy_thresholds():
    # phj.cpp:1791-1808 with hash_table_limit=6400
    assert reference_pass_plan(6400 * 5) == ()  # partitions=5 <= 10
    assert reference_pass_plan(6400 * 100) == (100,)  # 1 pass
    p2 = reference_pass_plan(6400 * 10_000)  # partitions=10000 -> 2 passes
    assert len(p2) == 2 and p2[0] * p2[1] <= 10_000 < (p2[0] + 1) ** 2
    p3 = reference_pass_plan(6400 * 100_000)  # -> 3 passes
    assert len(p3) == 3
    prod = p3[0] * p3[1] * p3[2]
    assert prod <= 100_000
    p4 = reference_pass_plan(6400 * 2_000_000)  # -> 4 passes
    assert len(p4) == 4


def test_plan_join_invariants():
    for ni, no in [(16_000_000, 256_000_000), (1024, 8192), (100, 100)]:
        p = plan_join(ni, no)
        assert sum(p.pass_bits) == p.p_bits
        assert p.slots >= 64 and p.tile % 128 == 0
        assert p.num_partitions == 1 << p.p_bits


@pytest.mark.parametrize("ni,no", [(16_000_000, 256_000_000),
                                   (64_000_000, 1_000_000_000),
                                   (4_000_000, 16_000_000), (1, 1)])
def test_plan_join_merge_defaults(ni, no):
    """The merge engine sorts the probe side globally at every size (no
    window or chunk rules remain), with a 128-multiple pad quantum."""
    p = plan_join(ni, no)
    assert p.probe_impl == "merge" and p.probe_chunks == 0
    assert p.tile == 2048 and not p.unique_build


def test_plan_join_keeps_requested_chunks():
    assert plan_join(4096, 65536, tile=512, probe_chunks=8).probe_chunks == 8

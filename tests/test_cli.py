"""CLI driver smoke tests (argv compatibility, file flow, verification)."""

import json

import pytest

from hash_join_codes_knl_tpu.cli import main


def test_write_then_phj(tmp_path, capsys):
    assert main(["write", "1", "4096", "4096", "--dir", str(tmp_path),
                 "--seed", "3"]) == 0
    meta = json.loads(capsys.readouterr().out.strip())
    assert meta["join_distinct"] == 4096
    assert main(["phj", "1", "4096", "4096", "--dir", str(tmp_path),
                 "--seed", "3", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 4096
    assert out["tuples_per_s"] > 0


def test_cli_selc_files_checked_only_with_selc(tmp_path, capsys):
    """On-disk relations written with selc < 1: without --selc the
    cardinality gate is SKIPPED (selectivity unknown -- the old check
    assumed 1.0 and false-failed correct joins); with --selc it runs
    exactly."""
    assert main(["write", "1", "4096", "4096", "0.5", "--dir",
                 str(tmp_path), "--seed", "11"]) == 0
    capsys.readouterr()
    assert main(["phj", "1", "4096", "4096", "--dir", str(tmp_path),
                 "--seed", "11", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 2048
    assert main(["phj", "1", "4096", "4096", "--dir", str(tmp_path),
                 "--seed", "11", "--selc", "0.5", "--json"]) == 0
    # and a wrong --selc assertion is a loud mismatch
    assert main(["phj", "1", "4096", "4096", "--dir", str(tmp_path),
                 "--seed", "11", "--selc", "1.0", "--json"]) == 1


def test_cli_truncated_relation_raises(tmp_path):
    """A truncated on-disk relation must raise, not silently regenerate
    different data under the benchmark (never-silent convention)."""
    assert main(["write", "1", "4096", "4096", "--dir", str(tmp_path),
                 "--seed", "3"]) == 0
    p = tmp_path / "ik_4096.txt"
    p.write_bytes(p.read_bytes()[: 100 * 4])
    with pytest.raises(ValueError, match="truncat|read"):
        main(["phj", "1", "4096", "4096", "--dir", str(tmp_path)])


def test_cpra_cli_zero_threads(capsys):
    """threads=0 degenerates to one device instead of a negative-shift
    crash."""
    assert main(["cpra", "0", "2048", "1024", "--seed", "9",
                 "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 2048


def test_npj_cli_in_memory(capsys):
    assert main(["npj", "1", "2048", "2048", "--seed", "5", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 2048
    assert "build_s" in out and "probe_s" in out


def test_cpra_cli(capsys):
    assert main(["cpra", "8", "8192", "1024", "--seed", "7", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 8192


def test_write_zipf(tmp_path, capsys):
    assert main(["write", "1", "8192", "1024", "1.0", "0.75",
                 "--dir", str(tmp_path)]) == 0
    meta = json.loads(capsys.readouterr().out.strip())
    assert meta["mode"] == "zipf"


def test_npj_cli_distributed(capsys):
    assert main(["npj", "8", "4096", "512", "--seed", "9", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 4096


def test_cpra_cli_with_tier_ratio(capsys):
    assert main(["cpra", "8", "8192", "1024", "0.75", "--seed", "11",
                 "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 8192


def test_phj_cli_timelog(capsys):
    assert main(["phj", "1", "8192", "1024", "--seed", "13", "--json",
                 "--timelog"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 8192
    for key in ("partition_build_s", "partition_probe_s", "probe_s"):
        assert key in out, key
    # the CPU has no memory-bandwidth peak: no roofline fields at all
    assert not any("roofline" in k or "peak" in k for k in out)


def test_phj_cli_profile(tmp_path, capsys):
    assert main(["phj", "1", "2048", "512", "--seed", "15", "--json",
                 "--profile", str(tmp_path / "trace")]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 2048
    import os

    assert any(os.scandir(tmp_path / "trace")), "no trace written"


def test_phj_cli_config_file(tmp_path, capsys):
    cfg = tmp_path / "plan.json"
    cfg.write_text(json.dumps({"tile": 256, "probe_chunks": 4,
                               "unique_build": True}))
    assert main(["phj", "1", "4096", "1024", "--seed", "17", "--json",
                 "--config", str(cfg)]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 4096


def test_cpra_cli_pipelined_chunks(capsys):
    assert main(["cpra", "8", "16384", "2048", "--seed", "19", "--json",
                 "--chunks", "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 16384


def test_cpra_cli_timelog_staged_phases(capsys):
    """--timelog must meter the exchange separately from the local join
    (cpra2.cpp:1895-1905 copy-time parity)."""
    assert main(["cpra", "8", "8192", "1024", "--seed", "7", "--json",
                 "--timelog"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["join_tuples"] == 8192
    assert "exchange_s" in out and "local_join_s" in out


def test_phj_cli_aggregate(capsys):
    """--aggregate runs the hash aggregate over the join output as a
    timed driver stage: group count equals the build distinct count on
    the uniform workload (every probe matches one build key) and the
    stage appears in the timing report."""
    assert main(["phj", "1", "8192", "1024", "--seed", "21", "--json",
                 "--aggregate"]) == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip())
    assert out["join_tuples"] == 8192
    assert "aggregate_s" in out
    assert "AGGREGATE: 1024 groups" in captured.err


def test_npj_cli_sorted_order(capsys):
    """--sorted-order on the npj driver: same cardinality through the
    single-sort sorted-aligned contract."""
    assert main(["npj", "1", "8192", "2048", "--seed", "33",
                 "--json"]) == 0
    out0 = json.loads(capsys.readouterr().out.strip())
    assert main(["npj", "1", "8192", "2048", "--seed", "33", "--json",
                 "--sorted-order"]) == 0
    out1 = json.loads(capsys.readouterr().out.strip())
    assert out1["join_tuples"] == out0["join_tuples"] == 8192


def test_phj_cli_aggregate_mn(tmp_path, capsys):
    """--aggregate on a duplicate-build (M:N) workload must stream the
    expansion through device blocks (aggregate_join_result_expanded)
    instead of refusing -- r5 closes the 'AGGREGATE UNSUPPORTED' gap."""
    assert main(["write", "1", "8192", "1024", "0.5", "--dir",
                 str(tmp_path), "--seed", "5"]) == 0
    capsys.readouterr()
    assert main(["phj", "1", "8192", "1024", "--dir", str(tmp_path),
                 "--json", "--aggregate"]) == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip())
    assert "aggregate_s" in out
    assert "AGGREGATE:" in captured.err
    # 1024 inner rows over 512 distinct keys (selc 0.5): genuinely M:N,
    # and the group count is the matched distinct-key count
    import re

    g = int(re.search(r"AGGREGATE: (\d+) groups", captured.err).group(1))
    assert 0 < g <= 512

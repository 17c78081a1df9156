"""Plan-time probe-chunk tuner (engine/tune.py): cache behavior and the
off-device fallback."""

import json
import os

from hash_join_codes_knl_tpu.engine.tune import tuned_probe_chunks


def test_tuner_falls_back_off_device():
    # the suite runs on the forced-CPU backend: no device timing, the
    # static default must come back untouched
    assert tuned_probe_chunks(256_000_000, default=64) == 64


def test_tuner_uses_cache_file(tmp_path):
    """A cached verdict for this (n, tile, jax version, device kind) key
    must be honored without any timing -- even on CPU the cache hit path
    is the same code the device driver takes."""
    import jax

    dev = jax.devices()[0]
    # off-device callers return the default before the cache is read;
    # exercise the cache logic by writing the key the device path would use
    key = f"256000000|3072|{jax.__version__}|{dev.device_kind}"
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({key: {"C": 56, "times": {"56": 0.9}}}))
    got = tuned_probe_chunks(256_000_000, cache_path=str(path))
    # CPU backend: default wins (no tuning there by design)
    assert got == 64


def test_tuner_disabled_by_env(monkeypatch):
    monkeypatch.setenv("HJK_TUNE", "0")
    assert tuned_probe_chunks(256_000_000, default=48) == 48


def test_plan_join_reads_tuner_default():
    from hash_join_codes_knl_tpu.engine.config import plan_join

    # the planner no longer consults the tuner: one global probe sort
    plan = plan_join(16_000_000, 256_000_000)
    assert plan.probe_chunks == 0
    assert plan.tile == 2048


def test_tuner_degenerate_candidate_sets():
    """A single candidate is returned untimed (even off-device: the
    planner's window-feasibility cap can narrow the set to one); an
    empty set falls back to the default."""
    assert tuned_probe_chunks(1_000_000, candidates=(56,), default=64) == 56
    assert tuned_probe_chunks(1_000_000, candidates=(), default=64) == 64


def test_tuner_cache_key_includes_candidate_set(tmp_path, monkeypatch):
    """A verdict cached under one candidate set must not be reused for a
    different set (a verdict timed under the planner's narrowed
    window-feasibility cap would otherwise lock in an untimed choice).
    A fake non-CPU device gets past the off-device gate so the cache
    lookup itself is exercised; the timing path is stubbed out."""
    import jax

    class _FakeDev:
        platform = "fakegpu"
        device_kind = "FakeChip"

    monkeypatch.setattr(jax, "devices", lambda: [_FakeDev()])
    import hash_join_codes_knl_tpu.engine.tune as tune

    monkeypatch.setattr(
        tune, "_time_sort", lambda outer_n, C, tile, reps: float(C)
    )
    path = str(tmp_path / "tune.json")
    stale = (f"1000000|3072|48,56|{jax.__version__}|FakeChip")
    with open(path, "w") as f:
        json.dump({stale: {"C": 56, "times": {"56": 0.1}}}, f)
    # the stale narrow-set verdict (C=56) must NOT satisfy the wide set:
    # the stubbed timer makes the smallest candidate win instead
    got = tune.tuned_probe_chunks(
        1_000_000, candidates=(48, 56, 64, 72), cache_path=path
    )
    assert got == 48
    # and the matching set IS served from cache (timer would return 48)
    with open(path, "w") as f:
        json.dump(
            {f"1000000|3072|48,56,64,72|{jax.__version__}|FakeChip":
             {"C": 72, "times": {"72": 0.1}}}, f)
    assert tune.tuned_probe_chunks(
        1_000_000, candidates=(48, 56, 64, 72), cache_path=path
    ) == 72

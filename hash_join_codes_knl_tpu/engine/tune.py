"""Probe-chunk tuner: times the batched probe-side sort on the device.

The batched 2-D pair-sort cost over (chunk count, row length) shifts
across XLA releases and devices, so this module times it for a few
candidate chunk counts C ON THE DEVICE, picks the fastest, and caches
the verdict per (outer rows, jax version, device kind) in a JSON file
(<checkout>/.hjk_tune.json unless HJK_TUNE_CACHE names another).
plan_join no longer calls it: on the H100 the global 1-D sort beat every
chunked sort (PERF.md).  Any failure (no device, OOM, interrupt) falls
back to the static default -- tuning is an optimization, never a
correctness dependency.
"""

from __future__ import annotations

import json
import os

DEFAULT_CANDIDATES = (48, 56, 64, 72)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cache_path() -> str:
    return os.environ.get(
        "HJK_TUNE_CACHE", os.path.join(_REPO_ROOT, ".hjk_tune.json")
    )


def _load_cache(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _time_sort(outer_n: int, C: int, tile: int, reps: int) -> float:
    """MIN seconds over `reps` runs of the batched (C, cap/C) pair sort
    at this geometry, on the default device.  Min, not median: host
    hiccups only ever ADD time, and at the default reps=2 a median would
    be the max."""
    import time

    import jax
    import jax.numpy as jnp

    quantum = tile * C
    cap = -(-outer_n // quantum) * quantum
    rows = cap // C

    @jax.jit
    def make(seed):
        k = jax.random.bits(jax.random.key(seed), (C, rows), jnp.uint32)
        v = jax.random.bits(jax.random.key(seed + 1), (C, rows),
                            jnp.uint32)
        return k, v

    run = jax.jit(lambda k, v: jax.lax.sort((k, v), dimension=1,
                                             num_keys=1))
    k, v = jax.block_until_ready(make(0))
    jax.block_until_ready(run(k, v))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(k, v))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def tuned_probe_chunks(
    outer_n: int,
    tile: int = 3072,
    default: int = 64,
    candidates=DEFAULT_CANDIDATES,
    reps: int = 2,
    cache_path: str | None = None,
) -> int:
    """The measured-best probe chunk count for this geometry (cached),
    or `default` when tuning is unavailable/disabled
    (HJK_TUNE=0 disables; off-device callers always get the default)."""
    if os.environ.get("HJK_TUNE", "1") == "0":
        return default
    if len(candidates) == 0:
        return default
    if len(candidates) == 1:
        return int(candidates[0])  # no choice to time
    try:
        import jax

        dev = jax.devices()[0]
        if dev.platform == "cpu":
            return default
        # the candidate set is part of the key: plan_join narrows
        # candidates by its window-feasibility cap, and a verdict timed
        # under a narrow cap must not be reused where more C values are
        # admissible (it would lock in an untimed choice)
        cset = ",".join(str(C) for C in candidates)
        key = (f"{outer_n}|{tile}|{cset}|{jax.__version__}|"
               f"{dev.device_kind}")
    except Exception:
        return default
    path = cache_path or _cache_path()
    cache = _load_cache(path)
    if key in cache:
        return int(cache[key]["C"])
    try:
        times = {}
        for C in candidates:
            times[str(C)] = round(_time_sort(outer_n, C, tile, reps), 4)
        best = int(min(times, key=lambda c: times[c]))
        # merge-on-write + atomic replace: a concurrent tuner (e.g. the
        # bench matrix running several geometries in parallel processes)
        # must neither read a torn half-written file nor have its own
        # fresh entry clobbered by this process's stale snapshot
        cache = _load_cache(path)
        cache[key] = {"C": best, "times": times}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1)
        os.replace(tmp, path)
        return best
    except Exception:
        return default

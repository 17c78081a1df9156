"""Multi-host runtime: initialization, meshes, health checks.

The reference is a single process with pthread barriers (npj.cpp:1002-1005);
its multi-worker story IS the shared-memory model.  This framework scales
hosts through jax.distributed: every host runs the same SPMD program and
the mesh spans all devices.  Failure detection (SURVEY.md section 5) is a
liveness barrier: a tiny psum across the full mesh with a timeout -- if a
host is gone, the collective never completes and the caller aborts +
relaunches (every stage is a pure function of its inputs, so re-running a
stage is always safe; the on-disk relation files are the coarse
checkpoint, relation.py).
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


import os


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the multi-host runtime.

    Explicit args mirror jax.distributed.initialize.  With args None,
    the ENV-DRIVEN pod path engages: if the standard coordination
    variables are present (jax.distributed's own auto-detect inputs),
    the no-arg initialize() runs; otherwise this is a single-host no-op.
    Without the env check the documented pod bring-up was unreachable
    and every host silently built a local-only mesh."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
        return
    if num_processes is None and any(
        os.environ.get(v)
        for v in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                  "JAX_NUM_PROCESSES")
    ):
        jax.distributed.initialize(coordinator_address=coordinator)


def data_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    """1-D data mesh over all (or the first n) addressable devices.

    The join engine's only sharded axis is the relation axis: partitioning
    depth within a chip is handled by the radix plan, across chips by the
    owner exchange; there is no tensor/pipeline axis in a relational engine
    (SURVEY.md section 2.5)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.make_mesh((len(devs),), (axis,), devices=devs)


import functools


@functools.lru_cache(maxsize=32)
def _heartbeat_fn(mesh: Mesh, axis: str):
    """Compiled heartbeat psum, cached per (mesh, axis): a fresh
    jit(shard_map(closure)) per call would retrace + recompile at EVERY
    stage boundary, eating the timeout budget it protects."""
    def beat(x):
        return jax.lax.psum(x, axis)

    return jax.jit(
        jax.shard_map(beat, mesh=mesh, in_specs=P(axis), out_specs=P()),
    )


def shard_null_padded(x, n_dev: int, sharding):
    """device_put a host array onto the mesh, zero-padding to a device
    multiple first: key 0 is the inert null everywhere, so ANY relation
    length shards (without this, a non-divisible length dies in jax's
    sharding divisibility check with a cryptic error).  Shared by the
    distributed drivers (cpra_join, npj_join_dist)."""
    x = np.asarray(x)
    pad = -len(x) % n_dev
    if pad:
        x = np.concatenate([x, np.zeros(pad, x.dtype)])
    return jax.device_put(x, sharding)


def liveness_check(mesh: Mesh, timeout_s: float = 30.0, axis: str = "x",
                   _beat_fn=None) -> bool:
    """All-hosts heartbeat: one tiny psum over the mesh with a timeout.

    Returns True if every participant answered within the deadline.  A
    False return means a chip/host is unreachable; abort the job and rerun
    the stage (stages are pure; inputs are still on disk/HBM).

    The distributed drivers (cpra_join, npj_join_dist) run this at their
    stage boundary via require_live_mesh; _beat_fn is a test hook that
    substitutes the collective (e.g. one that hangs, to exercise the
    timeout path)."""
    n = mesh.shape[axis]
    fn = _beat_fn or _heartbeat_fn(mesh, axis)
    if jax.process_count() > 1:
        # a plain host array cannot be auto-sharded onto a mesh that
        # spans processes; build the global heartbeat input explicitly
        from jax.sharding import NamedSharding

        x = jax.make_array_from_callback(
            (n,), NamedSharding(mesh, P(axis)),
            lambda idx: np.ones(n, np.int32)[idx],
        )
    else:
        x = jnp.ones(n, jnp.int32)
    result: list[bool] = []

    def run():
        try:
            out = fn(x)
            result.append(int(np.asarray(out)[0]) == n)
        except Exception:
            result.append(False)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    return bool(result and result[0])


def require_live_mesh(mesh: Mesh, timeout_s: float | None, axis: str = "x",
                      stage: str = "") -> None:
    """Stage-boundary guard used by the distributed drivers: abort with a
    diagnosable error instead of hanging inside a data collective when a
    mesh participant is gone.  timeout_s=None skips the check (single-
    chip meshes skip it implicitly -- there is nobody else to wait for)."""
    if timeout_s is None or mesh.devices.size <= 1:
        return
    if not liveness_check(mesh, timeout_s=timeout_s, axis=axis):
        raise RuntimeError(
            f"mesh liveness check failed before stage {stage!r}: a "
            f"participant of the {dict(zip(mesh.axis_names, mesh.devices.shape))} "
            "mesh did not answer the heartbeat within "
            f"{timeout_s}s -- abort and rerun the stage (stages are pure)"
        )

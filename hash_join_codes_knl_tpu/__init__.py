"""Vectorized hash-join engine in JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of the KNL
hash-join benchmark suite (xtcyclist/hash_join_codes_KNL, CIKM'17): NPJ / PHJ /
CPRA hash joins, radix partitioning and sort, hash aggregate, filter, and a
bit-compatible relation generator, scaled over device meshes via shard_map.
"""

__version__ = "0.1.0"

# Lazy top-level API: the flagship entry points re-exported without
# importing jax (or building the native generator) until first use --
# `import hash_join_codes_knl_tpu as hjk; hjk.join(...)`.
_EXPORTS = {
    "JoinPlan": ("engine.config", "JoinPlan"),
    "plan_join": ("engine.config", "plan_join"),
    "join": ("engine.phj", "join"),
    "materialize": ("engine.phj", "materialize"),
    "materialize_expanded": ("engine.phj", "materialize_expanded"),
    "npj_join": ("engine.npj", "npj_join"),
    "cpra_join": ("parallel.cpra", "cpra_join"),
    "stream_join": ("engine.stream", "stream_join"),
    "grace_join": ("engine.grace", "grace_join"),
    "grace_join_dist": ("parallel.grace_dist", "grace_join_dist"),
    "generate": ("relgen.generate", "generate"),
    "join_columns": ("engine.columns", "join_columns"),
    "join_columns_u64": ("engine.columns", "join_columns_u64"),
    "join_columns_multi": ("engine.columns", "join_columns_multi"),
    "hash_aggregate": ("ops.aggregate", "hash_aggregate"),
    "hash_aggregate_chunked": ("ops.aggregate", "hash_aggregate_chunked"),
    "hash_aggregate_auto": ("ops.aggregate", "hash_aggregate_auto"),
    "aggregate_join_result": ("ops.aggregate", "aggregate_join_result"),
    "aggregate_join_result_expanded": (
        "ops.aggregate", "aggregate_join_result_expanded"),
    "join_oracle": ("engine.oracle", "join_oracle"),
    "multiset_digest": ("engine.oracle", "multiset_digest"),
    "data_mesh": ("parallel.distributed", "data_mesh"),
}
__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        mod, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), attr)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))

"""Minimal end-to-end join: generate, join, materialize, verify.

Runs on whatever jax.devices() offers (GPU or CPU).  Sizes are
CLI-overridable: python examples/basic_join.py [inner] [outer]
"""

import sys

import hash_join_codes_knl_tpu as hjk


def main():
    ni = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 16
    no = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 18

    # 'uniform' draws the probe side uniformly from the build keys
    # (mode='ref' is the bit-exact reference walk, outer <= inner only)
    inner, outer, meta = hjk.generate(
        seed=42, inner_tuples=ni, outer_tuples=no, mode="uniform"
    )

    # join() auto-plans; the result is
    # the ALIGNED layout (one slot per probe row: match count + max val)
    res, plan = hjk.join(inner.keys, inner.vals, outer.keys, outer.vals)
    print(f"join_tuples={int(res.join_tuples)} plan={plan}")

    # compact matched rows to host columns (outer key, outer val, inner val)
    keys, vals, tabs = hjk.materialize(res)
    print(f"materialized {len(keys)} rows; first: "
          f"({keys[0]}, {vals[0]}, {tabs[0]})")

    # verify against the numpy golden join (multiset digest)
    want = hjk.multiset_digest(*hjk.join_oracle(
        inner.keys, inner.vals, outer.keys, outer.vals))
    got = hjk.multiset_digest(keys, vals, tabs)
    assert got == want, "digest mismatch vs oracle"
    print("verified against the golden oracle")


if __name__ == "__main__":
    main()

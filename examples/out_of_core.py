"""Out-of-core joins: relations that do not fit device memory.

Two drivers (tiny sizes here so the example runs anywhere; scale the
numbers on real hardware):

- stream_join: build side device-resident, probe side stays in host
  RAM / np.memmap and streams through in chunks (checkpoint/resume via
  spill_dir).
- grace_join: NEITHER side needs to fit -- one out-of-core radix pass
  spills both relations to host partition files, then per-partition
  joins stream through (resumable in both phases).

python examples/out_of_core.py [spill_dir]
"""

import sys
import tempfile

import numpy as np

import hash_join_codes_knl_tpu as hjk


def main():
    spill = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp()
    rng = np.random.default_rng(3)
    ni, no = 50_000, 400_000
    ik = np.unique(rng.integers(1, 2**32, ni * 2, dtype=np.uint32))[:ni]
    iv = rng.integers(0, 2**32, ni, dtype=np.uint32)
    ok = ik[rng.integers(0, ni, no)].astype(np.uint32)  # host-resident
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)

    sres = hjk.stream_join(ik, iv, ok, ov, chunk_rows=64_000,
                           spill_dir=f"{spill}/stream")
    print(f"stream_join: {sres.join_tuples} tuples over "
          f"{len(sres.chunks)} chunks (resumed {sres.resumed_chunks})")

    gres = hjk.grace_join(ik, iv, ok, ov, f_bits=4, chunk_rows=100_000,
                          spill_dir=f"{spill}/grace")
    print(f"grace_join: {gres.join_tuples} tuples over "
          f"{1 << gres.f_bits} partitions (reused {gres.reused_sides})")

    # a re-run over the same inputs resumes from the spills
    gres2 = hjk.grace_join(ik, iv, ok, ov, f_bits=4, chunk_rows=100_000,
                           spill_dir=f"{spill}/grace")
    assert gres2.join_tuples == gres.join_tuples
    print(f"resume: reused {gres2.reused_sides}, "
          f"{gres2.resumed_partitions} partitions from the journal")


if __name__ == "__main__":
    main()

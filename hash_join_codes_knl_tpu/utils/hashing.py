"""Multiplicative range hashing, bit-compatible with the reference.

The whole reference suite hashes with one primitive (npj.cpp:90-106 simd_hash,
scalar form npj.cpp:199-200):

    h  = uint32(key * factor)          # 32-bit wraparound multiply
    h  = (uint64(h) * nbins) >> 32     # range-reduce to [0, nbins)

On KNL this took a 17-instruction AVX-512 dance because the ISA lacks a
32x32->high32 multiply (npj.cpp:90-106); here it is a few u32 ops via a
16-bit split (JAX's default integers are 32-bit).

The two-level tier hash (phj.cpp:101-116 simd_hash_ratio) routes each tuple
first to one of two memory tiers by a 100-bin hash against ``cut``, then to a
partition within the tier's half; kept for placement-policy parity.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# second-level hash factor for the tier/partition split (odd, independent of
# any odd `factor` a caller passes); the reference draws factors_2 randomly
# per run (phj.cpp:2134-2139) -- any odd constant distinct from factor works
DEFAULT_FACTOR2 = 0xC2B2AE3D

# --- numpy (host oracle) ------------------------------------------------------


def np_hashed_key(keys: np.ndarray, factor: int) -> np.ndarray:
    """hk = (keys * factor) mod 2^32 -- the host twin of hashed_key
    (odd-factor scramble; a u32 bijection, 0 iff key == 0)."""
    return (keys.astype(np.uint32) * np.uint32(factor)).astype(np.uint32)


def np_range_hash(keys: np.ndarray, factor: int, nbins: int) -> np.ndarray:
    """h = ((keys * factor) mod 2^32) * nbins >> 32, as uint32 bins."""
    h = np_hashed_key(keys, factor).astype(np.uint64)
    return ((h * np.uint64(nbins)) >> np.uint64(32)).astype(np.uint32)


def np_hash_ratio(
    keys: np.ndarray, factor: int, partitions: int, ratio: float,
    factor2: int | None = None,
) -> np.ndarray:
    """Two-level tier+partition hash (phj.cpp:101-116).

    Tier bin = range_hash(k*factor, 100) vs cut = (1-ratio)*100; partition id
    within the tier half = range_hash(k*factor2, partitions/2), offset by
    partitions/2 for the second tier.  The two levels hash with INDEPENDENT
    factors, as the reference does (simd_hash_ratio's factors_1/factors_2,
    phj.cpp:101-123): deriving both from one scramble makes tier and pid
    monotone functions of each other, which concentrates all traffic on the
    edge chips of each half and idles the rest.
    """
    if partitions % 2:
        raise ValueError(
            f"tier hash needs an even partition count, got {partitions}: "
            "both tiers map into [0, 2*(P//2)), so an odd P would idle "
            "the last partition silently"
        )
    if factor2 is None:
        factor2 = DEFAULT_FACTOR2
    cut = np.uint32(int((1.0 - ratio) * 100))
    hk = (keys.astype(np.uint32) * np.uint32(factor)).astype(np.uint64)
    hk2 = (keys.astype(np.uint32) * np.uint32(factor2)).astype(np.uint64)
    tier = ((hk * np.uint64(100)) >> np.uint64(32)).astype(np.uint32) >= cut
    half = partitions // 2
    pid = ((hk2 * np.uint64(half)) >> np.uint64(32)).astype(np.uint32)
    return np.where(tier, pid + np.uint32(half), pid)


# --- jax/jnp (device, 32-bit-int safe) ----------------------------------------


def mulhi32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """High 32 bits of the 64-bit product of two uint32 arrays.

    Pure u32 arithmetic (16-bit split with carry propagation), so it needs
    no 64-bit integers -- the replacement for the KNL _mm512_mul_epu32
    interleave trick (npj.cpp:90-106).
    """
    a = a.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    m16 = jnp.uint32(0xFFFF)
    al, ah = a & m16, a >> 16
    bl, bh = b & m16, b >> 16
    lo = al * bl
    t = ah * bl + (lo >> 16)  # <= (2^16-1)^2 + 2^16 - 1 < 2^32: no overflow
    t2 = al * bh + (t & m16)
    return ah * bh + (t >> 16) + (t2 >> 16)


def range_hash(keys: jnp.ndarray, factor, nbins) -> jnp.ndarray:
    """Device version of np_range_hash; exact u32 match."""
    hk = keys.astype(jnp.uint32) * jnp.uint32(factor)
    return mulhi32(hk, jnp.uint32(nbins))


def hashed_key(keys: jnp.ndarray, factor) -> jnp.ndarray:
    """uint32(key * factor): the scrambled key all range hashes derive from.

    For power-of-two fanouts, range_hash(k, f, 2^b) == hashed_key(k, f) >> (32-b),
    which is what the multi-pass radix partitioner exploits: successive passes
    consume successive high-bit groups of one scrambled key (the analog of
    the reference's per-pass simd_hash fanout, phj.cpp:1791-1808).
    """
    return keys.astype(jnp.uint32) * jnp.uint32(factor)


def mod_inverse_u32(factor: int) -> int:
    """Inverse of an odd factor mod 2^32: key * factor is a BIJECTION on
    u32, so the engine can carry scrambled keys through sort/probe and
    recover originals with one multiply (hk * inverse == key)."""
    assert factor & 1, "factor must be odd"
    inv = 1
    for _ in range(5):  # Newton iteration doubles correct bits: 1->32
        inv = (inv * (2 - factor * inv)) & 0xFFFFFFFF
    assert (inv * factor) & 0xFFFFFFFF == 1
    return inv


def hash_ratio(keys: jnp.ndarray, factor, partitions: int,
               ratio: float, factor2: int | None = None) -> jnp.ndarray:
    """Device version of np_hash_ratio: the two-level tier+partition hash
    (simd_hash_ratio, phj.cpp:101-116).

    Tier bin = range-hash over 100 bins vs cut = (1-ratio)*100: bins below
    the cut route to tier A (partitions [0, P/2), the reference's DDR half),
    the rest to tier B ([P/2, P), the MCDRAM half).  Partition within the
    half by a range hash of an INDEPENDENT second scramble (factors_2 in
    the reference) -- see np_hash_ratio for why one scramble cannot feed
    both levels.
    """
    if partitions % 2:
        raise ValueError(
            f"tier hash needs an even partition count, got {partitions}: "
            "both tiers map into [0, 2*(P//2)), so an odd P would idle "
            "the last partition silently"
        )
    if factor2 is None:
        factor2 = DEFAULT_FACTOR2
    cut = jnp.uint32(int((1.0 - ratio) * 100))
    hk = hashed_key(keys, factor)
    tier_b = mulhi32(hk, jnp.uint32(100)) >= cut
    half = partitions // 2
    pid = mulhi32(hashed_key(keys, factor2), jnp.uint32(half))
    return jnp.where(tier_b, pid + jnp.uint32(half), pid)


def radix_bits(hk: jnp.ndarray, hi_bit: int, bits: int) -> jnp.ndarray:
    """Extract `bits` bits of hk ending just below `hi_bit` (from the top).

    hi_bit=32, bits=6 -> top 6 bits; next pass hi_bit=26, bits=6; etc.
    """
    shift = jnp.uint32(hi_bit - bits)
    mask = jnp.uint32((1 << bits) - 1)
    return (hk >> shift) & mask

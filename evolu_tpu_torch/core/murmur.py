"""MurmurHash3 x86 32-bit, bit-exact with the reference's hash (npm
`murmurhash`, seed 0, over the ASCII bytes of the timestamp string).

Golden value:
murmur3_32(b"1970-01-01T00:00:00.000Z-0000-0000000000000000") == 4179357717
"""

C1 = 0xCC9E2D51
C2 = 0x1B873593
MASK = 0xFFFFFFFF


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 32-bit of `data`. Returns unsigned uint32."""
    h = seed & MASK
    n = len(data) & ~3
    for i in range(0, n, 4):
        k = data[i] | (data[i + 1] << 8) | (data[i + 2] << 16) | (data[i + 3] << 24)
        k = (k * C1) & MASK
        k = ((k << 15) | (k >> 17)) & MASK
        k = (k * C2) & MASK
        h ^= k
        h = ((h << 13) | (h >> 19)) & MASK
        h = (h * 5 + 0xE6546B64) & MASK
    tail = data[n:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * C1) & MASK
        k = ((k << 15) | (k >> 17)) & MASK
        k = (k * C2) & MASK
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK
    h ^= h >> 16
    return h


def to_int32(x: int) -> int:
    """Coerce a uint32/arbitrary int to JS `| 0` signed int32 semantics."""
    x &= MASK
    return x - 0x100000000 if x >= 0x80000000 else x

"""Doc -> shard routing: murmur3 hash partitioning (the port's copy of
opensearch_tpu.cluster.routing).

The routing string (the doc id unless a `routing` value is given) is
encoded as UTF-16-LE code units and hashed with murmur3_x86_32, seed 0; the
shard id is `floorMod(hash + partition_offset, routing_num_shards) /
routing_factor`, the two-level scheme that keeps doc placement stable
across an index shrink. `routing_partition_size > 1` spreads one routing
value over several shards (partition_offset = floorMod(murmur3(id),
partition_size)).
"""

from __future__ import annotations

from typing import Optional

_MASK = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def murmurhash3_x86_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 (Austin Appleby, public domain); the result as
    a signed 32-bit int."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h1 = seed & _MASK
    length = len(data)
    rounded = length & ~0x3
    for i in range(0, rounded, 4):
        k1 = int.from_bytes(data[i:i + 4], "little")
        k1 = (k1 * c1) & _MASK
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _MASK
        h1 ^= k1
        h1 = _rotl32(h1, 13)
        h1 = (h1 * 5 + 0xE6546B64) & _MASK
    k1 = 0
    tail = length & 0x3
    if tail >= 3:
        k1 ^= data[rounded + 2] << 16
    if tail >= 2:
        k1 ^= data[rounded + 1] << 8
    if tail >= 1:
        k1 ^= data[rounded]
        k1 = (k1 * c1) & _MASK
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _MASK
        h1 ^= k1
    h1 ^= length
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _MASK
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _MASK
    h1 ^= h1 >> 16
    return h1 - (1 << 32) if h1 >= (1 << 31) else h1


def hash_routing(routing: str) -> int:
    """Murmur3 of a routing string's UTF-16-LE code units."""
    return murmurhash3_x86_32(routing.encode("utf-16-le"), seed=0)


def generate_shard_id(doc_id: str, num_shards: int,
                      routing: Optional[str] = None,
                      routing_num_shards: Optional[int] = None,
                      routing_partition_size: int = 1) -> int:
    """The shard of a document: OperationRouting.generateShardId."""
    if routing_num_shards is None:
        routing_num_shards = num_shards
    routing_factor = routing_num_shards // num_shards
    partition_offset = hash_routing(doc_id) % routing_partition_size \
        if routing_partition_size > 1 else 0
    effective = routing if routing is not None else doc_id
    h = hash_routing(effective) + partition_offset
    return (h % routing_num_shards) // routing_factor

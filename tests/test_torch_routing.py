"""Document routing of opensearch_tpu_torch held against opensearch_tpu:
murmur3 over UTF-16-LE code units and the two-level shard choice give the
same shard for every (id, routing, shards, routing shards, partition
size) case, exactly, so both packages place every document alike."""

import random

import pytest

from opensearch_tpu.cluster import routing as jr

from opensearch_tpu_torch.cluster import routing as tr


def _ids(n=3000, seed=5):
    rng = random.Random(seed)
    alphabet = "abcXYZ019-_.é漢字😀"
    out = [f"d{i}" for i in range(n // 2)]
    out += ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 24)))
            for _ in range(n - len(out))]
    return out


def test_hash_routing_equals_reference():
    for s in _ids():
        assert tr.hash_routing(s) == jr.hash_routing(s), s


@pytest.mark.parametrize("data", [b"", b"a", b"ab", b"abc", b"abcd",
                                  b"abcde", bytes(range(256))])
@pytest.mark.parametrize("seed", [0, 1, 0x9747B28C])
def test_murmur3_equals_reference(data, seed):
    assert tr.murmurhash3_x86_32(data, seed) == \
        jr.murmurhash3_x86_32(data, seed)


@pytest.mark.parametrize("shards,routing_shards,partition", [
    (1, None, 1), (2, None, 1), (3, None, 1), (5, None, 1), (4, 8, 1),
    (3, 12, 1), (5, 640, 1), (4, None, 2), (5, 10, 3), (8, 64, 7)])
@pytest.mark.parametrize("with_routing", [False, True])
def test_generate_shard_id_equals_reference(shards, routing_shards,
                                            partition, with_routing):
    rng = random.Random(shards * 31 + partition)
    for doc_id in _ids(2000, seed=shards):
        routing = f"user{rng.randint(0, 50)}" if with_routing else None
        want = jr.generate_shard_id(doc_id, shards, routing=routing,
                                    routing_num_shards=routing_shards,
                                    routing_partition_size=partition)
        got = tr.generate_shard_id(doc_id, shards, routing=routing,
                                   routing_num_shards=routing_shards,
                                   routing_partition_size=partition)
        assert got == want and 0 <= got < shards, (doc_id, routing)

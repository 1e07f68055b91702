"""Multi-shard search on one card: the single-device form of the
reference's DistributedSearcher (`distributed.py`)."""

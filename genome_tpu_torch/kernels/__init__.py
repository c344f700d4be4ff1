"""Device stages: int64 keys, extraction, counting, stream compaction."""

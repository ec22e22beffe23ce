"""Training over several devices: the process group and the global
statistics (`dist.py`), gradient buckets and ZeRO-1 / FSDP sharding of the
optimizer state (`shard.py`)."""

"""Replica sharding over several GPUs (port of flashmd_tpu/parallel)."""

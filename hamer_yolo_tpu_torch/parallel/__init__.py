"""Parallelism: the device mesh and sharding rules (parallel/mesh.py)."""

"""Partition specs, meshes, ``shard_map`` with its two bindings
(``spmd.py``) and the sharding rules (``rules.py``)."""

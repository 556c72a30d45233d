"""Parallel training and serving: data parallelism over processes, one rank
a device (`mesh.py`, `multihost.py`), and the two-stage GPipe pipeline
(`pipeline.py`). The JAX package's tensor and spatial sharding
(`parallel/tensor.py`, `parallel/spatial.py`) come with slice 6b."""

from .mesh import DataGroup, attach_data_group, make_data_group, shard_batch

__all__ = ["DataGroup", "attach_data_group", "make_data_group", "shard_batch"]

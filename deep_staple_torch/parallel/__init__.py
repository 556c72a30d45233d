"""Parallel training and serving: data parallelism over processes, one rank
a device (`mesh.py`, `multihost.py`), tensor parallelism over a model axis
of ranks (`tensor.py`), and the two-stage GPipe pipeline (`pipeline.py`).
The JAX package's spatial sharding (`parallel/spatial.py`) comes with
slices 6c and 6d."""

from .mesh import DataGroup, ModelGroup, attach_data_group, make_data_group, make_grid, shard_batch
from .tensor import shard_model, shard_train_state

__all__ = ["DataGroup", "ModelGroup", "attach_data_group", "make_data_group", "make_grid",
           "shard_batch", "shard_model", "shard_train_state"]

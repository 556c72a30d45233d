"""Parallel training and serving: data parallelism over processes, one rank
a device (`mesh.py`, `multihost.py`), tensor parallelism over a model axis
of ranks (`tensor.py`), the two-stage GPipe pipeline (`pipeline.py`), and
whole-volume inference and training over a space axis of ranks, each
holding a slab of the volume's H axis (`spatial.py`)."""

from .mesh import (DataGroup, ModelGroup, SpaceGroup, attach_data_group, batch_group,
                   make_data_group, make_grid, shard_batch)
from .tensor import shard_model, shard_train_state

__all__ = ["DataGroup", "ModelGroup", "SpaceGroup", "attach_data_group", "batch_group",
           "make_data_group", "make_grid", "shard_batch", "shard_model", "shard_train_state"]

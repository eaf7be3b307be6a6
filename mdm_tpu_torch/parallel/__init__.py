"""Rank meshes, multi-process bootstrap and tensor-parallel rules
(counterpart of mdm_tpu/parallel)."""
from .mesh import (  # noqa: F401
    Mesh,
    batch_axes,
    batch_sharding,
    get_mesh,
    make_mesh,
    make_mesh_for_batch,
    replicated,
    shard_batch,
)

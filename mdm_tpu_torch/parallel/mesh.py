"""The rank mesh of a torch.distributed world, and the batch helpers.

Counterpart of mdm_tpu/parallel/mesh.py. A ``Mesh`` lays the world's ranks
out on a grid in JAX's order, ``np.arange(world).reshape(...)``, with the
axes ``('data', 'model')``, or ``('slice', 'data', 'model')`` when
``num_slices > 1``: the batch splits over ``('slice', 'data')`` and a
tensor-parallel layer over ``'model'``. Each rank holds two process groups
built from explicit rank lists with ``torch.distributed.new_group`` (which
every backend takes): the ranks that share its model index (the batch
group, which sums the gradients) and the ranks that share its batch index
(the model group, which sums a row-parallel product). A world of one needs
no group and no initialised process group.

Data parallelism is one process per device. Each rank feeds only its rows
of every global batch (a loader's ``shard=(rank, world)``), so
``shard_batch`` only moves a batch to the rank's device, unless it is told
that it holds the global batch, and then it keeps the rank's rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

SLICE_AXIS = "slice"
DATA_AXIS = "data"
MODEL_AXIS = "model"

_active: dict = {"mesh": None}


def mesh_grid(n: int, model_parallel: int = 1, num_slices: int = 1
              ) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """The rank grid of ``n`` ranks and its axis names, as
    mdm_tpu.parallel.make_mesh lays out n devices (:38-82), with its
    wording where n does not divide."""
    if n % (model_parallel * num_slices) != 0:
        raise ValueError(f"{n} devices not divisible by tp={model_parallel} x "
                         f"slices={num_slices}")
    ranks = np.arange(n)
    if num_slices > 1:
        dp = n // (model_parallel * num_slices)
        return ranks.reshape(num_slices, dp, model_parallel), (SLICE_AXIS, DATA_AXIS, MODEL_AXIS)
    return ranks.reshape(n // model_parallel, model_parallel), (DATA_AXIS, MODEL_AXIS)


def data_parallel_size(n: int, batch_size: int, model_parallel: int = 1) -> int:
    """The data-parallel size of mdm_tpu's make_mesh_for_batch over n
    devices: the largest dp <= n // model_parallel that divides the batch."""
    dp = n // model_parallel
    while dp > 1 and batch_size % dp != 0:
        dp -= 1
    return dp


@dataclass
class Mesh:
    """This rank's place on the grid and its groups. ``batch_group`` and
    ``model_group`` are None in a world of one."""

    grid: np.ndarray
    axis_names: Tuple[str, ...]
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    batch_group: object = None
    model_group: object = None

    @property
    def size(self) -> int:
        return int(self.grid.size)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.grid.shape))

    @property
    def model_parallel(self) -> int:
        return int(self.grid.shape[-1])

    @property
    def data_parallel(self) -> int:
        """Ranks the batch splits over: slice x data."""
        return self.size // self.model_parallel

    @property
    def _coords(self) -> Tuple[int, ...]:
        return tuple(int(c[0]) for c in np.nonzero(self.grid == self.rank))

    @property
    def batch_index(self) -> int:
        """This rank's linear index over the batch axes."""
        return int(np.ravel_multi_index(self._coords[:-1], self.grid.shape[:-1]))

    @property
    def model_index(self) -> int:
        return self._coords[-1]

    def sum_over_batch(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` summed in place over this rank's batch group. A world
        of one that is up still runs the collective (the identity); a mesh
        of one rank with no process group up returns ``tensor`` as it is."""
        import torch.distributed as dist

        if self.size > 1 or dist.is_initialized():
            dist.all_reduce(tensor, group=self.batch_group)
        return tensor

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch that the batch axes divide."""
        if global_batch % self.data_parallel:
            raise ValueError(f"a batch of {global_batch} does not split over "
                             f"{self.data_parallel} data-parallel ranks")
        n = global_batch // self.data_parallel
        return slice(self.batch_index * n, (self.batch_index + 1) * n)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, num_slices: int = 1,
              device=None) -> Mesh:
    """The mesh of the world's ranks (all of them: a rank outside the mesh
    would have no rows to train), or of one rank when no world is up.
    ``device``: this rank's device, by default
    ``multihost.local_device()``. Becomes the mesh ``get_mesh`` returns."""
    from .multihost import local_device, rank, world_size

    world = world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"make_mesh(n_devices={n}) but the torch.distributed world holds "
                         f"{world} rank(s); launch one process per device "
                         "(launch_local_multihost, torchrun)")
    if n < world:
        raise ValueError(f"make_mesh(n_devices={n}) leaves ranks {n}..{world - 1} of the "
                         f"world of {world} outside the mesh")
    grid, names = mesh_grid(n, model_parallel, num_slices)
    mesh = Mesh(grid, names, rank(), torch.device(device) if device is not None
                else local_device())
    if world > 1:
        import torch.distributed as dist

        # new_group is collective: every rank builds every group, in one order.
        flat = grid.reshape(-1, model_parallel)
        for m in range(model_parallel):
            g = dist.new_group(flat[:, m].tolist())
            if mesh.rank in flat[:, m]:
                mesh.batch_group = g
        for row in flat:
            g = dist.new_group(row.tolist())
            if mesh.rank in row:
                mesh.model_group = g
    _active["mesh"] = mesh
    return mesh


def make_mesh_for_batch(batch_size: int, model_parallel: int = 1, device=None) -> Mesh:
    """A mesh whose data axis divides the global batch (mdm_tpu's
    make_mesh_for_batch). The port's world is fixed at launch, so a batch
    that would leave ranks idle raises instead of shrinking the mesh."""
    from .multihost import world_size

    n = world_size()
    dp = data_parallel_size(n, batch_size, model_parallel)
    if dp * model_parallel != n:
        raise ValueError(f"a global batch of {batch_size} does not split over the "
                         f"{n // model_parallel} data-parallel ranks of a world of {n}")
    return make_mesh(n_devices=n, model_parallel=model_parallel, device=device)


def get_mesh() -> Mesh:
    if _active["mesh"] is None:
        make_mesh()
    return _active["mesh"]


def batch_axes(mesh: Optional[Mesh] = None):
    """Mesh axis name(s) the batch dimension shards over."""
    mesh = mesh or get_mesh()
    if SLICE_AXIS in mesh.axis_names:
        return (SLICE_AXIS, DATA_AXIS)
    return DATA_AXIS


def batch_sharding(mesh: Optional[Mesh] = None):
    """The layout of a [B, ...] array: dim 0 split over the batch axes,
    given as the function from B to this rank's rows (``Mesh.rows``)."""
    return (mesh or get_mesh()).rows


def replicated(mesh: Optional[Mesh] = None):
    """The split of a leaf that every rank holds whole: None, as
    ``tp_rules.spec_for_param`` gives it (mdm_tpu's ``P()``)."""
    return None


def _map(tree, fn):
    import dataclasses

    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, np.ndarray):
        return fn(torch.from_numpy(tree)) if tree.dtype.kind in "biuf" else tree
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _map(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree)})
    return tree


def shard_batch(tree, mesh: Optional[Mesh] = None, *, global_batch: bool = False):
    """Every tensor of ``tree`` (dicts, lists, dataclasses such as
    Conditioning; numpy arrays become tensors) on the rank's device. With
    ``global_batch`` and a data-parallel world, each leaf whose first axis
    is the global batch keeps only this rank's rows; a loader's
    ``shard=`` batch is already local and is only moved."""
    mesh = mesh or get_mesh()
    rows = None
    if global_batch and mesh.data_parallel > 1:
        sizes = set()
        _map(tree, lambda t: sizes.add(t.shape[0]) if t.dim() else None)
        B = max(sizes) if sizes else 0
        rows = mesh.rows(B)

    def put(t):
        if rows is not None and t.dim() and t.shape[0] == B:
            t = t[rows]
        return t.to(mesh.device, non_blocking=True)

    return _map(tree, put)

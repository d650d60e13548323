"""Device meshes (torch counterpart of the JAX package's ``parallel/mesh.py``).

One ``Mesh`` type serves two uses:

* **In one process** (evaluation and serving) it is a grid of
  ``torch.device`` entries with axis names, as a JAX mesh is a grid of
  devices.  ``Evaluator`` and ``Forecaster`` hold one replica of the model
  an entry and split each batch over the entries.  An explicit ``devices=``
  may name one device more than once, as JAX's ``make_mesh(devices=...)``
  takes any devices: ``[cpu] * 8`` is the CPU tests' 8-entry mesh, and
  ``[cuda:0, cuda:0]`` puts two replicas on one card.
* **In a process group** (training) it is one rank an entry: ``devices``
  holds each rank's device in rank order, and ``device_mesh`` the
  ``torch.distributed.device_mesh.DeviceMesh`` over the ranks, of shape
  ``(data,)`` or ``(data, model)`` with the model axis minor (JAX
  ``mesh.py:36-38``).  The train step averages gradients and BatchNorm
  statistics over the data axis and shards kernels over the model axis
  (``parallel/tensor.py``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices with axis names; ``device_mesh`` is set in a
    process group (see the module docstring)."""

    devices: np.ndarray  # object array of torch.device, one axis per name
    axis_names: Tuple[str, ...]
    device_mesh: Any = None  # torch.distributed.device_mesh.DeviceMesh

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as JAX's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def in_group(self) -> bool:
        return self.device_mesh is not None

    @property
    def local_device(self) -> torch.device:
        """This rank's device in a process group, else the first entry."""
        if self.in_group:
            return self.devices.flat[dist.get_rank()]
        return self.devices.flat[0]

    @property
    def data_rank(self) -> int:
        """This rank's coordinate on the data axis (0 outside a group)."""
        if not self.in_group:
            return 0
        return int(self.device_mesh.get_coordinate()[0])

    def group(self, axis: str):
        """The process group of ``axis`` in a process group."""
        return self.device_mesh.get_group(axis)

    @property
    def entries(self) -> List[torch.device]:
        return list(self.devices.flat)


def _local_devices() -> List[torch.device]:
    """The devices a process outside a group sees: its cards (the port's
    entry points run on the card unless the caller asks for the CPU)."""
    from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device

    resolve_device(None, "make_mesh")  # no card: raise, naming the CPU's way
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _group_devices(rank_device: Optional[torch.device]) -> List[torch.device]:
    """Each rank's device, in rank order (one gather over the group)."""
    from spatiotemporal_variable_separation_tpu_torch.parallel.distributed import local_device

    device = rank_device if rank_device is not None else local_device()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(device))
    return [torch.device(n) for n in names]


def make_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              model_parallel: int = 1, rank_device=None) -> Mesh:
    """Mesh over the first ``num_devices`` devices.

    ``devices``: the entries of a one-process mesh (any devices, repeats
    allowed).  Without it, in a process group the mesh holds every rank
    (``num_devices`` must then be the group's size), and outside one the
    process's cards.  ``rank_device``: in a process group, this rank's
    device (default ``parallel.distributed.local_device()``).
    ``model_parallel == 1``: the 1-D ``("data",)`` mesh; above 1, ``(data,
    model)`` of shape ``(n // model_parallel, model_parallel)`` with the
    model axis minor."""
    in_group = devices is None and dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = (_group_devices(None if rank_device is None else torch.device(rank_device))
                   if in_group else _local_devices())
    devices = [torch.device(d) for d in devices]
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(f"requested {num_devices} devices, have {len(devices)}")
        if in_group and num_devices < len(devices):
            raise ValueError(f"requested {num_devices} devices, but the process group has "
                             f"{len(devices)} ranks, and a group trains on all of them")
        devices = devices[:num_devices]
    if model_parallel > 1:
        if len(devices) % model_parallel:
            raise ValueError(f"model_parallel={model_parallel} does not divide "
                             f"{len(devices)} devices")
        names: Tuple[str, ...] = (DATA_AXIS, MODEL_AXIS)
        shape: Tuple[int, ...] = (len(devices) // model_parallel, model_parallel)
    else:
        names, shape = (DATA_AXIS,), (len(devices),)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    grid = grid.reshape(shape)
    device_mesh = None
    if in_group:
        from torch.distributed.device_mesh import DeviceMesh

        device_mesh = DeviceMesh(devices[dist.get_rank()].type,
                                 torch.arange(len(devices)).reshape(shape),
                                 mesh_dim_names=names)
    return Mesh(grid, names, device_mesh)


class Sharding(NamedTuple):
    """A placement on a mesh: ``spec`` names the mesh axis of each leading
    array axis, as a JAX ``PartitionSpec`` does (``()``: replicated)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (batch) axis over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor or array of a tree of tuples, lists and dicts
    (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rows(x, lo: int, hi: Optional[int], device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x[lo:hi].to(device)


def device_put(x, sharding: Sharding):
    """``x`` placed on a mesh as ``sharding`` says (JAX's ``device_put`` of a
    mesh sharding).

    ``batch_sharding``: a tree split on its leading axis over the data axis,
    which must split evenly (``Evaluator`` pads a ragged batch first).
    ``replicated_sharding``: a whole copy on every entry; a module is moved
    to the first entry and deep-copied to the others.  In one process a
    list, one item an entry; in a process group this rank's item."""
    mesh, spec = sharding
    targets = [mesh.local_device] if mesh.in_group else mesh.entries
    if spec == ():
        if isinstance(x, torch.nn.Module):
            first = x.to(targets[0])
            out = [first] + [copy.deepcopy(first).to(d) for d in targets[1:]]
        else:
            out = [tree_map(lambda t, d=d: _rows(t, 0, None, d), x) for d in targets]
    elif spec == (DATA_AXIS,):
        n = mesh.shape[DATA_AXIS] if mesh.in_group else mesh.size
        first = x
        while isinstance(first, (tuple, list, dict)):
            first = next(iter(first.values())) if isinstance(first, dict) else first[0]
        b = first.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} rows does not split over {n} data shards")
        per = b // n
        shards = [mesh.data_rank] if mesh.in_group else range(n)
        out = [tree_map(lambda t, i=i, d=d: _rows(t, i * per, (i + 1) * per, d), x)
               for i, d in zip(shards, targets)]
    else:
        raise ValueError(f"device_put: a spec of {spec} is neither the batch's nor replicated")
    return out[0] if mesh.in_group else out


def shard_batch(mesh: Mesh, batch):
    """Split a global batch (a tree) on its leading axis over the data axis:
    in a process group this rank's rows on its device, in one process a
    list with each entry's rows on that entry's device."""
    return device_put(batch, batch_sharding(mesh))

"""Tensor-parallel parameter sharding over a 2-D ``(data, model)`` mesh.

Torch counterpart of the JAX package's ``parallel/tensor.py``, with its one
shape rule: for every kernel with >= 2 dims, shard whichever of its last two
**flax** dims (dense ``(in, out)``, conv ``(kh, kw, cin, cout)``) is larger
and divides the model-axis size; on a tie, the output dim.  The rule is
applied to the flax shape and the chosen dim mapped onto torch's layout with
the transposes of ``utils/weights.py:flax_to_torch``:

=============== ======================= ==========================
layer           flax kernel             torch weight
=============== ======================= ==========================
Dense           (in, out)               ``nn.Linear`` (out, in)
Conv            (kh, kw, cin, cout)     ``nn.Conv2d`` (cout, cin, kh, kw)
ConvTranspose   (kh, kw, cin, cout)     ``nn.ConvTranspose2d`` (cin, cout, kh, kw)
=============== ======================= ==========================

Where JAX leaves the collectives to GSPMD, the port says them: a sharded
weight is a ``DTensor`` on the mesh's ``DeviceMesh`` (``shard_state``), a
Linear runs on it with a replicated input (``models/layers.py:linear``), and
a convolution gathers it at use (``full_tensor()``, differentiable) and
convolves plain tensors, since DTensor's convolution takes replicated
weights only.  Each layer takes and returns replicated activations.
Biases, BatchNorm and every kernel that the rule leaves whole stay plain
tensors, equal on every rank; Adam's moments follow their parameter.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from spatiotemporal_variable_separation_tpu_torch.utils.weights import _flax_path, _torch_units

Path = Tuple[str, ...]

# flax kernel dim -> torch weight dim, by layer kind (the table above).
_FLAX_TO_TORCH_DIM = {"dense": {0: 1, 1: 0}, "conv": {2: 1, 3: 0}, "convT": {2: 0, 3: 1}}


def model_axis_size(mesh: Mesh) -> int:
    """Size of the mesh's model axis (1 when the mesh has none)."""
    return mesh.shape.get(MODEL_AXIS, 1)


def kernel_partition_spec(shape, n_model: int) -> Tuple:
    """The partition spec of one flax kernel, as a tuple (JAX's
    ``PartitionSpec`` as a tuple): the larger divisible of the last two dims
    on the model axis (tie: the last, output dim); ``()`` when neither
    divides."""
    nd = len(shape)
    if n_model <= 1 or nd < 2:
        return ()
    a, b = nd - 2, nd - 1
    div_a = shape[a] % n_model == 0 and shape[a] >= n_model
    div_b = shape[b] % n_model == 0 and shape[b] >= n_model
    if div_b and (not div_a or shape[b] >= shape[a]):
        axis = b
    elif div_a:
        axis = a
    else:
        return ()
    spec = [None] * nd
    spec[axis] = MODEL_AXIS
    return tuple(spec)


def _flax_kernel_shape(kind: str, weight: torch.Tensor) -> Tuple[int, ...]:
    s = tuple(weight.shape)
    if kind == "dense":
        return (s[1], s[0])
    if kind == "conv":
        return (s[2], s[3], s[1], s[0])
    return (s[2], s[3], s[0], s[1])  # convT


def _named_leaves(model: nn.Module) -> Iterator[Tuple[Path, str, nn.Module, str]]:
    """``(flax path, layer kind, module, torch leaf name)`` of every param."""
    for name, kind, m in _torch_units(model):
        path = _flax_path(name)
        if kind == "bn":
            yield path + ("scale",), kind, m, "weight"
        else:
            yield path + ("kernel",), kind, m, "weight"
        yield path + ("bias",), kind, m, "bias"


def state_shardings(model: nn.Module, mesh: Mesh) -> Dict[Path, Tuple]:
    """A placement per parameter, keyed by its flax path: a tuple of
    ``torch.distributed.tensor`` placements, one a mesh axis.  Kernels that
    the rule shards get ``Shard(torch dim)`` on the model axis; everything
    else is replicated."""
    from torch.distributed.tensor import Replicate, Shard

    n_model = model_axis_size(mesh)
    replicated = (Replicate(),) * len(mesh.axis_names)
    out: Dict[Path, Tuple] = {}
    for path, kind, m, leaf in _named_leaves(model):
        placements = replicated
        if path[-1] == "kernel":
            spec = kernel_partition_spec(_flax_kernel_shape(kind, m.weight), n_model)
            if spec:
                dim = _FLAX_TO_TORCH_DIM[kind][spec.index(MODEL_AXIS)]
                placements = tuple(Shard(dim) if axis == MODEL_AXIS else Replicate()
                                   for axis in mesh.axis_names)
        out[path] = placements
    return out


def is_sharded(placements) -> bool:
    return any(p.is_shard() for p in placements)


def expect_shardings(model: nn.Module, shardings) -> None:
    """Raise unless every parameter of ``model`` is placed as ``shardings``
    says: one that they shard a ``DTensor`` with those placements, any
    other a plain tensor."""
    from torch.distributed.tensor import DTensor

    for path, _, m, leaf in _named_leaves(model):
        p, want = getattr(m, leaf), tuple(shardings[path])
        placed = (isinstance(p, DTensor) and tuple(p.placements) == want if is_sharded(want)
                  else not isinstance(p, DTensor))
        if not placed:
            raise ValueError(f"{'/'.join(path)} is not placed as state_shardings say "
                             f"({want}): apply parallel.shard_state first")


def shard_state(state, mesh: Mesh, shardings=None):
    """Make each parameter that ``shardings`` (default ``state_shardings``
    of the mesh) shards a ``DTensor`` on the mesh's ``DeviceMesh``, in
    place, and Adam's state for it with the same placements.  Every rank
    holds the same full values (one seed, or one restored checkpoint), so
    no rank sends anything: each keeps its shard.  Returns ``state``."""
    from torch.distributed.tensor import distribute_tensor

    if not mesh.in_group:
        raise ValueError("shard_state needs a mesh over a process group")
    if shardings is None:
        shardings = state_shardings(state.model, mesh)
    swapped: Dict[nn.Parameter, nn.Parameter] = {}
    for path, _, m, leaf in _named_leaves(state.model):
        placements = shardings[path]
        if not is_sharded(placements):
            continue
        old = getattr(m, leaf)
        new = nn.Parameter(distribute_tensor(old.detach(), mesh.device_mesh, placements,
                                             src_data_rank=None))
        setattr(m, leaf, new)
        swapped[old] = new
    opt = state.optimizer
    for group in opt.param_groups:
        group["params"] = [swapped.get(p, p) for p in group["params"]]
        if swapped:
            # the multi-tensor (foreach) update, CUDA's default, takes the
            # group's DTensor and plain tensors in one call, which DTensor
            # refuses; the update of one tensor at a time takes each alone.
            group["foreach"] = False
    for old, new in swapped.items():
        if old in opt.state:
            opt.state[new] = {
                k: (distribute_tensor(v, mesh.device_mesh, new.placements, src_data_rank=None)
                    if isinstance(v, torch.Tensor) and v.shape == old.shape else v)
                for k, v in opt.state.pop(old).items()}
    return state


def full_tensor(t):
    """A ``DTensor``'s full value (a collective: every rank calls it), any
    other value as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def full_state_dicts(state) -> Tuple[dict, dict]:
    """``(model, optimizer)`` state dicts with every ``DTensor`` gathered to
    its full value, so a checkpoint is the same file whatever mesh wrote it.
    A collective under tensor parallelism."""
    from torch.distributed.tensor import DTensor

    model = {k: full_tensor(v) for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    opt["state"] = {i: {k: full_tensor(v) for k, v in s.items()}
                    for i, s in opt["state"].items()}
    if any(isinstance(p, DTensor) for p in state.model.parameters()):
        # shard_state's one-tensor-at-a-time update is the mesh's, not the run's
        opt["param_groups"] = [{**g, "foreach": None} for g in opt["param_groups"]]
    return model, opt

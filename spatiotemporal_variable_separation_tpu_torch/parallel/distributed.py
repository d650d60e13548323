"""Process groups: joining one, feeding it a batch, and starting its ranks.

Torch counterpart of the JAX package's ``parallel/distributed.py``.  JAX runs
one process a host and sees every local chip; PyTorch trains data- and
tensor-parallel with one process a device, so besides
``initialize_multihost`` and ``local_batch_to_global`` this module has a
launcher, ``launch``, that starts the ranks of one host: ``cli.main
--num_devices N`` trains through it, as the JAX package's ``--num_devices
N`` trains in one command.  Under ``torchrun`` each rank joins the group
itself (``initialize_multihost()`` reads torchrun's environment).
"""

from __future__ import annotations

import os
import signal
import tempfile
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    tree_map,
)

# This rank's device, set when it joins a group (one process, one rank).
_LOCAL_DEVICE: Optional[torch.device] = None


def under_torchrun() -> bool:
    """True in a process that ``torchrun`` started."""
    return "TORCHELASTIC_RUN_ID" in os.environ or all(
        k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None, backend: Optional[str] = None) -> torch.device:
    """Join the process group; returns this rank's device.

    Under ``torchrun`` every argument comes from its environment (``env://``).
    Otherwise ``coordinator_address`` is ``host:port`` (``tcp://``) or a
    rendezvous URL (``file://...``), with the group's size and this rank.
    ``device``: this rank's device (default the card of its local rank, or
    raise without one).  ``backend``: NCCL for a card, gloo for the CPU,
    unless given (gloo also carries CUDA tensors, e.g. two ranks on one
    card)."""
    global _LOCAL_DEVICE
    from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device

    if coordinator_address is None:
        if not under_torchrun():
            raise ValueError("initialize_multihost: give coordinator_address, num_processes "
                             "and process_id, or start the ranks with torchrun")
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize_multihost: num_processes and process_id go with "
                             "coordinator_address")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank, local_rank = num_processes, process_id, process_id
    if device is None:
        resolve_device(None, "initialize_multihost")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    device = resolve_device(device, "initialize_multihost")
    if device.type == "cuda":
        device = torch.device("cuda", device.index if device.index is not None
                              else torch.cuda.current_device())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _LOCAL_DEVICE = device
    return device


def local_device() -> torch.device:
    """This rank's device: the one ``initialize_multihost`` joined with, or
    the card NCCL uses in a group made elsewhere.  A group made elsewhere
    over another backend does not say which device its rank computes on
    (gloo carries CPU and CUDA tensors alike): that raises."""
    if _LOCAL_DEVICE is not None:
        return _LOCAL_DEVICE
    backend = dist.get_backend()
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"this rank's device is unknown: its {backend} group was not made by "
                     "initialize_multihost; pass the device (run_training(device=...), "
                     "make_mesh(rank_device=...))")


def group_rank() -> int:
    """This process's rank in its group (0 outside one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def group_barrier() -> None:
    """Wait for every rank of the group (nothing outside one)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def local_batch_to_global(mesh: Mesh, host_batch, global_batch_size: Optional[int] = None):
    """Put this rank's rows of the global batch (a tree, leading axis = its
    local rows) on its device.

    In a multi-rank job each rank loads only its slice of the global batch;
    the train step's reductions (gradients, BatchNorm statistics, metrics)
    make the step that of the global batch.  ``global_batch_size`` defaults
    to ``local rows x data ranks`` and must equal it."""
    n_data = mesh.shape[DATA_AXIS]

    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        want = global_batch_size if global_batch_size is not None else x.shape[0] * n_data
        if x.shape[0] * n_data != want:
            raise ValueError(f"global batch {want} is not {x.shape[0]} local rows x "
                             f"{n_data} data ranks")
        return x.to(mesh.local_device)

    return tree_map(put, host_batch)


def _rank_main(rank: int, fn: Callable, args: tuple, init_method: str,
               devices: Sequence[str], backend: Optional[str]) -> None:
    """One rank of ``launch``: join the group, run ``fn(*args)``, leave."""
    device = torch.device(devices[rank])
    if device.type == "cpu":
        # ranks on one host's cores: split them, not oversubscribe them.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    initialize_multihost(init_method, len(devices), rank, device=device, backend=backend)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, args: tuple, devices: Sequence, backend: Optional[str] = None,
           timeout: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in one process a device of ``devices``, as the ranks
    of one group (rank r on ``devices[r]``), and wait for them.

    The ranks are spawned (``torch.multiprocessing``) and meet at a
    ``file://`` rendezvous in a fresh temporary directory, so no other job on
    the machine can collide with them.  ``fn`` and ``args`` must pickle.  A
    rank that raises fails the job with its traceback
    (``ProcessRaisedException``) and the others are stopped; ``timeout``
    seconds without an end stop them all and raise ``TimeoutError``.  A
    SIGTERM to this process is passed on to the ranks, whose train loops
    stop between steps and save."""
    import torch.multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    with tempfile.TemporaryDirectory(prefix="varsep-rendezvous-") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, "file://" + os.path.join(tmp, "store"), devices, backend),
            nprocs=len(devices), join=False, start_method="spawn")

        def forward(signum, frame):
            for p in ctx.processes:
                if p.is_alive():
                    os.kill(p.pid, signum)

        installed = threading.current_thread() is threading.main_thread()
        if installed:
            prev = signal.signal(signal.SIGTERM, forward)
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    for p in ctx.processes:
                        if p.is_alive():
                            p.kill()
                    raise TimeoutError(f"launch: {len(devices)} ranks did not end within "
                                       f"{timeout:g} s")
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)

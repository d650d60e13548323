"""MLP-ResNet Euler rollout: the hand-written CUDA kernels and their plain version.

Counterpart of the JAX package's ``ops/pallas/rollout.py``.  The separable
forecaster evolves its T code by ``n_steps - 1`` sequential Euler steps of a
small residual MLP (reference ``var_sep/networks/model.py:78-83``).

* ``mlp_resnet_rollout_reference`` is the plain PyTorch version: a Python
  loop over steps and blocks of ``addmm``/``relu`` in f32.
* ``rollout_plan`` chooses, from the shapes alone, which kernel serves a
  rollout on the card:

  - ``"cluster"`` (``csrc/mlp_resnet_rollout_cluster.cu``): a thread-block
    cluster of C CTAs holds every block's weights in its shared memory for
    the whole rollout, each CTA a 1/C slice of the hidden columns.  C is the
    smallest of 1, 2, 4, 8, 16 whose slices and activations fit one CTA's
    232,448 bytes; the cluster serves ``rows`` batch rows.
  - ``"stream"`` (``csrc/mlp_resnet_rollout.cu``): one block per 8 batch
    rows streams the weights from L2 every step; it takes the weights that
    no cluster can hold (e.g. 4 blocks at hidden 512).

* ``mlp_resnet_rollout`` runs the plain version for a tensor on the CPU and
  launches the planned kernel for a tensor on the card; a failed launch
  raises, and nothing falls back to another variant, the plain version or
  the CPU.  ``mlp_resnet_rollout.launches`` counts the kernel launches, and
  ``mlp_resnet_rollout.variant_launches`` counts them by variant.

``params`` is the flat ``[w1, b1, w2, b2, w3, b3] * n_blocks`` list in the
JAX ``(in, out)`` layout (``MLPResnet.flat_params``), f32 and contiguous; the
result is ``(n_steps, B, code)`` with ``t0`` as row 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from spatiotemporal_variable_separation_tpu_torch.ops import _build

SMEM_LIMIT = 232_448          # bytes of shared memory one CTA may use on an H100
CLUSTER_SIZES = (1, 2, 4, 8, 16)
CLUSTER_THREADS = 256         # threads per CTA of the cluster kernel
MAX_BLOCKS = 16               # MLP-ResNet blocks either kernel takes
STREAM_ROWS = 8               # batch rows per block of the streaming kernel


class RolloutPlan(NamedTuple):
    variant: str     # "cluster" or "stream"
    cluster: int     # CTAs per cluster; 1 for "stream"
    rows: int        # batch rows per cluster ("cluster") or per block ("stream")
    smem_bytes: int  # dynamic shared memory of one CTA
    grid: int        # CTAs launched: a whole number of clusters


def _round_up4(x: int) -> int:
    return (x + 3) & ~3


def cluster_smem_bytes(code: int, hidden: int, n_blocks: int, cluster: int,
                       rows: int) -> int:
    """Dynamic shared memory of one CTA of the cluster kernel, in bytes: every
    block's weight slices (hidden columns padded to 4) and the activations.
    The kernel's ``make_layout`` computes the same."""
    sp = _round_up4(-(-hidden // cluster))
    k_groups = min(max(1, CLUSTER_THREADS // (sp // 2)), hidden)
    k3_groups = min(max(1, CLUSTER_THREADS // code), sp)
    per_block = 2 * code * sp + 2 * sp + hidden * sp + _round_up4(code)
    # The split-K sums of the W2 and W3 products share one scratch.
    scratch = max(k_groups * sp, k3_groups * code)
    activations = rows * (code + hidden + sp + scratch + cluster * code)
    return 4 * (n_blocks * per_block + activations)


def rollout_plan(batch: int, code: int, hidden: int, n_blocks: int,
                 variant: Optional[str] = None, rows: Optional[int] = None) -> RolloutPlan:
    """The kernel, cluster size, row tile and shared memory of a rollout.

    By default the cluster kernel at the smallest cluster whose slices fit,
    8 rows a cluster, else the streaming kernel.  8 rows, not 4: at the
    serving batch of 64 and clusters of 8, 4 rows need 16 clusters, and an
    H100 runs at most 15 such clusters at once, so the last runs in a second
    wave (``chip_smoke.py`` times both).  ``variant`` and ``rows`` force a
    choice, to measure one against the other; a forced cluster that fits no
    cluster size raises.
    """
    if not 1 <= n_blocks <= MAX_BLOCKS:
        raise ValueError(f"the rollout kernels take 1 to {MAX_BLOCKS} blocks, got {n_blocks}")
    if variant not in (None, "cluster", "stream"):
        raise ValueError(f"variant must be 'cluster' or 'stream', got {variant!r}")
    if variant != "stream":
        r = 8 if rows is None else rows
        if r not in (4, 8):
            raise ValueError(f"the cluster kernel takes 4 or 8 rows, got {r}")
        for c in CLUSTER_SIZES:
            smem = cluster_smem_bytes(code, hidden, n_blocks, c, r)
            if smem <= SMEM_LIMIT:
                return RolloutPlan("cluster", c, r, smem, -(-batch // r) * c)
        if variant == "cluster":
            raise ValueError(f"no cluster of up to {CLUSTER_SIZES[-1]} CTAs holds "
                             f"{n_blocks} block(s) at code {code}, hidden {hidden}")
    if rows not in (None, STREAM_ROWS):
        raise ValueError(f"the streaming kernel takes {STREAM_ROWS} rows, got {rows}")
    smem = 4 * STREAM_ROWS * (code + 2 * hidden)
    if smem > SMEM_LIMIT:
        raise ValueError(f"no rollout kernel takes hidden {hidden}: the streaming "
                         f"kernel's activations need {smem} bytes")
    return RolloutPlan("stream", 1, STREAM_ROWS, smem, -(-batch // STREAM_ROWS))


def mlp_resnet_rollout_reference(t0: torch.Tensor, params: Sequence[torch.Tensor],
                                 n_steps: int) -> torch.Tensor:
    """Plain PyTorch rollout; returns (n_steps, B, code) with t0 first."""
    t = t0.float()
    out = [t]
    for _ in range(n_steps - 1):
        for i in range(0, len(params), 6):
            w1, b1, w2, b2, w3, b3 = params[i:i + 6]
            h = torch.addmm(b1, t, w1).relu_()
            h = torch.addmm(b2, h, w2).relu_()
            t = t + torch.addmm(b3, h, w3)
        out.append(t)
    return torch.stack(out)


def _check_inputs(t0: torch.Tensor, params: Sequence[torch.Tensor], n_steps: int):
    """Validate what the kernel takes; returns (n_blocks, batch, code, hidden)."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if t0.dim() != 2:
        raise ValueError(f"t0 must be (batch, code), got shape {tuple(t0.shape)}")
    if not params or len(params) % 6:
        raise ValueError(f"params must be [w1, b1, w2, b2, w3, b3] * n_blocks, "
                         f"got {len(params)} tensors")
    batch, code = t0.shape
    if params[0].dim() != 2:
        raise ValueError(f"w1 must be (code, hidden), got shape {tuple(params[0].shape)}")
    hidden = params[0].shape[1]
    expected = [(code, hidden), (hidden,), (hidden, hidden), (hidden,),
                (hidden, code), (code,)]
    for i, p in enumerate(params):
        name = f"params[{i}] ({('w1', 'b1', 'w2', 'b2', 'w3', 'b3')[i % 6]})"
        if tuple(p.shape) != expected[i % 6]:
            raise ValueError(f"{name} must have shape {expected[i % 6]}, "
                             f"got {tuple(p.shape)}")
    for name, x in [("t0", t0)] + [(f"params[{i}]", p) for i, p in enumerate(params)]:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != t0.device:
            raise ValueError(f"{name} is on {x.device}, t0 on {t0.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return len(params) // 6, batch, code, hidden


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "mlp_resnet_rollout":
        lib.mlp_resnet_rollout_f32.argtypes = [vp, vp, i, vp, i, i, i, i, vp]
        lib.mlp_resnet_rollout_f32.restype = i
    else:
        lib.mlp_resnet_rollout_cluster_f32.argtypes = [vp, vp, i, vp, i, i, i, i, i, i, vp]
        lib.mlp_resnet_rollout_cluster_f32.restype = i
        lib.mlp_resnet_rollout_cluster_smem_bytes.argtypes = [i, i, i, i, i]
        lib.mlp_resnet_rollout_cluster_smem_bytes.restype = i
        lib.mlp_resnet_rollout_cluster_max_active.argtypes = [i, i, i, i, i, i]
        lib.mlp_resnet_rollout_cluster_max_active.restype = i
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes = [i]
    error_string.restype = ctypes.c_char_p
    return lib


def cluster_library() -> ctypes.CDLL:
    """The cluster kernel's library, for its shared-memory and occupancy queries."""
    return _library("mlp_resnet_rollout_cluster")


def mlp_resnet_rollout(t0: torch.Tensor, params: Sequence[torch.Tensor], n_steps: int,
                       plan: Optional[RolloutPlan] = None) -> torch.Tensor:
    """Rollout (B, code) -> (n_steps, B, code), t0 included.

    CPU tensors take the plain version; CUDA tensors launch the kernel that
    ``plan`` (default ``rollout_plan`` of the shapes) names on the current
    stream, or raise.
    """
    n_blocks, batch, code, hidden = _check_inputs(t0, params, n_steps)
    if t0.device.type == "cpu":
        return mlp_resnet_rollout_reference(t0, params, n_steps)
    if t0.device.type != "cuda":
        raise ValueError(f"mlp_resnet_rollout has no kernel for device {t0.device}")
    if plan is None:
        plan = rollout_plan(batch, code, hidden, n_blocks)
    name = "mlp_resnet_rollout" if plan.variant == "stream" else "mlp_resnet_rollout_cluster"
    lib = _library(name)
    out = torch.empty((n_steps, batch, code), dtype=torch.float32, device=t0.device)
    ptrs = (ctypes.c_void_p * len(params))(*(p.data_ptr() for p in params))
    args = (t0.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p), n_blocks, out.data_ptr(),
            batch, code, hidden, n_steps)
    with torch.cuda.device(t0.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.variant == "stream":
            err = lib.mlp_resnet_rollout_f32(*args, stream)
        else:
            err = lib.mlp_resnet_rollout_cluster_f32(*args, plan.cluster, plan.rows, stream)
    if err != 0:
        message = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed ({plan}): {message} (code {err})")
    mlp_resnet_rollout.launches += 1
    mlp_resnet_rollout.variant_launches[plan.variant] += 1
    return out


mlp_resnet_rollout.launches = 0
mlp_resnet_rollout.variant_launches = {"cluster": 0, "stream": 0}

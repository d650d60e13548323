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
  - ``"stream"`` (``csrc/mlp_resnet_rollout.cu``): the same column split
    over a cluster of C CTAs, with W1, the biases and W3 resident and every
    block's W2 slice streamed from L2 through a ring of ``STREAM_STAGES``
    chunks fed by TMA bulk copies; it takes every shape no resident cluster
    holds (e.g. WaveEq's 3 blocks at hidden 512).  Where even the W1, bias
    and W3 slices of every block do not fit (``resident=False``: e.g. 8
    blocks at code 64, hidden 512), the kernel reads them from L2 every
    block-step and streams W2 as before.  C and the row tile R (4 to 32, a
    multiple of 4) give the fewest waves of clusters the card runs at once,
    then the least work a CTA.  ``pack_w2`` lays W2 out for it, once per
    call.

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
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from spatiotemporal_variable_separation_tpu_torch.ops import _build

SMEM_LIMIT = 232_448          # bytes of shared memory one CTA may use on an H100
CLUSTER_SIZES = (1, 2, 4, 8, 16)
CLUSTER_THREADS = 256         # threads per CTA of either kernel
MAX_BLOCKS = 16               # MLP-ResNet blocks either kernel takes
STREAM_ROWS = tuple(range(4, 33, 4))  # row tiles the streaming kernel is built for
STREAM_STAGES = 2             # W2 chunks in the streaming kernel's ring (its kStages)
STREAM_GROUP_ROWS = 16        # W2 rows one thread group takes from a chunk
STREAM_GROUP_COLS = 2         # W2 columns a thread of the W2 product takes
# Clusters of C CTAs that an H100 SXM runs at once at one CTA an SM, for a
# plan made off the card (cudaOccupancyMaxActiveClusters of the streaming
# kernel on an H100 80GB HBM3); on the card ``mlp_resnet_rollout`` asks it of
# the launch itself.
H100_ACTIVE_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


class RolloutPlan(NamedTuple):
    variant: str     # "cluster" or "stream"
    cluster: int     # CTAs per cluster
    rows: int        # batch rows per cluster
    smem_bytes: int  # dynamic shared memory of one CTA
    grid: int        # CTAs launched: a whole number of clusters
    waves: int = 0   # rounds of clusters the card runs ("stream"); 0 for "cluster"
    resident: bool = True  # W1, biases and W3 held in shared memory (always for "cluster")


class StreamLayout(NamedTuple):
    slice: int       # S: hidden columns a rank owns
    slice_pad: int   # S rounded up to 4
    k_groups: int    # thread groups over the rows of a W2 chunk
    chunk_rows: int  # W2 rows a chunk holds: STREAM_GROUP_ROWS * k_groups
    n_chunks: int    # chunks of one block's W2 slice
    hidden_pad: int  # n_chunks * chunk_rows: W2 rows, zero-padded


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


def stream_layout(hidden: int, cluster: int) -> StreamLayout:
    """How the streaming kernel cuts a rank's W2 slice into chunks; its
    ``make_layout`` computes the same."""
    s = -(-hidden // cluster)
    sp = _round_up4(s)
    k_groups = max(1, min(CLUSTER_THREADS // (sp // STREAM_GROUP_COLS),
                          -(-hidden // STREAM_GROUP_ROWS)))
    chunk_rows = STREAM_GROUP_ROWS * k_groups
    n_chunks = -(-hidden // chunk_rows)
    return StreamLayout(s, sp, k_groups, chunk_rows, n_chunks, n_chunks * chunk_rows)


def stream_smem_bytes(code: int, hidden: int, n_blocks: int, cluster: int, rows: int,
                      resident: bool = True) -> int:
    """Dynamic shared memory of one CTA of the streaming kernel, in bytes:
    every block's W1, b1, b2, W3, b3 slices (``resident``), the ring of W2
    chunks, the activations and the ring's mbarriers.  The kernel's
    ``make_layout`` computes the same."""
    lay = stream_layout(hidden, cluster)
    sp = lay.slice_pad
    k3_groups = min(max(1, CLUSTER_THREADS // code), sp)
    per_block = 2 * code * sp + 2 * sp + _round_up4(code) if resident else 0
    ring = STREAM_STAGES * lay.chunk_rows * sp
    scratch = max(lay.k_groups * sp, k3_groups * code)
    activations = rows * (code + lay.hidden_pad + sp + scratch + cluster * code)
    barriers = 4 * STREAM_STAGES * lay.k_groups  # a full and an empty mbarrier a slot and group
    return 4 * (n_blocks * per_block + ring + activations + barriers)


def rollout_plan(batch: int, code: int, hidden: int, n_blocks: int,
                 variant: Optional[str] = None, rows: Optional[int] = None,
                 active_clusters: Optional[Callable[[int, int, bool], int]] = None
                 ) -> RolloutPlan:
    """The kernel, cluster size, row tile and shared memory of a rollout.

    By default the cluster kernel at the smallest cluster whose slices fit,
    8 rows a cluster, else the streaming kernel.  8 rows, not 4: at the
    serving batch of 64 and clusters of 8, 4 rows need 16 clusters, and an
    H100 runs at most 15 such clusters at once, so the last runs in a second
    wave (``chip_smoke.py`` times both).

    The streaming kernel holds W1, the biases and W3 resident whenever some
    cluster size and row tile fit so, else reads them from L2.  Within that
    mode it takes the cluster size and row tile with the fewest waves,
    ``active_clusters(cluster, rows, resident)`` being the number of such
    clusters the card runs at once (default ``H100_ACTIVE_CLUSTERS``), then
    the least work a CTA (rows x slice), then the most rows.  ``variant``
    and ``rows`` force a choice, to measure one against the other; a forced
    choice that fits nowhere raises.
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
    if rows is not None and rows not in STREAM_ROWS:
        raise ValueError(f"the streaming kernel takes 4 to 32 rows, a multiple of 4, "
                         f"got {rows}")
    active_clusters = active_clusters or (lambda c, r, resident: H100_ACTIVE_CLUSTERS[c])
    for resident in (True, False):
        best = None
        for c in CLUSTER_SIZES:
            sp = stream_layout(hidden, c).slice_pad
            if sp > STREAM_GROUP_COLS * CLUSTER_THREADS:  # a thread a column pair of W2
                continue
            for r in STREAM_ROWS if rows is None else (rows,):
                smem = stream_smem_bytes(code, hidden, n_blocks, c, r, resident)
                if smem > SMEM_LIMIT:
                    break  # more rows need more
                fit = active_clusters(c, r, resident)
                if fit < 1:
                    continue
                n_clusters = -(-batch // r)
                waves = -(-n_clusters // fit)
                key = (waves, r * sp, -r)
                if best is None or key < best[0]:
                    best = (key, RolloutPlan("stream", c, r, smem, n_clusters * c, waves,
                                             resident))
        if best is not None:
            return best[1]
    raise ValueError(f"no rollout kernel takes {n_blocks} block(s) at code {code}, "
                     f"hidden {hidden}: the streaming kernel's ring and activations "
                     f"exceed {SMEM_LIMIT} bytes a CTA at every cluster size")


def pack_w2(params: Sequence[torch.Tensor], cluster: int) -> torch.Tensor:
    """Every block's W2 as the streaming kernel reads it: (n_blocks, cluster,
    hidden_pad, slice_pad), where [b, j, k, s] = W2_b[k, j*S + s] for
    k < hidden and j*S + s < hidden, else 0 -- so that each chunk of a rank's
    slice is one contiguous, 16-byte-aligned run for a bulk copy."""
    hidden = params[0].shape[1]
    lay = stream_layout(hidden, cluster)
    n_blocks = len(params) // 6
    packed = params[2].new_zeros((n_blocks, cluster, lay.hidden_pad, lay.slice_pad))
    for b in range(n_blocks):
        w2 = torch.nn.functional.pad(params[6 * b + 2], (0, cluster * lay.slice - hidden))
        packed[b, :, :hidden, :lay.slice] = w2.view(hidden, cluster, lay.slice).transpose(0, 1)
    return packed


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
        lib.mlp_resnet_rollout_f32.argtypes = [vp, vp, vp, i, vp, i, i, i, i, i, i, i, vp]
        lib.mlp_resnet_rollout_f32.restype = i
        lib.mlp_resnet_rollout_smem_bytes.argtypes = [i, i, i, i, i, i]
        lib.mlp_resnet_rollout_smem_bytes.restype = i
        lib.mlp_resnet_rollout_max_active.argtypes = [i, i, i, i, i, i, i]
        lib.mlp_resnet_rollout_max_active.restype = i
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


def stream_library() -> ctypes.CDLL:
    """The streaming kernel's library, for its shared-memory and occupancy queries."""
    return _library("mlp_resnet_rollout")


@functools.lru_cache(maxsize=None)
def _stream_active(batch: int, code: int, hidden: int, n_blocks: int, cluster: int,
                   rows: int, resident: bool) -> int:
    active = stream_library().mlp_resnet_rollout_max_active(
        batch, code, hidden, n_blocks, cluster, rows, int(resident))
    if active < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters of the streaming kernel failed "
                           f"(code {-active}) at cluster {cluster}, {rows} rows, "
                           f"resident={resident}")
    return active


def stream_active_clusters(batch: int, code: int, hidden: int,
                           n_blocks: int) -> Callable[[int, int, bool], int]:
    """``active_clusters`` for ``rollout_plan`` from the current card: the
    streaming clusters of this shape that fit at once, as
    cudaOccupancyMaxActiveClusters reports them for the launch itself.  Each
    shape is asked once and remembered."""
    return functools.partial(_stream_active, batch, code, hidden, n_blocks)


def mlp_resnet_rollout(t0: torch.Tensor, params: Sequence[torch.Tensor], n_steps: int,
                       plan: Optional[RolloutPlan] = None) -> torch.Tensor:
    """Rollout (B, code) -> (n_steps, B, code), t0 included.

    CPU tensors take the plain version; CUDA tensors launch the kernel that
    ``plan`` (default ``rollout_plan`` of the shapes, with the card's own
    count of streaming clusters that fit) names on the current stream, or
    raise.
    """
    n_blocks, batch, code, hidden = _check_inputs(t0, params, n_steps)
    if t0.device.type == "cpu":
        return mlp_resnet_rollout_reference(t0, params, n_steps)
    if t0.device.type != "cuda":
        raise ValueError(f"mlp_resnet_rollout has no kernel for device {t0.device}")
    with torch.cuda.device(t0.device):
        if plan is None:
            plan = rollout_plan(batch, code, hidden, n_blocks,
                                active_clusters=stream_active_clusters(batch, code, hidden,
                                                                       n_blocks))
        name = "mlp_resnet_rollout" if plan.variant == "stream" else "mlp_resnet_rollout_cluster"
        lib = _library(name)
        out = torch.empty((n_steps, batch, code), dtype=torch.float32, device=t0.device)
        ptrs = (ctypes.c_void_p * len(params))(*(p.data_ptr() for p in params))
        args = (t0.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p))
        shape = (n_blocks, out.data_ptr(), batch, code, hidden, n_steps, plan.cluster,
                 plan.rows)
        stream = torch.cuda.current_stream().cuda_stream
        if plan.variant == "stream":
            # w2 is freed on return; the caching allocator reuses its memory only
            # for work queued on this stream after the kernel.
            w2 = pack_w2(params, plan.cluster)
            err = lib.mlp_resnet_rollout_f32(*args, w2.data_ptr(), *shape, int(plan.resident),
                                             stream)
        else:
            err = lib.mlp_resnet_rollout_cluster_f32(*args, *shape, stream)
    if err != 0:
        message = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed ({plan}): {message} (code {err})")
    mlp_resnet_rollout.launches += 1
    mlp_resnet_rollout.variant_launches[plan.variant] += 1
    return out


mlp_resnet_rollout.launches = 0
mlp_resnet_rollout.variant_launches = {"cluster": 0, "stream": 0}

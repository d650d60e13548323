"""MLP-ResNet Euler rollout: the hand-written CUDA kernel and its plain version.

Counterpart of the JAX package's ``ops/pallas/rollout.py``.  The separable
forecaster evolves its T code by ``n_steps - 1`` sequential Euler steps of a
small residual MLP (reference ``var_sep/networks/model.py:78-83``).

* ``mlp_resnet_rollout_reference`` is the plain PyTorch version: a Python
  loop over steps and blocks of ``addmm``/``relu`` in f32.
* ``mlp_resnet_rollout`` runs the plain version for a tensor on the CPU and
  launches ``csrc/mlp_resnet_rollout.cu`` for a tensor on the card; it never
  falls back from one to the other.  ``mlp_resnet_rollout.launches`` counts
  the kernel launches.

``params`` is the flat ``[w1, b1, w2, b2, w3, b3] * n_blocks`` list in the
JAX ``(in, out)`` layout (``MLPResnet.flat_params``), f32 and contiguous; the
result is ``(n_steps, B, code)`` with ``t0`` as row 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from spatiotemporal_variable_separation_tpu_torch.ops import _build


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
def _library() -> ctypes.CDLL:
    lib = _build.load("mlp_resnet_rollout")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mlp_resnet_rollout_f32.argtypes = [vp, vp, i, vp, i, i, i, i, vp]
    lib.mlp_resnet_rollout_f32.restype = i
    lib.mlp_resnet_rollout_max_blocks.argtypes = []
    lib.mlp_resnet_rollout_max_blocks.restype = i
    lib.mlp_resnet_rollout_error_string.argtypes = [i]
    lib.mlp_resnet_rollout_error_string.restype = ctypes.c_char_p
    return lib


def mlp_resnet_rollout(t0: torch.Tensor, params: Sequence[torch.Tensor],
                       n_steps: int) -> torch.Tensor:
    """Rollout (B, code) -> (n_steps, B, code), t0 included.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream, or raise.
    """
    n_blocks, batch, code, hidden = _check_inputs(t0, params, n_steps)
    if t0.device.type == "cpu":
        return mlp_resnet_rollout_reference(t0, params, n_steps)
    if t0.device.type != "cuda":
        raise ValueError(f"mlp_resnet_rollout has no kernel for device {t0.device}")
    lib = _library()
    max_blocks = lib.mlp_resnet_rollout_max_blocks()
    if n_blocks > max_blocks:
        raise ValueError(f"the rollout kernel takes at most {max_blocks} blocks, "
                         f"got {n_blocks}")
    out = torch.empty((n_steps, batch, code), dtype=torch.float32, device=t0.device)
    ptrs = (ctypes.c_void_p * len(params))(*(p.data_ptr() for p in params))
    with torch.cuda.device(t0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlp_resnet_rollout_f32(
            t0.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p), n_blocks,
            out.data_ptr(), batch, code, hidden, n_steps, stream)
    if err != 0:
        raise RuntimeError("mlp_resnet_rollout kernel launch failed: "
                           f"{lib.mlp_resnet_rollout_error_string(err).decode()} "
                           f"(cudaError_t {err})")
    mlp_resnet_rollout.launches += 1
    return out


mlp_resnet_rollout.launches = 0

"""The DCGAN decoder's transposed 4x4 convolutions: a hand-written CUDA kernel and its
plain version.

A stage of ``models/conv.py:DCGAN64Decoder`` is ConvTranspose2d(k 4) -> eval
BatchNorm (running statistics) -> activation.  Both functions here compute
that stage on an NHWC input:

* ``transposed_conv_reference`` is the plain PyTorch version.  A k4 s2 p1
  transposed conv is four stride-1 2x2 convolutions, one for each output
  phase (oy % 2, ox % 2): even outputs take kernel taps 1 and 3, odd outputs
  taps 0 and 2.  It runs them with ``F.conv2d`` on the tap slices and
  interleaves them; a 1x1 input (stride 1, padding 0) is one matrix product.
  Then ``F.batch_norm`` and the activation.
* ``transposed_conv`` runs the plain version for a tensor on the CPU and, for
  a tensor on the card, launches ``csrc/transposed_conv.cu`` on the current
  stream, or raises: an implicit GEMM a phase on the tensor cores in 3xTF32,
  or for a frame of at most 4 channels a kernel on the CUDA cores in f32, each
  with the bias, the BatchNorm and the activation in its epilogue.  Nothing
  falls back.  ``transposed_conv.launches`` counts the launches, one a call.

The weight is ConvTranspose2d's own, (C_in, C_out, 4, 4); the kernel takes it
packed as (ky, kx, C_out, C_in), a copy made each call, so a weight that changes
between calls is always read anew.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from spatiotemporal_variable_separation_tpu_torch.core.activations import activation
from spatiotemporal_variable_separation_tpu_torch.ops import _build

# Activations the kernel's epilogue computes, by their registry names.
EPILOGUE_ACTS = {None: 0, "none": 0, "identity": 0, "relu": 1, "leaky_relu": 2, "sigmoid": 3,
                 "tanh": 4, "elu": 5}
# The kernel rows of output phase p's two taps, in F.conv2d's order after the
# phase's padding (before, after) of one row: p 0 reads rows q - 1 and q, p 1
# rows q and q + 1.
_PHASE_TAPS = {0: [3, 1], 1: [2, 0]}
_PHASE_PAD = {0: (1, 0), 1: (0, 1)}


class BatchNormStats(NamedTuple):
    """An eval BatchNorm: its running statistics, its affine pair and eps."""
    mean: torch.Tensor
    var: torch.Tensor
    weight: torch.Tensor
    bias: torch.Tensor
    eps: float


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           bn: Optional[BatchNormStats], act: Optional[str], stride: int, padding: int,
           out_nchw: bool) -> bool:
    """Validate what both versions take; returns whether the conv upsamples
    (k4 s2 p1) rather than maps a 1x1 input (k4 s1 p0)."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (N, H, W, C_in), got shape {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if weight.dim() != 4 or weight.shape[0] != cin or tuple(weight.shape[2:]) != (4, 4):
        raise ValueError(f"weight must be ({cin}, C_out, 4, 4), got {tuple(weight.shape)}")
    cout = weight.shape[1]
    if (stride, padding) == (2, 1):
        up = True
    elif (stride, padding) == (1, 0) and (h, w) == (1, 1):
        up = False
        if out_nchw:
            raise ValueError("a 1x1 input's output is NHWC only")
    else:
        raise ValueError(f"the kernel takes stride 2 padding 1, or stride 1 padding 0 on a "
                         f"1x1 input; got stride {stride}, padding {padding} on {h}x{w}")
    if act not in EPILOGUE_ACTS:
        raise ValueError(f"the epilogue has no activation {act!r}")
    vectors = [("bias", bias)] + ([] if bn is None else
                                  [(f"bn.{k}", getattr(bn, k))
                                   for k in ("mean", "var", "weight", "bias")])
    for name, v in [("x", x), ("weight", weight)] + vectors:
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if v.dtype != x.dtype:
            raise TypeError(f"{name} is {v.dtype}, x {x.dtype}")
    for name, v in vectors:
        if tuple(v.shape) != (cout,):
            raise ValueError(f"{name} must have shape ({cout},), got {tuple(v.shape)}")
    if min(n, h, w, cin) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    return up


def transposed_conv_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              bn: Optional[BatchNormStats] = None, act: Optional[str] = None,
                              *, stride: int, padding: int,
                              out_nchw: bool = False) -> torch.Tensor:
    """Plain version: the four phases by ``F.conv2d``, then bias, BatchNorm and
    the activation, in the input's type.  x NHWC; returns NHWC, or NCHW with
    ``out_nchw``."""
    up = _check(x, weight, bias, bn, act, stride, padding, out_nchw)
    n, h, w, cin = x.shape
    cout = weight.shape[1]
    if up:
        xc = x.permute(0, 3, 1, 2)
        wt = weight.transpose(0, 1)  # (C_out, C_in, ky, kx), F.conv2d's layout
        y = x.new_empty((n, cout, 2 * h, 2 * w))
        for py in (0, 1):
            for px in (0, 1):
                k = wt[:, :, _PHASE_TAPS[py]][:, :, :, _PHASE_TAPS[px]]
                y[:, :, py::2, px::2] = F.conv2d(F.pad(xc, _PHASE_PAD[px] + _PHASE_PAD[py]), k,
                                                 bias)
    else:
        y = (x.reshape(n, cin) @ weight.reshape(cin, cout * 16)).reshape(n, cout, 4, 4)
        y = y + bias[:, None, None]
    if bn is not None:
        y = F.batch_norm(y, bn.mean, bn.var, bn.weight, bn.bias, False, 0.0, bn.eps)
    y = activation(act)(y)
    return y if out_nchw else y.permute(0, 2, 3, 1).contiguous()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("transposed_conv")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.transposed_conv_f32.argtypes = [vp] * 7 + [ctypes.c_float, vp] + [i] * 8 + [vp]
    lib.transposed_conv_f32.restype = i
    lib.transposed_conv_error_string.argtypes = [i]
    lib.transposed_conv_error_string.restype = ctypes.c_char_p
    return lib


def transposed_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    bn: Optional[BatchNormStats] = None, act: Optional[str] = None, *,
                    stride: int, padding: int, out_nchw: bool = False) -> torch.Tensor:
    """One decoder stage on an NHWC input: ConvTranspose2d(4, stride, padding)
    + bias -> eval BatchNorm -> ``act``; NHWC out, or NCHW with ``out_nchw``.

    CPU tensors take the plain version; CUDA tensors (f32, x contiguous)
    launch the kernel on the current stream, or raise."""
    up = _check(x, weight, bias, bn, act, stride, padding, out_nchw)
    if x.device.type == "cpu":
        return transposed_conv_reference(x, weight, bias, bn, act, stride=stride,
                                         padding=padding, out_nchw=out_nchw)
    if x.device.type != "cuda":
        raise ValueError(f"transposed_conv has no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    n, h, w, cin = x.shape
    cout = weight.shape[1]
    vectors = [bias] + ([] if bn is None else [bn.mean, bn.var, bn.weight, bn.bias])
    vectors = [v.contiguous() for v in vectors]
    with torch.cuda.device(x.device):
        lib = _library()
        # (ky, kx, C_out, C_in): C_out rows of each tap, K contiguous (a 1x1 input's
        # 16 C_out columns are the rows of all taps)
        packed = weight.permute(2, 3, 1, 0).contiguous()
        shape = (n, cout, 2 * h, 2 * w) if out_nchw else ((n, 2 * h, 2 * w, cout) if up
                                                          else (n, 4, 4, cout))
        out = torch.empty(shape, dtype=torch.float32, device=x.device)
        stats = [v.data_ptr() for v in vectors[1:]] or [None] * 4
        eps = 0.0 if bn is None else bn.eps
        err = lib.transposed_conv_f32(x.data_ptr(), packed.data_ptr(), vectors[0].data_ptr(),
                                      *stats, eps, out.data_ptr(), n, h, w, cin, cout, int(up),
                                      EPILOGUE_ACTS[act], int(out_nchw),
                                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        message = lib.transposed_conv_error_string(err).decode()
        raise RuntimeError(f"transposed_conv kernel launch failed at x {tuple(x.shape)}, "
                           f"C_out {cout}, stride {stride}: {message} (code {err})")
    transposed_conv.launches += 1
    return out


transposed_conv.launches = 0

"""The DCGAN decoder's transposed-conv kernel route on the CPU: the plain
phase-decomposed version against ``F.conv_transpose2d``, the kernel's 3xTF32
split emulated (``split_tf32``, ``dot_3xtf32``), and the route that picks the
kernel.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py`` holds
it against the plain version; on the CPU ``transposed_conv`` takes the plain
version.

Tolerances: (a) compares in f64, where the two decompositions of the same
sums agree to ~1e-15 (in f32 their sums in other orders differ by ~1e-6 of
the largest output at K = 2,048); 1e-6 relative to the largest output.  (b)
2e-6 of the dot's own scale sum |a_i b_i|: the three TF32 products keep
about 22 bits of each operand, one keeps 11.
"""

import pytest
import torch
import torch.nn.functional as F

from spatiotemporal_variable_separation_tpu_torch.core import activations as activations_mod
from spatiotemporal_variable_separation_tpu_torch.core.activations import activation
from spatiotemporal_variable_separation_tpu_torch.models import conv as conv_mod
from spatiotemporal_variable_separation_tpu_torch.models import layers as layers_mod
from spatiotemporal_variable_separation_tpu_torch.models.conv import (
    DCGAN64Decoder,
    kernel_route,
)
from spatiotemporal_variable_separation_tpu_torch.ops import _build
from spatiotemporal_variable_separation_tpu_torch.ops.transposed_conv import (
    BatchNormStats,
    transposed_conv,
    transposed_conv_reference,
)

REL = 1e-6
DOT_REL = 2e-6

# (batch, input side, C_in, C_out, BatchNorm, activation): every DCGAN64Decoder
# stage at nf 64, then a skip width ((nf + snf) 8 = 1,024 at nf = snf = 64), the
# chairs frame (nc 3) and an odd C_in and batch.
STAGES = {
    "first_upconv nz 148 on 1x1": (2, 1, 148, 512, True, "leaky_relu"),
    "up_0 512 to 256": (2, 4, 512, 256, True, "leaky_relu"),
    "up_1 256 to 128": (2, 8, 256, 128, True, "leaky_relu"),
    "up_2 128 to 64": (2, 16, 128, 64, True, "leaky_relu"),
    "to_frame 64 to 1, sigmoid": (2, 32, 64, 1, False, "sigmoid"),
    "up_0 with skip, 1024 to 256": (2, 4, 1024, 256, True, "leaky_relu"),
    "to_frame nc 3, sigmoid": (2, 32, 64, 3, False, "sigmoid"),
    "odd C_in 7 and batch 3, tanh": (3, 5, 7, 10, True, "tanh"),
    "odd nz 13 on 1x1, odd batch": (3, 1, 13, 6, True, "relu"),
}


def _stage_inputs(batch, side, cin, cout, bn, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, side, side, cin, generator=g, dtype=dtype)
    w = torch.randn(cin, cout, 4, 4, generator=g, dtype=dtype) * (2.0 / (4 * cin)) ** 0.5
    b = 0.02 * torch.randn(cout, generator=g, dtype=dtype)
    stats = None
    if bn:
        stats = BatchNormStats(0.1 * torch.randn(cout, generator=g, dtype=dtype),
                               torch.rand(cout, generator=g, dtype=dtype) + 0.5,
                               1 + 0.02 * torch.randn(cout, generator=g, dtype=dtype),
                               0.02 * torch.randn(cout, generator=g, dtype=dtype), 1e-5)
    return x, w, b, stats


def _library_stage(x, w, b, stats, act, stride, padding):
    """F.conv_transpose2d + eval BatchNorm + activation, NCHW."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    if stats is not None:
        y = F.batch_norm(y, stats.mean, stats.var, stats.weight, stats.bias, False, 0.0,
                         stats.eps)
    return activation(act)(y)


@pytest.mark.parametrize("label", list(STAGES))
def test_plain_phases_equal_conv_transpose(label):
    batch, side, cin, cout, bn, act = STAGES[label]
    stride, padding = (1, 0) if side == 1 else (2, 1)
    x, w, b, stats = _stage_inputs(batch, side, cin, cout, bn)
    ref = _library_stage(x, w, b, stats, act, stride, padding)
    out = transposed_conv_reference(x, w, b, stats, act, stride=stride, padding=padding)
    assert out.shape == ref.permute(0, 2, 3, 1).shape
    scale = float(ref.abs().max())
    assert float((out - ref.permute(0, 2, 3, 1)).abs().max()) <= REL * scale
    if side > 1:
        nchw = transposed_conv_reference(x, w, b, stats, act, stride=stride, padding=padding,
                                         out_nchw=True)
        assert float((nchw - ref).abs().max()) <= REL * scale


def test_cpu_tensors_take_the_plain_version():
    x, w, b, stats = _stage_inputs(2, 4, 12, 8, True, dtype=torch.float32)
    before = transposed_conv.launches
    out = transposed_conv(x, w, b, stats, "leaky_relu", stride=2, padding=1)
    assert transposed_conv.launches == before
    torch.testing.assert_close(
        out, transposed_conv_reference(x, w, b, stats, "leaky_relu", stride=2, padding=1),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad,match", [
    (dict(stride=2, padding=0), "stride 2 padding 1"),
    (dict(stride=1, padding=0), "1x1 input"),
    (dict(act="gelu"), "no activation"),
    (dict(weight_shape=(12, 8, 3, 3)), "weight must be"),
    (dict(bias_len=7), r"bias must have shape \(8,\)"),
])
def test_wrapper_raises_on_what_the_kernel_cannot_take(bad, match):
    x, w, b, stats = _stage_inputs(2, 4, 12, 8, True, dtype=torch.float32)
    if "weight_shape" in bad:
        w = torch.zeros(bad["weight_shape"])
    if "bias_len" in bad:
        b = torch.zeros(bad["bias_len"])
    with pytest.raises(ValueError, match=match):
        transposed_conv(x, w, b, stats, bad.get("act", "leaky_relu"),
                        stride=bad.get("stride", 2), padding=bad.get("padding", 1))


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: the low 13 mantissa
    bits cleared, to nearest, ties away from zero.  In sign and magnitude, adding
    half of the dropped ulp to the magnitude's bits rounds ties away from zero, and
    a carry moves into the exponent as it should."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple:
    """(big, small) TF32 values of f32 ``x`` as the kernel splits each operand:
    big = x rounded to TF32, small = x - big rounded the same way."""
    big = _round_tf32(x)
    return big, _round_tf32(x - big)


def dot_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The kernel's dot products of f32 rows, (..., K) x (..., K) -> (...):
    small*big + big*small + big*big of TF32 values, summed in f32.  A product of
    two TF32 values (11 significant bits each) is exact in f32.  ``passes`` 1
    takes big*big alone (1xTF32)."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    if passes == 1:
        return (a_big * b_big).sum(-1)
    return (a_small * b_big + a_big * b_small + a_big * b_big).sum(-1)


def test_tf32_split_rounds_to_nearest_away_and_keeps_22_bits():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4096, generator=g) * 10.0 ** torch.randint(-6, 6, (4096,), generator=g)
    big, small = split_tf32(x)
    for part in (big, small):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())  # 10 mantissa bits left
    assert bool(((big - x).abs() <= x.abs() * 2.0 ** -11).all())
    assert bool(((big + small - x).abs() <= x.abs() * 2.0 ** -21).all())
    # 1 + 2^-11 lies halfway between two TF32 values: ties go away from zero.
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert split_tf32(tie)[0].tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


def test_three_tf32_products_keep_f32_accuracy_at_k_2048():
    g = torch.Generator().manual_seed(2)
    a, b = torch.randn(64, 2048, generator=g), torch.randn(64, 2048, generator=g)
    exact = (a.double() * b.double()).sum(-1)
    scale = (a.double() * b.double()).abs().sum(-1)
    three = ((dot_3xtf32(a, b).double() - exact).abs() / scale).max()
    one = ((dot_3xtf32(a, b, passes=1).double() - exact).abs() / scale).max()
    assert float(three) <= DOT_REL
    assert float(one) > DOT_REL


FACTS = [(training, grad, dtype, device)
         for training in (False, True) for grad in (False, True)
         for dtype in (torch.float32, torch.bfloat16) for device in ("cuda", "cpu")]


@pytest.mark.parametrize("training,grad,dtype,device", FACTS)
def test_kernel_route_only_in_eval_no_grad_f32_on_the_card(training, grad, dtype, device):
    taken = kernel_route(training, grad, dtype, torch.device(device))
    assert taken == (not training and not grad and dtype == torch.float32
                     and device == "cuda")


def _decoder(skip, nc, last, nf=6, snf=5):
    g = torch.Generator().manual_seed(0)
    dec = DCGAN64Decoder(20, nc, nf, generator=g, skip=skip, skip_nf=snf if skip else None,
                         last_activation=last).eval()
    with torch.no_grad():
        for m in dec.modules():
            if isinstance(m, layers_mod.BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    b = 3
    z1, z2 = torch.randn(b, 12, generator=g), torch.randn(b, 8, generator=g)
    skips = None
    if skip:
        skips = [torch.randn(b, snf * k, s, s, generator=g)
                 for k, s in ((8, 4), (4, 8), (2, 16), (1, 32))]
    return dec, z1, z2, skips


def test_cpu_eval_keeps_conv_transpose(monkeypatch):
    dec, z1, z2, _ = _decoder(False, 1, "sigmoid")

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel route was taken")

    monkeypatch.setattr(layers_mod, "transposed_conv", refuse)
    with torch.no_grad():
        out = dec(z1, z2)
    assert out.shape == (3, 1, 64, 64)


@pytest.mark.parametrize("skip,nc,last", [
    (False, 1, "sigmoid"),
    (True, 3, "tanh"),
    (False, 2, None),
    (False, 1, "softsign_test"),  # an activation the epilogue lacks: applied after it
])
def test_kernel_route_forward_equals_module_forward(monkeypatch, skip, nc, last):
    """The route's NHWC forward (run here through the plain version) against
    the module's own F.conv_transpose2d forward."""
    monkeypatch.setitem(activations_mod._REGISTRY, "softsign_test", F.softsign)
    dec, z1, z2, skips = _decoder(skip, nc, last)
    with torch.no_grad():
        ref = dec(z1, z2, skips)
        monkeypatch.setattr(conv_mod, "kernel_route", lambda *facts: True)
        out = dec(z1, z2, skips)
    assert out.shape == ref.shape == (3, nc, 64, 64)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


def test_serving_kernels_build_in_one_call(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "build",
                        lambda names=None, build_root=None: calls.append(tuple(names)) or
                        {n: f"lib{n}.so" for n in names})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_LOADED", {})
    assert _build.load("transposed_conv") == "libtransposed_conv.so"
    assert calls == [_build.SERVING_KERNELS]
    assert set(_build.SERVING_KERNELS) <= set(_build.kernel_names())

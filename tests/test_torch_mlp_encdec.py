"""The port's MLP encoder and decoder (``models/mlp_encdec.py``) against the
JAX package's, f32 on the CPU, with the same redrawn flax variables carried
across by ``load_flax_variables`` (no new case in ``utils/weights.py``).

The C = 3 frame (8, 8, 3) tells the encoder's (T, H, W, C) flatten apart
from the channel-major one, which a C = 1 frame cannot: there both orders
coincide.

Tolerance: atol 1e-5, as ``test_torch_layers`` (f32, sums in another
order over at most a few hundred O(1) terms).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.models import mlp_encdec as jmlp
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models import mlp_encdec as tmlp
from spatiotemporal_variable_separation_tpu_torch.models.conv import DCGAN64Decoder
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from test_torch_layers import ATOL, GEN, port, random_variables

FRAMES = {"full": (64, 64, 1), "partial": (10, 1), "rgb": (8, 8, 3)}


@pytest.mark.parametrize("frame", list(FRAMES))
def test_mlp_encoder_matches_flax(frame):
    shape = FRAMES[frame]
    nt = 3
    x = np.random.default_rng(0).random((4, nt) + shape, dtype=np.float32)
    fm = jmlp.MLPEncoder(nh=6, hidden_size=16, nlayers=3)
    v = random_variables(fm, jnp.asarray(x))
    ref = np.asarray(fm.apply(v, jnp.asarray(x)))
    tm = port(tmlp.MLPEncoder(nt * int(np.prod(shape)), 6, 16, 3, generator=GEN), v)
    out = tm(torch.from_numpy(x), return_skip=True).detach().numpy()
    assert out.shape == ref.shape == (4, 6)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    if shape[-1] > 1:
        # the channel-major flatten (the reference's order) reads other
        # weights for the same pixels: it must not pass.
        cm = np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3)).reshape(4, -1)
        other = tm.mlp(torch.from_numpy(cm)).detach().numpy()
        assert np.abs(other - ref).max() > 100 * ATOL


@pytest.mark.parametrize("frame,mixing,last_act", [
    ("full", "concat", "sigmoid"),
    ("full", "mul", None),
    ("partial", "mul", "sigmoid"),
    ("partial", "concat", None),
    ("rgb", "concat", "sigmoid"),
])
def test_mlp_decoder_matches_flax(frame, mixing, last_act):
    shape = FRAMES[frame]
    rng = np.random.default_rng(1)
    code_s = 8 if mixing == "mul" else 5
    z1 = rng.standard_normal((3, code_s)).astype(np.float32)
    z2 = rng.standard_normal((3, 8)).astype(np.float32)
    fm = jmlp.MLPDecoder(output_shape=shape, hidden_size=16, nlayers=4,
                         last_activation=last_act, mixing=mixing)
    v = random_variables(fm, jnp.asarray(z1), jnp.asarray(z2))
    ref = np.asarray(fm.apply(v, jnp.asarray(z1), jnp.asarray(z2)))
    nz = code_s + 8 if mixing == "concat" else 8
    tm = port(tmlp.MLPDecoder(nz, shape, 16, 4, last_activation=last_act, mixing=mixing,
                              generator=GEN), v)
    out = tm(torch.from_numpy(z1), torch.from_numpy(z2)).detach().numpy()
    assert out.shape == ref.shape == (3,) + shape
    np.testing.assert_allclose(out, ref, atol=ATOL)
    with pytest.raises(ValueError, match="no skip"):
        tm(torch.from_numpy(z1), torch.from_numpy(z2), skip=[torch.zeros(1)])


def test_decoders_own_their_layout():
    """Each decoder converts between its output and the JAX (..., *frame)
    layout; the MLP decoder's output already is that layout."""
    stack = torch.arange(2 * 3 * 4 * 5 * 6.0).reshape(2, 3, 4, 5, 6)  # (n, B, C, H, W)
    frames = DCGAN64Decoder.stack_to_frames(stack)
    assert frames.shape == (3, 2, 5, 6, 4)
    assert torch.equal(DCGAN64Decoder.frame_to_output(frames[:, 0]), stack[0])
    partial = torch.arange(2 * 3 * 10.0).reshape(2, 3, 10, 1)  # (n, B, N, 1)
    assert torch.equal(tmlp.MLPDecoder.stack_to_frames(partial), partial.transpose(0, 1))
    assert tmlp.MLPDecoder.frame_to_output(partial) is partial


@pytest.mark.parametrize("data,arch,decoder", [
    ("wave", "mlp", None), ("wave_partial", "mlp", None), ("wave", "dcgan", "mlp"),
    ("wave", "mlp", "dcgan"),
])
def test_factory_builds_the_mlp_pairs(data, arch, decoder):
    cfg = ExperimentConfig(data=data, architecture=arch, decoder_architecture=decoder,
                           mixing="mul", code_size_s=8, code_size_t=8, enc_hidden_size=8,
                           dec_hidden_size=8, res_hidden_size=16, nt_cond=2, offset=2,
                           precision="bf16")
    model = build_separable_network(cfg, torch.device("cpu"), GEN)
    kinds = (type(model.Es).__name__, type(model.decoder).__name__)
    assert kinds == ({"mlp": "MLPEncoder", "dcgan": "DCGAN64Encoder"}[arch],
                     {"mlp": "MLPDecoder", "dcgan": "DCGAN64Decoder"}[cfg.decoder_arch])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if cfg.decoder_arch == "mlp":
        assert model.decoder.output_shape == cfg.frame_shape
    cond = torch.rand((2, 2) + cfg.frame_shape)
    with torch.no_grad():
        out = model.eval().get_forecast(cond, 3)[0]
    assert out.shape == (2, 3) + cfg.frame_shape and out.dtype == torch.bfloat16
